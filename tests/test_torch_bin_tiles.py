"""The binning kernels' design (ops/csrc/bin_tiles.cu) pinned on the CPU.

Within one tile the plain version's stable sort of fused keys orders the
candidates by a key that is unique there: (quantized depth, point id) for
the forward table, the point id for the occupancy-backward table.  So a
count, a scan, a scatter in any order and a sort of each tile's segment
by that key give bin_splats_plain's tables exactly.  `_model_tables` does
those steps in numpy (the scatter in a shuffled order), `_model_median`
the median kernel's radix selection over ordered float keys; both are
held to the plain versions bit for bit.  CPU tensors take the plain
versions and launch nothing."""
import numpy as np
import pytest
import torch

from dss_tpu_torch.ops import kernels, splat

S, T, V, N = 64, 16, 3, 300


def _splats(seed, n=N, v=V, ties=False):
    """Screen-space splats with points off screen (|x|, |y| up to 1.3),
    behind the camera (pz < 0), NaN-free; `ties` rounds pz to 0.25 so
    that many candidates of a tile share their quantized depth."""
    rng = np.random.default_rng(seed)
    pz = rng.uniform(-0.5, 3.0, (v, n))
    if ties:
        pz = np.round(pz * 4.0) / 4.0
    pts = np.stack([rng.uniform(-1.3, 1.3, (v, n)),
                    rng.uniform(-1.3, 1.3, (v, n)), pz], -1)
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    return dict(
        pts=f(pts), ellipse=f(rng.uniform(0.5, 50.0, (v, n, 3))),
        cutoff=f(rng.uniform(0.5, 4.0, (v, n))),
        radii=f(rng.uniform(0.0, 0.15, (v, n, 2))),
        scaler=f(rng.uniform(0.1, 1.0, (v, n))),
        features=f(rng.uniform(0.0, 1.0, (v, n, 3))),
        visible=torch.tensor(rng.random((v, n)) < 0.7))


def _model_tables(sp, s, t, m, mtx, mty, extra, depth, backward, pair_cap,
                  seed, visible=None, scaler=True, features=True):
    """count → scan → shuffled scatter → per-tile sort, in numpy."""
    pts, radii = sp["pts"], sp["radii"]
    v, p = pts.shape[:2]
    nt = s // t
    n_tiles = nt * nt
    cap = splat._pair_cap(p, p * mtx * mty, pair_cap, backward)
    ex = torch.as_tensor(extra, dtype=torch.float32).expand(v)[:, None]
    px, py, pz = pts.unbind(-1)
    rx, ry = radii[..., 0] + ex, radii[..., 1] + ex
    cx_lo, cx_hi = splat.ndc_to_pixel(px + rx, s), splat.ndc_to_pixel(px - rx, s)
    cy_lo, cy_hi = splat.ndc_to_pixel(py + ry, s), splat.ndc_to_pixel(py - ry, s)
    off = (cx_hi < 0) | (cx_lo > s - 1) | (cy_hi < 0) | (cy_lo > s - 1)
    live = (rx > 0) & (pz >= 0.0) & ~off
    if visible is not None:
        live &= visible
    tx_lo, tx_hi = (splat._tile_index(c, t, nt).numpy() for c in (cx_lo, cx_hi))
    ty_lo, ty_hi = (splat._tile_index(c, t, nt).numpy() for c in (cy_lo, cy_hi))
    live = live.numpy()
    span = live & ((tx_hi - tx_lo + 1 > mtx) | (ty_hi - ty_lo + 1 > mty))

    # 1. count: one pair per (point, tile) of its span within the budget
    pairs = [(vi, (ty_lo[vi, pi] + j) * nt + tx_lo[vi, pi] + i, pi)
             for vi, pi in zip(*np.nonzero(live))
             for i in range(mtx) if tx_lo[vi, pi] + i <= tx_hi[vi, pi]
             for j in range(mty) if ty_lo[vi, pi] + j <= ty_hi[vi, pi]]
    counts = np.zeros((v, n_tiles), np.int64)
    for vi, ti, _ in pairs:
        counts[vi, ti] += 1
    # 2. scan: offsets, the pair cap, the capacity, the overflow terms
    seg = np.cumsum(counts, 1) - counts
    total = counts.sum(1)
    full = np.minimum(seg + counts, cap) - np.minimum(seg, cap)
    kept = np.minimum(full, m)
    overflow = (np.maximum(full - m, 0).sum(1) + span.sum(1)
                + np.maximum(total - cap, 0))
    # the unique key of each point
    ids = np.arange(p, dtype=np.int64)
    key = np.broadcast_to(ids, (v, p))
    if depth:
        zq_bits = max(1, 30 - max(n_tiles - 1, 1).bit_length())
        zq_max = (1 << zq_bits) - 1
        lv = torch.tensor(live)
        z_lo = torch.amin(torch.where(lv, pz, torch.inf), 1)
        z_hi = torch.amax(torch.where(lv, pz, -torch.inf), 1)
        z_lo = torch.where(torch.isfinite(z_lo), z_lo, 0.0)
        z_hi = torch.where(torch.isfinite(z_hi), z_hi, 1.0)
        zf = (pz - z_lo[:, None]) / torch.clamp(z_hi - z_lo, min=1e-9)[:, None]
        zf = torch.clamp(zf * zq_max, 0.0, float(zq_max))
        zq = torch.clamp(zf.to(torch.int64), 0, zq_max).numpy()
        key = (zq << 24) | ids
    # 3. scatter in a shuffled order at per-tile cursors
    keys = np.full((v, p * mtx * mty), -1, np.int64)
    cursor = np.zeros_like(counts)
    for k in np.random.default_rng(seed).permutation(len(pairs)):
        vi, ti, pi = pairs[k]
        if seg[vi, ti] < cap:
            keys[vi, seg[vi, ti] + cursor[vi, ti]] = key[vi, pi]
            cursor[vi, ti] += 1
    # 4. each tile's segment sorted, its first `kept` keys written
    zero = torch.zeros((v, p))
    if backward:
        src = torch.stack([px, py, pz, radii[..., 0], radii[..., 1]], -1)
        sentinel = [2.0, 2.0, -1.0, 0.0, 0.0]
    else:
        sc = sp["scaler"] if scaler else zero
        ft = sp["features"] if features else torch.zeros((v, p, 3))
        src = torch.stack([px, py, pz, *sp["ellipse"].unbind(-1),
                           sp["cutoff"], rx, ry, sc, *ft.unbind(-1),
                           torch.arange(p, dtype=torch.float32).expand(v, p)],
                          -1)
        sentinel = [2.0, 2.0, -1.0, 0, 0, 0, -np.inf, 0, 0, 0, 0, 0, 0, -1.0]
    src = src.numpy()
    c = src.shape[-1]
    table = np.broadcast_to(np.asarray(sentinel, np.float32)[:, None],
                            (v, n_tiles, c, m)).copy()
    tile_ids = np.full((v, n_tiles, m), -1, np.int32)
    for vi in range(v):
        for ti in range(n_tiles):
            n = counts[vi, ti] if seg[vi, ti] < cap else 0
            got = np.sort(keys[vi, seg[vi, ti]:seg[vi, ti] + n])[:kept[vi, ti]]
            pid = got & ((1 << 24) - 1)
            table[vi, ti, :, :len(pid)] = src[vi, pid].T
            tile_ids[vi, ti, :len(pid)] = pid
    return splat.BinnedSplats(torch.tensor(table), torch.tensor(tile_ids),
                              torch.tensor(kept, dtype=torch.int32),
                              torch.tensor(overflow, dtype=torch.int32))


def _assert_equal(got, want):
    for field in splat.BinnedSplats._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


# (label, seed, splat kwargs, tile, capacity, max tiles, extra radius,
#  sort_by_depth, backward_channels, pair_cap, with scaler and features)
CASES = [
    ("forward", 1, {}, T, 128, 4, 0.0, True, False, None, True),
    ("depth ties", 2, {"ties": True}, T, 128, 4, 0.0, True, False, None, True),
    ("tile capacity", 3, {}, T, 8, 4, 0.0, True, False, None, True),
    ("pair cap", 4, {}, T, 128, 4, 0.0, True, False, 128, True),
    ("span", 5, {}, 8, 128, 1, 0.1, True, False, None, True),
    ("per-view extra radius", 6, {}, T, 128, 4, [0.0, 0.05, 0.2], True,
     False, None, True),
    ("unsorted forward, no scaler or features", 7, {}, T, 128, 4, 0.0, False,
     False, None, False),
    ("one tile", 8, {}, 64, 256, 1, 0.0, True, False, None, True),
    ("32 px", 9, {"n": 120}, 16, 64, 2, 0.0, True, False, None, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_count_scan_scatter_sort_equals_plain(case):
    _, seed, kw, t, m, mt, extra, depth, backward, pair_cap, chans = case
    sp = _splats(seed, **kw)
    s = 32 if "n" in kw else S
    ex = torch.tensor(extra) if isinstance(extra, list) else extra
    want = splat.bin_splats_plain(
        sp["pts"], sp["ellipse"], sp["cutoff"], sp["radii"], s, t, m, mt, mt,
        ex, depth, sp["scaler"] if chans else None,
        sp["features"] if chans else None, backward, pair_cap)
    got = _model_tables(sp, s, t, m, mt, mt, extra, depth, backward, pair_cap,
                        seed, scaler=chans, features=chans)
    _assert_equal(got, want)
    if case[0] in ("tile capacity", "pair cap", "span"):
        assert int(want.overflow.min()) > 0
    if case[0] == "depth ties":
        d = want.tile_data
        z = d[:, :, kernels.CH_PZ, 1:]
        same = (z == d[:, :, kernels.CH_PZ, :-1]) & (z >= 0.0)
        assert int(same.sum()) > 20  # equal depths, ordered by point id


@pytest.mark.parametrize("n_live_views", [3, 2])
def test_support_table_equals_plain(n_live_views):
    """The occupancy-backward table: the visible mask, the per-view support
    radius as the extra radius, id-ordered tiles; with a view whose points
    are all behind the camera (z range (0, 1), an empty table)."""
    sp = _splats(11)
    if n_live_views < V:
        sp["pts"][V - 1, :, 2] = -1.0
    binned, cur_r2 = splat.bin_for_occ_backward(
        sp["pts"], sp["radii"], sp["visible"], 5.0, S, T, 256, 4)
    v, p = sp["pts"].shape[:2]
    r = splat.masked_median_plain(
        sp["radii"].reshape(v, -1),
        sp["visible"][..., None].expand(v, p, 2).reshape(v, -1)) * 5.0
    assert torch.equal(r * r, cur_r2)
    got = _model_tables(sp, S, T, 256, 4, 4, r, False, True, None, 12,
                        visible=sp["visible"])
    _assert_equal(got, binned)
    assert float(cur_r2.min()) > 0
    if n_live_views < V:
        assert int(binned.tile_counts[V - 1].sum()) == 0


def _ordered(x):
    u = x.view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _unordered(k):
    k = np.uint64(k)
    u = k ^ np.uint64(0x80000000) if k & np.uint64(0x80000000) else ~k
    return np.array([u & np.uint64(0xFFFFFFFF)], np.uint64).astype(
        np.uint32).view(np.float32)[0]


def _model_median(vals, mask):
    """The median kernel: ordered keys (masked-out as +inf, NaN above it),
    two ranks found by 8-bit digit histograms, most significant first."""
    out = []
    for x, mk in zip(vals, mask):
        n = int(mk.sum())
        keys = np.where(~mk, _ordered(np.float32([np.inf]))[0],
                        np.where(np.isnan(x), np.uint64(0xFFFFFFFF),
                                 _ordered(x))).astype(np.uint64)
        picked = []
        for rank in (max((n - 1) // 2, 0), n // 2):
            prefix, pmask = 0, 0
            for shift in (24, 16, 8, 0):
                sel = keys[(keys & pmask) == prefix]
                hist = np.bincount(((sel >> shift) & 255).astype(np.int64),
                                   minlength=256)
                cum = np.cumsum(hist)
                b = int(np.searchsorted(cum, rank, side="right"))
                rank -= int(cum[b] - hist[b])
                prefix |= b << shift
                pmask |= 255 << shift
            picked.append(_unordered(prefix))
        med = np.float32(0.5) * (picked[0] + picked[1]) if n else np.float32(0)
        out.append(med)
    return np.asarray(out, np.float32)


def test_median_selection_equals_plain():
    """Even, odd and zero masked counts, duplicates, +inf among the masked
    values, a NaN (placed above +inf, as torch.sort places it)."""
    rng = np.random.default_rng(13)
    vals = rng.uniform(0.0, 0.1, (6, 201)).astype(np.float32)
    vals[1, ::3] = 0.05  # duplicates
    vals[2, :5] = np.inf
    vals[3, 7] = np.nan
    mask = rng.random((6, 201)) < np.array([[0.5], [0.7], [1.0], [0.4], [0.0],
                                            [1.0]])
    mask[5, 200] = False  # 200 values: an even count
    got = _model_median(vals, mask)
    want = splat.masked_median_plain(torch.tensor(vals),
                                     torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert {int(n) % 2 for n in mask.sum(1) if n} == {0, 1}
    assert want[4] == 0.0 and np.isfinite(want[:2]).all()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    sp = _splats(17)
    kernels.reset_launch_counts()
    fwd = splat.bin_splats(sp["pts"], sp["ellipse"], sp["cutoff"], sp["radii"],
                           S, T, 128, scaler=sp["scaler"],
                           features=sp["features"])
    bwd, r2 = splat.bin_for_occ_backward(sp["pts"], sp["radii"],
                                         sp["visible"], 5.0, S, T, 256, 4)
    med = splat.masked_median(sp["radii"][..., 0], sp["visible"])
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.read_bin_long_tiles("cpu") == 0
    _assert_equal(fwd, splat.bin_splats_plain(
        sp["pts"], sp["ellipse"], sp["cutoff"], sp["radii"], S, T, 128,
        scaler=sp["scaler"], features=sp["features"]))
    assert torch.equal(med, splat.masked_median_plain(sp["radii"][..., 0],
                                                      sp["visible"]))
    binned, cur_r2, total = splat._bin_support(
        sp["pts"], sp["radii"], sp["visible"], 5.0, S, T, 256, 4, None,
        overflow_base=fwd.overflow)
    _assert_equal(binned, bwd)
    assert torch.equal(cur_r2, r2)
    assert torch.equal(total, fwd.overflow + bwd.overflow)
