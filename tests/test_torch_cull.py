"""The sub-tile cull that K1, K3 and K5 share (csrc/common.cuh: cull_chunk,
walk_culled), pinned to dss_tpu on the CPU.

The kernels run on the card only; here `culled` replays what they compute
with the plain versions: each 16×16 sub-tile of a tile walks its own copy
of the tile's table, in which every slot `kernels.subtile_cull_plain`
culls for that sub-tile holds the sentinel row.  The replay must give the
unculled walk's outputs on every sub-tile's pixels, and through the port's
ops the outputs of dss_tpu's Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dss_tpu.ops import splat_pallas as jsp
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.ops.splat import _seg, _tile, _untile

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N, K, CAP, DMT = 64, 32, 3, 300, 5, 512, 0.05
SUB = kernels.SUB
CFG = splat.TileConfig(tile=T, cap=CAP, max_tiles=4)
# The padding row of the forward table (dss_tpu_torch.ops.splat, as in
# dss_tpu): off screen, pz = −1, cutoff = −inf, id −1.
SENTINEL = torch.tensor([2.0, 2.0, -1.0, 0.0, 0.0, 0.0, -torch.inf, 0.0, 0.0,
                         0.0, 0.0, 0.0, 0.0, -1.0])


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# The replay of the culled kernels
# ---------------------------------------------------------------------------


def _sub_tile_tables(counts, table, s, t):
    """Each sub-tile's table after the cull, as a table of 16² tiles:
    (counts (V, nt16), table (V, nt16, C, M)), the parent tile's count and
    table with the sub-tile's culled slots replaced by the sentinel row."""
    v, nt, c, m = table.shape
    ntx, subs = s // t, t // SUB
    keep = kernels.subtile_cull_plain(counts, table, s, t)  # (V, nt, subs², M)
    tabs = torch.where(keep[:, :, :, None, :], table[:, :, None],
                       SENTINEL[:, None])
    # (ty, tx, a, b) → 16²-tile order (ty, a, tx, b)
    order = lambda x: x.reshape(v, ntx, ntx, subs, subs, *x.shape[3:]).permute(
        0, 1, 3, 2, 4, *range(5, x.ndim + 2)).reshape(v, -1, *x.shape[3:])
    cnt = counts[:, :, None].expand(v, nt, subs * subs)
    return order(cnt).contiguous(), order(tabs).contiguous()


def _retile(x, s, t_from, t_to):
    """Per-pixel outputs (V, nt, [ch,] tt) from tiles of t_from to t_to."""
    flat = x.ndim == 3
    y = _tile(_untile(x[:, :, None] if flat else x, s, t_from), t_to)
    y = y.transpose(2, 3)
    return (y[:, :, 0] if flat else y).contiguous()


def _per_tile(x, s, t, reduce):
    """Per-slot outputs (V, nt16, [ch,] M) of the sub-tiles → (V, nt, [ch,]
    M), reduced over each tile's sub-tiles."""
    v, ntx, subs = x.shape[0], s // t, t // SUB
    y = x.reshape(v, ntx, subs, ntx, subs, *x.shape[2:])
    return reduce(y, dim=(2, 4)).reshape(v, ntx * ntx, *x.shape[2:])


def culled(name):
    """kernels.<name>_plain as the culled CUDA kernel computes it; the same
    arguments and outputs."""
    plain = getattr(kernels, name + "_plain")

    def run(counts, table, *args):
        grad = args[0] if name == "feat_bwd" else None
        dmt, s, t, *rest = args[1:] if name == "feat_bwd" else args
        c16, tab16 = _sub_tile_tables(counts, table, s, t)
        if name == "feat_bwd":
            g16 = _retile(grad.transpose(2, 3), s, t, SUB).transpose(2, 3)
            out = plain(c16, tab16, g16.contiguous(), dmt, s, SUB, *rest)
            return _per_tile(out, s, t, torch.sum)
        out = plain(c16, tab16, dmt, s, SUB, *rest)
        vis = chip_smoke.EXACT_OUTPUTS[name].index("vis")
        return tuple(_per_tile(x, s, t, torch.amax) if i == vis
                     else _retile(x, s, SUB, t) for i, x in enumerate(out))

    return run


def _same_as_unculled(name, counts, table, *args):
    """The replay against the plain version: bit-equal cnt, vis, z, q, ids;
    rgbw within 1e-6 relative (the same terms in the same order, through a
    matmul whose zero terms may sit elsewhere); K3's sums within K3's
    tolerance (per sub-tile, then over them).  Returns the replay's
    outputs."""
    got = culled(name)(counts, table, *args)
    want = getattr(kernels, name + "_plain")(counts, table, *args)
    if name == "feat_bwd":
        chip_smoke._close(name, got, want, 1e-4, 1e-6)
        return got
    for i, label in enumerate(chip_smoke.EXACT_OUTPUTS[name]):
        assert torch.equal(got[i], want[i]), (name, label)
    torch.testing.assert_close(got[-1], want[-1], rtol=1e-6, atol=0.0)
    return got


def _accepted_per_sub_tile(counts, table, s, t):
    """(V, nt, subs², M): whether some pixel of the sub-tile accepts the
    live slot (the plain accept test over the whole table)."""
    v, nt, _, m = table.shape
    subs = t // SUB
    xf, yf = kernels._pixel_centres(s // t, t, s, table.device)
    live = torch.arange(m) < counts[:, :, None]
    out = []
    for vi in range(v):
        _, acc = kernels._chunk_accept(table[vi], xf[..., None], yf[..., None])
        acc = acc.reshape(nt, subs, SUB, subs, SUB, m).any(4).any(2)
        out.append(acc.reshape(nt, subs * subs, m) & live[vi, :, None])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# (a) A scene binned by dss_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    """Random screen-space splats (3 views, 64² in tiles of 32, 300 points,
    radii 2–4 px, depths 1–1.6) and dss_tpu's lean forward on them, with
    its binned tables."""
    rng = np.random.default_rng(21)
    a = rng.uniform(60.0, 200.0, (V, N, 1))
    c = rng.uniform(60.0, 200.0, (V, N, 1))
    b = rng.uniform(-20.0, 20.0, (V, N, 1))
    den = 4 * a * c - b * b
    f32 = lambda x: np.asarray(x, np.float32)
    sp = dict(
        pts=f32(np.concatenate([rng.uniform(-0.9, 0.9, (V, N, 2)),
                                rng.uniform(1.0, 1.6, (V, N, 1))], -1)),
        ell=f32(np.concatenate([a, b, c], -1)),
        cut=f32(np.ones((V, N))),
        radii=f32(np.sqrt(np.concatenate([4 * c / den, 4 * a / den], -1))),
        scaler=f32(rng.uniform(0.5, 1.5, (V, N))),
        feat=f32(rng.uniform(0.0, 1.0, (V, N, 3))),
    )
    occ, visible, rgbw, overflow, binned = jsp.rasterize_forward_views_lean(
        *(jnp.asarray(sp[k]) for k in ("pts", "ell", "cut", "radii")), DMT, S,
        K, tile_size=T, bin_capacity=CAP, scaler=jnp.asarray(sp["scaler"]),
        features=jnp.asarray(sp["feat"]), matmul_scatter=True, with_depth=True)
    assert int(jnp.sum(overflow)) == 0
    return dict(sp=sp, occ=np.asarray(occ), visible=np.asarray(visible),
                rgbw=np.asarray(rgbw),
                counts=_t(binned.tile_counts, torch.int32),
                table=_t(binned.tile_data),
                tile_ids=_t(binned.tile_ids, torch.int32))


def test_culled_fwd_lean_matches_unculled_and_jax(scene):
    counts, table = scene["counts"], scene["table"]
    assert not (_accepted_per_sub_tile(counts, table, S, T)
                & ~kernels.subtile_cull_plain(counts, table, S, T)).any()
    cnt, vis, rgbw = _same_as_unculled("fwd_lean", counts, table, DMT, S, T, K,
                                       True)
    occ = _untile(cnt[:, :, None, :], S, T)[..., 0] > 0
    visible = kernels.segment_sum_plain(
        vis.reshape(V, 1, -1), _seg(scene["tile_ids"], N), N)[..., 0] > 0
    np.testing.assert_array_equal(occ.numpy().astype(np.float32), scene["occ"])
    np.testing.assert_array_equal(visible.numpy(), scene["visible"])
    # the same terms in another order than the Pallas kernel's
    np.testing.assert_allclose(_untile(rgbw, S, T).numpy(), scene["rgbw"],
                               atol=1e-5)
    assert scene["visible"].sum() > 100


def test_culled_fwd_frag_matches_unculled_and_jax(scene, monkeypatch):
    counts, table = scene["counts"], scene["table"]
    got = _same_as_unculled("fwd_frag", counts, table, DMT, S, T, K)
    assert int((got[2] >= 0).sum()) > 1000
    # through the port's fragment forward (K5's fused scatter on the
    # replay), against rasterize_forward_pallas
    monkeypatch.setattr(kernels, "fwd_frag_plain", culled("fwd_frag"))
    sp = scene["sp"]
    (idx, zbuf, qv, occ, visible, rgbw, overflow,
     _b) = splat.rasterize_forward_fragments(
        S, K, CFG, *(_t(sp[k]) for k in ("pts", "ell", "cut", "radii")), DMT,
        _t(sp["scaler"]), _t(sp["feat"]))
    for v in range(V):
        (j_idx, j_z, j_q, j_occ, _fs, j_vis, j_rgbw, j_over) = map(
            np.asarray, jsp.rasterize_forward_pallas(
                *(jnp.asarray(sp[k][v]) for k in ("pts", "ell", "cut", "radii")),
                DMT, S, K, tile_size=T, bin_capacity=CAP, chunk=128,
                max_tiles_xy=4, scaler=jnp.asarray(sp["scaler"][v]),
                with_extras=True, features=jnp.asarray(sp["feat"][v])))
        np.testing.assert_array_equal(idx[v].numpy(), j_idx)
        np.testing.assert_array_equal(zbuf[v].numpy(), j_z)
        np.testing.assert_array_equal(occ[v].numpy(), j_occ)
        np.testing.assert_array_equal(visible[v].numpy(), j_vis)
        np.testing.assert_allclose(qv[v].numpy(), j_q, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rgbw[v].numpy(), j_rgbw, rtol=1e-5,
                                   atol=1e-6 * np.abs(j_rgbw).max())
        assert int(overflow[v]) == int(j_over) == 0


def test_culled_feat_bwd_matches_unculled(scene):
    counts, table = scene["counts"], scene["table"]
    g = np.random.default_rng(22).standard_normal(
        (V, counts.shape[1], T * T, 4)).astype(np.float32)
    got = _same_as_unculled("feat_bwd", counts, table, _t(g), DMT, S, T, K)
    assert float(got.abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# (b) The edge tables that chip_smoke.py and the CUDA tests hold the
# kernels to
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["border", "empty_chunk"])
def test_cull_keeps_every_accepted_pair_of_the_edge_tables(case):
    make = {"border": chip_smoke.cull_border_case,
            "empty_chunk": chip_smoke.cull_empty_chunk_case}[case]
    counts, table, grad, s, t, k, dmt = make(DEV)
    acc = _accepted_per_sub_tile(counts, table, s, t)
    assert acc.any()
    assert not (acc & ~kernels.subtile_cull_plain(counts, table, s, t)).any()
    if case == "border":
        # the table reaches the border: a cull over a sub-tile one pixel
        # narrower refuses an accepted pair
        narrow = kernels.subtile_cull_plain(counts, table, s, t, margin=-1)
        assert (acc & ~narrow).any()
    else:
        # the first chunk reaches one corner sub-tile only
        keep = kernels.subtile_cull_plain(counts, table, s, t)
        assert keep[0, 0, 0, :128].any() and not keep[0, 0, 1:, :128].any()
    _same_as_unculled("fwd_lean", counts, table, dmt, s, t, k, True)
    _same_as_unculled("feat_bwd", counts, table, grad, dmt, s, t, k)
    for kk in (k, 16):
        _same_as_unculled("fwd_frag", counts, table, dmt, s, t, kk)


# ---------------------------------------------------------------------------
# (c) Both window rules under the cull
# ---------------------------------------------------------------------------


def test_window_rules_survive_the_cull():
    """test_window_rules_of_k5_and_k3_match_jax's tie (there held to
    dss_tpu) on a tile of 32: the two splats straddle the border of
    sub-tiles 0 and 1 of tile 0 and are culled from sub-tiles 2 and 3.  A
    far splat makes a quantized-depth tie put the deeper of the two first.
    K5's window (z₀ = the rank-0 fragment) keeps it; K1's and K3's chunk
    minimum drops it.  The culled replay keeps both rules."""
    f32 = lambda x: _t(np.asarray(x, np.float32))
    y = 1.0 - 17.0 / S  # row 8
    b = splat.bin_splats(
        f32([[[0.5, y, 1.2], [0.5, y, 1.0], [-0.5, -0.5, 1e8]]]),
        f32([[[100.0, 0.0, 100.0]] * 3]), f32([[1.0] * 3]),
        f32([[[0.1, 0.1]] * 3]), S, T, CAP, 4, 4, scaler=f32([[1.0] * 3]),
        features=f32([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]]))
    counts, table = b.tile_counts, b.tile_data
    assert b.tile_ids[0, 0].tolist()[:2] == [0, 1]  # the deeper splat first
    keep = kernels.subtile_cull_plain(counts, table, S, T)[0, 0, :, :2]
    assert keep.tolist() == [[True, True], [True, True], [False, False],
                             [False, False]]
    _, vis, _ = _same_as_unculled("fwd_lean", counts, table, DMT, S, T, K, True)
    frag = _same_as_unculled("fwd_frag", counts, table, DMT, S, T, K)
    g = np.random.default_rng(3).standard_normal(
        (1, counts.shape[1], T * T, 4)).astype(np.float32)
    gf = _same_as_unculled("feat_bwd", counts, table, _t(g), DMT, S, T, K)
    # K5 keeps the deeper splat: the rank-0 fragment of its pixels, visible
    assert (frag[2][0, 0, 0] == 0).sum() > 10 and frag[4][0, 0, 0] == 1.0
    # K1 and K3 drop it: not visible, no colour gradient
    assert vis[0, 0, 0] == 0.0 and vis[0, 0, 1] == 1.0
    assert not gf[0, 0, :3, 0].any() and gf[0, 0, :3, 1].abs().max() > 1e-3


# ---------------------------------------------------------------------------
# (d) The cull is not vacuous
# ---------------------------------------------------------------------------


def test_cull_leaves_few_candidates_per_sub_tile(scene):
    counts, table = scene["counts"], scene["table"]
    keep = kernels.subtile_cull_plain(counts, table, S, T)
    per_sub = float(keep.sum()) / keep[..., 0].numel()
    per_tile = float(torch.clamp(counts, max=CAP).sum()) / counts.numel()
    assert per_tile > 50 and per_sub < 0.5 * per_tile, (per_sub, per_tile)
