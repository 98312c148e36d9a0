"""The CUDA kernels against their plain versions on the card.  Needs a
CUDA device and nvcc; skipped elsewhere.  The machine with the card has no
jax, which tests/conftest.py imports, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import _prep_view, _tile_config, render_views

pytestmark = pytest.mark.cuda

S, T, V, N, K, DMT = 128, 32, 4, 2000, 5, 0.05
# chip_smoke.k4_edge_cases, by label
K4_CASES = ("one id", "alternating ids", "-1 and P mixed in", "P = 1")


def fibonacci_sphere(n, radius):
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5**0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], axis=-1)
    return (pts * radius).astype(np.float32)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="module")
def tables(dev):
    pts = torch.tensor(fibonacci_sphere(N, 0.5), device=dev)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.linspace(-30.0, 30.0, V),
                                  azim=torch.linspace(0.0, 270.0, V))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=dev)
    st = RasterSettings(image_size=S, tile_size=T, backface_culling=False,
                        Vrk_invariant=True, Vrk_isotropic=False)
    cfg = _tile_config(N, st)
    with torch.no_grad():
        shaded, sp, pts_s = _prep_view(
            pts, pts / pts.norm(dim=-1, keepdim=True), torch.full_like(pts, 0.6),
            torch.ones(N, dtype=torch.bool, device=dev), cams, None, st, None,
            64.0)
        b = splat.bin_splats(pts_s, sp.ellipse_params, sp.cutoff, sp.radii, S,
                             T, cfg.cap, scaler=sp.scaler, features=shaded)
        vis = torch.rand((V, N), generator=torch.Generator(dev).manual_seed(0),
                         device=dev) < 0.8
        bb, r2 = splat.bin_for_occ_backward(pts_s, sp.radii, vis, 5.0, S, T,
                                            2048, 4)
    return b, bb, r2.contiguous()


def test_fwd_lean_matches_plain(tables):
    b = tables[0]
    got = kernels.fwd_lean(b.tile_counts, b.tile_data, N, DMT, S, T, K, True)
    want = kernels.fwd_lean_points_plain(b.tile_counts, b.tile_data, N, DMT,
                                         S, T, K, True)
    # cnt and the points' visibility flags bit-equal
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[1].sum() > 100
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


def test_occ_bwd_matches_plain(tables):
    bb, r2 = tables[1], tables[2]
    g = torch.randn((V, bb.tile_counts.shape[1], T * T), device="cuda") * 3e-4
    args = (bb.tile_counts, bb.tile_data, bb.tile_ids, g, r2, N, S, T)
    _close_k(kernels.occ_bwd(*args), kernels.occ_bwd_points_plain(*args))


def test_feat_bwd_matches_plain(tables):
    b = tables[0]
    g = torch.randn((V, b.tile_counts.shape[1], T * T, 4), device="cuda")
    got = kernels.feat_bwd(b.tile_counts, b.tile_data, g, N, DMT, S, T, K)
    want = kernels.feat_bwd_points_plain(b.tile_counts, b.tile_data, g, N,
                                         DMT, S, T, K)
    # per-point sums by float atomics in a run-dependent order: rtol 1e-4
    # with atol 1e-6·max for entries that nearly cancel
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))


def test_segment_sum_matches_plain(dev):
    gen = torch.Generator(dev).manual_seed(1)
    vals = torch.randn((3, 4, 50000), generator=gen, device=dev)
    seg = torch.randint(0, 1001, (3, 50000), generator=gen, device=dev,
                        dtype=torch.int32)
    got = kernels.segment_sum(vals, seg, 1000)
    want = kernels.segment_sum_plain(vals, seg, 1000)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", K4_CASES)
def test_segment_sum_warp_merge_edge_cases(dev, case):
    """chip_smoke.k4_edge_cases: one id in every lane, ids alternating
    from lane to lane, −1 and P among the ids, P = 1."""
    import chip_smoke

    label, vals, seg, p = next(c for c in chip_smoke.k4_edge_cases(dev)
                               if c[0] == case)
    want = kernels.segment_sum_plain(vals, seg, p)
    # positive terms summed in another order
    torch.testing.assert_close(kernels.segment_sum(vals, seg, p), want,
                               rtol=1e-4, atol=1e-6 * float(want.max()))
    assert want.max() > 0


def test_fwd_frag_matches_plain(tables):
    b = tables[0]
    got = kernels.fwd_frag(b.tile_counts, b.tile_data, N, DMT, S, T, K)
    want = kernels.fwd_frag_points_plain(b.tile_counts, b.tile_data, N, DMT,
                                         S, T, K)
    # z, q, ids, cnt and the points' visibility: the same accept, rank and
    # window arithmetic
    for i, name in enumerate(("z", "q", "ids", "cnt", "vis")):
        assert torch.equal(got[i], want[i]), name
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=1e-6)
    assert int((want[2] >= 0).sum()) > 0


@pytest.fixture(scope="module")
def wide_tables(dev):
    """200 splats 4–10 px in radius on 64² in tiles of 16 (2 views), so
    that a point lies in up to 3 × 3 tiles and the fused scatters add the
    tiles' sums into one point: (forward binning, support binning, cur_r²)
    on the card."""
    rng = np.random.default_rng(9)
    v, p, s, t = 2, 200, 64, 16
    a = rng.uniform(10.0, 64.0, (v, p, 1))
    c = rng.uniform(10.0, 64.0, (v, p, 1))
    b = rng.uniform(-5.0, 5.0, (v, p, 1))
    den = 4 * a * c - b * b
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    pts = f(np.concatenate([rng.uniform(-0.9, 0.9, (v, p, 2)),
                            rng.uniform(1.0, 1.6, (v, p, 1))], -1))
    radii = f(np.sqrt(np.concatenate([4 * c / den, 4 * a / den], -1)))
    fb = splat.bin_splats(pts, f(np.concatenate([a, b, c], -1)),
                          f(np.ones((v, p))), radii, s, t, 512,
                          scaler=f(rng.uniform(0.5, 1.5, (v, p))),
                          features=f(rng.uniform(0.0, 1.0, (v, p, 3))),
                          pair_cap=16 * p)
    visible = torch.ones((v, p), dtype=torch.bool, device=dev)
    bb, r2 = splat.bin_for_occ_backward(pts, radii, visible, 3.0, s, t, 2048,
                                        4, pair_cap=16 * p)
    assert int(fb.overflow.sum()) == 0 and int(bb.overflow.sum()) == 0
    return fb, bb, r2.contiguous()


@pytest.mark.parametrize("name", ["fwd_lean", "occ_bwd", "feat_bwd",
                                  "fwd_frag"])
def test_fused_scatter_of_points_in_several_tiles(dev, wide_tables, name):
    """Each fused kernel against its per-point plain version where most
    points have slots in several tiles (K2: several support tiles)."""
    import chip_smoke

    fb, bb, r2 = wide_tables
    s, t, p = 64, 16, 200
    b = bb if name == "occ_bwd" else fb
    slot = torch.arange(b.tile_ids.shape[-1], device=dev)
    live = slot < b.tile_counts[..., None]
    tiles_per_point = torch.stack([
        torch.bincount(b.tile_ids[vi][live[vi]].long(), minlength=p)
        for vi in range(b.tile_ids.shape[0])])
    assert (tiles_per_point >= 2).float().mean() > 0.5
    if name == "occ_bwd":
        g = torch.randn((2, 16, t * t), device=dev)
        args = (bb.tile_counts, bb.tile_data, bb.tile_ids, g, r2, p, s, t)
        want = kernels.occ_bwd_points_plain(*args)
        _close_k(kernels.occ_bwd(*args), want)
    else:
        g = torch.randn((2, 16, t * t, 4), device=dev)
        run, plain = chip_smoke.kernel_pair(name, fb.tile_counts, fb.tile_data,
                                            s, t, K, DMT, g, p)
        want = plain()
        chip_smoke.hold_to_plain(name, run(), want)
    # the forward kernels' visibility flags, the backward kernels' sums
    assert (want[-2] if name.startswith("fwd") else want).abs().max() > 0


def test_fragment_op_matches_the_cpu_path(dev):
    """rasterize_views_fragments on the card against its CPU path:
    forward outputs and the gradients to pts and features."""
    rng = np.random.default_rng(4)
    v, p, s, k = 2, 400, 64, 5
    a = rng.uniform(15.0, 80.0, (v, p, 1))
    c = rng.uniform(15.0, 80.0, (v, p, 1))
    b = rng.uniform(-20.0, 20.0, (v, p, 1))
    den = 4 * a * c - b * b
    arrays = dict(
        pts=np.concatenate([rng.uniform(-0.9, 0.9, (v, p, 2)),
                            rng.uniform(1.0, 1.6, (v, p, 1))], -1),
        ell=np.concatenate([a, b, c], -1), cut=np.ones((v, p)),
        radii=np.sqrt(np.concatenate([4 * c / den, 4 * a / den], -1)),
        scl=rng.uniform(0.5, 1.5, (v, p)), feat=rng.uniform(0.0, 1.0, (v, p, 3)),
        g_occ=rng.standard_normal((v, s, s)),
        g_rgbw=rng.standard_normal((v, s, s, 4)),
        g_z=rng.standard_normal((v, s, s, k)))
    cfg = splat.TileConfig(tile=16, cap=512, max_tiles=4)

    def run(device):
        f = {n: torch.tensor(np.asarray(x, np.float32), device=device)
             for n, x in arrays.items()}
        ps, fe = f["pts"].requires_grad_(), f["feat"].requires_grad_()
        out = splat.rasterize_views_fragments(
            s, k, cfg, ps, f["ell"], f["cut"], f["radii"], 0.3, 3.0, f["scl"], fe)
        loss = ((out[3] * f["g_occ"]).sum() + (out[5] * f["g_rgbw"]).sum()
                + (out[1] * f["g_z"]).sum())
        return [x.detach().cpu() for x in
                (*out, *torch.autograd.grad(loss, (ps, fe)))]

    got, want = run(dev), run("cpu")
    for i in (0, 1, 2, 3, 4, 6):  # idx, zbuf, qvalue, occ, visible, overflow
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=1e-6)
    for i in (7, 8):  # grad pts, grad features
        torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                   atol=1e-5 * float(want[i].abs().max()))


def test_reference_backend_on_the_card_matches_the_cpu(dev):
    """backend="reference" (plain PyTorch, no kernels) on CUDA tensors
    against the same path on the CPU: fragments and point gradients."""
    n, s = 300, 32
    pts = fibonacci_sphere(n, 0.5)
    r, t = look_at_view_transform(dist=torch.full((2,), 2.0),
                                  elev=torch.tensor([0.0, 25.0]),
                                  azim=torch.tensor([0.0, 80.0]))
    st = RasterSettings(image_size=s, tile_size=16, backend="reference",
                        Vrk_invariant=True, Vrk_isotropic=False)

    def run(device):
        p = torch.tensor(pts, device=device, requires_grad=True)
        rgba, fr, vis = render_views(
            p, p.detach() / p.detach().norm(dim=-1, keepdim=True),
            torch.full_like(p, 0.6), torch.ones(n, dtype=torch.bool, device=device),
            FoVPerspectiveCameras.create(r, t, fov=60.0, device=device), None, st)
        loss = rgba.square().sum() + fr.zbuf[..., 0].sum()
        (gp,) = torch.autograd.grad(loss, (p,))
        return [x.detach().cpu() for x in (fr.idx, fr.zbuf, rgba, vis, gp)]

    got, want = run(dev), run("cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[4], want[4], rtol=1e-4,
                               atol=1e-5 * float(want[4].abs().max()))


def test_launch_counters_count_kernel_launches(tables):
    b = tables[0]
    kernels.reset_launch_counts()
    kernels.fwd_lean(b.tile_counts, b.tile_data, N, DMT, S, T, K, False)
    kernels.fwd_lean_points_plain(b.tile_counts, b.tile_data, N, DMT, S, T, K,
                                  False)
    assert kernels.launch_counts()["fwd_lean"] == 1
    assert np.sum(list(kernels.launch_counts().values())) == 1


# ---------------------------------------------------------------------------
# K2, and the sub-tile cull of K1, K3 and K5, on adversarial tables
# ---------------------------------------------------------------------------


def _close_k(got, want):
    # K2's per-point (gx, gy), summed by a warp tree and float atomics in
    # another order than the plain version: rtol 1e-4 with atol 1e-6·max
    # for near-cancelling entries, gx and gy each, as chip_smoke.py
    import chip_smoke

    chip_smoke.close_xy("occ_bwd", got, want)


def _occ_bwd_both(dev, counts, table, g, r2, s, t):
    """K2 and its plain version, each slot its own point (P = nt·M)."""
    import chip_smoke

    counts, table, g, r2 = [torch.as_tensor(x, device=dev)
                            for x in (counts, table, g, r2)]
    ids = chip_smoke.slot_ids(table)
    args = (counts, table, ids, g, r2, ids[0].numel(), s, t)
    return kernels.occ_bwd(*args), kernels.occ_bwd_points_plain(*args)


def test_occ_bwd_disc_and_box_edges(dev):
    """Pixels exactly at dist² = cur_r² and at |dx| = rx, |dy| = ry, under
    gradients of both signs: the kernel counts the pixels its plain version
    counts, and one pixel more or less would break the tolerance."""
    import chip_smoke

    counts, tab, g, r2, s, t, r2_lo, tab_lo = chip_smoke.k2_edge_case(dev)
    want = kernels.occ_bwd_plain(counts, tab, g, r2, s, t)
    for moved in (kernels.occ_bwd_plain(counts, tab, g, r2_lo, s, t),
                  kernels.occ_bwd_plain(counts, tab_lo, g, r2, s, t)):
        assert any(chip_smoke._differs(a, w, 1e-4, 1e-6)
                   for a, w in zip(moved, want))
    got, want_pts = _occ_bwd_both(dev, counts, tab, g, r2, s, t)
    _close_k(got, want_pts)
    # each slot its own point: the per-point sums are the per-slot ones
    assert torch.equal(want_pts, torch.stack(want, -1).reshape(want_pts.shape))


def test_occ_bwd_long_lists_empty_tiles_and_rejected_points(dev):
    """A tile with 800 candidates (more than a block's stride covers at
    once), empty tiles, points off screen or behind the camera, small
    boxes under positive gradients, and a view whose disc covers the
    screen."""
    rng = np.random.default_rng(7)
    s, t, m, v = 128, 64, 1024, 2
    nt = (s // t) ** 2
    table = np.zeros((v, nt, 5, m), np.float32)
    table[:, :, 0:2], table[:, :, 2] = 2.0, -1.0
    counts = np.array([[800, 0, 37, 0], [0, 300, 0, 5]], np.int32)
    for vi in range(v):
        for gi in range(nt):
            c = counts[vi, gi]
            ty, tx = divmod(gi, s // t)
            # centres in and around the tile, NDC (+x left, +y up)
            x0, y0 = 1 - 2 * tx * t / s, 1 - 2 * ty * t / s
            table[vi, gi, 0, :c] = x0 - rng.uniform(-0.3, 1.3, c) * 2 * t / s
            table[vi, gi, 1, :c] = y0 - rng.uniform(-0.3, 1.3, c) * 2 * t / s
            table[vi, gi, 2, :c] = rng.uniform(0.5, 3.0, c)
            table[vi, gi, 3:5, :c] = rng.uniform(0.005, 0.2, (2, c))
            bad = rng.random(c) < 0.1
            table[vi, gi, 2, :c][bad & (rng.random(c) < 0.5)] = -0.5
            table[vi, gi, 0, :c][bad & (rng.random(c) < 0.5)] = 1.02
    g = rng.standard_normal((v, nt, t * t)).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = 0.0
    r2 = np.array([0.04, 25.0], np.float32)  # 0.2 NDC; the whole screen
    got, want = _occ_bwd_both(dev, counts, table, g, r2, s, t)
    _close_k(got, want)
    assert float(want[..., 0].abs().max()) > 0
    per_slot = got.reshape(v, nt, m, 2)
    assert not per_slot[1, 0].any() and not per_slot[0, 1].any()  # empty tiles


# K1, K3 and K5 on the edge tables of their shared sub-tile cull (K1 and
# K5 bit-equal to the plain version on cnt, vis, z, q and ids)
CULLED = [("fwd_lean", 5), ("feat_bwd", 5), ("fwd_frag", 5)]


def _hold(name, case, k=None):
    import chip_smoke

    counts, table, grad, s, t, k0, dmt = case
    run, plain = chip_smoke.kernel_pair(name, counts, table, s, t, k or k0,
                                        dmt, grad)
    want = plain()
    chip_smoke.hold_to_plain(name, run(), want)
    return want


@pytest.mark.parametrize("name,k", CULLED + [("fwd_frag", 16)],
                         ids=["fwd_lean", "feat_bwd", "fwd_frag", "fwd_frag-K16"])
def test_cull_boxes_straddling_sub_tile_borders(dev, name, k):
    """Boxes whose edge lies within a pixel of a 16×16 sub-tile border, on
    either side, down to a pixel centre exactly: the cull keeps every
    candidate a pixel of the sub-tile accepts (K = 16: K5's second
    register instance)."""
    import chip_smoke

    want = _hold(name, chip_smoke.cull_border_case(dev), k)
    assert float(want[-1].abs().max()) > 0


@pytest.mark.parametrize("name,k", CULLED, ids=[n for n, _ in CULLED])
def test_cull_chunks_without_survivors(dev, name, k):
    """Two 128-candidate chunks: the first only reaches one corner
    sub-tile, so the other sub-tiles skip it; the second covers the tile,
    and ranks and z₀ carry over from the first chunk."""
    import chip_smoke

    want = _hold(name, chip_smoke.cull_empty_chunk_case(dev))
    # the second chunk's candidates are points 128..217
    if name == "feat_bwd":
        assert want[0, 128:218].abs().max() > 0
    else:  # the second chunk wins somewhere
        assert want[-2][0, 128:218].any()


@pytest.mark.parametrize("name", [n for n, _ in CULLED])
def test_cull_keeps_both_window_rules(dev, name):
    """test_window_rules_of_k5_and_k3_match_jax's tile on the card: a far
    splat makes a quantized-depth tie put the deeper of two splats first.
    K1's and K3's window (z₀ = the chunk's minimum accepted depth) drops
    it; K5's (z₀ = the rank-0 fragment) keeps it."""
    s = 64
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    pts = f([[[0.5, 0.5, 1.2], [0.5, 0.5, 1.0], [-0.5, -0.5, 1e8]]])
    b = splat.bin_splats(pts, f([[[100.0, 0.0, 100.0]] * 3]),
                         f([[1.0, 1.0, 1.0]]), f([[[0.1, 0.1]] * 3]), s, 16,
                         512, 4, 4, scaler=f([[1.0, 1.0, 1.0]]),
                         features=f([[[1, 0, 0], [0, 1, 0], [0, 0, 1]]]))
    g = torch.randn((1, b.tile_counts.shape[1], 256, 4), device=dev)
    want = _hold(name, (b.tile_counts, b.tile_data, g, s, 16, K, 0.05))
    # the deeper splat (id 0) sorts first
    ids = b.tile_data[:, :, kernels.CH_ID]
    live = torch.arange(ids.shape[-1], device=dev) < b.tile_counts[..., None]
    deeper = live & (ids == 0)
    assert deeper.any()
    if name == "feat_bwd":  # no colour gradient reaches it
        assert not want[0, 0, 0:3].any()
        assert want.abs().max() > 1e-3
    else:  # visible under K5's window only
        assert bool(want[-2][0, 0]) == (name == "fwd_frag")


def test_entry_points_build_on_the_card_by_default(dev):
    # tests/ is on sys.path under pytest's default import mode
    from test_torch_device import ENTRY_POINTS, _tensors

    for name, make in ENTRY_POINTS.items():
        for x in _tensors(make()):
            assert x.device == torch.device("cuda", 0), name
