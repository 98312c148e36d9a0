"""The CUDA kernels against their plain versions on the card.  Needs a
CUDA device and nvcc; skipped elsewhere.  The machine with the card has no
jax, which tests/conftest.py imports, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import dataclasses
import statistics

import numpy as np
import pytest
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render import prep
from dss_tpu_torch.render.renderer import _prep_view, _tile_config, render_views
from prep_cases import (CASES as PREP_CASES, prep_cotangents, prep_grads,
                        prep_scene, run_prep)

pytestmark = pytest.mark.cuda

S, T, V, N, K, DMT = 128, 32, 4, 2000, 5, 0.05
# chip_smoke.k4_edge_cases, by label
K4_CASES = ("one id", "alternating ids", "-1 and P mixed in", "P = 1")
# The train window's guard and update: one launch of each per replay
UPDATE = {"all_finite": 1, "guarded_adam": 1}
# The render's set-up: one forward and one backward launch per replay
PREP = {"prep_fwd": 1, "prep_bwd": 1}
# The binning: the forward and the support table, and the support radius's
# median, per replay
BIN = {"bin_tiles": 2 * kernels.BIN_LAUNCHES, "median_select": 1}


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


def _noisy_sphere(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (0.5 * d + rng.normal(0, 0.004, (n, 3))).astype(np.float32)
    nrm = (d + 0.25 * rng.standard_normal((n, 3))).astype(np.float32)
    return pts, nrm, rng.random(n) > 0.1


def test_anisotropic_render_on_the_card_matches_the_cpu(dev):
    """The anisotropic Vrk (the eigensolver kernel against its plain
    version, one launch for the render) through the tile-binned ops: rgba
    within 1e-4, visibility equal, point gradients within rtol 1e-3,
    atol 1e-4·max."""
    pts, _, _ = _noisy_sphere(1500, 1)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((3,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 100.0, 220.0]))
    st = RasterSettings(image_size=64, tile_size=32, Vrk_invariant=False,
                        Vrk_isotropic=False)
    g = np.random.default_rng(2).standard_normal((3, 64, 64, 4)).astype(np.float32)

    def run(device):
        p = torch.tensor(pts, device=device, requires_grad=True)
        rgba, _, vis = render_views(
            p, torch.tensor(nrm, device=device), torch.full_like(p, 0.6),
            torch.ones(len(pts), dtype=torch.bool, device=device),
            FoVPerspectiveCameras.create(r, t, fov=60.0, device=device), None, st)
        (gp,) = torch.autograd.grad((rgba * torch.tensor(g, device=device)).sum(),
                                    (p,))
        return [x.detach().cpu() for x in (rgba, vis, gp)]

    kernels.reset_launch_counts()
    got = run(dev)
    assert kernels.launch_counts()["symeig3"] == 1
    want = run("cpu")
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-3,
                               atol=1e-4 * float(want[2].abs().max()))
    assert float(want[0][..., 3].mean()) > 0.1


def test_refine_normals_on_the_card_matches_the_cpu(dev):
    """The jet fit (a batched 6×6 solve_ex) and the bilateral passes on the
    card against the CPU: cos ≥ 1 − 1e-4."""
    from dss_tpu_torch.geometry.normals import refine_normals

    pts, nrm, mask = _noisy_sphere(2000, 3)
    got, want = [refine_normals(torch.tensor(pts, device=d),
                                torch.tensor(nrm, device=d),
                                torch.tensor(mask, device=d),
                                jet_passes=3).cpu()
                 for d in (dev, "cpu")]
    cos = (got * want).sum(-1)
    assert float(cos.min()) >= 1 - 1e-4


def test_prune_dead_points_on_the_card_matches_the_cpu(dev):
    """The zero test on K2's and K3's atomic per-point sums: a point with
    contributions is never exactly 0, one without keeps the zero fill."""
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.models.point_model import (PointModelParams,
                                                  prune_dead_points)

    pts = np.concatenate([fibonacci_sphere(N, 0.4),
                          np.tile([[5.0, 5.0, 0.0]], (20, 1))]).astype(np.float32)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.tensor([2.0, 2.0]),
                                  elev=torch.tensor([0.0, 30.0]),
                                  azim=torch.tensor([0.0, 120.0]))
    st = RasterSettings(image_size=64, points_per_pixel=3, tile_size=32)
    keep = [prune_dead_points(
        PointModelParams.create(pts, nrm, device=d),
        PointFilters.ones(len(pts), device=d),
        FoVPerspectiveCameras.create(r, t, fov=60.0, device=d), st,
        torch.ones((2, 64, 64), device=d)).cpu() for d in (dev, "cpu")]
    assert torch.equal(keep[0], keep[1])
    assert not keep[0][N:].any() and keep[0][:N].float().mean() > 0.45


def _window_case(dev, graph, nan=False, aniso=False, train=(), lit=False,
                 texture=False):
    """The train window over 4 views at 128² of a 2000-point sphere, the
    model a sphere of 1500 points; with `nan`, the second of 3 batches
    holds a NaN in its mask; with `aniso`, the model renders with the
    anisotropic Vrk; `train` adds TrainConfig entries; with `lit`, three
    point lights a view shade the model (else its raw colours); with
    `texture`, a neural texture (IDR's decoder at width 32) does.  Returns
    (window, state, epoch_idx)."""
    from dss_tpu_torch.models.decoders import RenderingNetwork
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.render.lighting import PointLights
    from dss_tpu_torch.render.texture import NeuralTexture
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                create_train_state,
                                                make_optimizer,
                                                make_train_window)

    gt = torch.tensor(fibonacci_sphere(N, 0.5), device=dev)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.linspace(-30.0, 30.0, V),
                                  azim=torch.linspace(0.0, 270.0, V))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=dev)
    st = RasterSettings(image_size=S, tile_size=T, backface_culling=False,
                        Vrk_invariant=True, Vrk_isotropic=False,
                        depth_channel=True)
    with torch.no_grad():
        rgba, frags, _ = render_views(
            gt, gt / gt.norm(dim=-1, keepdim=True), torch.full_like(gt, 0.6),
            torch.ones(N, dtype=torch.bool, device=dev), cams, None, st)
    img, mask = rgba[..., :3].contiguous(), rgba[..., 3].contiguous()
    depth = torch.where(mask > 0.5, frags.wdepth, 100.0).contiguous()
    if nan:
        mask = mask.clone()
        mask[2, 0, 0] = float("nan")
    pts = fibonacci_sphere(1500, 0.45)
    tex = (NeuralTexture(RenderingNetwork(
        hidden_size=32, n_layers=2, generator=torch.Generator().manual_seed(0)))
        if texture else None)
    params = PointModelParams.create(pts, pts / np.linalg.norm(
        pts, axis=-1, keepdims=True), np.full_like(pts, 0.6), device=dev,
        texture=tex)
    state = create_train_state(params, make_optimizer(params, lr_colors=0.0))
    lights = None
    if lit:
        loc = torch.tensor([[2.0, 2.0, 2.0], [-2.0, 1.0, 2.0],
                            [0.0, -2.0, -2.0]])
        lights = PointLights.create(location=loc, n_views=V, device=dev)
    if aniso:
        st = dataclasses.replace(st, Vrk_invariant=False)
    window = make_train_window(
        st, TrainConfig(lambda_proj=0.01, lambda_repel=0.1, lambda_depth=0.1,
                        **dict(train)),
        AnnealSchedule(steps_backward_radii=2), state, cams, lights, img,
        mask, depth, graph=graph)
    rows = [[0, 1], [2, 3], [0, 1]] if nan else [[0, 1], [2, 3]]
    return window, state, torch.tensor(rows, device=dev)


def _q99(a, b):
    d = torch.cat([(x - y).abs().reshape(-1) for x, y in
                   zip(a.params.tensors(), b.params.tensors())])
    return float(torch.quantile(d, 0.99))


@pytest.mark.parametrize("grid", [False, True], ids=["exact knn", "grid knn"])
def test_train_window_graph_matches_the_eager_window(dev, grid, monkeypatch):
    """The captured CUDA graph against the same window run eagerly on the
    card: the first replayed loss bit-equal, one K1, K2, K3, prep_fwd and
    prep_bwd per replay, the launch counters counting replays, and after 4 steps the
    parameters' 99th percentile of |Δ| within max(two eager windows', 1e-6)
    (Adam moves an element whose gradient is at the atomics' noise level by
    ±lr either way: the largest |Δ| is O(lr) even between eager runs).
    With `grid`, the surface losses' kNN runs on the grid inside the
    graph.  The exact kNN kernel runs twice per replay (the Vrk's h and the
    surface losses' neighbours), once with `grid`."""
    if grid:
        monkeypatch.setenv("DSS_KNN_GRID_THRESHOLD", "0")
    runs = []
    for graph in (False, False, True):
        window, state, rows = _window_case(dev, graph)
        kernels.reset_launch_counts()
        state, m1 = window(state, rows, 1)
        state, m = window(state, rows, 3)
        runs.append((state, float(m1["loss"]), kernels.launch_counts(),
                     window.per_replay))
    assert runs[2][1] == runs[0][1]
    assert runs[2][3] == {"fwd_lean": 1, "occ_bwd": 1, "feat_bwd": 1,
                          "knn_topk": 1 if grid else 2, **UPDATE, **PREP,
                          **BIN}
    # the eager windows launch 4 of each; the graph 2 warm-up steps and 4
    # replays
    assert runs[0][2]["occ_bwd"] == 4 and runs[2][2]["occ_bwd"] == 6
    assert _q99(runs[2][0], runs[0][0]) <= max(_q99(runs[1][0], runs[0][0]),
                                               1e-6)


def test_train_window_graph_skips_a_nan_step(dev):
    """A NaN in the mask of the middle batch of a 3-step graphed window:
    params_finite false, Adam's counts 2 and the step 3, as the eager
    windows on the card, and the parameters as close to theirs as they
    lie to each other."""
    out = []
    for graph in (False, False, True):
        window, state, rows = _window_case(dev, graph, nan=True)
        state, m = window(state, rows, 3)
        assert not bool(m["params_finite"]) and state.step == 3
        assert {float(state.optimizer.state[t]["step"])
                for t in state.params.tensors()} == {2.0}
        out.append(state)
    assert torch.isfinite(out[2].params.points).all()
    assert _q99(out[2], out[0]) <= max(_q99(out[1], out[0]), 1e-6)


@pytest.mark.parametrize("recipe", ["anisotropic Vrk", "PCA anchor"])
def test_train_window_graph_of_the_eigensolver_recipes(dev, recipe):
    """The recipes that run the eigensolver every step (the anisotropic
    Vrk's frames, the PCA normal anchor) captured as a CUDA graph against
    the same window run eagerly: the first replayed loss bit-equal, K1, K2,
    K3, symeig3 and the set-up's two kernels once per replay, the exact kNN kernel twice (the frames'
    or the Vrk's h, and the surface losses') and with the PCA anchor a
    third time (its normals), and after 4 steps the parameters' 99th
    percentile of |Δ| within max(two eager windows', 1e-6)."""
    kw = (dict(aniso=True) if recipe == "anisotropic Vrk" else
          dict(train=dict(lambda_normal=0.1, normal_anchor="pca",
                          normal_anchor_k=8)))
    runs = []
    for graph in (False, False, True):
        window, state, rows = _window_case(dev, graph, **kw)
        state, m1 = window(state, rows, 1)
        state, m = window(state, rows, 3)
        assert bool(m["params_finite"])
        runs.append((state, float(m1["loss"]), window.per_replay))
    assert runs[2][1] == runs[0][1]
    assert runs[2][2] == {"fwd_lean": 1, "occ_bwd": 1, "feat_bwd": 1,
                          "symeig3": 1,
                          "knn_topk": 2 if recipe == "anisotropic Vrk" else 3,
                          **UPDATE, **PREP, **BIN}
    assert _q99(runs[2][0], runs[0][0]) <= max(_q99(runs[1][0], runs[0][0]),
                                               1e-6)


def test_train_window_graph_of_the_jet_anchor(dev):
    """The jet-anchored normal refine (points frozen, the normal term's
    target refine_normals over 48 neighbours: a kNN, two jet passes of
    batched 6x6 solves, the median and the bilateral passes, every step)
    captured as a CUDA graph against the same window run eagerly: the
    first replayed loss bit-equal, no point's target non-finite, K1, K2,
    K3 and the set-up's two kernels once per replay, the exact kNN kernel
    three times (the Vrk's h, the surface losses' and the anchor's), and
    after 4 steps the parameters' 99th percentile of |Δ| within max(two
    eager windows', 1e-6)."""
    train = dict(lambda_normal=0.1, normal_anchor="jet", normal_anchor_k=48)
    runs = []
    for graph in (False, False, True):
        window, state, rows = _window_case(dev, graph, train=train)
        points = state.optimizer.param_groups[0]  # learn_points: false
        points["lr"] = points["base_lr"] = 0.0
        state, m1 = window(state, rows, 1)
        state, m = window(state, rows, 3)
        assert bool(m["params_finite"]) and int(m["anchor_nonfinite"]) == 0
        runs.append((state, float(m1["loss"]), window.per_replay))
    assert runs[2][1] == runs[0][1]
    assert runs[2][2] == {"fwd_lean": 1, "occ_bwd": 1, "feat_bwd": 1,
                          "knn_topk": 3, **UPDATE, **PREP, **BIN}
    assert _q99(runs[2][0], runs[0][0]) <= max(_q99(runs[1][0], runs[0][0]),
                                               1e-6)


def _symeig3_inputs(dev):
    """8-NN covariances of a noisy sphere, random SPD matrices, zero rows
    and rows with a NaN in the lower triangle, as one (N, 3, 3) batch."""
    from dss_tpu_torch.geometry.normals import local_covariances

    pts, _, _ = _noisy_sphere(3000, 4)
    cov = local_covariances(torch.tensor(pts, device=dev), None, 8)[0]
    rng = np.random.default_rng(6)
    a = rng.standard_normal((20000, 3, 3))
    spd = torch.tensor((a @ np.swapaxes(a, 1, 2)).astype(np.float32),
                       device=dev)
    odd = torch.zeros((4, 3, 3), device=dev)
    odd[2] = odd[3] = torch.eye(3, device=dev)
    odd[2, 1, 0] = float("nan")
    odd[3, 2, 2] = float("nan")
    return torch.cat([cov, spd, odd]).contiguous()


def test_symeig3_matches_plain_and_eigh(dev):
    """The eigensolver kernel against its plain version on the card (the
    same rounded operations: bit-equal) and against torch.linalg.eigh
    (eigenvalues within 4e-6 of the row's largest |λ|, projectors v vᵀ of
    the eigenvectors with a relative gap ≥ 1e-3 within 4e-6 / gap:
    chip_smoke.py's SYMEIG3_LIB_TOL); zero rows give λ = 0 and v = I, rows
    with a NaN all NaN; one launch, counted."""
    m = _symeig3_inputs(dev)
    kernels.reset_launch_counts()
    w, v = kernels.symeig3(m)
    assert kernels.launch_counts()["symeig3"] == 1
    pw, pv = kernels.symeig3_plain(m)
    assert torch.equal(w.isnan(), pw.isnan()) and torch.equal(v.isnan(),
                                                              pv.isnan())
    torch.testing.assert_close(w, pw, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(v, pv, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(w[-2:]).all() and torch.isnan(v[-2:]).all()
    assert torch.equal(w[-4:-2], torch.zeros_like(w[-4:-2]))
    assert torch.equal(v[-4:-2], torch.eye(3, device=dev).expand(2, 3, 3))
    w, v, m = w[:-4].double(), v[:-4].double(), m[:-4]
    lw, lv = torch.linalg.eigh(m)
    scale = lw.abs().amax(dim=1, keepdim=True).double()
    assert float(((w - lw).abs() / scale).max()) <= 4e-6
    lw = lw.double()
    gap = torch.stack([torch.minimum((lw[:, i] - lw[:, (i + 1) % 3]).abs(),
                                     (lw[:, i] - lw[:, (i + 2) % 3]).abs())
                       for i in range(3)], dim=1) / scale
    proj = lambda x: x[:, :, None, :] * x[:, None, :, :]
    dp = (proj(v) - proj(lv.double())).abs().amax(dim=(1, 2))
    ok = gap >= 1e-3
    assert float(ok.float().mean()) > 0.99
    assert float((dp[ok] * gap[ok]).max()) <= 4e-6


# ---------------------------------------------------------------------------
# knn_topk: the exact kNN
# ---------------------------------------------------------------------------


def _knn_case(dev, name):
    """(query, ref, query_mask, ref_mask, kwargs) on the card, by name: the
    cells' four kNNs on a start cloud (uniform on a sphere of radius 0.5),
    then masks, Q != P (2 and 8 warps per query), padding, k = 1, 16, 32,
    48 and 100 (one, two and four list slots per lane), and duplicates."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def sphere(n):
        v = rng.normal(size=(n, 3))
        return torch.tensor((0.5 * v / np.linalg.norm(v, axis=-1,
                                                       keepdims=True))
                            .astype(np.float32), device=dev)

    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
    some = lambda n, share: torch.tensor(rng.random(n) < share, device=dev)
    if name.startswith("5000 ") or name.startswith("8000 "):
        n = int(name.split(" ")[0])
        p = sphere(n)
        k = int(name.split("k ")[1].split(",")[0])
        return p, p, ones(n), ones(n), dict(k=k,
                                            exclude_self="exclude" in name)
    if name == "masked refs and queries":
        p = sphere(5000)
        return p, p, some(5000, 0.9), some(5000, 0.8), dict(k=11,
                                                            exclude_self=True)
    if name == "Q != P (the sampled Vrk h)":
        p, m = sphere(9000), some(9000, 0.95)
        qi = torch.arange(4096, device=dev) * 2
        return p[qi], p, m[qi], m, dict(k=7)
    if name == "padding: 5 valid refs":
        p, m = sphere(2000), torch.zeros(2000, dtype=torch.bool, device=dev)
        m[[3, 17, 500, 1999, 1000]] = True
        return p, p, None, m, dict(k=8, exclude_self=True)
    if name == "P < k":
        return sphere(300), sphere(6), None, None, dict(k=10)
    if name == "k 1: 20000 against 5000":
        return sphere(20000), sphere(5000), None, None, dict(k=1)
    if name == "few queries: 500 against 20000":  # 8 warps per query
        p, m = sphere(20000), some(20000, 0.9)
        return p[:500], p, m[:500], m, dict(k=8, exclude_self=True)
    if name == "k 16, exclude_self":
        p = sphere(3000)
        return p, p, None, None, dict(k=16, exclude_self=True)
    if name == "k 32":
        p = sphere(2000)
        return p, p, None, None, dict(k=32)
    if name == "k 48, masked (the jet fit)":
        p, m = sphere(2000), some(2000, 0.9)
        return p, p, m, m, dict(k=48)
    if name == "k 100, exclude_self":
        p = sphere(3000)
        return p, p, None, None, dict(k=100, exclude_self=True)
    if name == "duplicates":
        p = sphere(1000).repeat_interleave(3, dim=0)
        return p, p, None, None, dict(k=5, exclude_self=True)
    raise KeyError(name)


KNN_CASES = ("5000 k 7", "5000 k 11, exclude_self", "8000 k 8",
             "8000 k 11, exclude_self", "masked refs and queries",
             "Q != P (the sampled Vrk h)", "padding: 5 valid refs", "P < k",
             "k 1: 20000 against 5000", "few queries: 500 against 20000",
             "k 16, exclude_self", "k 32", "k 48, masked (the jet fit)",
             "k 100, exclude_self", "duplicates")


def _same_up_to_ties(d1, i1, d2, i2):
    """Bit-equal distances; per row, the same indices at every distance
    below the row's largest (a tie at the last slot may pick either
    point)."""
    assert torch.equal(d1, d2)
    assert torch.equal(i1 < 0, i2 < 0)
    last = torch.where(torch.isfinite(d1), d1, -float("inf")).amax(
        dim=1, keepdim=True)
    below = (d1 < last) & (i1 >= 0)
    a = torch.sort(torch.where(below, i1, -2), dim=1).values
    b = torch.sort(torch.where(below, i2, -2), dim=1).values
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", KNN_CASES)
def test_knn_topk_matches_plain(dev, name):
    """The fused kNN kernel against its plain version (the distance matmul
    and torch.topk) on the card: distances bit for bit, index sets equal
    but for ties at the last slot, equal distances in index order, one
    launch, counted."""
    q, r, qm, rm, kw = _knn_case(dev, name)
    kernels.reset_launch_counts()
    d, i = kernels.knn_topk(q, r, qm, rm, **kw)
    assert kernels.launch_counts()["knn_topk"] == 1
    pd, pi = kernels.knn_topk_plain(q, r, qm, rm, **kw)
    assert d.shape == pd.shape and i.dtype == torch.int64
    _same_up_to_ties(d, i, pd, pi)
    tie = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0)
    assert bool((i[:, 1:] > i[:, :-1])[tie].all())


def test_knn_topk_refuses_more_than_128(dev):
    p = torch.rand((200, 3), device=dev)
    with pytest.raises(ValueError):
        kernels.knn_topk(p, p, k=129)


def test_knn_topk_gradients_match_autograd_of_the_plain_version(dev):
    """The kernel's backward (knn_topk_grads) against autograd through the
    plain version on a 2000-point cloud, self and Q != P: within 1e-4
    relative and 1e-5 of the largest gradient (the plain version's
    gradient is 2q·Σg − 2Σg·r, which cancels in float32)."""
    rng = np.random.default_rng(11)
    pts = torch.tensor(rng.normal(size=(2000, 3)).astype(np.float32) * 0.3,
                       device=dev)
    other = torch.tensor(rng.normal(size=(700, 3)).astype(np.float32) * 0.3,
                         device=dev)
    m = torch.tensor(rng.random(2000) < 0.9, device=dev)
    for same in (True, False):
        grads = []
        for fn in (kernels.knn_topk, kernels.knn_topk_plain):
            q = pts.clone().requires_grad_()
            r = q if same else other.clone().requires_grad_()
            d, _ = fn(q, r, m, m if same else None, k=11, exclude_self=same)
            g = torch.tensor(rng.normal(size=d.shape).astype(np.float32),
                             device=dev) if not grads else grads[0][0]
            fin = torch.isfinite(d)
            loss = torch.sum(torch.where(fin, d, 0.0) * torch.where(fin, g,
                                                                    0.0))
            grads.append((g, *torch.autograd.grad(loss, [q] if same else
                                                  [q, r])))
        for a, b in zip(grads[0][1:], grads[1][1:]):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))


def test_knn_topk_in_a_cuda_graph(dev):
    """Captured into a CUDA graph and replayed on new points: the replay's
    outputs equal an eager call's."""
    q, r, qm, rm, kw = _knn_case(dev, "5000 k 11, exclude_self")
    kernels.knn_topk(q, r, qm, rm, **kw)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.knn_topk(q, r, qm, rm, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = kernels.knn_topk(q, r, qm, rm, **kw)
    q.copy_(torch.roll(q, 7, dims=0))
    graph.replay()
    torch.cuda.synchronize()
    d, i = kernels.knn_topk(q, r, qm, rm, **kw)
    assert torch.equal(out[0], d) and torch.equal(out[1], i)


# ---------------------------------------------------------------------------
# all_finite, guarded_adam: the train window's guard and update
# ---------------------------------------------------------------------------

C = kernels.MT_CHUNK
# The neural cell's 18 leaves (points, normals, colors, then IDR's decoder:
# 33 → 512 × 4 → 3, each layer's weight-normed v, g and bias) and the
# flagship's 3, with their lrs.
NEURAL_LEAVES = ([(5000, 3)] * 3
                 + [s for a, b in ((33, 512), (512, 512), (512, 512),
                                   (512, 512), (512, 3))
                    for s in ((b, a), (b,), (b,))])
FLAGSHIP_LRS = (0.01, 0.01, 0.0)
ADAM_CASES = {
    # shapes, lrs, counts (per tensor), milestones, steps
    "neural 18 leaves": (NEURAL_LEAVES, FLAGSHIP_LRS + (1e-4,) * 15,
                         [3200] * 18, (500, 800), 2),
    "flagship 3 leaves": ([(5000, 3)] * 3, FLAGSHIP_LRS, [3200] * 3,
                          (500, 800), 2),
    "across chunks": ([(C + 1,), (3, 2 * C - 1), (C,), (C - 1,), (1,), (0,)],
                      (0.01,) * 6, [5] * 6, (), 2),
    "two launches": ([(17 + 31 * i,) for i in range(kernels.ADAM_MAX_TENSORS
                                                    + 8)],
                     (0.01,) * (kernels.ADAM_MAX_TENSORS + 8),
                     list(range(kernels.ADAM_MAX_TENSORS + 8)), (20,), 2),
    "about a milestone": ([(700, 3)] * 6, (0.01,) * 6,
                          [0, 498, 499, 500, 799, 800], (500, 800, 800), 3),
}


def _adam_case(dev, shapes, lrs, counts, milestones, seed=0):
    """One Adam group per tensor as make_optimizer builds them (betas 0.5,
    0.9; gamma 0.5), the tensors, moments and counts drawn from the seed
    (the moments at the scale a run holds them), and gradients per step."""
    gen = torch.Generator(dev).manual_seed(seed)
    rnd = lambda shape, scale=1.0: torch.randn(shape, generator=gen,
                                               device=dev) * scale
    ts = [rnd(s).requires_grad_() for s in shapes]
    opt = torch.optim.Adam(
        [{"params": [t], "lr": lr, "name": f"t{i}", "base_lr": lr,
          "milestones": milestones, "gamma": 0.5}
         for i, (t, lr) in enumerate(zip(ts, lrs))], betas=(0.5, 0.9),
        eps=1e-8)
    for t, c in zip(ts, counts):
        opt.state[t] = {"step": torch.tensor(float(c), device=dev),
                        "exp_avg": rnd(t.shape, 1e-3),
                        "exp_avg_sq": rnd(t.shape, 1e-3) ** 2}
    return ts, opt, lambda: [rnd(t.shape, 1e-3) for t in ts]


def _adam_bits(ts, opt):
    return [x.detach().clone() for t in ts
            for x in (t, *(opt.state[t][k] for k in
                           ("exp_avg", "exp_avg_sq", "step")))]


def _same_bits(a, b):
    return [i for i, (x, y) in enumerate(zip(a, b))
            if not torch.equal(x.view(torch.int32), y.view(torch.int32))]


@pytest.mark.parametrize("case", ADAM_CASES)
def test_guarded_adam_matches_the_composite_bit_for_bit(dev, case):
    """The update kernel (trainer.guarded_adam_ on CUDA tensors) against
    the composite run on the card (guarded_adam_plain) from one state with
    one gradient per step: parameters, both moments and the counts equal
    bit for bit after every step, every count advanced once per step; the
    guard kernel true; one update launch per ADAM_MAX_TENSORS tensors."""
    from dss_tpu_torch.training import trainer

    shapes, lrs, counts, milestones, steps = ADAM_CASES[case]
    runs = []
    for fn in (trainer.guarded_adam_plain, trainer.guarded_adam_):
        ts, opt, grads = _adam_case(dev, shapes, lrs, counts, milestones)
        kernels.reset_launch_counts()
        got = []
        for _ in range(steps):
            g = grads()
            finite = kernels.all_finite(g)
            assert bool(finite)
            fn(opt, g, finite)
            got.append(_adam_bits(ts, opt))
        launches = kernels.launch_counts()
        runs.append(got)
    n_launches = -(-len(shapes) // kernels.ADAM_MAX_TENSORS)
    assert launches["guarded_adam"] == steps * n_launches
    assert launches["all_finite"] == steps
    for k, (plain, kern) in enumerate(zip(*runs)):
        assert not _same_bits(plain, kern), (k, _same_bits(plain, kern)[:8])
        assert [float(x) for x in kern[3::4]] == [c + k + 1 for c in counts]


def test_guarded_adam_skips_a_nan_and_an_inf(dev):
    """A NaN and an Inf in one gradient of the neural cell's 18: the guard
    kernel false, as its plain version; the update writes nothing, every
    parameter, moment and count keeps its bits."""
    from dss_tpu_torch.training import trainer

    ts, opt, grads = _adam_case(dev, NEURAL_LEAVES,
                                FLAGSHIP_LRS + (1e-4,) * 15, [3200] * 18,
                                (500, 800))
    before = _adam_bits(ts, opt)
    g = grads()
    g[4].view(-1)[7] = float("nan")
    g[4].view(-1)[-1] = float("inf")
    finite = kernels.all_finite(g)
    assert not bool(finite) and not bool(kernels.all_finite_plain(g))
    trainer.guarded_adam_(opt, g, finite)
    assert not _same_bits(before, _adam_bits(ts, opt))


@pytest.mark.parametrize("where", [0, 100, 129], ids=lambda w: f"tensor {w}")
def test_all_finite_over_two_launches(dev, where):
    """The guard over 130 tensors (two launches) against its plain version,
    all finite and with an Inf in one tensor."""
    gen = torch.Generator(dev).manual_seed(where)
    xs = [torch.randn((3 * i + 1,), generator=gen, device=dev)
          for i in range(130)]
    kernels.reset_launch_counts()
    assert bool(kernels.all_finite(xs))
    assert kernels.launch_counts()["all_finite"] == 2
    xs[where].view(-1)[-1] = -float("inf")
    assert not bool(kernels.all_finite(xs))


def test_train_window_graph_launches_the_guard_and_update_once(dev):
    """The tiny window captured as a CUDA graph: one guard and one update
    launch per replay, 4 replays count 4 of each, and every Adam count
    advances once per step."""
    window, state, rows = _window_case(dev, True)
    state, _ = window(state, rows, 1)
    assert {k: window.per_replay[k] for k in UPDATE} == UPDATE
    kernels.reset_launch_counts()
    state, m = window(state, rows, 4)
    assert {k: kernels.launch_counts()[k] for k in UPDATE} == {
        k: 4 for k in UPDATE}
    assert bool(m["params_finite"])
    assert {float(state.optimizer.state[t]["step"])
            for t in state.params.tensors()} == {5.0}


@pytest.mark.parametrize("recipe", ["flagship", "default", "texture"])
def test_train_window_graph_launches_the_set_up_once(dev, recipe):
    """The tiny window captured as a CUDA graph in the three training
    recipes (point lights with the Vrk-invariant frame; point lights with
    the anisotropic Vrk; a neural texture, which the kernels do not
    shade): one prep_fwd and one prep_bwd per replay, finite steps."""
    kw = {"flagship": dict(lit=True),
          "default": dict(lit=True, aniso=True),
          "texture": dict(texture=True)}[recipe]
    window, state, rows = _window_case(dev, True, **kw)
    state, m = window(state, rows, 2)
    assert {k: window.per_replay[k] for k in PREP} == PREP
    assert bool(m["params_finite"]) and np.isfinite(float(m["loss"]))


def _same(got, want):
    """Bit for bit, a NaN equal to a NaN."""
    if got is None or want is None:
        return got is None and want is None
    if got.dtype == torch.bool:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_prep_fwd_matches_the_composite_bit_for_bit(dev, name):
    """prep_fwd (through prep_splats, one launch) against the composite,
    its plain version, on the card bit for bit, every output: the kernel
    rounds as the composite's cuBLAS chains, shading einsums and norms
    round there (with one diffuse and specular colour broadcast over three
    lights the composite's einsum sums the light axis in another order:
    there the shading is held within float32 rounding, rtol 2e-5)."""
    case = PREP_CASES[name]
    sc = prep_scene(case, dev)
    texture = case.get("texture")
    with torch.no_grad():
        want = run_prep(sc, False, texture)
        kernels.reset_launch_counts()
        got = run_prep(sc, True, texture)
        assert kernels.launch_counts()["prep_fwd"] == 1
    assert 0 < int(want[1].mask.sum()) < want[1].mask.numel()
    fields = ("ellipse_params", "cutoff", "radii", "scaler", "mask")
    pairs = [("shaded", got[0], want[0]), ("pts_screen", got[2], want[2])]
    pairs += [(f, getattr(got[1], f), getattr(want[1], f)) for f in fields]
    if name == "shared light colours":
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0.0)
        pairs = pairs[1:]
    differ = [n for n, g, w in pairs if not _same(g, w)]
    assert not differ, f"prep_fwd differs from the composite in {differ}"


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_prep_bwd_matches_autograd_of_the_composite(dev, name):
    """prep_bwd's gradients in points, normals and colours (through
    prep_splats, one launch) against autograd through the composite on the
    card, at the CPU test's tolerance (rtol 1e-4, atol 1e-5 of the largest
    entry); and against its plain version on the card bit for bit."""
    case = PREP_CASES[name]
    sc = prep_scene(case, dev)
    texture = case.get("texture")
    g_scr, g_sh = prep_cotangents(dev)
    want = prep_grads(sc, False, texture, g_scr, g_sh)
    kernels.reset_launch_counts()
    got = prep_grads(sc, True, texture, g_scr, g_sh)
    assert kernels.launch_counts()["prep_bwd"] == 1
    for w, g in zip(want, got):
        if w.abs().max() == 0:
            assert g.abs().max() == 0
        else:
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=1e-5 * float(w.abs().max()))
    assert want[0].abs().max() > 0
    packed = prep.prep_inputs(sc["points"], sc["normals"], sc["mask"],
                              sc["cameras"], sc["lights"], sc["settings"],
                              shade=not texture)
    inputs = (sc["points"], sc["normals"], sc["colors"], *packed,
              None if texture else g_sh, g_scr)
    differ = [n for n, g, w in zip(("points", "normals", "colors"),
                                   kernels.prep_bwd(*inputs),
                                   prep.prep_bwd_plain(*inputs))
              if not _same(g, w)]
    assert not differ, f"prep_bwd differs from its plain version in {differ}"


# ---------------------------------------------------------------------------
# The train step's spans (utils/spans.py) in the CUDA graph
# ---------------------------------------------------------------------------


def _mark_rows(prof):
    """The profiler's device rows of the span marks, by start (ns)."""
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "span_mark" in e.name]
    return sorted(int(round(e.time_range.start * 1000)) for e in rows)


def _device_rows(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.fixture
def spans_off():
    from dss_tpu_torch.utils import spans

    spans.disable()
    yield spans
    spans.disable()


def test_span_marks_are_captured_and_every_replay_kept(dev, spans_off):
    """Spans on before the capture: the graph holds the step's marks (a
    replay's device rows are the spans-off graph's plus one row per mark,
    and the spans-off graph has no mark), the 4 replays of a window fill 4
    rows of the ring with the one layout, each replay's stamps rise in the
    order of its marks and lie after the previous replay's, and the
    kernels' counters still count K1-K3 and the set-up's two kernels once
    per replay and the exact kNN twice."""
    spans = spans_off
    acts = [torch.profiler.ProfilerActivity.CUDA]
    rows = {}
    for on in (False, True):
        window, state, epoch = _window_case(dev, True)
        if on:
            spans.enable()
        state, _ = window(state, epoch, 1)  # captures
        torch.cuda.synchronize()
        first = spans.begun(dev)
        with torch.profiler.profile(activities=acts) as prof:
            state, _ = window(state, epoch, 1)
            torch.cuda.synchronize()
        rows[on] = (len(_device_rows(prof)), len(_mark_rows(prof)))
        assert window.per_replay == {"fwd_lean": 1, "occ_bwd": 1,
                                     "feat_bwd": 1, "knn_topk": 2, **UPDATE,
                                     **PREP, **BIN}
        if on:
            # the capturing call's replay and the profiled one
            assert window.replays == 2 and window.replay_host_ns > 0
            first = spans.begun(dev)
            state, _ = window(state, epoch, 4)
            rec = spans.read(first=first)
        spans.disable()
    n_marks = rows[True][1]
    assert rows[False][1] == 0 and n_marks > 20
    assert rows[True][0] == rows[False][0] + n_marks
    assert rec["clock"] == "globaltimer" and rec["dropped"] == 0
    assert [st["index"] for st in rec["steps"]] == list(range(first,
                                                              first + 4))
    assert {tuple(s.name for s in st["spans"]) for st in rec["steps"]} == {
        tuple(s.name for s in rec["steps"][0]["spans"])}
    assert 2 * len(rec["steps"][0]["spans"]) == n_marks
    prev = 0
    for st in rec["steps"]:
        stamps = sorted([(s.start_ns, 0) for s in st["spans"]]
                        + [(s.end_ns, 1) for s in st["spans"]])
        assert stamps[0][0] >= prev
        prev = st["spans"][0].end_ns
        for s in st["spans"]:
            assert s.start_ns <= s.end_ns
            if s.parent >= 0:
                p = st["spans"][s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert {s.name for s in st["spans"]} >= {
            "step", "render.prep", "splat.raster", "bwd.splat", "loss.reg",
            "geometry.knn", "update"}


def test_span_stamps_map_onto_the_profiler_clock(dev, spans_off):
    """Over a traced window of 4 replays, the marks' %globaltimer stamps and
    their profiler rows pair one to one in order, and the offset between
    them spreads by at most 2 µs about its straight-line fit (the
    profiler's clock has been seen to run from a few to 8500 ppm off the
    card's %globaltimer, from one session to the next)."""
    spans = spans_off
    window, state, epoch = _window_case(dev, True)
    spans.enable()
    state, _ = window(state, epoch, 1)
    torch.cuda.synchronize()
    first = spans.begun(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = window(state, epoch, 4)
        torch.cuda.synchronize()
    rec = spans.read(first=first)
    rows = _mark_rows(prof)
    stamps = sorted(t for st in rec["steps"] for s in st["spans"]
                    for t in (s.start_ns, s.end_ns))
    assert len(rec["steps"]) == 4 and len(rows) == len(stamps)
    off = [r - s for r, s in zip(rows, stamps)]
    slope, icpt = statistics.linear_regression(stamps, off)
    resid = [o - (icpt + slope * t) for t, o in zip(stamps, off)]
    print(f"stamp-to-row offset over {len(off)} marks: spread "
          f"{max(off) - min(off)} ns, {slope * 1e6:.1f} ppm, about the "
          f"line {max(resid) - min(resid):.0f} ns")
    assert max(resid) - min(resid) <= 2000


def test_spans_on_train_like_spans_off_on_the_card(dev, spans_off):
    """A graphed window of k = 8, spans off twice and on once: the first
    replayed loss bit-equal, and the parameters after 8 steps as close to
    the spans-off run's as the two spans-off runs lie to each other (bit
    for bit where those are; K2's and K3's float atomics sum in a
    run-dependent order)."""
    spans = spans_off
    runs = []
    for on in (False, False, True):
        window, state, epoch = _window_case(dev, True)
        if on:
            spans.enable()
        state, m1 = window(state, epoch, 1)
        state, _ = window(state, epoch, 7)
        spans.disable()
        runs.append((state, float(m1["loss"])))
    assert runs[2][1] == runs[0][1]
    noise = _q99(runs[1][0], runs[0][0])
    got = _q99(runs[2][0], runs[0][0])
    print(f"q99 |Δ params| after 8 steps: spans on vs off {got}, off vs "
          f"off {noise}")
    same = all(torch.equal(a, b) for a, b in zip(
        runs[1][0].params.tensors(), runs[0][0].params.tensors()))
    if same:
        for a, b in zip(runs[2][0].params.tensors(),
                        runs[0][0].params.tensors()):
            assert torch.equal(a, b)
    assert got <= max(noise, 1e-6)
