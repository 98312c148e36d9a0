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
    got = kernels.fwd_lean(b.tile_counts, b.tile_data, DMT, S, T, K, True)
    want = kernels.fwd_lean_plain(b.tile_counts, b.tile_data, DMT, S, T, K, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


def test_occ_bwd_matches_plain(tables):
    bb, r2 = tables[1], tables[2]
    g = torch.randn((V, bb.tile_counts.shape[1], T * T), device="cuda") * 3e-4
    got = kernels.occ_bwd(bb.tile_counts, bb.tile_data, g, r2, S, T)
    want = kernels.occ_bwd_plain(bb.tile_counts, bb.tile_data, g, r2, S, T)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4,
                                   atol=1e-6 * float(w.abs().max()))


def test_feat_bwd_matches_plain(tables):
    b = tables[0]
    g = torch.randn((V, b.tile_counts.shape[1], T * T, 4), device="cuda")
    got = kernels.feat_bwd(b.tile_counts, b.tile_data, g, DMT, S, T, K)
    want = kernels.feat_bwd_plain(b.tile_counts, b.tile_data, g, DMT, S, T, K)
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


def test_fwd_frag_matches_plain(tables):
    b = tables[0]
    got = kernels.fwd_frag(b.tile_counts, b.tile_data, DMT, S, T, K)
    want = kernels.fwd_frag_plain(b.tile_counts, b.tile_data, DMT, S, T, K)
    # z, q, ids, cnt and vis: the same accept, rank and window arithmetic
    for i, name in enumerate(("z", "q", "ids", "cnt", "vis")):
        assert torch.equal(got[i], want[i]), name
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=1e-6)
    assert int((want[2] >= 0).sum()) > 0


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
    kernels.fwd_lean(b.tile_counts, b.tile_data, DMT, S, T, K, False)
    kernels.fwd_lean_plain(b.tile_counts, b.tile_data, DMT, S, T, K, False)
    assert kernels.launch_counts()["fwd_lean"] == 1
    assert np.sum(list(kernels.launch_counts().values())) == 1
