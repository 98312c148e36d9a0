"""Each splat kernel's plain PyTorch version (the CPU path of the port and
the reference its CUDA kernel is held to on the card) against the dss_tpu
function that runs the Pallas kernel, in interpret mode, on dss_tpu's own
binned tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.ops import splat_pallas as jsp
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.ops.splat import _seg, _untile
from dss_tpu_torch.render.ewa import RasterSettings, prepare_splats
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N, K, DMT, CAP, CAP_BWD = 32, 16, 3, 300, 5, 0.05, 384, 2048


@pytest.fixture(scope="module")
def scene():
    """Screen-space splats (3 views, 32², tile 16) and dss_tpu's lean
    forward on them, with its binned tables."""
    pts = fibonacci_sphere(N, 0.5)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 80.0, 200.0]))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=DEV)
    st = RasterSettings(image_size=S, points_per_pixel=K, backface_culling=True,
                        Vrk_invariant=True, Vrk_isotropic=False)
    sp = prepare_splats(torch.tensor(pts), torch.tensor(nrm),
                        torch.ones(N, dtype=torch.bool), cams, st)
    rng = np.random.default_rng(7)
    arr = {k: jnp.asarray(getattr(sp, k).detach().numpy()) for k in
           ("pts_screen", "ellipse_params", "cutoff", "radii", "scaler")}
    arr["features"] = jnp.asarray(rng.uniform(0, 1, (V, N, 3)), jnp.float32)
    occ, visible, rgbw, overflow, binned = jsp.rasterize_forward_views_lean(
        arr["pts_screen"], arr["ellipse_params"], arr["cutoff"], arr["radii"],
        DMT, S, K, tile_size=T, bin_capacity=CAP, scaler=arr["scaler"],
        features=arr["features"], matmul_scatter=True, with_depth=True,
    )
    assert int(jnp.sum(overflow)) == 0
    return dict(arr=arr, occ=np.asarray(occ), visible=np.asarray(visible),
                rgbw=np.asarray(rgbw), binned=binned, rng=rng)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def test_fwd_lean_plain_matches_jax(scene):
    b = scene["binned"]
    cnt, vis, rgbw = kernels.fwd_lean_plain(
        _t(b.tile_counts), _t(b.tile_data), DMT, S, T, K, with_depth=True)
    occ = _untile(cnt[:, :, None, :], S, T)[..., 0] > 0
    seg = _seg(_t(b.tile_ids), N)
    visible = kernels.segment_sum_plain(vis.reshape(V, 1, -1), seg, N)[..., 0] > 0
    # cnt and the visibility flags are exact (same accept / rank / window
    # arithmetic); rgbw sums the same terms in another order
    np.testing.assert_array_equal(occ.numpy().astype(np.float32), scene["occ"])
    np.testing.assert_array_equal(visible.numpy(), scene["visible"])
    np.testing.assert_allclose(_untile(rgbw, S, T).numpy(), scene["rgbw"],
                               atol=1e-5)
    assert scene["visible"].sum() > 100


def test_occ_bwd_plain_matches_jax(scene):
    arr = scene["arr"]
    bb, cur_r2 = jax.vmap(lambda p, r, v: jsp.bin_for_occ_backward(
        p, r, v, jnp.float32(5.0), S, T, CAP_BWD, 4))(
        arr["pts_screen"], arr["radii"], jnp.asarray(scene["visible"]))
    g = scene["rng"].standard_normal((V, S, S)).astype(np.float32) * 3e-4
    want = jsp.occ_backward_views_from_binned(
        bb, cur_r2, jnp.asarray(g), N, S, T, CAP_BWD, matmul_scatter=True)
    g_t = _t(g).reshape(V, S // T, T, S // T, T).permute(0, 1, 3, 2, 4)
    gx, gy = kernels.occ_bwd_plain(
        _t(bb.tile_counts), _t(bb.tile_data),
        g_t.reshape(V, -1, T * T).contiguous(), _t(cur_r2), S, T)
    got = kernels.segment_sum_plain(
        torch.stack([gx.reshape(V, -1), gy.reshape(V, -1)], 1),
        _seg(_t(bb.tile_ids), N), N)
    # per-candidate sums over the tile's pixels in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-3


def test_feat_bwd_plain_matches_jax(scene):
    b = scene["binned"]
    g = scene["rng"].standard_normal((V, S, S, 4)).astype(np.float32) * 3e-4
    want = jsp.feat_backward_views(b, jnp.asarray(g), DMT, N, S, K, T, CAP,
                                   matmul_scatter=True, with_depth=True)
    g_t = _t(g).reshape(V, S // T, T, S // T, T, 4).permute(0, 1, 3, 2, 4, 5)
    gf = kernels.feat_bwd_plain(_t(b.tile_counts), _t(b.tile_data),
                                g_t.reshape(V, -1, T * T, 4).contiguous(),
                                DMT, S, T, K)
    got = kernels.segment_sum_plain(
        gf.permute(0, 2, 1, 3).reshape(V, 4, -1).contiguous(),
        _seg(_t(b.tile_ids), N), N)
    # sums of w·g over pixels and slots in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-4


@pytest.mark.parametrize("route", ["sorted", "matmul"])
def test_segment_sum_plain_matches_jax(route):
    rng = np.random.default_rng(3)
    v, c, n, p = 2, 4, 4096, 300
    vals = rng.standard_normal((v, c, n)).astype(np.float32)
    seg = rng.integers(0, p + 1, (v, n)).astype(np.int32)  # p = dump bucket
    if route == "matmul":
        want = np.asarray(jsp.segment_sum_views_matmul(
            jnp.asarray(vals), jnp.asarray(seg), p))
    else:
        want = np.stack([np.asarray(jsp.sorted_segment_sum(
            jnp.asarray(vals[i].T), jnp.asarray(seg[i]), p)) for i in range(v)])
    got = kernels.segment_sum_plain(_t(vals), _t(seg), p).numpy()
    # the matmul route splits f32 into 3 bf16 terms: exact to ~2^-24
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
