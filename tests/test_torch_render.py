"""The port's renderer against dss_tpu's on the lean pallas path (interpret
mode) with the weighted-depth channel: forward images, visibility and the
gradients to points and colours; plus the EWA setup alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.render import ewa as jewa
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.render.renderer import render_views as j_render_views
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.utils.mathutil import tan_f32
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N = 32, 16, 3, 300
KW = dict(image_size=S, points_per_pixel=5, backface_culling=True,
          tile_size=T, Vrk_invariant=True, Vrk_isotropic=False,
          clip_pts_grad=0.05, depth_channel=True)


@pytest.fixture(scope="module")
def inputs():
    pts = fibonacci_sphere(N, 0.5)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 80.0, 200.0]))
    rng = np.random.default_rng(2)
    return dict(
        pts=pts,
        nrm=pts / np.linalg.norm(pts, axis=-1, keepdims=True),
        cols=rng.uniform(0.2, 0.9, (N, 3)).astype(np.float32),
        cams={"R": r.numpy(), "T": t.numpy(), "fov": 60.0},
        lights={"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
                "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]},
        target=rng.uniform(0, 1, (V, S, S, 4)).astype(np.float32),
    )


def _jax_cams(d):
    return JCameras.create(d["R"], d["T"], fov=d["fov"])


def test_render_views_matches_jax(inputs):
    d = inputs
    jst = jewa.RasterSettings(backend="pallas", **KW)
    jl = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (V,) + x.shape),
                                JLights.create(**d["lights"]))
    mask = jnp.ones((N,), bool)

    def jloss(p, c):
        rgba, fr, vis = j_render_views(p, jnp.asarray(d["nrm"]), c, mask,
                                       _jax_cams(d["cams"]), jl, jst)
        loss = jnp.mean((rgba - d["target"]) ** 2) + jnp.mean(
            jnp.abs(fr.wdepth - 2.0))
        return loss, (rgba, vis, fr.wdepth)

    (jl_, (jrgba, jvis, jwd)), (jgp, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(d["pts"]),
                                             jnp.asarray(d["cols"]))

    tp = torch.tensor(d["pts"], requires_grad=True)
    tc = torch.tensor(d["cols"], requires_grad=True)
    rgba, fr, vis = render_views(
        tp, torch.tensor(d["nrm"]), tc, torch.ones(N, dtype=torch.bool),
        convert.cameras_from_numpy(d["cams"], device=DEV),
        convert.lights_from_numpy(d["lights"], V, device=DEV), tewa.RasterSettings(**KW))
    loss = torch.mean((rgba - torch.tensor(d["target"])) ** 2) + torch.mean(
        torch.abs(fr.wdepth - 2.0))
    gp, gc = torch.autograd.grad(loss, (tp, tc))

    np.testing.assert_allclose(loss.item(), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(jrgba), atol=1e-5)
    np.testing.assert_allclose(fr.wdepth.detach().numpy(), np.asarray(jwd), atol=1e-5)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    # gradients: the same sums in another order, through clip and shading
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-3, atol=1e-4)
    assert int(fr.overflow.sum()) == 0 and np.abs(np.asarray(jgp)).max() > 1e-3


@pytest.mark.parametrize("backface", [True, False])
def test_prepare_splats_matches_jax(inputs, backface):
    d = inputs
    kw = {**KW, "backface_culling": backface}
    mask = np.ones(N, bool)
    mask[::7] = False
    jcams = _jax_cams(d["cams"])
    want = [jewa.prepare_splats(
        jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]), jnp.asarray(mask),
        jax.tree_util.tree_map(lambda x: x[v:v + 1], jcams),
        jewa.RasterSettings(**kw)) for v in range(V)]
    got = tewa.prepare_splats(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.tensor(mask),
        convert.cameras_from_numpy(d["cams"], device=DEV), tewa.RasterSettings(**kw))
    for field in ("pts_screen", "cutoff", "radii", "mask"):
        np.testing.assert_allclose(
            getattr(got, field).detach().numpy(),
            np.stack([np.asarray(getattr(w, field)) for w in want]),
            atol=1e-6, err_msg=field)
    # the conic (~1e3, 1/det GV) and the scaler (~40) are large: float32
    # ulps there exceed 1e-6, so both are held to 1e-5 of their scale (the
    # conic's b = −(gv01 + gv10) can be a small difference of large terms)
    for field in ("ellipse_params", "scaler"):
        w = np.stack([np.asarray(getattr(x, field)) for x in want])
        np.testing.assert_allclose(getattr(got, field).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=field)


@pytest.mark.parametrize("n", [300, 9000])
def test_compute_vrk_h_global_matches_jax(n):
    """Exact mean below 8192 points; above, the strided 4096-query
    estimate over the active points."""
    rng = np.random.default_rng(n)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    mask = rng.random(n) < 0.9
    want = float(jewa.compute_vrk_h_global(jnp.asarray(pts), jnp.asarray(mask)))
    got = float(tewa.compute_vrk_h_global(torch.tensor(pts), torch.tensor(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fov", [30.0, 45.0, 60.0, 90.0])
def test_projection_matrix_matches_jax_bit_for_bit(fov):
    """s1 = 1/(aspect·tan(fov/2)) and s2 = 1/tan(fov/2) as dss_tpu gives
    them: tan_f32 reproduces jnp.tan, which torch.tan misses by an ulp at
    60° on some hosts."""
    r, t = look_at_view_transform(dist=2.0, elev=20.0, azim=40.0)
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": fov, "aspect_ratio": 1.5}
    want = np.asarray(JCameras.create(cams["R"], cams["T"], fov=fov,
                                      aspect_ratio=1.5).projection_matrix())
    got = convert.cameras_from_numpy(cams, device=DEV).projection_matrix()
    np.testing.assert_array_equal(got.numpy(), want)


def test_tan_f32_matches_jnp_tan():
    """Every float32 half-angle on a dense grid of fields of view, both
    signs, and a wide random sample."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.deg2rad(np.arange(0.01, 180.0, 0.01, dtype=np.float32)) / 2,
        rng.uniform(-119.0, 119.0, 200_000)]).astype(np.float32)
    x = np.concatenate([x, -x])
    np.testing.assert_array_equal(tan_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.tan(x)))
