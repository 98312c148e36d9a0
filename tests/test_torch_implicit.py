"""Implicit-surface rendering (render/implicit.py) against dss_tpu's on
the same numpy inputs: camera rays (atol 1e-6), the sphere and box
intersections, sphere tracing, and `render_sdf` at 48² of an analytic
sphere and of a small SDF network whose flax weights are carried across.
Alpha must be equal except at ≤ 1% of the pixels, all on the silhouette's
boundary (a ray that grazes the surface may end its march on either side
of the 10·eps hit test); rgb within 1e-4 elsewhere.  With grad enabled,
the SDF normals keep the second-order term: their parameter gradients
match jax.grad's within rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.models.decoders import SDF as JSDF
from dss_tpu.render import implicit as jimp
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.utils.mathutil import normalize as jnormalize
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.models.decoders import SDF
from dss_tpu_torch.render import implicit as timp

torch.set_num_threads(2)

DEV = "cpu"
S = 48
LIGHTS = {"ambient_color": [0.4] * 3, "diffuse_color": [0.5] * 3,
          "specular_color": [0.1] * 3, "direction": [0.3, 1.0, -0.5]}


def _cams(elev=25.0, azim=40.0, dist=2.5, aspect=1.0):
    r, t = look_at_view_transform(dist=dist, elev=elev, azim=azim)
    d = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0, "aspect_ratio": aspect}
    jcam = JCameras.create(d["R"], d["T"], fov=60.0, aspect_ratio=aspect)
    return convert.cameras_from_numpy(d, device=DEV), jcam


@pytest.fixture(scope="module")
def sdf_net():
    jm = JSDF(hidden_size=32, n_layers=3, skip_in=(2,), num_frequencies=2,
              bias=0.5)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))))
    tm = SDF(hidden_size=32, n_layers=3, skip_in=(2,), num_frequencies=2,
             bias=0.5, device=DEV)
    tm.load_state_dict(convert.decoder_state_from_flax(tm, params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("aspect", [1.0, 1.5])
def test_camera_rays_match_jax(aspect):
    cam, jcam = _cams(aspect=aspect)
    o, d = timp.camera_rays(cam, S)
    jo, jd = jimp.camera_rays(jcam, S)
    assert o.shape == d.shape == (S, S, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def test_intersections_match_jax():
    rng = np.random.default_rng(0)
    o = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    # half the rays aim near the origin, so both hit and miss often
    d[250:] = rng.uniform(-1, 1, (250, 3)).astype(np.float32) - o[250:]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:5, 0] = 0.0  # axis-parallel rays take the 1e-12 guard
    c = np.array([0.1, -0.2, 0.3], np.float32)
    got = timp.ray_sphere_intersect(torch.tensor(o), torch.tensor(d),
                                    torch.tensor(c), 1.2)
    want = jimp.ray_sphere_intersect(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(c), 1.2)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 50 < int(got[2].sum()) < 450
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    lo, hi = np.full(3, -0.7, np.float32), np.array([0.5, 0.8, 0.6], np.float32)
    got = timp.ray_box_intersect(torch.tensor(o), torch.tensor(d),
                                 torch.tensor(lo), torch.tensor(hi))
    want = jimp.ray_box_intersect(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 20 < int(got[2].sum()) < 480
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _sphere_t(p):
    return torch.linalg.vector_norm(p, dim=-1) - 0.6


def _sphere_j(p):
    return jnp.linalg.norm(p, axis=-1) - 0.6


def test_sphere_trace_matches_jax():
    cam, jcam = _cams()
    o, d = timp.camera_rays(cam, S)
    t0, t1, h0 = timp.ray_sphere_intersect(o, d, torch.zeros(3), 1.5)
    t, hit = timp.sphere_trace(_sphere_t, o, d, t0, torch.where(h0, t1, -1.0),
                               32)
    jo, jd = jimp.camera_rays(jcam, S)
    jt0, jt1, jh0 = jimp.ray_sphere_intersect(jo, jd, jnp.zeros(3), 1.5)
    jt, jhit = jimp.sphere_trace(_sphere_j, jo, jd, jt0,
                                 jnp.where(jh0, jt1, -1.0), 32)
    assert t.shape == hit.shape == (S, S)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    inside = hit.numpy()
    np.testing.assert_allclose(t.numpy()[inside], np.asarray(jt)[inside],
                               atol=1e-5)


def _alpha_and_rgb_agree(got, want):
    """Alpha equal except at ≤ 1% of the pixels, each on the boundary of
    the silhouette; rgb within 1e-4 where alpha agrees."""
    got, want = got.detach().numpy(), np.asarray(want)
    a, b = got[..., 3] > 0.5, want[..., 3] > 0.5
    diff = a != b
    assert diff.mean() <= 0.01, diff.mean()
    pad = np.pad(b, 1, mode="edge")
    edge = np.zeros_like(b)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= pad[1 + dy:1 + dy + S, 1 + dx:1 + dx + S] != b
    assert not (diff & ~edge).any()
    np.testing.assert_allclose(got[~diff], want[~diff], atol=1e-4)
    assert 0.05 < b.mean() < 0.95


@pytest.mark.parametrize("lit", [False, True])
def test_render_sdf_sphere_matches_jax(lit):
    cam, jcam = _cams(elev=-15.0, azim=120.0)
    lights = convert.lights_from_numpy(LIGHTS, 1, device=DEV) if lit else None
    jl = JLights.create(**LIGHTS) if lit else None
    got = timp.render_sdf(_sphere_t, cam, S, lights=lights)
    want = jimp.render_sdf(_sphere_j, jcam, S, lights=jl)
    assert got.shape == (S, S, 4)
    _alpha_and_rgb_agree(got, want)


def test_render_sdf_network_matches_jax(sdf_net):
    jm, params, tm = sdf_net
    cam, jcam = _cams(elev=30.0, azim=-60.0)
    with torch.no_grad():
        got = timp.render_sdf(lambda p: tm(p)["sdf"][..., 0], cam, S,
                              n_steps=48)
    want = jimp.render_sdf(lambda p: jm.apply(params, p)["sdf"][..., 0], jcam,
                           S, n_steps=48)
    _alpha_and_rgb_agree(got, want)


def test_sdf_normals_keep_the_second_order_term(sdf_net):
    """Under grad the normals' parameter gradient is jax.grad's through
    vmap(grad(sdf)); under no_grad they carry no graph."""
    jm, params, tm = sdf_net
    pts = np.random.default_rng(1).uniform(-0.7, 0.7, (64, 3)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal((64, 3)).astype(np.float32)

    def jloss(prm):
        f = lambda q: jm.apply(prm, q[None])["sdf"][0, 0]
        return jnp.sum(jnormalize(jax.vmap(jax.grad(f))(jnp.asarray(pts))) * cot)

    jg = jax.grad(jloss)(params)
    n = timp.sdf_normals(lambda p: tm(p)["sdf"][..., 0], torch.tensor(pts))
    (n * torch.tensor(cot)).sum().backward()
    want = convert.decoder_state_from_flax(tm, jg)
    for k, p in tm.named_parameters():
        w = want[k].numpy()
        # the last bias does not reach a gradient: no grad here, zeros there
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    with torch.no_grad():
        n = timp.sdf_normals(lambda p: tm(p)["sdf"][..., 0], torch.tensor(pts))
    assert n.grad_fn is None and not n.requires_grad
