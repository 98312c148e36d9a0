"""Neural and lighting textures through the renderer (render/texture.py)
against dss_tpu on the same numpy inputs: `render_views` (2 views) and
`render_single_view` at 32² with 200 points and a RenderingNetwork whose
flax weights are carried across, dss_tpu on its Pallas kernels in
interpret mode and on its reference rasterizer; rgba within atol 1e-5, the
decoder's parameter gradients within rtol 1e-4, atol 1e-5 of their
largest entry.  The lighting texture equals the renderer's own shading,
and `render_views_stacked` takes a texture per scene."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.models.decoders import RenderingNetwork as JRenderingNetwork
from dss_tpu.render import ewa as jewa
from dss_tpu.render.renderer import render_single_view as j_render_single_view
from dss_tpu.render.renderer import render_views as j_render_views
from dss_tpu.render.texture import make_neural_texture as j_make_neural_texture
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.models.decoders import RenderingNetwork
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render import (render_single_view, render_views,
                                  render_views_stacked)
from dss_tpu_torch.render.texture import (make_lighting_texture,
                                          make_neural_texture)
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = "cpu"
S, T, N, V = 32, 16, 200, 2
KW = dict(image_size=S, points_per_pixel=3, tile_size=T, backface_culling=True)
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}
# path → (JAX backend, port backend)
PATHS = {"tiled": ("pallas", "auto"), "reference": ("reference", "reference")}


@pytest.fixture(scope="module")
def scene():
    pts = fibonacci_sphere(N, 0.5)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=2.0, elev=torch.tensor([20.0, -10.0]),
                                  azim=torch.tensor([30.0, 200.0]))
    jdec = JRenderingNetwork(hidden_size=32, n_layers=2)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, 33))))
    return dict(pts=pts, nrm=nrm, R=r.numpy(), T=t.numpy(), jdec=jdec,
                params=params)


def _port_decoder(d):
    dec = RenderingNetwork(hidden_size=32, n_layers=2, device=DEV)
    dec.load_state_dict(convert.decoder_state_from_flax(dec, d["params"]),
                        strict=True)
    return dec


def _cot(shape):
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


def _check_grads(dec, jgrads):
    want = convert.decoder_state_from_flax(dec, jgrads)
    got = dict(dec.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    assert any(float(p.grad.abs().max()) > 0 for p in dec.parameters())


@pytest.mark.parametrize("path", list(PATHS))
def test_render_views_neural_texture_matches_jax(scene, path):
    d = scene
    jb, tb = PATHS[path]
    jst = jewa.RasterSettings(backend=jb, **KW)
    jcams = JCameras.create(d["R"], d["T"], fov=60.0)
    args = (jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]),
            jnp.ones((N, 3)), jnp.ones((N,), bool), jcams, None, jst)
    cot = _cot((V, S, S, 4))

    def jloss(prm):
        rgba = j_render_views(
            *args, texture_fn=j_make_neural_texture(d["jdec"].apply, prm))[0]
        return jnp.sum(rgba * cot), rgba

    (_, jrgba), jg = jax.value_and_grad(jloss, has_aux=True)(d["params"])

    dec = _port_decoder(d)
    cams = convert.cameras_from_numpy({"R": d["R"], "T": d["T"], "fov": 60.0},
                                      device=DEV)
    rgba, _, vis = render_views(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.ones(N, 3),
        torch.ones(N, dtype=torch.bool), cams, None,
        tewa.RasterSettings(backend=tb, **KW),
        texture_fn=make_neural_texture(dec))
    assert rgba.shape == (V, S, S, 4) and int(vis.sum()) > 0
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(jrgba),
                               atol=1e-5)
    assert float(rgba[..., 3].detach().mean()) > 0.05
    (rgba * torch.tensor(cot)).sum().backward()
    _check_grads(dec, jg)


def test_render_single_view_neural_texture_matches_jax(scene):
    d = scene
    jst = jewa.RasterSettings(backend="pallas", **KW)
    jcam = JCameras.create(d["R"][1:], d["T"][1:], fov=60.0)
    cot = _cot((S, S, 4))

    def jloss(prm):
        rgba = j_render_single_view(
            jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]), jnp.ones((N, 3)),
            jnp.ones((N,), bool), jcam, None, jst,
            texture_fn=j_make_neural_texture(d["jdec"].apply, prm))[0]
        return jnp.sum(rgba * cot), rgba

    (_, jrgba), jg = jax.value_and_grad(jloss, has_aux=True)(d["params"])
    dec = _port_decoder(d)
    cam = convert.cameras_from_numpy(
        {"R": d["R"][1:], "T": d["T"][1:], "fov": 60.0}, device=DEV)
    rgba, _, vis = render_single_view(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.ones(N, 3),
        torch.ones(N, dtype=torch.bool), cam, None,
        tewa.RasterSettings(**KW), texture_fn=make_neural_texture(dec))
    assert rgba.shape == (S, S, 4) and vis.shape == (N,)
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(jrgba),
                               atol=1e-5)
    (rgba * torch.tensor(cot)).sum().backward()
    _check_grads(dec, jg)


def test_texture_takes_precedence_and_lighting_texture_is_the_shading(scene):
    """A lighting texture gives the renderer's own shading bit for bit, and
    it overrides the lights passed beside it."""
    d = scene
    cams = convert.cameras_from_numpy({"R": d["R"], "T": d["T"], "fov": 60.0},
                                      device=DEV)
    lights = convert.lights_from_numpy(LIGHTS, V, device=DEV)
    base = (torch.tensor(d["pts"]), torch.tensor(d["nrm"]),
            torch.full((N, 3), 0.7), torch.ones(N, dtype=torch.bool), cams)
    st = tewa.RasterSettings(**KW)
    shaded = render_views(*base, lights, st)[0]
    tex = make_lighting_texture(lights, albedo=torch.full((N, 3), 0.7))
    textured = render_views(*base, None, st, texture_fn=tex)[0]
    assert torch.equal(shaded, textured)
    other = convert.lights_from_numpy({**LIGHTS, "ambient_color": [0.0] * 3},
                                      V, device=DEV)
    assert torch.equal(render_views(*base, other, st, texture_fn=tex)[0],
                       textured)


def test_view_independent_texture_and_one_decoder_call(scene):
    d = scene
    calls = []
    dec = RenderingNetwork(hidden_size=16, n_layers=1, in_dim=6, device=DEV)
    dec.register_forward_hook(lambda m, i, o: calls.append(i[0].shape))
    cams = convert.cameras_from_numpy({"R": d["R"], "T": d["T"], "fov": 60.0},
                                      device=DEV)
    pts, nrm = torch.tensor(d["pts"]), torch.tensor(d["nrm"])
    out = make_neural_texture(dec, view_dependent=False)(pts, nrm, cams)
    assert out.shape == (V, N, 3) and torch.equal(out[0], out[1])
    dec33 = _port_decoder(d)
    dec33.register_forward_hook(lambda m, i, o: calls.append(i[0].shape))
    out = make_neural_texture(dec33)(pts, nrm, cams)
    assert out.shape == (V, N, 3) and not torch.equal(out[0], out[1])
    assert calls == [(N, 6), (V * N, 33)]


def test_render_views_stacked_with_a_texture(scene):
    d = scene
    dec = _port_decoder(d)
    cams = convert.cameras_from_numpy({"R": d["R"], "T": d["T"], "fov": 60.0},
                                      device=DEV)
    pts = torch.tensor(d["pts"])
    nrm = torch.tensor(d["nrm"])
    st = tewa.RasterSettings(**KW)
    tex = make_neural_texture(dec)
    stacked = render_views_stacked(
        torch.stack([pts, pts * 0.8]), torch.stack([nrm, nrm]),
        torch.ones(2, N, 3), torch.ones(2, N, dtype=torch.bool), [cams, cams],
        None, st, texture_fn=tex)[0]
    for s, scale in enumerate((1.0, 0.8)):
        one = render_views(pts * scale, nrm, torch.ones(N, 3),
                           torch.ones(N, dtype=torch.bool), cams, None, st,
                           texture_fn=tex)[0]
        np.testing.assert_allclose(stacked[s].detach().numpy(),
                                   one.detach().numpy(), atol=1e-6)
