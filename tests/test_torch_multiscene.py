"""Multi-scene training in the port against dss_tpu on the same numpy
inputs: `render_views_stacked` (all S·V views in one lean rasterizer call;
dss_tpu's Pallas kernels in interpret mode), `make_stacked_loss_fn`'s
loss, parts and gradients, the folded call against the port's own loop
over scenes, the binning budgets around the 20k-point line, and the
train_multiscene CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.ops import splat_pallas as jsplat
from dss_tpu.render import ewa as jewa
from dss_tpu.render import renderer as jrenderer
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.training import trainer as jtrainer
from dss_tpu_torch import convert
from dss_tpu_torch.apps import train_multiscene
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.ops import splat
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render import renderer
from dss_tpu_torch.training import trainer
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")
N_SCENES, N_VIEWS, N_PTS, S = 3, 2, 200, 32
# tests/test_parallel.py::TestMultiSceneTraining's settings
KW = dict(image_size=S, points_per_pixel=3, tile_size=16, bin_capacity=256,
          Vrk_invariant=True, Vrk_isotropic=False)
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}


@pytest.fixture(scope="module")
def scenes():
    """Three different clouds (radius, offset and colours per scene), each
    with its own two-view ring, and per-scene targets."""
    rng = np.random.default_rng(0)
    pts = np.stack([fibonacci_sphere(N_PTS, 0.35 + 0.1 * i)
                    + np.float32(0.05 * i) for i in range(N_SCENES)])
    nrm = np.stack([fibonacci_sphere(N_PTS, 1.0) for _ in range(N_SCENES)])
    cols = rng.uniform(0.2, 0.9, (N_SCENES, N_PTS, 3)).astype(np.float32)
    rings = []
    for i in range(N_SCENES):
        r, t = look_at_view_transform(
            dist=torch.full((N_VIEWS,), 2.0),
            elev=torch.tensor([10.0 * i, 30.0]),
            azim=torch.tensor([15.0 * i, 100.0 + 10.0 * i]))
        rings.append({"R": r.numpy(), "T": t.numpy(), "fov": 60.0})
    img = rng.uniform(0, 1, (N_SCENES, N_VIEWS, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (N_SCENES, N_VIEWS, S, S)) > 0.5).astype(
        np.float32)
    return dict(pts=pts, nrm=nrm, cols=cols, rings=rings, img=img, mask=mask)


def _jax_cams(d):
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JCameras.create(r["R"], r["T"], fov=r["fov"]) for r in d["rings"]])


def _port_cams(d):
    return [convert.cameras_from_numpy(r, device=DEV) for r in d["rings"]]


def test_render_views_stacked_matches_jax(scenes):
    d = scenes
    jl = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N_SCENES, N_VIEWS) + x.shape),
        JLights.create(**LIGHTS))
    mask = np.ones((N_SCENES, N_PTS), bool)
    mask[1, ::5] = False
    vrk_h = np.array([2e-4, 3e-4, 4e-4], np.float32)
    jrgba, jfr, jvis = jrenderer.render_views_stacked(
        jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]), jnp.asarray(d["cols"]),
        jnp.asarray(mask), _jax_cams(d), jl,
        jewa.RasterSettings(backend="pallas", **KW), vrk_h=jnp.asarray(vrk_h))
    rgba, fr, vis = renderer.render_views_stacked(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.tensor(d["cols"]),
        torch.tensor(mask), _port_cams(d),
        [convert.lights_from_numpy(LIGHTS, N_VIEWS, device=DEV)] * N_SCENES,
        tewa.RasterSettings(**KW), vrk_h=torch.tensor(vrk_h))
    assert rgba.shape == (N_SCENES, N_VIEWS, S, S, 4)
    assert vis.shape == (N_SCENES, N_VIEWS, N_PTS)
    np.testing.assert_allclose(rgba.numpy(), np.asarray(jrgba), atol=1e-5)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(fr.overflow.numpy(), np.asarray(jfr.overflow))
    assert not vis[1][:, ::5].any() and vis.any(dim=-1).all()


def _port_state(d):
    params = PointModelParams.create(d["pts"], d["nrm"], np.full_like(
        d["pts"], 0.6), device=DEV)
    ones = torch.ones((N_SCENES, N_PTS), dtype=torch.bool)
    return params, PointFilters(ones, ones.clone(), ones.clone())


CFG = dict(lambda_repel=0.05)


def _port_stacked_loss(d):
    params, filters = _port_state(d)
    fn = trainer.make_stacked_loss_fn(tewa.RasterSettings(**KW),
                                      trainer.TrainConfig(**CFG),
                                      trainer.AnnealSchedule())
    total, (parts, new_f) = fn(params, filters, _port_cams(d), None,
                               torch.tensor(d["img"]), torch.tensor(d["mask"]),
                               0)
    grads = torch.autograd.grad(total, params.tensors(), allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(params.tensors(), grads)]
    return total, parts, new_f, grads


def test_stacked_loss_matches_jax(scenes):
    """tests/test_parallel.py's folded case (3 scenes, 2 views, 200 points,
    32², tile 16) in both packages: loss and parts at rtol 1e-5, gradients
    at rtol 1e-4, atol 1e-6."""
    d = scenes
    total, parts, new_f, grads = _port_stacked_loss(d)

    jparams = JParams(points=jnp.asarray(d["pts"]), normals=jnp.asarray(d["nrm"]),
                      colors=jnp.full_like(jnp.asarray(d["pts"]), 0.6))
    jfilters = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_SCENES,) + x.shape),
        JFilters.ones(N_PTS))
    jfn = jtrainer.make_stacked_loss_fn(
        jewa.RasterSettings(backend="pallas", **KW),
        jtrainer.TrainConfig(**CFG), jtrainer.AnnealSchedule())

    def jloss(p):
        t, (pa, nf) = jfn(p, jfilters, _jax_cams(d), None, jnp.asarray(d["img"]),
                          jnp.asarray(d["mask"]), jnp.zeros((), jnp.int32))
        return t, (pa, nf)

    (jt, (jparts, jnf)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-5)
    assert set(parts) == set(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    for name, g in zip(("points", "normals", "colors"), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jg, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for k in ("visibility", "inmask"):
        np.testing.assert_array_equal(getattr(new_f, k).numpy(),
                                      np.asarray(getattr(jnf, k)))
    assert np.abs(np.asarray(jg.points)).max() > 1e-4


def test_folded_equals_the_loop_over_scenes(scenes):
    """The folded call against make_loss_fn per scene, mean of the totals:
    each scene's gradient is 1/S of its single-scene gradient."""
    d = scenes
    total, parts, _, grads = _port_stacked_loss(d)
    params, filters = _port_state(d)
    fn = trainer.make_loss_fn(tewa.RasterSettings(**KW),
                              trainer.TrainConfig(**CFG),
                              trainer.AnnealSchedule())
    cams = _port_cams(d)
    totals, scene_parts = [], []
    for s in range(N_SCENES):
        t, (pa, _) = fn(
            PointModelParams(params.points[s], params.normals[s],
                             params.colors[s]),
            PointFilters(filters.activation[s], filters.visibility[s],
                         filters.inmask[s]),
            cams[s], None, torch.tensor(d["img"][s]),
            torch.tensor(d["mask"][s]), 0)
        totals.append(t)
        scene_parts.append(pa)
    want = torch.mean(torch.stack(totals))
    want_g = torch.autograd.grad(want, params.tensors(), allow_unused=True)
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)
    for k in parts:
        if k == "bin_overflow":
            assert int(parts[k]) == sum(int(p[k]) for p in scene_parts)
        else:
            torch.testing.assert_close(
                parts[k], torch.mean(torch.stack([p[k] for p in scene_parts])),
                rtol=1e-6, atol=0)
    for g, w, t in zip(grads, want_g, params.tensors()):
        w = torch.zeros_like(t) if w is None else w
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("p", [5000, 10000, 20000, 20001, 25000, 100000])
def test_tile_budgets_match_jax(p):
    """_tile_config and _bwd_tile_budget at the flagship raster settings on
    both sides of the 20k-point line (max_tiles 4 → 2, the backward budget
    min(mt, 2), no 0.4·P / 0.75·P concentrated-cloud capacity)."""
    kw = dict(image_size=512, tile_size=64, bin_capacity=512)
    cfg = renderer._tile_config(p, tewa.RasterSettings(**kw))
    jcfg = jrenderer._tile_config(p, jewa.RasterSettings(**kw))
    assert (cfg.tile, cfg.cap, 128, cfg.max_tiles, cfg.max_tiles_bwd,
            cfg.pair_cap_fwd, cfg.pair_cap_bwd) == tuple(jcfg[:7])
    jt, jcap, _, jmt, jpc = jsplat._bwd_tile_budget(jcfg, p)
    assert splat._bwd_tile_budget(cfg, p) == (jt, jcap, jmt, jpc)
    assert cfg.max_tiles == (4 if p <= 20000 else 2)


def test_cli_lowers_the_loss(capsys):
    """The CLI at tests/test_parallel.py's size: the final loss below the
    first step's, finite chamfer per scene."""
    train_multiscene.main(["--scenes", "2", "--points", "300", "--views", "2",
                           "--image-size", "32", "--iters", "10",
                           "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    result = json.loads(out[-1])
    first_loss = float(out[1].split("loss0=")[1])
    assert np.isfinite(result["final_loss"])
    assert result["final_loss"] < first_loss
    assert len(result["chamfer_per_scene"]) == 2
    assert all(np.isfinite(c) for c in result["chamfer_per_scene"])
    assert {"scenes", "points_per_scene", "views", "dispatch", "image_size",
            "iters", "sec_per_iter", "msplats_per_s", "final_loss",
            "chamfer_per_scene"} == set(result)
