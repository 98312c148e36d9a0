"""The slice as a whole: the flagship train step (Vrk_invariant, no backface
culling, clip_pts_grad 0.05, weighted-depth channel; λ rgb 1, silhouette 1,
proj 0.01, repel 0.1, depth 0.1) at 32², against dss_tpu's on the lean
pallas path in interpret mode, from the same convert.py inputs."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dss_tpu.training.trainer as jt
from dss_tpu import config as jconfig
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.render.ewa import RasterSettings as JSettings
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import trainer as tt

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N = 32, 16, 3, 300
RASTER = {**chip_smoke.FLAGSHIP_RASTER, "image_size": S, "tile_size": T}
TRAIN = {k: v for k, v in chip_smoke.FLAGSHIP_TRAIN.items()}
SCHED = dict(chip_smoke.FLAGSHIP_SCHEDULE)
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}
PART_KEYS = ("loss_dr_rgb", "loss_dr_silhouette", "loss_dr_depth",
             "loss_dr_proj", "loss_dr_repel")


@pytest.fixture(scope="module")
def case():
    """Model cloud, cameras and targets (rendered by the port from an
    ellipsoid), all numpy from one seed."""
    rng = np.random.default_rng(0)
    verts, faces = ico_sphere(3, 0.5)
    pts, nrm = sample_points_from_mesh(verts, faces, N, rng=rng)
    gt, gt_n = sample_points_from_mesh(verts, faces, 800, rng=rng)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 120.0, 240.0]))
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0}
    with torch.no_grad():
        rgba, fr, _ = render_views(
            torch.tensor(gt * np.array([1.2, 0.9, 1.0], np.float32)),
            torch.tensor(gt_n), torch.full((800, 3), 0.6),
            torch.ones(800, dtype=torch.bool), convert.cameras_from_numpy(cams, device=DEV),
            convert.lights_from_numpy(LIGHTS, V, device=DEV), RasterSettings(**RASTER))
    mask = rgba[..., 3].numpy()
    return dict(
        params={"points": pts, "normals": nrm, "colors": np.ones_like(pts)},
        cams=cams, img=rgba[..., :3].numpy(), mask=mask,
        depth=np.where(mask > 0.5, fr.wdepth.numpy(), 100.0).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_step(case):
    """dss_tpu's loss parts and gradients for the case (one interpret-mode
    run shared by the tests below)."""
    c = case
    loss_fn = jt.make_loss_fn(JSettings(backend="pallas", **RASTER),
                              jt.TrainConfig(**TRAIN), jt.AnnealSchedule(**SCHED))
    lights = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), JLights.create())
    params = JParams.create(**c["params"])
    (total, (parts, nf)), g = jax.value_and_grad(loss_fn, has_aux=True)(
        params, JFilters.ones(N), JCameras.create(c["cams"]["R"], c["cams"]["T"],
                                                  fov=60.0),
        lights, jnp.asarray(c["img"]), jnp.asarray(c["mask"]), jnp.asarray(0),
        jnp.asarray(c["depth"]))
    return dict(total=float(total), parts={k: float(v) for k, v in parts.items()},
                grads=[np.asarray(x) for x in (g.points, g.normals, g.colors)],
                filters=nf, params=params, raw_grads=g)


def _torch_loss(case):
    c = case
    loss_fn = tt.make_loss_fn(RasterSettings(**RASTER), tt.TrainConfig(**TRAIN),
                              tt.AnnealSchedule(**SCHED))
    params = convert.params_from_numpy(c["params"], device=DEV)
    total, (parts, nf) = loss_fn(
        params, PointFilters.ones(N, device=DEV), convert.cameras_from_numpy(c["cams"], device=DEV),
        convert.lights_from_numpy(LIGHTS, V, device=DEV), torch.tensor(c["img"]),
        torch.tensor(c["mask"]), 0, torch.tensor(c["depth"]))
    return params, total, parts, nf


def test_loss_parts_and_grads_match_jax(case, jax_step):
    params, total, parts, nf = _torch_loss(case)
    grads = torch.autograd.grad(total, params.tensors())
    for k in PART_KEYS:
        np.testing.assert_allclose(parts[k].item(), jax_step["parts"][k],
                                   rtol=1e-4, err_msg=k)
    assert int(parts["bin_overflow"]) == 0 == jax_step["parts"]["bin_overflow"]
    for name, got, want in zip(("points", "normals", "colors"), grads,
                               jax_step["grads"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(nf.visibility.numpy(),
                                  np.asarray(jax_step["filters"].visibility))
    np.testing.assert_array_equal(nf.inmask.numpy(),
                                  np.asarray(jax_step["filters"].inmask))
    assert np.abs(jax_step["grads"][0]).max() > 1e-3


def test_lean_colour_gradient_matches_jax_reference_backend(case):
    """The lean path's colour gradient against dss_tpu's `reference`
    backend, at test_loss_parts_and_grads_match_jax's tolerance: the port's
    K3 is held to the JAX package's spec, not only to its Pallas path
    (which parts from that spec where the L1 meets an 8-bit target exactly,
    in both packages alike: tests/test_torch_lean_colour_gradient.py)."""
    c = case
    loss_fn = jt.make_loss_fn(JSettings(backend="reference", **RASTER),
                              jt.TrainConfig(**TRAIN), jt.AnnealSchedule(**SCHED))
    lights = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), JLights.create())
    g = jax.grad(lambda p: loss_fn(
        p, JFilters.ones(N), JCameras.create(c["cams"]["R"], c["cams"]["T"],
                                             fov=60.0),
        lights, jnp.asarray(c["img"]), jnp.asarray(c["mask"]), jnp.asarray(0),
        jnp.asarray(c["depth"]))[0])(JParams.create(**c["params"]))
    want = np.asarray(g.colors)
    params, total, _, _ = _torch_loss(case)
    got = torch.autograd.grad(total, params.colors)[0].numpy()
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def _opt_kwargs():
    o = chip_smoke.FLAGSHIP_OPT
    return dict(lr_points=o["lr_points"], lr_normals=o["lr_normals"],
                lr_colors=o["lr_colors"], milestones=o["milestones"],
                gamma=o["gamma"])


def test_adam_update_matches_jax(jax_step):
    """Two updates with dss_tpu's gradients injected into both packages
    (held apart from the gradient test: Adam's m/√v magnifies sign noise on
    near-zero gradients)."""
    opt = jt.make_optimizer(**_opt_kwargs())
    jstate = jt.create_train_state(jax_step["params"], opt)
    g1 = jax_step["raw_grads"]
    g2 = jax.tree_util.tree_map(lambda x: -0.5 * x + 1e-4, g1)
    params = convert.params_from_numpy(
        {k: np.asarray(getattr(jax_step["params"], k))
         for k in ("points", "normals", "colors")}, device=DEV)
    state = tt.create_train_state(params, tt.make_optimizer(params, **_opt_kwargs()))
    zero = torch.zeros(())
    for g in (g1, g2):
        jstate, _ = jt.apply_update(opt, jstate, g, jnp.zeros(()), {},
                                    jstate.filters)
        state, m = tt.apply_update(
            state, [torch.tensor(np.asarray(x)) for x in
                    (g.points, g.normals, g.colors)], zero, {}, state.filters)
        assert bool(m["params_finite"])
    for name in ("points", "normals", "colors"):
        np.testing.assert_allclose(
            getattr(state.params, name).detach().numpy(),
            np.asarray(getattr(jstate.params, name)), atol=1e-6, err_msg=name)
    assert state.step == 2


def test_nan_gradient_skips_params_and_adam_state(case):
    params = convert.params_from_numpy(case["params"], device=DEV)
    state = tt.create_train_state(params, tt.make_optimizer(params, **_opt_kwargs()))
    ones = [torch.full_like(t, 0.1) for t in params.tensors()]
    state, _ = tt.apply_update(state, ones, torch.zeros(()), {}, state.filters)
    before = [t.detach().clone() for t in params.tensors()]
    opt_before = copy.deepcopy(state.optimizer.state_dict())
    bad = [g.clone() for g in ones]
    bad[0][5, 1] = float("nan")
    state, m = tt.apply_update(state, bad, torch.zeros(()), {}, state.filters)
    assert not bool(m["params_finite"]) and state.step == 2
    for a, b in zip(before, params.tensors()):
        assert torch.equal(a, b.detach())
    opt_after = state.optimizer.state_dict()
    for k, st in opt_before["state"].items():
        for name, val in st.items():
            assert torch.equal(val, opt_after["state"][k][name]), (k, name)


def test_apply_update_reads_nothing_on_the_host(case, monkeypatch):
    """apply_update keeps the guard, the lrs and Adam's count on the
    device: with every host read of a tensor made to raise, the first
    update (which makes Adam's state) runs through and moves the points."""
    params = convert.params_from_numpy(case["params"], device=DEV)
    state = tt.create_train_state(params, tt.make_optimizer(params, **_opt_kwargs()))
    grads = [torch.full_like(t, 0.1) for t in params.tensors()]
    start = params.points.detach().clone()

    def host_read(*_):
        raise AssertionError("apply_update read a tensor on the host")

    with monkeypatch.context() as m:
        for name in ("__bool__", "__int__", "__float__", "item"):
            m.setattr(torch.Tensor, name, host_read)
        state, metrics = tt.apply_update(state, grads, torch.zeros(()), {},
                                         state.filters)
    assert bool(metrics["params_finite"]) and state.step == 1
    assert not torch.equal(start, params.points.detach())


def test_two_train_steps_through_make_train_step(case):
    c = case
    params = convert.params_from_numpy(c["params"], device=DEV)
    state = tt.create_train_state(params, tt.make_optimizer(params, **_opt_kwargs()))
    step = tt.make_train_step(RasterSettings(**RASTER), tt.TrainConfig(**TRAIN),
                              tt.AnnealSchedule(**SCHED))
    start = params.points.detach().clone()
    args = (convert.cameras_from_numpy(c["cams"], device=DEV),
            convert.lights_from_numpy(LIGHTS, V, device=DEV), torch.tensor(c["img"]),
            torch.tensor(c["mask"]), torch.tensor(c["depth"]))
    for _ in range(2):
        state, m = step(state, *args)
        assert bool(m["params_finite"]) and np.isfinite(m["loss"].item())
        assert "bin_overflow" in m and int(m["bin_overflow"]) == 0
        assert set(PART_KEYS) <= set(m)
    assert state.step == 2
    assert not torch.equal(start, state.params.points.detach())
    assert bool(state.filters.visibility.any())


def test_flagship_values_match_the_yaml():
    """chip_smoke's flagship literals equal what dss_tpu.config builds from
    configs/dss_depth.yml with train_mvr's depth wiring."""
    cfg = jconfig.load_config("configs/dss_depth.yml")
    # train_mvr.py: lambda_dr_depth > 0 turns on the lean depth channel
    assert float(cfg["training"]["lambda_dr_depth"]) > 0
    cfg["renderer"]["raster_params"].setdefault("depth_channel", True)
    rs = jconfig.create_raster_settings(cfg)
    for k, v in chip_smoke.FLAGSHIP_RASTER.items():
        assert getattr(rs, k) == v, k
    assert rs.lean_fragments
    tc = jconfig.create_train_config(cfg)
    for k, v in chip_smoke.FLAGSHIP_TRAIN.items():
        assert getattr(tc, k) == v, k
    sc = jconfig.create_anneal_schedule(cfg)
    for k, v in chip_smoke.FLAGSHIP_SCHEDULE.items():
        assert getattr(sc, k) == v, k
    mk = cfg["model"]["model_kwargs"]
    assert int(mk["n_points_per_cloud"]) == chip_smoke.N_POINTS
    assert int(cfg["training"]["batch_size"]) == chip_smoke.N_VIEWS
    t = cfg["training"]
    o = chip_smoke.FLAGSHIP_OPT
    assert o["lr_points"] == float(t["lr_points"]) and mk["learn_points"]
    assert o["lr_normals"] == float(t["lr_normals"]) and mk["learn_normals"]
    assert o["lr_colors"] == 0.0 and not mk["learn_colors"]
    assert tuple(o["milestones"]) == tuple(t["scheduler_milestones"])
    assert o["gamma"] == float(t["scheduler_gamma"])


def test_params_from_a_dss_tpu_checkpoint(case, tmp_path):
    """convert.params_from_numpy reads the npz keys dss_tpu's CheckpointIO
    writes (params/points, …)."""
    from dss_tpu.training.checkpoint import CheckpointIO

    jstate = jt.create_train_state(JParams.create(**case["params"]),
                                   jt.make_optimizer())
    path = CheckpointIO(str(tmp_path)).save("model.npz", jstate, it=3)
    params = convert.params_from_numpy(np.load(path), device=DEV)
    for k, t in convert.params_to_numpy(params).items():
        np.testing.assert_array_equal(t, case["params"][k].astype(np.float32))
