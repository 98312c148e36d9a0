"""Upstream's neural texture on the port's train path (`configs/dss_neural.yml`
cut to 32², 300 points, 2 of 4 views per step, a decoder of width 32):
the program's loss, every leaf's gradient and its parameters after three
steps, by the eager step and by the train window (its CPU path), against
the plain reference of the benchmark (`benchmark/reference/neural_step.py`,
loaded by path; it imports nothing of the program), from the same leaves,
decoder weights and Adam state; the config factories with the texture on
and off; a checkpoint round trip with the decoder's leaves; and
`train_mvr` on the cut-down config.

Tolerances, from what was measured on the CPU when this test was written
(both sides run the same float32 operations in another order):
- the first step's loss is bit-equal; held at rtol 1e-6;
- every leaf's gradient lies within 2.3e-7 of the leaf's largest entry
  (points), the decoder's within 1.7e-7; held at 2e-6 of it, ten times
  the largest, as the point gradients of the lean path against its own
  reference backend are held (test_torch_lean_colour_gradient.py);
- after three steps every leaf's change from the start lies within
  2.6e-6 of the largest change of that leaf (points), the decoder's within
  1e-6; held at 1e-4 of it: Adam divides each gradient by its running
  scale, which magnifies the gradients' round-off where they are small.
"""
import copy
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark import generate
from dss_tpu_torch import config as cm
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as train_main
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.lighting import PointLights
from dss_tpu_torch.training import trainer as tt
from dss_tpu_torch.training.checkpoint import CheckpointIO

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DEV = "cpu"
S, P, V, B, WIDTH = 32, 300, 4, 2, 32
START = 3200  # the benchmark cell's start step: the anneal's floor
VIEWS = (torch.tensor([0, 1]), torch.tensor([2, 3]))  # one epoch's rows
LEARN = {"points": True, "normals": True, "colors": False, "texture": True}
GRAD_TOL, CHANGE_TOL = 2e-6, 1e-4


def _load(path: Path):
    """The reference module, by path, kept in sys.modules (its dataclasses
    need it there)."""
    name = "neural_step_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


REF = _load(ROOT / "benchmark" / "reference" / "neural_step.py")


def _config():
    cfg = cm.load_config(str(ROOT / "configs" / "dss_neural.yml"))
    cfg["renderer"]["raster_params"].update(image_size=S, tile_size=16,
                                            depth_channel=True)
    cfg["renderer"]["texture_kwargs"]["hidden_size"] = WIDTH
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = P
    cfg["training"]["batch_size"] = B
    return cfg


@pytest.fixture(scope="module")
def case():
    """Posed views of a seeded ellipsoid (the benchmark's generator), the
    start cloud, a decoder from a seed, and Adam's state at START drawn at
    the scale of the reference's first gradient of each leaf."""
    cfg = _config()
    ds = json.loads((ROOT / "benchmark" / "datasets" / "mvr128.json")
                    .read_text())
    data = generate.make(cfg, {**ds, "n_views": V}, 7, DEV, 1)
    texture = cm.create_texture(cfg, torch.Generator().manual_seed(3),
                                device=DEV)
    case = {"cfg": cfg, "data": data, "texture": texture}
    grads = _Reference(case, None).grads_of_step(0)
    gen = generate.generator(11, DEV)
    case["moments"] = [
        generate.adam_state(g.shape, float(g.pow(2).mean().sqrt()) + 1e-12,
                            gen, DEV) for g in grads]
    return case


def _params(case) -> PointModelParams:
    lv = case["data"]["leaves"]
    return PointModelParams.create(lv["points"], lv["normals"], lv["colors"],
                                   device=DEV,
                                   texture=copy.deepcopy(case["texture"]))


def _state(case):
    params = _params(case)
    opt = cm.create_optimizer(case["cfg"], params, LEARN,
                              steps_per_epoch=V // B)
    for t, (m, v) in zip(params.tensors(), case["moments"]):
        opt.state[t] = {"step": torch.tensor(float(START)),
                        "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    state = tt.create_train_state(params, opt)
    state.step = START
    return state


def _program_objects(case):
    cfg, d = case["cfg"], case["data"]
    cams = FoVPerspectiveCameras.create(d["R"], d["T"], fov=d["fov"],
                                        znear=d["znear"], zfar=d["zfar"],
                                        device=DEV)
    lights = PointLights.create(n_views=V, device=DEV, **d["lights"])
    return (cm.create_raster_settings(cfg), cm.create_train_config(cfg),
            cm.create_anneal_schedule(cfg), cams, lights)


class _Reference:
    """The reference's trainer on the case, stepped on VIEWS in turn."""

    def __init__(self, case, moments):
        cfg, d = case["cfg"], case["data"]
        rp, t = cfg["renderer"]["raster_params"], cfg["training"]
        raster = REF.Raster(
            image_size=S, points_per_pixel=int(rp["points_per_pixel"]),
            cutoff_threshold=float(rp["cutoff_threshold"]),
            depth_merging_threshold=float(rp["depth_merging_threshold"]),
            antialiasing_sigma=float(rp["antialiasing_sigma"]),
            Vrk_invariant=True, clip_pts_grad=float(rp["clip_pts_grad"]))
        decoder = [x.detach() for x in case["texture"].parameters()]
        recipe = REF.Recipe(
            lambda_rgb=1.0, lambda_silhouette=1.0,
            lambda_proj=float(t["lambda_dr_proj"]),
            lambda_repel=float(t["lambda_dr_repel"]),
            lambda_depth=float(t["lambda_dr_depth"]), knn_k=int(t["knn_k"]),
            filter_scale=float(t["filter_scale"]),
            sharpness_sigma=float(t["sharpness_sigma"]),
            init_radii=float(rp["radii_backward_scaler"]),
            steps_radii=int(t["steps_dss_backward_radii"]),
            gamma_radii=float(t["gamma_dss_backward_radii"]),
            limit_radii=float(t["limit_dss_backward_radii"]),
            lr=(float(t["lr_points"]), float(t["lr_normals"]), 0.0)
            + (float(t["lr_texture"]),) * len(decoder),
            milestones=tuple(int(m) * (V // B)
                             for m in t["scheduler_milestones"]),
            lr_gamma=float(t["scheduler_gamma"]))
        full = lambda x: torch.full((V,), x)
        self.cams = REF.Cameras(d["R"], d["T"], full(d["fov"]),
                                full(d["znear"]), full(d["zfar"]))
        self.lights = REF.PointLights(**d["lights"])
        self.data = d
        lv = d["leaves"]
        self.tr = REF.NeuralTrainer(
            raster, recipe, lv["points"], lv["normals"], lv["colors"],
            decoder, torch.ones(P, dtype=torch.bool), START, moments, START)

    def step(self, i):
        v = VIEWS[(START + i) % len(VIEWS)]
        d = self.data
        return self.tr.train_step(self.cams.take(v), self.lights.take(v),
                                  d["img"][v], d["mask"][v], d["depth"][v])

    def grads_of_step(self, i):
        self.step(i)
        return self.tr.grads


def _close(got, want, tol, what):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * scale, err_msg=what)


def test_neural_loss_and_every_leaf_gradient_match_the_reference(case):
    settings, tcfg, schedule, cams, lights = _program_objects(case)
    d, v = case["data"], VIEWS[START % len(VIEWS)]
    params = _params(case)
    total, _ = tt.make_loss_fn(settings, tcfg, schedule)(
        params, PointFilters.ones(P, device=DEV), tt.take_views(cams, v),
        tt.take_views(lights, v), d["img"][v], d["mask"][v], START,
        d["depth"][v])
    grads = torch.autograd.grad(total, params.tensors(), allow_unused=True)
    ref = _Reference(case, case["moments"])
    loss, _ = ref.step(0)
    np.testing.assert_allclose(float(total.detach()), loss, rtol=1e-6)
    names = params.names()
    assert len(names) == 3 + 3 * 5
    for name, g, want in zip(names, grads, ref.tr.grads):
        if name == "colors":  # the texture replaces the shade: not read
            assert g is None and float(want.abs().max()) == 0.0
            continue
        assert float(want.abs().max()) > 0, name
        _close(g, want, GRAD_TOL, name)


@pytest.mark.parametrize("path", ["window", "eager"])
def test_neural_steps_match_the_reference(case, path):
    """Three steps by TrainWindow (one call of k = 3) and by make_train_step
    (one call a step), each updating through guarded_adam_."""
    settings, tcfg, schedule, cams, lights = _program_objects(case)
    d = case["data"]
    state = _state(case)
    start = [t.detach().clone() for t in state.params.tensors()]
    if path == "window":
        window = tt.make_train_window(settings, tcfg, schedule, state, cams,
                                      lights, d["img"], d["mask"],
                                      d["depth"], graph=False)
        state, metrics = window(state, torch.stack(VIEWS), 3)
        assert bool(metrics["params_finite"])
    else:
        step = tt.make_train_step(settings, tcfg, schedule)
        for i in range(3):
            v = VIEWS[(START + i) % len(VIEWS)]
            state, _ = step(state, tt.take_views(cams, v),
                            tt.take_views(lights, v), d["img"][v],
                            d["mask"][v], d["depth"][v])
    ref = _Reference(case, case["moments"])
    for i in range(3):
        ref.step(i)
    for name, s, got, want in zip(state.params.names(), start,
                                  state.params.tensors(), ref.tr.params):
        if name == "colors":
            assert torch.equal(got.detach(), s) and torch.equal(want, s)
            continue
        assert float((want - s).abs().max()) > 0, name
        _close(got - s, want - s, CHANGE_TOL, name)
    for t in state.params.tensors()[3:]:
        st = state.optimizer.state[t]
        assert float(st["step"]) == START + 3


def test_factories_build_the_texture_only_when_asked():
    cfg = cm.load_config(str(ROOT / "configs" / "dss_neural.yml"))
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 40
    rng = np.random.default_rng(5)
    params, learn = cm.create_model_params(cfg, rng, device=DEV)
    shapes = [tuple(t.shape) for t in params.tensors()[3:]]
    assert shapes == [(512, 33), (512,), (512,)] + [
        (512, 512), (512,), (512,)] * 3 + [(3, 512), (3,), (3,)]
    assert learn["texture"] is True
    opt = cm.create_optimizer(cfg, params, learn, steps_per_epoch=16)
    assert [g["name"] for g in opt.param_groups] == list(params.names())
    assert all(g["lr"] == 1e-4 for g in opt.param_groups[3:])
    assert all(g["milestones"] == (8000, 12800) for g in opt.param_groups)
    # the weights follow the seed
    again, _ = cm.create_model_params(cfg, np.random.default_rng(5),
                                      device=DEV)
    for a, b in zip(params.tensors(), again.tensors()):
        assert torch.equal(a, b)

    off = cm.load_config(str(ROOT / "configs" / "dss_depth.yml"))
    off["model"]["model_kwargs"]["n_points_per_cloud"] = 40
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    plain, learn = cm.create_model_params(off, rng_a, device=DEV)
    assert plain.texture is None and set(learn) == {"points", "normals",
                                                    "colors"}
    assert params.names()[:3] == plain.names() == ("points", "normals",
                                                   "colors")
    opt = cm.create_optimizer(off, plain, learn, steps_per_epoch=16)
    assert [(g["name"], g["lr"]) for g in opt.param_groups] == [
        ("points", 0.01), ("normals", 0.01), ("colors", 0.0)]
    # texture off: the cloud draws as before and the seed's stream is left
    # as it was
    for a, b in zip(plain.tensors(), params.tensors()):
        assert torch.equal(a, b)
    cm.create_model_params(off, rng_b, device=DEV)
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


def test_stacked_and_view_parallel_paths_refuse_a_texture(case):
    from dss_tpu_torch.models.point_model import point_model_forward_stacked
    from dss_tpu_torch.parallel import mesh

    settings, tcfg, schedule, cams, lights = _program_objects(case)
    params = _params(case)
    with pytest.raises(ValueError, match="neural texture"):
        point_model_forward_stacked(params, None, [cams], None, settings)
    with pytest.raises(ValueError, match="neural texture"):
        tt.make_stacked_loss_fn(settings, tcfg, schedule)(
            params, None, [cams], None, None, None, 0)
    one = mesh.ViewMesh(group=None, size=1, index=0)  # no process group
    grad_fn = mesh.make_shardmap_grad_fn(settings, tcfg, schedule, one)
    with pytest.raises(ValueError, match="neural texture"):
        grad_fn(params, None, cams, lights, None, None, 0)


def test_checkpoint_round_trip_with_the_decoder_leaves(case, tmp_path):
    settings, tcfg, schedule, cams, lights = _program_objects(case)
    d = case["data"]
    state = _state(case)
    window = tt.make_train_window(settings, tcfg, schedule, state, cams,
                                  lights, d["img"], d["mask"], d["depth"],
                                  graph=False)
    state, _ = window(state, torch.stack(VIEWS), 2)
    io = CheckpointIO(str(tmp_path))
    io.save("model.npz", state, it=2)
    with np.load(tmp_path / "model.npz") as f:
        keys = set(f.files)
    for name in state.params.names():
        assert f"params/{name}" in keys
        assert (f"opt_state/inner_states/{name}/inner_state/0/mu/{name}"
                in keys)
    params = _params(case)
    fresh = tt.create_train_state(params, cm.create_optimizer(
        case["cfg"], params, LEARN, steps_per_epoch=V // B))
    assert not torch.equal(params.tensors()[3], state.params.tensors()[3])
    loaded, scalars = io.load("model.npz", fresh)
    assert scalars["it"] == 2 and loaded.step == state.step
    for name, a, b in zip(state.params.names(), state.params.tensors(),
                          loaded.params.tensors()):
        assert torch.equal(a.detach(), b.detach()), name
        sa, sb = state.optimizer.state[a], loaded.optimizer.state[b]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (name, k)
        assert float(sa["step"]) == float(sb["step"]) == START + 2


def test_train_mvr_trains_the_neural_recipe(tmp_path, caplog):
    """`train_mvr --config` on a cut-down configs/dss_neural.yml: the
    decoder's leaves move, are checkpointed and resume."""
    ds = tmp_path / "ds"
    make_tiny_dataset(str(ds), views=4, image_size=S, points=300, device=DEV)
    cfg = {
        "inherit_from": str(ROOT / "configs" / "dss_neural.yml"),
        "name": "neural", "data": {"data_dir": str(ds)},
        "model": {"model_kwargs": {"n_points_per_cloud": 200}},
        "renderer": {"raster_params": {"image_size": S, "tile_size": 16},
                     "texture_kwargs": {"hidden_size": WIDTH}},
        "training": {"out_dir": str(tmp_path / "exp"), "batch_size": 2,
                     "print_every": 2, "validate_every": 4,
                     "checkpoint_every": 4, "visualize_every": -1},
    }
    path = tmp_path / "neural.yml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--device", DEV, "--seed", "1"]
    state = train_main(args + ["--max-iters", "4"])
    assert state.params.texture is not None
    names = state.params.names()
    run = tmp_path / "exp" / "neural"
    with np.load(run / "model.npz") as f:
        first = {n: f[f"params/{n}"] for n in names}
    with caplog.at_level("INFO", logger="train_mvr"):
        state = train_main(args + ["--max-iters", "6"])
    assert "resumed from model.npz at it=4" in caplog.text
    with np.load(run / "model.npz") as f:
        for n in names[3:]:
            assert not np.array_equal(f[f"params/{n}"], first[n]), n
        assert int(f[f"opt_state/inner_states/{names[3]}/inner_state/0/"
                     "count"]) == 6
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
