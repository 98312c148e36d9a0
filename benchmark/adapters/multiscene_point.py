"""The adapter of S independent scenes of upstream DSS's point model,
trained at once (`model.model_kwargs.n_scenes` = S): the data stacks the
scenes along a leading axis (`generate.make_scenes`), the program trains
stacked (S, P, 3) leaves with one optimizer and takes S camera batches
and S light batches (`trainer.make_stacked_loss_fn`), and the reference is
`reference/multiscene_step.py`, S of `dss_step.py`'s trainers stepped as
one.  Each scene's raster, recipe, cameras and lights are the point
model's (`dss_point.py`, loaded from beside this file) on that scene's
slice of the data."""
from __future__ import annotations

from pathlib import Path

import torch

from benchmark import program
from benchmark.harness import load_module, scenes

HERE = Path(__file__).resolve().parent
BASE = load_module(HERE / "dss_point.py")
REF = load_module(HERE.parent / "reference" / "multiscene_step.py")
LEAVES, learn_flags, count_inputs = BASE.LEAVES, BASE.learn_flags, BASE.count_inputs


def scene(data: dict, s: int) -> dict:
    """Scene s of stacked data, as the single-scene data of the seed
    `generate.scene_seed` gives it (the shared epochs included)."""
    out = {k: v for k, v in data.items() if k != "n_scenes"}
    for key in ("R", "T", "img", "mask", "depth"):
        out[key] = None if data[key] is None else data[key][s]
    out["lights"] = {k: v[s] for k, v in data["lights"].items()}
    out["leaves"] = {k: v[s] for k, v in data["leaves"].items()}
    if data["moments"] is not None:
        out["moments"] = [(m[s], v[s]) for m, v in data["moments"]]
    return out


def program_objects(cell, data: dict, device):
    """(settings, train config, schedule, state, cameras, lights) of the
    program: the stacked leaves in one optimizer holding the data's
    stacked Adam state after the start step's count of updates, (S, P)
    filters, and S camera and S light batches of the scenes' N views
    (the caller sets the state's step)."""
    from dss_tpu_torch import config as cm
    from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.render.lighting import PointLights
    from dss_tpu_torch.training.trainer import TrainState

    cfg = program.run_config(cell)
    params = PointModelParams.create(*(data["leaves"][n] for n in LEAVES),
                                     device=device)
    optimizer = cm.create_optimizer(cfg, params, learn_flags(cfg),
                                    steps_per_epoch=program.steps_per_epoch(cell))
    s0 = int(cell.workload["start_step"])
    for t, (m, v) in zip(params.tensors(), data["moments"]):
        # torch's own layout of Adam's state: the count a float32 on the host
        optimizer.state[t] = {"step": torch.tensor(float(s0)),
                              "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    ones = torch.ones(params.points.shape[:2], dtype=torch.bool,
                      device=device)
    state = TrainState(params, optimizer,
                       PointFilters(ones, ones.clone(), ones.clone()))
    n = scenes(data)
    cams = [FoVPerspectiveCameras.create(
        data["R"][s], data["T"][s], fov=data["fov"], znear=data["znear"],
        zfar=data["zfar"], device=device) for s in range(n)]
    lights = [PointLights.create(n_views=data["R"].shape[1], device=device,
                                 **{k: v[s] for k, v in data["lights"].items()})
              for s in range(n)]
    return (cm.create_raster_settings(cfg), cm.create_train_config(cfg),
            cm.create_anneal_schedule(cfg), state, cams, lights)


def reference_objects(cell, data: dict):
    """(raster, recipe, cameras, lights) of the reference: the point
    model's raster and recipe, and S camera and S light batches
    (`REF.Scenes`)."""
    per = [BASE.reference_objects(cell, scene(data, s))
           for s in range(scenes(data))]
    raster, recipe = per[0][:2]
    return (raster, recipe, REF.Scenes(p[2] for p in per),
            REF.Scenes(p[3] for p in per))


def reference_trainer(cell, data: dict, betas=None):
    """(trainer, cameras, lights): the reference's trainer of the S scenes
    at the start step, each scene's from its slice of the leaves and of
    Adam's state; `betas` in place of the configuration's where given (a
    fault for the control)."""
    per = [BASE.reference_trainer(cell, scene(data, s), betas)
           for s in range(scenes(data))]
    return (REF.MultiSceneTrainer(p[0] for p in per),
            REF.Scenes(p[1] for p in per), REF.Scenes(p[2] for p in per))
