"""The default adapter: upstream DSS's point model, whose leaves are the
generator's points, normals and colours.  The program's objects come from
its public factories (`dss_tpu_torch.config`, the camera, light and
parameter constructors); the reference is `reference/dss_step.py`, loaded
from beside this file's folder, so that a copy of the benchmark runs its
own."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from benchmark import program
from benchmark.harness import load_module

REF = load_module(Path(__file__).resolve().parents[1] / "reference"
                  / "dss_step.py")
LEAVES = ("points", "normals", "colors")


def learn_flags(cfg: dict) -> dict:
    mk = cfg["model"]["model_kwargs"]
    return {name: bool(mk.get("learn_" + name, default))
            for name, default in (("points", True), ("normals", True),
                                  ("colors", False))}


def program_objects(cell, data: dict, device):
    """(settings, train config, schedule, state, cameras, lights) of the
    program, its optimizer holding the data's Adam state after the start
    step's count of updates (the caller sets the state's step)."""
    from dss_tpu_torch import config as cm
    from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.render.lighting import PointLights
    from dss_tpu_torch.training.trainer import create_train_state

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
    state = create_train_state(params, optimizer)
    cams = FoVPerspectiveCameras.create(
        data["R"], data["T"], fov=data["fov"], znear=data["znear"],
        zfar=data["zfar"], device=device)
    lights = PointLights.create(n_views=data["R"].shape[0], device=device,
                                **data["lights"])
    return (cm.create_raster_settings(cfg), cm.create_train_config(cfg),
            cm.create_anneal_schedule(cfg), state, cams, lights)


def reference_objects(cell, data: dict):
    """(raster, recipe, cameras, lights) of the reference, read from the
    same configuration with the program's defaults where a key is absent
    (the frozen configuration files hold every key)."""
    cfg = program.run_config(cell)
    rp, t = cfg["renderer"]["raster_params"], cfg["training"]
    if float(t.get("lambda_dr_normal", 0.0)) > 0 or int(t.get("steps_proj", -1)) > 0:
        raise NotImplementedError("the reference runs no normal anchor and "
                                  "no projection anneal")
    raster = REF.Raster(
        image_size=int(rp["image_size"]),
        points_per_pixel=int(rp["points_per_pixel"]),
        cutoff_threshold=float(rp["cutoff_threshold"]),
        depth_merging_threshold=float(rp["depth_merging_threshold"]),
        antialiasing_sigma=float(rp["antialiasing_sigma"]),
        Vrk_invariant=bool(rp["Vrk_invariant"]),
        Vrk_isotropic=bool(rp["Vrk_isotropic"]),
        backface_culling=bool(rp["backface_culling"]),
        clip_pts_grad=float(rp["clip_pts_grad"]),
        depth_from_fragments=not bool(rp.get("depth_channel", False)),
    )
    flags = learn_flags(cfg)
    spe = program.steps_per_epoch(cell)
    recipe = REF.Recipe(
        lambda_rgb=float(t["lambda_dr_rgb"]),
        lambda_silhouette=float(t["lambda_dr_silhouette"]),
        lambda_proj=float(t["lambda_dr_proj"]),
        lambda_repel=float(t["lambda_dr_repel"]),
        lambda_depth=float(t["lambda_dr_depth"]),
        knn_k=int(t["knn_k"]),
        filter_scale=float(t["filter_scale"]),
        sharpness_sigma=float(t["sharpness_sigma"]),
        init_radii=float(rp["radii_backward_scaler"]),
        steps_radii=int(t["steps_dss_backward_radii"]),
        gamma_radii=float(t["gamma_dss_backward_radii"]),
        limit_radii=float(t["limit_dss_backward_radii"]),
        lr=tuple(float(t["lr_" + n]) if flags[n] else 0.0 for n in LEAVES),
        milestones=tuple(int(m) * spe for m in t["scheduler_milestones"]),
        lr_gamma=float(t["scheduler_gamma"]),
    )
    n = data["R"].shape[0]
    full = lambda x: torch.full((n,), x, device=data["R"].device)
    cams = REF.Cameras(data["R"], data["T"], full(data["fov"]),
                       full(data["znear"]), full(data["zfar"]))
    lights = REF.PointLights(**data["lights"])
    return raster, recipe, cams, lights


def reference_trainer(cell, data: dict, betas=None):
    """(trainer, cameras, lights): the reference's trainer at the start
    step, from the data's leaves and Adam state; `betas` in place of the
    configuration's where given (a fault for the control)."""
    raster, recipe, cams, lights = reference_objects(cell, data)
    if betas is not None:
        recipe = dataclasses.replace(recipe, betas=tuple(betas))
    points, normals, colors = (data["leaves"][n] for n in LEAVES)
    act = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    s0 = int(cell.workload["start_step"])
    tr = REF.ReferenceTrainer(raster, recipe, points, normals, colors, act,
                              s0, data["moments"], s0)
    return tr, cams, lights


def count_inputs(state):
    """The program's points, normals and activation, copied: what the
    work counts (counts.py) read before a step."""
    p = state.params
    return (p.points.detach().clone(), p.normals.detach().clone(),
            state.filters.activation.clone())
