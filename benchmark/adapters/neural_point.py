"""The adapter of upstream DSS's point model shaded by its neural texture
(`renderer.is_neural_texture`): the leaves are the generator's points,
normals and colours, then the decoder's, v, g and bias of each of its
weight-normed layers, first to last, named as the program names them
(`texture.decoder.layers.<i>.<v|g|bias>`).  The decoder's leaves are drawn
from the seed's generator after everything else, so that the other leaves
and the data are bit-equal to the point model's.  The program's objects
come from its public factories (`dss_tpu_torch.config`, the camera, light
and parameter constructors); the reference is `reference/neural_step.py`,
loaded from beside this file's folder.  What the point model's adapter
already does (the learn flags, the reference's raster and recipe) is
taken from it."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from benchmark import program
from benchmark.harness import load_module

HERE = Path(__file__).resolve().parent
BASE = load_module(HERE / "dss_point.py")
REF = load_module(HERE.parent / "reference" / "neural_step.py")
# each layer's input width, then the output width, as the program's
# factory reads them from the configuration
widths = load_module(HERE.parent / "roofline" / "texture_mlp.py").widths
LEAVES = BASE.LEAVES
count_inputs = BASE.count_inputs


def leaf_names(cfg: dict) -> list:
    n = len(widths(cfg)) - 1
    return [f"texture.decoder.layers.{i}.{k}" for i in range(n)
            for k in REF.LAYER_LEAVES]


def _require_texture():
    """The program's factory of the neural texture, or a clear failure."""
    from dss_tpu_torch import config as cm

    if not hasattr(cm, "create_texture"):
        raise RuntimeError(
            "the program has no neural texture on its train path "
            "(dss_tpu_torch.config.create_texture is missing): it cannot "
            "run a configuration with renderer.is_neural_texture")
    return cm


def extra_leaves(config: dict, g: torch.Generator, device):
    """The decoder's leaves drawn from g: v ~ N(0, 1/in) per (out, in)
    weight, g = |v| per output unit (so w = v, as the decoder's own init
    sets it), bias 0."""
    _require_texture()
    w, names = widths(config), leaf_names(config)
    out = []
    for i, (a, b) in enumerate(zip(w[:-1], w[1:])):
        name_v, name_g, name_b = names[3 * i:3 * i + 3]
        v = torch.randn((b, a), generator=g, device=device) / a ** 0.5
        out += [(name_v, v),
                (name_g, torch.linalg.vector_norm(v, dim=1) + 1e-12),
                (name_b, torch.zeros((b,), device=device))]
    return out


def learn_flags(cfg: dict) -> dict:
    return {**BASE.learn_flags(cfg), "texture": True}


def program_objects(cell, data: dict, device):
    """(settings, train config, schedule, state, cameras, lights) of the
    program, its decoder holding the data's decoder leaves and its
    optimizer the data's Adam state after the start step's count of
    updates (the caller sets the state's step)."""
    cm = _require_texture()
    from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.render.lighting import PointLights
    from dss_tpu_torch.training.trainer import create_train_state

    cfg = program.run_config(cell)
    params = PointModelParams.create(
        *(data["leaves"][n] for n in LEAVES), device=device,
        texture=cm.create_texture(cfg, device=device))
    if list(params.names()) != list(data["leaves"]):
        raise ValueError(f"the program's leaves {list(params.names())} are "
                         f"not the data's {list(data['leaves'])}")
    with torch.no_grad():
        for name, t in zip(params.names(), params.tensors()):
            t.copy_(data["leaves"][name])
    optimizer = cm.create_optimizer(cfg, params, learn_flags(cfg),
                                    steps_per_epoch=program.steps_per_epoch(cell))
    s0 = int(cell.workload["start_step"])
    for t, (m, v) in zip(params.tensors(), data["moments"]):
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
    """(raster, recipe, cameras, lights) of the reference: the point
    model's, with the decoder's leaves at `training.lr_texture`."""
    raster, recipe, cams, lights = BASE.reference_objects(cell, data)
    cfg = program.run_config(cell)
    lr_texture = float(cfg["training"]["lr_texture"])
    recipe = dataclasses.replace(
        recipe, lr=recipe.lr + (lr_texture,) * len(leaf_names(cfg)))
    return raster, recipe, cams, lights


def reference_trainer(cell, data: dict, betas=None):
    """(trainer, cameras, lights): the reference's trainer at the start
    step, from the data's leaves and Adam state; `betas` in place of the
    configuration's where given (a fault for the control)."""
    raster, recipe, cams, lights = reference_objects(cell, data)
    if betas is not None:
        recipe = dataclasses.replace(recipe, betas=tuple(betas))
    cfg = program.run_config(cell)
    tk = cfg["renderer"]["texture_kwargs"]
    points, normals, colors = (data["leaves"][n] for n in LEAVES)
    decoder = [data["leaves"][n] for n in leaf_names(cfg)]
    act = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    s0 = int(cell.workload["start_step"])
    tr = REF.NeuralTrainer(raster, recipe, points, normals, colors, decoder,
                           act, s0, data["moments"], s0,
                           view_dependent=bool(tk["view_dependent"]),
                           view_freqs=int(tk["view_freqs"]))
    return tr, cams, lights
