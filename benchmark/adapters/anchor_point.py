"""The adapter of upstream DSS's point model trained with the normal
term (`training.lambda_dr_normal` > 0, `normal_anchor` "pca" or "jet"):
the point model's leaves, objects and reference raster and recipe
(`dss_point.py`, loaded from beside this file), the reference's trainer
from `reference/anchor_step.py`, which adds the term.

The start normals are not the generator's radial ones: on the
generator's sphere those are almost exactly either anchor's own target,
so 1 - cos and its gradient would vanish and a program that skipped the
anchor would read the same.  A refine phase starts from a cloud whose
normal field lags its geometry, so each normal is tilted by a fixed,
smooth function of its point (`tilt`), with no random draw; the program
(`program_objects`) and the reference (`reference_trainer`) start from
the same tilted tensor.  The work tables (counts.py) read the point
model's: `REF` and `reference_objects` give the flagship's raster and
recipe, whose kNNs do not include the anchor's."""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch

from benchmark import program
from benchmark.harness import load_module

HERE = Path(__file__).resolve().parent
BASE = load_module(HERE / "dss_point.py")
REF = load_module(HERE.parent / "reference" / "anchor_step.py")
LEAVES, learn_flags, count_inputs = BASE.LEAVES, BASE.learn_flags, BASE.count_inputs

# The tilt: the angle it tends to as the tangential field grows, and the
# field's length at which it reaches 1/sqrt(2) of that
TILT_MAX_DEG = 50.0
TILT_EPS = 0.3


def tilt(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """The start normals: each unit normal n turned toward the tangential
    part t of the field g(x) = (sin(8 x_1 + 1), sin(8 x_2 + 2),
    sin(8 x_0 + 3)) by the angle TILT_MAX_DEG * r / sqrt(r^2 + TILT_EPS^2),
    r = |t|: n + tan(angle) t / r, normalised.  On the generator's sphere
    of radius 0.5 the angle to the radial normal is 49.2 degrees at most
    and 1 - cos is 0.307 on average (2 * 10^5 points)."""
    x = points
    g = torch.stack([torch.sin(8.0 * x[:, 1] + 1.0),
                     torch.sin(8.0 * x[:, 2] + 2.0),
                     torch.sin(8.0 * x[:, 0] + 3.0)], dim=-1)
    t = g - torch.sum(g * normals, dim=-1, keepdim=True) * normals
    r = torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                    min=1e-12)
    angle = math.radians(TILT_MAX_DEG) * r / torch.sqrt(r * r + TILT_EPS ** 2)
    out = normals + torch.tan(angle) / r * t
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def start(data: dict) -> dict:
    """The data with the tilted start normals in place of the generator's
    (a new dict; the data is not changed)."""
    leaves = dict(data["leaves"])
    leaves["normals"] = tilt(leaves["points"], leaves["normals"])
    return {**data, "leaves": leaves}


def anchor_of(cell):
    """The normal term of the cell's configuration, as the program's
    config reads it (`dss_tpu_torch.config.create_train_config`) and the
    loss calls `refine_normals` (its defaults past k)."""
    t = program.run_config(cell)["training"]
    return REF.Anchor(weight=float(t.get("lambda_dr_normal", 0.0)),
                      kind=str(t.get("normal_anchor", "pca")),
                      k=int(t.get("normal_anchor_k", 8)))


def program_objects(cell, data: dict, device):
    """The point model's objects (dss_point.py) from the tilted start."""
    return BASE.program_objects(cell, start(data), device)


def without_normal_term(cell):
    """The cell with its configuration's normal term taken out."""
    cfg = dict(cell.config)
    cfg["training"] = {**cfg["training"], "lambda_dr_normal": 0.0}
    return dataclasses.replace(cell, config=cfg)


def reference_objects(cell, data: dict):
    """(raster, recipe, cameras, lights) of the reference: the point
    model's, read from the configuration without its normal term (which
    `anchor_of` reads)."""
    return BASE.reference_objects(without_normal_term(cell), data)


def reference_trainer(cell, data: dict, betas=None):
    """(trainer, cameras, lights): the reference's trainer at the start
    step, from the tilted start and the data's Adam state; `betas` in
    place of the configuration's where given (a fault for the control)."""
    raster, recipe, cams, lights = reference_objects(cell, data)
    if betas is not None:
        recipe = dataclasses.replace(recipe, betas=tuple(betas))
    points, normals, colors = (start(data)["leaves"][n] for n in LEAVES)
    act = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    s0 = int(cell.workload["start_step"])
    tr = REF.AnchorTrainer(raster, recipe, anchor_of(cell), points, normals,
                           colors, act, s0, data["moments"], s0)
    return tr, cams, lights
