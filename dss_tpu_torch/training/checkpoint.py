"""Checkpoint / resume (counterpart of dss_tpu/training/checkpoint.py).

A checkpoint is one `.npz`, written atomically, in the JAX package's key
layout, so that a run resumes from it in either package:

    params/{points,normals,colors}                          (P, 3) f32
    opt_state/inner_states/<g>/inner_state/0/count          () int32
    opt_state/inner_states/<g>/inner_state/0/mu/<g>         (P, 3) f32
    opt_state/inner_states/<g>/inner_state/0/nu/<g>         (P, 3) f32
    opt_state/inner_states/<g>/inner_state/1/count          () int32
    filters/{activation,visibility,inmask}                  (P,) bool
    step                                                    () int32
    __scalar__/<name>                                       the run's scalars

with <g> each of points, normals, colors.  A neural texture's leaves
(`PointModelParams.names()`: texture.decoder.layers.<i>.{v,g,bias}) add
`params/<name>` and their Adam state under <g> = <name>; the JAX package
has no such keys.  Adam's `step`, `exp_avg` and
`exp_avg_sq` are optax's `count`, `mu` and `nu` (zeros and count 0 before
the first update).  `.../1/count` is the learning-rate schedule's count,
written only when the group has milestones: both counts advance on applied
updates only, as `step` does under `trainer.guarded_adam_`'s guard.
`step` is TrainState.step, which counts skipped steps too.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from dss_tpu_torch import convert
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.training.trainer import TrainState

_GROUP = "opt_state/inner_states/{g}/inner_state/"
_FILTERS = ("activation", "visibility", "inmask")


def _texture_leaves(params):
    """(name, tensor) of the neural texture's leaves, none without one."""
    return list(zip(params.names(), params.tensors()))[3:]


def _state_to_numpy(state: TrainState) -> Dict[str, np.ndarray]:
    """The train state as the JAX package's flattened npz keys."""
    flat = {f"params/{k}": v
            for k, v in convert.params_to_numpy(state.params).items()}
    for name, t in _texture_leaves(state.params):
        flat[f"params/{name}"] = t.detach().cpu().numpy()
    for group in state.optimizer.param_groups:
        g, t = group["name"], group["params"][0]
        st = state.optimizer.state.get(t, {})
        count = np.int32(int(st["step"]) if "step" in st else 0)
        moment = lambda k: (st[k].detach().cpu().numpy() if k in st
                            else np.zeros(t.shape, np.float32))
        pre = _GROUP.format(g=g)
        flat[pre + "0/count"] = count
        flat[pre + f"0/mu/{g}"] = moment("exp_avg")
        flat[pre + f"0/nu/{g}"] = moment("exp_avg_sq")
        if group["milestones"]:
            flat[pre + "1/count"] = count
    for k in _FILTERS:
        flat[f"filters/{k}"] = getattr(state.filters, k).cpu().numpy()
    flat["step"] = np.int32(state.step)
    return flat


def _load_state_numpy(state: TrainState, flat) -> list:
    """Restore what `flat` holds into `state` in place (partial restore:
    the parameters take the checkpoint's shapes; a missing key keeps the
    state's value).  Returns the missing keys."""
    missing = []

    def present(keys):
        absent = [k for k in keys if k not in flat]
        missing.extend(absent)
        return not absent

    if present([f"params/{k}" for k in ("points", "normals", "colors")]):
        loaded = convert.params_from_numpy(flat, device=state.params.points.device)
        with torch.no_grad():
            for t, src in zip(state.params.tensors(), loaded.tensors()):
                t.data = src.detach()
    for name, t in _texture_leaves(state.params):
        if present([f"params/{name}"]):
            src = np.asarray(flat[f"params/{name}"], np.float32)
            if src.shape != tuple(t.shape):
                raise ValueError(f"params/{name}: {src.shape} in the "
                                 f"checkpoint, {tuple(t.shape)} in the model")
            t.data = torch.as_tensor(src, device=t.device)
    opt = state.optimizer
    for group in opt.param_groups:
        g, t = group["name"], group["params"][0]
        pre = _GROUP.format(g=g)
        keys = (pre + "0/count", pre + f"0/mu/{g}", pre + f"0/nu/{g}")
        if not present(keys):
            continue
        count = int(flat[keys[0]])
        opt.state.pop(t, None)
        if count > 0:
            f = lambda k: torch.as_tensor(np.asarray(flat[k], np.float32),
                                          device=t.device)
            opt.state[t] = {"step": torch.tensor(float(count)),
                            "exp_avg": f(keys[1]), "exp_avg_sq": f(keys[2])}
    if present([f"filters/{k}" for k in _FILTERS]):
        dev = state.params.points.device
        state.filters = PointFilters(**{
            k: torch.as_tensor(np.asarray(flat[f"filters/{k}"], bool), device=dev)
            for k in _FILTERS})
    if present(["step"]):
        state.step = int(flat["step"])
    return missing


class CheckpointIO:
    """Save/load a TrainState + scalars to `<out_dir>/<name>.npz`."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def save(self, filename: str, state: TrainState, **scalars) -> str:
        path = os.path.join(self.out_dir, filename)
        flat = _state_to_numpy(state)
        for k, v in scalars.items():
            flat["__scalar__/" + k] = np.asarray(v)
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".tmp")
        os.close(fd)
        try:
            np.savez(tmp, **flat)
            # np.savez appends .npz to the filename it opens
            os.replace(tmp + ".npz", path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def load(self, filename: str, state: TrainState):
        """Restore into `state` (in place; keys the file lacks keep the
        state's value).  Returns (state, scalars dict)."""
        path = os.path.join(self.out_dir, filename)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        scalars = {k.split("/", 1)[1]: v.item()
                   for k, v in flat.items() if k.startswith("__scalar__/")}
        missing = _load_state_numpy(state, flat)
        if missing:
            print("CheckpointIO: missing keys kept from the state:", missing[:8])
        return state, scalars

    def backup_best(self, filename: str) -> Optional[str]:
        """Timestamped copy of a checkpoint."""
        src = os.path.join(self.out_dir, filename)
        if not os.path.exists(src):
            return None
        ts = time.strftime("%Y%m%d%H%M%S")
        dst = os.path.join(self.out_dir, f"backup_{ts}_{filename}")
        shutil.copyfile(src, dst)
        return dst
