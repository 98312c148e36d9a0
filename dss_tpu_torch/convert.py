"""Carry-over of weights and state between the JAX package and the port.

The port's objects are built from plain numpy: `params_from_numpy` takes
{"points", "normals", "colors"} or the npz keys of a JAX checkpoint
(`params/points`, … as dss_tpu/training/checkpoint.py writes them);
`cameras_from_numpy` and `lights_from_numpy` take the camera and light
fields; `decoder_state_from_flax` maps a flax decoder's parameter tree
(numpy leaves) onto the state dict of the port's module.  Tests feed both packages through these functions.  Each builds on
the card unless `device` says otherwise (utils/device.py: with no card and
no device it raises).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.models import decoders
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.lighting import DirectionalLights, PointLights

_PARAM_KEYS = ("points", "normals", "colors")


def _lookup(d: Mapping, name: str, prefix: str):
    for key in (name, f"{prefix}/{name}"):
        if key in d:
            return d[key]
    raise KeyError(f"neither {name!r} nor {prefix + '/' + name!r} in the input")


def params_from_numpy(d: Mapping, device=None,
                      requires_grad: bool = True) -> PointModelParams:
    """PointModelParams from numpy arrays (or a loaded JAX checkpoint)."""
    vals = [np.array(_lookup(d, k, "params"), np.float32) for k in _PARAM_KEYS]
    return PointModelParams.create(*vals, device=device,
                                   requires_grad=requires_grad)


def params_to_numpy(params: PointModelParams) -> dict:
    return {k: t.detach().cpu().numpy()
            for k, t in zip(_PARAM_KEYS, params.tensors())}


def cameras_from_numpy(d: Mapping, device=None) -> FoVPerspectiveCameras:
    """Cameras from R (V, 3, 3), T (V, 3) and the optional fov, znear,
    zfar, aspect_ratio (scalars or (V,))."""
    opt = {k: np.asarray(d[k], np.float32)
           for k in ("fov", "znear", "zfar", "aspect_ratio") if k in d}
    return FoVPerspectiveCameras.create(
        np.asarray(d["R"], np.float32), np.asarray(d["T"], np.float32),
        device=device, **opt,
    )


def lights_from_numpy(d: Mapping, n_views: int, device=None):
    """Directional lights (a `direction` key) or point lights (`location`)
    from per-view (V, L, 3) or shared (L, 3) / (3,) colour arrays."""
    kind, geo = ((DirectionalLights, "direction") if "direction" in d
                 else (PointLights, "location"))
    fields = ("ambient_color", "diffuse_color", "specular_color", geo)
    return kind.create(**{k: np.asarray(d[k], np.float32) for k in fields},
                       n_views=n_views, device=device)


def _flax_children(module: nn.Module):
    """(torch child name, flax submodule name) pairs of a decoder, in the
    order flax creates them (its names count per module type)."""
    if isinstance(module, decoders.SineLayer):
        return [("linear", "Dense_0")]
    if isinstance(module, decoders.Siren):
        n = len(module.net)
        last = ("Dense_0" if isinstance(module.last, nn.Linear)
                else f"SineLayer_{n}")
        return [(f"net.{i}", f"SineLayer_{i}") for i in range(n)] + [("last", last)]
    if isinstance(module, (decoders.SDF, decoders.RenderingNetwork)):
        return [(f"layers.{i}", f"WNDense_{i}") for i in range(len(module.layers))]
    if isinstance(module, decoders.ResnetBlockFC):
        pairs = [("fc_0", "Dense_0"), ("fc_1", "Dense_1")]
        return pairs + ([("shortcut", "Dense_2")] if module.shortcut is not None
                        else [])
    if isinstance(module, decoders.Occupancy):
        n_c = len(module.fc_c)
        return ([("fc_p", "Dense_0")]
                + [(f"fc_c.{i}", f"Dense_{1 + i}") for i in range(n_c)]
                + [(f"blocks.{i}", f"ResnetBlockFC_{i}")
                   for i in range(len(module.blocks))]
                + [("fc_out", f"Dense_{1 + n_c}")])
    if isinstance(module, decoders.ResidualSDF):
        return [("base", "SDF_0"), ("residual", "Siren_0")]
    raise TypeError(f"no flax layout for {type(module).__name__}")


def _decoder_leaves(module: nn.Module, tree: Mapping, prefix: str, out: dict):
    if isinstance(module, nn.Linear):
        out[prefix + "weight"] = np.asarray(tree["kernel"]).T
        if module.bias is not None:
            out[prefix + "bias"] = np.asarray(tree["bias"])
        return
    if isinstance(module, decoders.WNDense):
        out[prefix + "v"] = np.asarray(tree["v"]).T
        out[prefix + "g"] = np.asarray(tree["g"])
        out[prefix + "bias"] = np.asarray(tree["bias"])
        return
    for name, flax_name in _flax_children(module):
        _decoder_leaves(module.get_submodule(name), tree[flax_name],
                        prefix + name + ".", out)


def decoder_state_from_flax(module: nn.Module, flax_params: Mapping) -> dict:
    """The state dict of `module` (a dss_tpu_torch.models.decoders module)
    holding a flax decoder's weights: `flax_params` is the tree `init`
    returns (with or without its "params" level), leaves as numpy arrays.
    A Dense kernel (in, out) becomes a Linear weight (out, in); WNDense
    maps v (transposed), g and bias.  Load it with
    `module.load_state_dict(state, strict=True)`."""
    tree = flax_params.get("params", flax_params)
    leaves: dict = {}
    _decoder_leaves(module, tree, "", leaves)
    ref = module.state_dict()
    state = {}
    for k, v in leaves.items():
        if k not in ref or tuple(ref[k].shape) != v.shape:
            raise ValueError(f"{k}: flax {v.shape} does not fit the module's "
                             f"{None if k not in ref else tuple(ref[k].shape)}")
        state[k] = torch.tensor(np.ascontiguousarray(v), dtype=ref[k].dtype,
                                device=ref[k].device)
    return state
