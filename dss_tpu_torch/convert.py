"""Carry-over of weights and state between the JAX package and the port.

The port's objects are built from plain numpy: `params_from_numpy` takes
{"points", "normals", "colors"} or the npz keys of a JAX checkpoint
(`params/points`, … as dss_tpu/training/checkpoint.py writes them);
`cameras_from_numpy` and `lights_from_numpy` take the camera and light
fields.  Tests feed both packages through these functions.  Each builds on
the card unless `device` says otherwise (utils/device.py: with no card and
no device it raises).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
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
