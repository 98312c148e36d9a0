"""The port's entry points build on the card unless the caller names a
device, and never fall back to the CPU: without a card they raise."""
import dataclasses

import numpy as np
import pytest
import torch

from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.lighting import DirectionalLights, PointLights
from dss_tpu_torch.utils.device import resolve_device

DEV = torch.device("cpu")
_PTS = np.zeros((4, 3), np.float32)
_LIGHT = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3}
ENTRY_POINTS = {
    "PointModelParams.create": lambda **kw: PointModelParams.create(_PTS, **kw),
    "params_from_numpy": lambda **kw: convert.params_from_numpy(
        {"points": _PTS, "normals": _PTS, "colors": _PTS}, **kw),
    "FoVPerspectiveCameras.create": lambda **kw: FoVPerspectiveCameras.create(
        np.eye(3), np.zeros(3), **kw),
    "cameras_from_numpy": lambda **kw: convert.cameras_from_numpy(
        {"R": np.eye(3)[None], "T": np.zeros((1, 3)), "fov": 45.0}, **kw),
    "DirectionalLights.create": lambda **kw: DirectionalLights.create(
        n_views=2, **kw),
    "PointLights.create": lambda **kw: PointLights.create(n_views=2, **kw),
    "lights_from_numpy": lambda **kw: convert.lights_from_numpy(
        {**_LIGHT, "location": [0.0, 1.0, 0.0]}, 2, **kw),
    "PointFilters.ones": lambda **kw: PointFilters.ones(4, **kw),
}


def _tensors(obj):
    """Every tensor the object holds: its tensor fields, and the parameters
    of a module field (a point model's neural texture; None when it has
    none)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.nn.Module):
            out += list(v.parameters())
        elif v is not None:
            out.append(v)
    return out


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_builds_where_it_is_told(name):
    for t in _tensors(ENTRY_POINTS[name](device=DEV)):
        assert t.device == DEV


def test_no_device_means_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == DEV
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
