"""Point texture functions: fixed lighting or a neural texture
(counterpart of dss_tpu/render/texture.py).

Reference: DSS/core/texture.py — `LightingTexture` (74-127, the renderer's
default shading through `render.lighting.shade_points`) and `NeuralTexture`
(130-162): a decoder MLP over (normals, points [, encoded view dirs]) gives
each point's rgb.

A texture is a callable (points (P, 3), normals (P, 3), cameras) →
(V, P, 3) colours for all V views of the camera batch at once, passed to
the renderer as `texture_fn`.  dss_tpu vmaps a per-view (P, 3) texture
over the views; here the neural texture builds (V, P, F) features and
calls its decoder once over V·P rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.models.decoders import neural_texture_features
from dss_tpu_torch.render.lighting import Lights, shade_points

TextureFn = Callable[[torch.Tensor, torch.Tensor, FoVPerspectiveCameras],
                     torch.Tensor]


def make_lighting_texture(lights: Lights, albedo: Optional[torch.Tensor] = None,
                          shininess: float = 64.0) -> TextureFn:
    """LightingTexture with fixed lights (one per view of the cameras it is
    called with): rgb·(ambient + diffuse) + specular."""

    def fn(points, normals, cameras):
        rgb = albedo if albedo is not None else torch.ones_like(points)
        return shade_points(points, normals, rgb, lights,
                            cameras.camera_position(), shininess)

    return fn


def make_neural_texture(decoder: nn.Module, view_dependent: bool = True,
                        view_freqs: int = 4) -> TextureFn:
    """NeuralTexture: colours = decoder(normals ‖ points [‖ PE(view dir)])
    ["rgb"], one decoder call for every view (reference texture.py:
    130-162).  Without view dependence the P colours are shared by the
    views."""

    def fn(points, normals, cameras):
        v, p = len(cameras), points.shape[0]
        if not view_dependent:
            rgb = decoder(neural_texture_features(points, normals))["rgb"]
            return torch.broadcast_to(rgb[None], (v, p, rgb.shape[-1]))
        x = neural_texture_features(points, normals, cameras.camera_position(),
                                    view_freqs)
        return decoder(x.reshape(v * p, -1))["rgb"].reshape(v, p, -1)

    return fn
