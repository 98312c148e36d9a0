"""Multi-light Lambert/Phong shading (counterpart of dss_tpu/render/lighting.py).

A light container holds L lights per view with a written-out leading view
axis: every field is (V, L, 3).  `shade_points` shades one shared cloud
for all V views at once.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import normalize


def _as_lights(v, n_views, device):
    """(V, L, 3) from a per-view, shared or single colour or vector; on
    the card unless `device` says otherwise (resolve_device)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=resolve_device(device))
    t = torch.atleast_2d(t)
    if t.ndim == 2:
        t = t[None]
    return torch.broadcast_to(t, (n_views,) + t.shape[1:]).clone()


@dataclasses.dataclass
class DirectionalLights:
    """L directional lights per view: colours and directions toward the
    light, each (V, L, 3)."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    direction: torch.Tensor

    @classmethod
    def create(cls, ambient_color=(0.5, 0.5, 0.5), diffuse_color=(0.3, 0.3, 0.3),
               specular_color=(0.2, 0.2, 0.2), direction=(0.0, 1.0, 0.0),
               n_views: int = 1, device=None) -> "DirectionalLights":
        f = lambda v: _as_lights(v, n_views, device)
        return cls(f(ambient_color), f(diffuse_color), f(specular_color),
                   f(direction))

    def light_directions(self, points: torch.Tensor) -> torch.Tensor:
        """(V, P, L, 3) unit directions toward each light."""
        d = normalize(self.direction, eps=1e-6)  # (V, L, 3)
        v, l_ = d.shape[:2]
        return torch.broadcast_to(d[:, None], (v, points.shape[0], l_, 3))


@dataclasses.dataclass
class PointLights:
    """L point lights per view: colours and world locations, each (V, L, 3)."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    location: torch.Tensor

    @classmethod
    def create(cls, ambient_color=(0.5, 0.5, 0.5), diffuse_color=(0.3, 0.3, 0.3),
               specular_color=(0.2, 0.2, 0.2), location=(0.0, 1.0, 0.0),
               n_views: int = 1, device=None) -> "PointLights":
        f = lambda v: _as_lights(v, n_views, device)
        return cls(f(ambient_color), f(diffuse_color), f(specular_color),
                   f(location))

    def light_directions(self, points: torch.Tensor) -> torch.Tensor:
        """(V, P, L, 3): direction from each point toward each light."""
        return normalize(
            self.location[:, None, :, :] - points[None, :, None, :], eps=1e-6
        )


Lights = Union[DirectionalLights, PointLights]


def apply_lighting(points, normals, lights: Lights, camera_position,
                   shininess: float = 64.0):
    """(ambient (V, 3), diffuse (V, P, 3), specular (V, P, 3)) for V views;
    points/normals (P, 3), camera_position (V, 3)."""
    n = normalize(normals, eps=1e-6)
    d = lights.light_directions(points)  # (V, P, L, 3)

    cos = torch.einsum("pi,vpli->vpl", n, d)
    zero = torch.zeros((), device=cos.device)
    # torch.maximum, not clamp: at a tie both split the gradient in half,
    # as jnp.maximum does (face normals of a mesh can give cos = 0 exactly)
    angle = torch.maximum(cos, zero)
    diffuse = torch.einsum("vli,vpl->vpi", lights.diffuse_color, angle)

    # Phong specular: reflect = −d + 2·cos·n; alpha = relu(view·reflect)
    # gated by cos > 0.
    view_dir = normalize(camera_position[:, None, :] - points[None], eps=1e-6)
    reflect = -d + 2.0 * cos[..., None] * n[None, :, None, :]
    alpha = torch.maximum(torch.einsum("vpi,vpli->vpl", view_dir, reflect),
                          zero)
    alpha = alpha * (cos > 0.0)
    specular = torch.einsum("vli,vpl->vpi", lights.specular_color,
                            alpha ** shininess)
    ambient = torch.sum(lights.ambient_color, dim=1)  # (V, 3)
    return ambient, diffuse, specular


def shade_points(points, normals, rgb, lights: Lights, camera_position,
                 shininess: float = 64.0) -> torch.Tensor:
    """LightingTexture: shaded = rgb·(ambient + diffuse) + specular, (V, P, 3)."""
    ambient, diffuse, specular = apply_lighting(
        points, normals, lights, camera_position, shininess
    )
    return rgb[None] * (ambient[:, None, :] + diffuse) + specular
