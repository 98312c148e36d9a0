"""Fixed-capacity point clouds and point filters (counterpart of
dss_tpu/geometry/pointclouds.py).

One padded representation (P, ·) plus boolean masks, as in the JAX
package: every "filter" is a mask update, never a reallocation.
`PointFilters` holds three boolean masks AND-combined to select the active
subset of a cloud, as the reference's `PointCloudsFilters`:

- activation: point pruning state (maintained by the model);
- visibility: produced by the rasterizer forward pass;
- inmask: the point projects inside the GT mask (model forward).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import eps_denom


@dataclasses.dataclass
class PointClouds:
    """A single padded point cloud: points (P, 3), normals (P, 3, zeros if
    absent), features (P, C) (colours, ones if absent), mask (P,) bool,
    True for real points and False for padding."""

    points: torch.Tensor
    normals: torch.Tensor
    features: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def create(cls, points, normals=None, features=None, mask=None,
               capacity: Optional[int] = None, device=None) -> "PointClouds":
        """Pads to `capacity` rows (zeros, mask False) if it exceeds the
        point count.  On the card unless `device` says otherwise."""
        dev = resolve_device(device)
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        p = points.shape[0]
        cap = capacity or p
        as_f32 = lambda x, fill: (torch.full((p, 3), fill, device=dev)
                                  if x is None else
                                  torch.as_tensor(x, dtype=torch.float32,
                                                  device=dev))
        normals = as_f32(normals, 0.0)
        features = as_f32(features, 1.0)
        mask = (torch.ones((p,), dtype=torch.bool, device=dev) if mask is None
                else torch.as_tensor(mask, dtype=torch.bool, device=dev))
        if cap > p:
            pad = lambda x: torch.cat([x, x.new_zeros((cap - p,) + x.shape[1:])])
            points, normals, features, mask = map(
                pad, (points, normals, features, mask))
        return cls(points=points, normals=normals, features=features,
                   mask=mask)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def num_points(self) -> torch.Tensor:
        return torch.sum(self.mask)

    def masked_points(self, fill: float = 0.0) -> torch.Tensor:
        return torch.where(self.mask[:, None], self.points, fill)

    def normalize_to_sphere(
            self) -> Tuple["PointClouds", torch.Tensor, torch.Tensor]:
        """Centre on the valid points' mean and scale them into the unit
        sphere.  Returns (cloud, centre (3,), scale ()): x·scale + centre
        undoes it."""
        w = self.mask.to(torch.float32)[:, None]
        center = torch.sum(self.points * w, dim=0) / eps_denom(torch.sum(w))
        centered = (self.points - center) * w
        scale = eps_denom(torch.amax(torch.linalg.vector_norm(centered,
                                                              dim=-1)))
        return (dataclasses.replace(self, points=centered / scale), center,
                scale)

    def normalize_to_box(
            self) -> Tuple["PointClouds", torch.Tensor, torch.Tensor]:
        """Centre on the valid points' bounding-box centre and scale its
        longest side to 2.  Returns (cloud, centre (3,), scale ())."""
        m = self.mask[:, None]
        lo = torch.amin(torch.where(m, self.points, torch.inf), dim=0)
        hi = torch.amax(torch.where(m, self.points, -torch.inf), dim=0)
        center = (lo + hi) / 2.0
        scale = eps_denom(torch.amax(hi - lo) / 2.0)
        points = (self.points - center) / scale * m
        return dataclasses.replace(self, points=points), center, scale

    def subsample_randomly(self, generator: torch.Generator,
                           ratio: float) -> "PointClouds":
        """Switch off each valid point with probability 1 − ratio (the
        cloud keeps its capacity).  Draws from `generator`, which must live
        on the cloud's device; its stream is not jax.random's."""
        keep = torch.rand((self.capacity,), generator=generator,
                          device=self.points.device) < ratio
        return dataclasses.replace(self, mask=self.mask & keep)


@dataclasses.dataclass
class PointFilters:
    activation: torch.Tensor  # (P,) bool
    visibility: torch.Tensor  # (P,) bool
    inmask: torch.Tensor  # (P,) bool

    @classmethod
    def ones(cls, capacity: int, device=None) -> "PointFilters":
        """All on; on the card unless `device` says otherwise."""
        m = torch.ones((capacity,), dtype=torch.bool,
                       device=resolve_device(device))
        return cls(activation=m, visibility=m.clone(), inmask=m.clone())

    def combined(self) -> torch.Tensor:
        return self.activation & self.visibility & self.inmask
