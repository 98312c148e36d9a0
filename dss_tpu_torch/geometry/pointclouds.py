"""Point filters (counterpart of dss_tpu/geometry/pointclouds.py::PointFilters).

Three boolean masks AND-combined to select the active subset of a
fixed-capacity cloud, as the reference's `PointCloudsFilters`:

- activation: point pruning state (maintained by the model);
- visibility: produced by the rasterizer forward pass;
- inmask: the point projects inside the GT mask (model forward).
"""
from __future__ import annotations

import dataclasses

import torch

from dss_tpu_torch.utils.device import resolve_device


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
