"""Rasterizer containers and the per-point gradient clip (counterpart of the
parts of dss_tpu/render/rasterizer.py that the lean training path uses).

The full reference rasterizer (per-pixel top-K fragments, `_occ_backward`,
`_zbuf_backward`) is not ported yet: see ROADMAP.md, queue 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Fragments:
    """Per-view fragment outputs for a batch of V views.  The lean path
    carries no per-fragment buffers: idx/zbuf/qvalue are (V, S, S, 0)."""

    idx: torch.Tensor  # (V, S, S, K) int32, -1 padded
    zbuf: torch.Tensor  # (V, S, S, K) view-space depth, -1 padded
    qvalue: torch.Tensor  # (V, S, S, K) conic value Q, -1 padded
    occupancy: torch.Tensor  # (V, S, S) float {0, 1}
    # (V,) int32: candidates dropped by the static binning budgets
    # (forward + occupancy-backward tables); nonzero = lost fragments or
    # gradients.
    overflow: Optional[torch.Tensor] = None
    # (V, S, S) weighted-mean view-space depth Σw·z/Σw, −1 where uncovered;
    # set when RasterSettings.depth_channel is on.
    wdepth: Optional[torch.Tensor] = None


class _ClipGradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_norm):
        ctx.max_norm = max_norm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        scale = torch.clamp(n, 0.0, ctx.max_norm) / torch.clamp(n, min=1e-12)
        return g * scale, None


def clip_grad_norm(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Identity whose backward clips per-row gradient norms to `max_norm`
    (reference clip_pts_grad=0.05)."""
    return _ClipGradNorm.apply(x, max_norm)
