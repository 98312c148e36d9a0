"""Point model: the learnable parameters are the point cloud (counterpart of
dss_tpu/models/point_model.py).

The parameters are three leaf tensors; the activation / visibility /
inmask filters travel separately in a PointFilters, so autograd sees only
the learnables.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.render.ewa import (
    RasterSettings,
    compute_vrk_h_global,
    compute_vrk_h_isotropic,
)
from dss_tpu_torch.render.lighting import Lights
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import normalize


@dataclasses.dataclass
class PointModelParams:
    """Learnable state: points, normals, colors, each (P, 3)."""

    points: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor

    @classmethod
    def create(cls, points, normals=None, colors=None, device=None,
               requires_grad: bool = True) -> "PointModelParams":
        """On the card unless `device` says otherwise (resolve_device)."""
        device = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        points = f(points)
        normals = torch.zeros_like(points) if normals is None else f(normals)
        colors = torch.ones_like(points) if colors is None else f(colors)
        out = cls(points=points.clone(), normals=normals.clone(),
                  colors=colors.clone())
        for t in out.tensors():
            t.requires_grad_(requires_grad)
        return out

    def tensors(self):
        return (self.points, self.normals, self.colors)


def sample_image_at_ndc(images: torch.Tensor, p_ndc: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of (V, H, W) images at (V, P, 2) NDC xy
    (grid_sample align_corners=False semantics, borders clamped)."""
    v, h, w = images.shape
    x = (p_ndc[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (p_ndc[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    vidx = torch.arange(v, device=images.device)[:, None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xx = torch.clamp(xx.to(torch.int64), 0, w - 1)
        return images[vidx, yy, xx]

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def point_model_forward(
    params: PointModelParams,
    filters: PointFilters,
    cameras: FoVPerspectiveCameras,
    lights: Optional[Lights],
    settings: RasterSettings,
    mask_img: Optional[torch.Tensor] = None,
    vrk_h: Optional[torch.Tensor] = None,
    **render_kwargs,
) -> Tuple[Dict[str, torch.Tensor], PointFilters]:
    """Render the camera batch and update the point filters: visibility :=
    some view rendered the point; inmask := the point projects inside the
    GT mask in some view and is visible.

    Returns ({img_pred (V,S,S,3), mask_img_pred (V,S,S), bin_overflow ()
    [, depth_pred (V,S,S), −1 where uncovered]}, new_filters)."""
    normals = normalize(params.normals)
    active = filters.activation

    # The kernel size h is world-space and shared by every view: computed
    # once per step.
    if vrk_h is None:
        if settings.Vrk_invariant:
            vrk_h = compute_vrk_h_global(params.points.detach(), active)
        elif settings.Vrk_isotropic:
            vrk_h = compute_vrk_h_isotropic(params.points.detach(), active)

    rgba, frags, visible = render_views(
        params.points, normals, params.colors, active, cameras, lights,
        settings, vrk_h=vrk_h, **render_kwargs,
    )
    visibility = torch.any(visible, dim=0) & active

    if mask_img is not None:
        with torch.no_grad():
            p_screen = cameras.transform_points_screen(params.points)
            # NDC xy sign flip: image +x right / +y down vs NDC +x left /
            # +y up.
            p = torch.clamp(-p_screen[..., :2], -1.0, 1.0)
            sampled = sample_image_at_ndc(mask_img.to(torch.float32), p)
            inmask = torch.any(sampled > 0.5, dim=0) & visibility
    else:
        inmask = filters.inmask

    new_filters = PointFilters(activation=active, visibility=visibility,
                               inmask=inmask)
    out = {
        "img_pred": rgba[..., :3],
        "mask_img_pred": rgba[..., 3],
        # candidates dropped by the static binning budgets, all views
        "bin_overflow": torch.sum(frags.overflow),
    }
    # Depth: the weighted-depth channel where it is on, else the nearest
    # fragment's z on the paths that carry fragments (its gradient reaches
    # point z through the zbuf scatter).
    if frags.wdepth is not None:
        out["depth_pred"] = frags.wdepth
    elif frags.zbuf.shape[-1] > 0:
        out["depth_pred"] = frags.zbuf[..., 0]
    return out, new_filters
