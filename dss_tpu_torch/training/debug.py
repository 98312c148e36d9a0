"""Per-source gradient debugging (counterpart of dss_tpu/training/debug.py).

`collect_gradient_fields` gives the world-space point gradient of each loss
source — the dr image loss through the renderer ('position'), the
projection and the repulsion regularizers — each by its own
`torch.autograd.grad` on a fresh leaf copy of the points, with the
normals and colours held fixed.  `dump_debug_quivers` draws them as the 2D
(NDC, view 0) and 3D quiver PNGs of `utils/visualize.py`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams, point_model_forward
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.losses import dr_loss, projection_loss, repulsion_loss
from dss_tpu_torch.utils.mathutil import normalize
from dss_tpu_torch.utils.visualize import plot_2d_quiver, plot_3d_quiver


def collect_gradient_fields(
    params: PointModelParams,
    filters: PointFilters,
    cameras: FoVPerspectiveCameras,
    lights,
    settings: RasterSettings,
    img: torch.Tensor,
    mask_img: torch.Tensor,
    cfg=None,
) -> Dict[str, torch.Tensor]:
    """World-space point-gradient field per loss source:
    {'position': dr-loss grad, 'proj': ..., 'repel': ...}, each (P, 3).
    The regularizers weigh by `filters` as given; the filters that the
    render returns are discarded.  `cfg` is a TrainConfig (default
    λ_proj = λ_repel = 1)."""
    from dss_tpu_torch.training.trainer import TrainConfig

    cfg = cfg or TrainConfig(lambda_proj=1.0, lambda_repel=1.0)
    normals = params.normals.detach()
    colors = params.colors.detach()
    reliable = filters.visibility & filters.inmask

    def grad_of(term):
        pts = params.points.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(term(pts), pts, allow_unused=True)
        return torch.zeros_like(pts) if g is None else g

    def dr_term(points):
        out, _ = point_model_forward(
            PointModelParams(points, normals, colors), filters, cameras,
            lights, settings, mask_img=mask_img)
        total, _ = dr_loss(img, out["img_pred"], mask_img,
                           out["mask_img_pred"], cfg.lambda_rgb,
                           cfg.lambda_silhouette)
        return total

    def proj_term(points):
        return projection_loss(
            points, normalize(normals), filters.activation,
            visibility=filters.visibility, reliable=reliable,
            knn_k=cfg.knn_k, filter_scale=cfg.filter_scale,
            sharpness_sigma=cfg.sharpness_sigma)

    def repel_term(points):
        return repulsion_loss(
            points, normalize(normals), filters.activation,
            reliable=reliable, knn_k=cfg.knn_k,
            filter_scale=cfg.filter_scale,
            sharpness_sigma=cfg.sharpness_sigma)

    return {"position": grad_of(dr_term), "proj": grad_of(proj_term),
            "repel": grad_of(repel_term)}


def dump_debug_quivers(
    params: PointModelParams,
    grads: Dict[str, torch.Tensor],
    cameras: FoVPerspectiveCameras,
    mask_img: Optional[torch.Tensor],
    out_dir: str,
    it: int,
    image_size: int = 256,
) -> None:
    """Write debug_2d_%06d.png (each field's NDC displacement of the
    points under view 0, as (proj(p + 1e-2·g) − proj(p))·1e2, over view
    0's mask) and debug_3d_%06d.png (the world-space fields) to out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    cam0 = FoVPerspectiveCameras(**{
        f.name: getattr(cameras, f.name)[:1]
        for f in dataclasses.fields(cameras)})
    with torch.no_grad():
        points = params.points.detach()
        pts_ndc = cam0.transform_points_screen(points)[0]
        grads_ndc = {
            name: ((cam0.transform_points_screen(points + 1e-2 * g)[0]
                    - pts_ndc)[:, :2] * 1e2).cpu().numpy()
            for name, g in grads.items()}
    m0 = None if mask_img is None else mask_img[0].detach().cpu().numpy()
    plot_2d_quiver(pts_ndc.cpu().numpy(), grads_ndc, m0,
                   os.path.join(out_dir, f"debug_2d_{it:06d}.png"),
                   image_size)
    plot_3d_quiver(points.cpu().numpy(),
                   {k: v.detach().cpu().numpy() for k, v in grads.items()},
                   os.path.join(out_dir, f"debug_3d_{it:06d}.png"))
