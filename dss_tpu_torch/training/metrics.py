"""Point-cloud quality metrics (counterpart of dss_tpu/training/metrics.py):
chamfer and Hausdorff distances, point-to-surface distance against the GT
cloud's local planes, and NUC-style uniformity.  Masks select the valid
points of either cloud; non-finite kNN distances count as 0."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.utils.mathutil import eps_denom, normalize


def _weights(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[:1], dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)


@torch.no_grad()
def chamfer_hausdorff(
    pred: torch.Tensor,
    gt: torch.Tensor,
    pred_mask: Optional[torch.Tensor] = None,
    gt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Symmetric chamfer (sum of the two directed means of squared NN
    distances) and Hausdorff (max of the directed max NN distances)."""

    def directed(a, b, am, bm):
        d, _ = knn_points(a, b, am, bm, k=1)
        d = d[:, 0]
        w = _weights(a, am)
        d = torch.where(torch.isfinite(d), d, 0.0)
        mean = torch.sum(d * w) / eps_denom(torch.sum(w))
        mx = torch.amax(torch.where(w > 0, d, -torch.inf))
        return mean, torch.sqrt(torch.clamp(mx, min=0.0))

    cd_pg, h_pg = directed(pred, gt, pred_mask, gt_mask)
    cd_gp, h_gp = directed(gt, pred, gt_mask, pred_mask)
    return {
        "chamfer": cd_pg + cd_gp,
        "hausdorff": torch.maximum(h_pg, h_gp),
        "cd_pred2gt": cd_pg,
        "cd_gt2pred": cd_gp,
    }


@torch.no_grad()
def point_to_surface(
    pred: torch.Tensor,
    gt: torch.Tensor,
    gt_normals: Optional[torch.Tensor] = None,
    pred_mask: Optional[torch.Tensor] = None,
    gt_mask: Optional[torch.Tensor] = None,
    k: int = 4,
) -> torch.Tensor:
    """Mean |nᵢ·(x − xᵢ)| of each predicted point against the local planes
    of its k GT neighbours; PCA normals of the GT cloud when none are
    given."""
    if gt_normals is None:
        gt_normals = estimate_normals(gt, gt_mask, neighborhood_size=8)
    gt_normals = normalize(gt_normals)
    _, idx = knn_points(pred, gt, pred_mask, gt_mask, k=k)
    nn = masked_gather(gt, idx)
    nnn = masked_gather(gt_normals, idx)
    valid = (idx >= 0).to(pred.dtype)
    d = torch.abs(torch.sum((pred[:, None, :] - nn) * nnn, dim=-1)) * valid
    per_point = torch.sum(d, dim=-1) / eps_denom(torch.sum(valid, dim=-1))
    w = _weights(pred, pred_mask)
    return torch.sum(per_point * w) / eps_denom(torch.sum(w))


@torch.no_grad()
def uniformity_nuc(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    k: int = 8,
) -> torch.Tensor:
    """Coefficient of variation of the local kNN spacing (root of the mean
    squared distance to the k nearest other points) across the cloud; 0
    for a perfectly uniform cloud."""
    d, idx = knn_points(points, points, mask, mask, k=k, exclude_self=True)
    valid = (idx >= 0).to(points.dtype)
    # invalid slots hold inf; 0·inf would be NaN
    d = torch.where(idx >= 0, d, 0.0)
    local = torch.sqrt(torch.clamp(
        torch.sum(d * valid, -1) / eps_denom(torch.sum(valid, -1)), min=0.0))
    w = _weights(points, mask)
    mean = torch.sum(local * w) / eps_denom(torch.sum(w))
    var = torch.sum((local - mean) ** 2 * w) / eps_denom(torch.sum(w))
    return torch.sqrt(var) / eps_denom(mean)
