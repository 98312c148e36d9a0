"""Image losses and surface regularizers (counterpart of the parts of
dss_tpu/training/losses.py the flagship step and the normal anchor use).

Functions take one (P, ·) cloud and its validity mask; reductions respect
the mask.  `.detach()` stands where the JAX package has stop_gradient.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import torch

from dss_tpu_torch.geometry.knn import grid_knn_points, knn_points, masked_gather
from dss_tpu_torch.geometry.normals import estimate_normals, refine_normals
from dss_tpu_torch.utils import spans
from dss_tpu_torch.utils.mathutil import eps_denom, jax_abs, normalize

# ---------------------------------------------------------------------------
# Image losses
# ---------------------------------------------------------------------------


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / eps_denom(torch.sum(m))


def l1_loss(x, y, mask=None):
    return masked_mean(jax_abs(x - y), mask)


def l2_loss(x, y, mask=None, weights=None):
    """Masked mean of (x − y)², each term times `weights` if given."""
    d = (x - y) ** 2
    if weights is not None:
        d = d * weights
    return masked_mean(d, mask)


def smape_loss(x, y, mask=None, eps: float = 1e-8):
    """Relative L1: masked mean of |x − y| / (|x| + |y| + eps)."""
    d = jax_abs(x - y) / (jax_abs(x) + jax_abs(y) + eps)
    return masked_mean(d, mask)


def iou_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 − intersection/union over all non-batch dims, meaned over batch."""
    dims = tuple(range(1, predict.ndim))
    inter = torch.sum(predict * target, dim=dims)
    union = torch.sum(predict + target - predict * target, dim=dims)
    return torch.mean(1.0 - inter / eps_denom(union))


def dr_loss(img, img_pred, mask_img, mask_img_pred, lambda_rgb: float = 1.0,
            lambda_silhouette: float = 1.0):
    """L1 RGB restricted to the GT ∧ predicted silhouette intersection, plus
    the silhouette term 0.01·IoU + L1 mask.  Returns (total, parts)."""
    inter = (mask_img > 0.5) & (mask_img_pred > 0.5)
    loss_rgb = l1_loss(img, img_pred, mask=inter[..., None]) * lambda_rgb
    m = mask_img.to(img.dtype)
    loss_sil = (0.01 * iou_loss(m, mask_img_pred)
                + torch.mean(jax_abs(m - mask_img_pred))) * lambda_silhouette
    return loss_rgb + loss_sil, {"loss_dr_rgb": loss_rgb,
                                 "loss_dr_silhouette": loss_sil}


def depth_l1_loss(depth, depth_pred, mask_img) -> torch.Tensor:
    """Masked L1 between GT dense depth (V, S, S; background = zfar) and the
    rendered depth (−1 where uncovered), over pixels covered by both the GT
    silhouette and a rendered fragment."""
    valid = (mask_img > 0.5) & (depth_pred > 0.0)
    return l1_loss(depth, depth_pred, mask=valid)


# ---------------------------------------------------------------------------
# Surface regularizers (projection & repulsion)
# ---------------------------------------------------------------------------


class KnnCache(NamedTuple):
    """Neighbour structure shared by the surface losses (knn_k total with
    the self column dropped)."""

    dists: torch.Tensor  # (P, K) squared dists, 0 for invalid
    idx: torch.Tensor  # (P, K) int64, -1 for invalid
    nn: torch.Tensor  # (P, K, 3) neighbour positions (0 fill)
    valid: torch.Tensor  # (P, K) bool


def build_knn(points, mask, knn_k: int = 12,
              grid_threshold: Optional[int] = None) -> KnnCache:
    """Neighbour cache for the surface losses.  Above `grid_threshold`
    points (default: $DSS_KNN_GRID_THRESHOLD, else 10⁹) it takes the grid
    kNN with grid_res = max(4, ⌈√(P/96)⌉) and 64 points per cell, as the
    JAX package does; else the exact brute force.  The JAX package selects
    with the TPU's approx_min_k above 20k points; the port keeps the exact
    `topk` at every size (ROADMAP.md)."""
    k = knn_k - 1  # the self column is dropped
    p = points.shape[0]
    if grid_threshold is None:
        grid_threshold = int(os.environ.get("DSS_KNN_GRID_THRESHOLD",
                                            1_000_000_000))
    if p > grid_threshold:
        dists, idx = grid_knn_points(
            points, mask, k=k, exclude_self=True,
            grid_res=max(4, math.ceil((p / 96.0) ** 0.5)), bucket_size=64)
    else:
        dists, idx = knn_points(points, points, mask, mask, k=k,
                                exclude_self=True)
    nn = masked_gather(points, idx)
    valid = idx >= 0
    dists = torch.where(valid, dists, 0.0)
    return KnnCache(dists=dists, idx=idx, nn=nn, valid=valid)


def get_phi(knn: KnnCache, filter_scale: float = 2.0) -> torch.Tensor:
    """Compact spatial kernel (1 − d²/h)₊⁴, h = 4·mean local sq-spacing."""
    valid_f = knn.valid.to(knn.dists.dtype)
    mean_sq = torch.sum(knn.dists * valid_f, dim=-1, keepdim=True) / eps_denom(
        torch.sum(valid_f, dim=-1, keepdim=True))
    h = mean_sq * 4.0
    w = torch.clamp(1.0 - knn.dists / eps_denom(h), min=0.0)
    w = w * w
    w = w * w
    return w * valid_f


def denoise_normals(normals, knn: KnnCache, weights, reliable=None):
    """Weighted neighbour average of the normals, keeping the original
    normal where `reliable` (visibility ∧ inmask)."""
    knn_normals = masked_gather(normals, knn.idx)
    denom = eps_denom(torch.sum(weights, dim=-1, keepdim=True))
    averaged = torch.sum(knn_normals * weights[..., None], dim=-2) / denom
    if reliable is not None:
        averaged = torch.where(reliable[:, None], normals, averaged)
    return averaged


def get_normal_w(normals, knn: KnnCache, sharpness_sigma: float = 0.75):
    """exp(−‖n̂ − n̂ᵢ‖²/σ²)."""
    inv_sigma = 1.0 / (sharpness_sigma * sharpness_sigma)
    n = normalize(normals)
    nn = normalize(masked_gather(normals, knn.idx))
    diff = nn - n[:, None, :]
    w = torch.exp(-torch.sum(diff * diff, dim=-1) * inv_sigma)
    return w * knn.valid


def projection_loss(points, normals, mask, visibility=None, reliable=None,
                    knn: Optional[KnnCache] = None, knn_k: int = 12,
                    filter_scale: float = 2.0,
                    sharpness_sigma: float = 0.75) -> torch.Tensor:
    """Surface attraction: weighted squared distance of each point to its
    neighbours' local planes; invisible neighbours weigh 0.1."""
    if knn is None:
        knn = build_knn(points.detach(), mask, knn_k)
    with torch.no_grad():
        phi = get_phi(knn, filter_scale)
        n_denoised = denoise_normals(normals, knn, phi, reliable)
        normal_w = get_normal_w(n_denoised, knn, sharpness_sigma)
        if visibility is None:
            vis_w = torch.ones_like(phi)
        else:
            vis_nb = masked_gather(visibility.to(points.dtype)[:, None],
                                   knn.idx)[..., 0]
            vis_w = torch.where(vis_nb > 0.5, 1.0, 0.1)
        weights = phi * normal_w * vis_w * knn.valid
        knn_normals = masked_gather(n_denoised, knn.idx)
    # sdf_i = nᵢ·(xᵢ − x), neighbour positions detached
    sdf = torch.sum((knn.nn.detach() - points[:, None, :]) * knn_normals,
                    dim=-1)
    per_point = torch.sum(weights * sdf * sdf, dim=-1) / eps_denom(
        torch.sum(weights, dim=-1))
    return masked_mean(per_point, mask)


def normal_consistency_terms(points, normals, mask,
                             neighborhood_size: int = 8,
                             anchor: str = "pca"):
    """(loss, nonfinite): `normal_consistency_loss`, and the count of the
    points of `mask` whose target is not finite (a 0-d int64 on the
    device; a singular jet system gives one, and its NaN makes the step's
    gradient non-finite).  The target is computed in the span
    `loss.anchor`."""
    n = normalize(normals)
    with torch.no_grad(), spans.span("loss.anchor"):
        if anchor == "jet":
            target = refine_normals(points.detach(), n.detach(), mask,
                                    neighborhood_size=max(neighborhood_size, 16))
        else:
            target = normalize(estimate_normals(points.detach(), mask,
                                                neighborhood_size))
        sign = torch.where(
            torch.sum(n.detach() * target, -1, keepdim=True) < 0, -1.0, 1.0)
        bad = ~torch.all(torch.isfinite(target), dim=-1)
        nonfinite = torch.sum(bad if mask is None else bad & mask)
    cos = torch.sum(n * target * sign, dim=-1)
    return masked_mean(1.0 - cos, mask), nonfinite


def normal_consistency_loss(points, normals, mask,
                            neighborhood_size: int = 8,
                            anchor: str = "pca") -> torch.Tensor:
    """Pull the learned normal field toward a geometric estimate of the
    current cloud: masked mean of 1 − cos(n̂, target), the target detached
    and sign-aligned to the detached learned normal (shading keeps owning
    the orientation).

    anchor="pca": plane-PCA normals over `neighborhood_size` neighbours.
    anchor="jet": `refine_normals` (jet fit + bilateral) over
    max(neighborhood_size, 16) neighbours, oriented by the learned field."""
    return normal_consistency_terms(points, normals, mask, neighborhood_size,
                                    anchor)[0]


def repulsion_loss(points, normals, mask, reliable=None,
                   knn: Optional[KnnCache] = None, knn_k: int = 12,
                   filter_scale: float = 2.0,
                   sharpness_sigma: float = 0.75) -> torch.Tensor:
    """Uniform spread: project neighbour offsets onto the tangent plane;
    loss = exp(−|repel_vec|), smallest when the density-weighted mean
    tangential offset is large."""
    if knn is None:
        knn = build_knn(points.detach(), mask, knn_k)
    with torch.no_grad():
        phi = get_phi(knn, filter_scale)
        n_denoised = denoise_normals(normals, knn, phi, reliable)
        knn_normals = masked_gather(n_denoised, knn.idx)
        # spatial_w = exp(−d²·N/diag²·filter_scale)
        lo = torch.amin(torch.where(mask[:, None], points, torch.inf), dim=0)
        hi = torch.amax(torch.where(mask[:, None], points, -torch.inf), dim=0)
        diag2 = eps_denom(torch.sum((hi - lo) ** 2))
        n_valid = torch.sum(mask.to(points.dtype))
        spatial_w = (torch.exp(-knn.dists * (n_valid / diag2) * filter_scale)
                     * knn.valid)
        normal_w = get_normal_w(n_denoised, knn, sharpness_sigma)
        density_w = torch.sum(spatial_w, dim=-1, keepdim=True) + 1.0
        weights = spatial_w * normal_w

    knn_diff = points[:, None, :] - knn.nn.detach()
    proj = knn_diff - torch.sum(knn_diff * knn_normals, dim=-1,
                                keepdim=True) * knn_normals
    repel_vec = torch.sum(proj * weights[..., None], dim=1) / eps_denom(
        torch.sum(weights, dim=1, keepdim=True))
    repel_vec = repel_vec * density_w
    per_point = torch.exp(-jax_abs(repel_vec))  # (P, 3)
    return masked_mean(per_point, mask[:, None])
