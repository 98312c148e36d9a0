"""Point-cloud denoising and resampling operators (counterpart of
dss_tpu/geometry/denoise.py).

Reference: DSS/core/cloud.py's standalone geometry ops — remove_outliers,
resample_uniformly, project_to_latent_surface (RIMLS, robust implicit
MLS), denoise_normals (bilateral normal filtering), upsample and
upsample_ear (EAR-style edge-aware resampling).  They carry the paper's
point-cloud denoising application.  Every function takes one cloud (P, ·)
with a mask and returns tensors on its device, with no host sync inside.

As in the JAX package, the RIMLS gradient is the correct MLS gradient
(the reference drops the minus sign of dφ/dx), and the implicit surface
is the input cloud's: the neighbours stay fixed while the points move.

Ties: neighbours come from `knn_points` (`torch.topk`), and the insertion
round takes the sparsest fathers by a stable descending sort, so equal
sparsities go to the lower index, as `jax.lax.top_k` does; `torch.topk`
on CUDA does not promise that order, and the kNN's order among equal
distances is not promised either.  Compare with the JAX package on
inputs without ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.geometry.normals import (
    estimate_local_coord_frames,
    estimate_normals,
)
from dss_tpu_torch.utils.mathutil import eps_denom, normalize


def _bbox_diag(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Diagonal of the masked points' bounding box; NaN when none is
    masked in, as jnp.nanmax/nanmin give."""
    m = mask[:, None]
    hi = torch.amax(torch.where(m, points, -torch.inf), dim=0)
    lo = torch.amin(torch.where(m, points, torch.inf), dim=0)
    diag = torch.linalg.vector_norm(hi - lo)
    return torch.where(torch.any(mask), diag, torch.nan)


def remove_outliers(
    points: torch.Tensor,
    mask: torch.Tensor,
    neighborhood_size: int = 16,
    tolerance: float = 0.05,
) -> torch.Tensor:
    """Outlier: the ratio of the smallest to the total neighbourhood
    variance exceeds `tolerance` (reference cloud.py:363-378).  Returns the
    updated mask."""
    curv, _ = estimate_local_coord_frames(points, mask, neighborhood_size)
    ratio = curv[:, 0] / eps_denom(torch.sum(curv, dim=-1))
    return mask & (ratio < tolerance)


def denoise_normals_bilateral(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    sharpness_sigma: float = 30.0,
    neighborhood_size: int = 16,
) -> torch.Tensor:
    """Bilateral normal mollification (reference cloud.py:515-552):
    weights exp(-((1-n·nᵢ)/σ)²) · exp(-d²·P/2) with the spatial term cut at
    d² > 16/(P/2)."""
    dists, idx = knn_points(points, points, mask, mask, k=neighborhood_size,
                            exclude_self=True)
    valid = idx >= 0
    dists = torch.where(valid, dists, 0.0)

    n = normalize(normals)
    nn_normals = masked_gather(n, idx)
    cos = torch.sum(nn_normals * n[:, None, :], dim=-1)
    w_n = torch.exp(-(((1.0 - cos) / sharpness_sigma) ** 2))

    n_valid = torch.sum(mask.to(points.dtype))
    inv_sigma_spatial = n_valid / 2.0
    spatial_cut = 16.0 / inv_sigma_spatial
    w_p = torch.exp(-dists * inv_sigma_spatial)
    w_p = torch.where(dists > spatial_cut, 0.0, w_p)

    w = w_p * w_n * valid
    out = torch.sum(nn_normals * w[..., None], dim=-2) / eps_denom(
        torch.sum(w, dim=-1, keepdim=True))
    out = normalize(out)
    out = torch.where(torch.all(out == 0, dim=-1, keepdim=True), n, out)
    return torch.where(mask[:, None], out, normals)


def resample_uniformly(
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: Optional[torch.Tensor] = None,
    neighborhood_size: int = 8,
    iters: int = 1,
    repulsion_mu: float = 1.0,
    reproject: bool = False,
) -> torch.Tensor:
    """Repulsion-style uniform resampling (reference cloud.py:381-440): move
    each point along the density-weighted mean of normalized tangential
    offsets from its neighbours, step μ·avg_spacing."""
    p = points.shape[0]
    if normals is None:
        normals = estimate_normals(points, mask, neighborhood_size)
    else:
        normals = normalize(normals)

    n_valid = torch.sum(mask.to(points.dtype))
    diag = _bbox_diag(points, mask)
    avg_spacing = torch.sqrt(diag / p)
    inv_sigma_spatial = n_valid / 2.0 / 16.0

    _, idx0 = knn_points(points, points, mask, mask, k=neighborhood_size,
                         exclude_self=True)
    valid = idx0 >= 0

    def step(pts, normals):
        nn = masked_gather(pts, idx0)
        pts_diff = pts[:, None, :] - nn
        d2 = torch.sum(pts_diff ** 2, dim=-1)
        spatial_w = torch.exp(-d2 * inv_sigma_spatial) * valid
        density = masked_gather(
            torch.sum(spatial_w, -1, keepdim=True) + 1.0, idx0)[..., 0]
        nn_normals = masked_gather(normals, idx0)
        proj = pts_diff - torch.sum(pts_diff * nn_normals, -1,
                                    keepdim=True) * nn_normals
        move = repulsion_mu * avg_spacing * torch.mean(
            density[..., None] * spatial_w[..., None] * normalize(proj), dim=-2)
        return pts + move * mask[:, None]

    pts = points
    for _ in range(iters):
        if reproject:
            normals = denoise_normals_bilateral(pts, normals, mask)
            pts = project_to_latent_surface(pts, normals, mask,
                                            max_proj_iters=2, max_est_iter=3)
        pts = step(pts, normals)
    return pts


def project_to_latent_surface(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    sharpness_angle: float = 60.0,
    neighborhood_size: int = 31,
    max_proj_iters: int = 10,
    max_est_iter: int = 5,
) -> torch.Tensor:
    """RIMLS projection (reference cloud.py:442-513): project each point onto
    the latent surface of its neighbours' planes, with robust reweighting
    (normal-difference and residual terms).

    Fixed iteration counts: the reference's per-point convergence loops
    become masked updates, and a point whose move is ≤ 5e-4 stops."""
    p = points.shape[0]
    normals = normalize(normals)
    dists, idx = knn_points(points, points, mask, mask, k=neighborhood_size,
                            exclude_self=True)
    valid = idx >= 0
    nn_normals = masked_gather(normals, idx)  # fixed neighbour normals
    # fixed neighbour positions: the implicit surface is the input cloud's;
    # gathering from the moving points (as the reference does) lets the
    # whole cloud inflate by the local sagitta every iteration
    nn = masked_gather(points, idx)  # (P, K, 3)
    d0 = dists[:, 0]
    inv_sigma = 1.0 / eps_denom(torch.where(torch.isfinite(d0), d0, 1.0)) / 16.0

    def estimate(pts_diff, fx, w, gw):
        sum_w = eps_denom(torch.sum(w, dim=-1))
        f = torch.sum(w * fx, dim=-1) / sum_w
        grad = (torch.sum(gw * fx[..., None], dim=-2)
                - f[:, None] * torch.sum(gw, dim=-2)
                + torch.sum(w[..., None] * nn_normals, dim=-2)) / sum_w[:, None]
        return f, grad

    def proj_step(pts, active):
        pts_diff = pts[:, None, :] - nn
        fx = torch.sum(pts_diff * nn_normals, dim=-1)  # (P, K) plane offsets
        d2 = torch.sum(pts_diff * pts_diff, dim=-1)
        phi = torch.exp(-d2 * inv_sigma[:, None]) * valid

        # the first estimate with alpha = 1
        f, grad_f = estimate(
            pts_diff, fx, phi,
            -2.0 * pts_diff * (inv_sigma[:, None] * phi)[..., None])
        for _ in range(max_est_iter - 1):
            w_n = torch.exp(-((torch.linalg.vector_norm(
                nn_normals - grad_f[:, None, :], dim=-1) / 0.5) ** 2))
            w_p = torch.exp(-((fx - f[:, None]) ** 2) * inv_sigma[:, None] / 4.0)
            alpha = w_n * w_p
            # dw/dx = −2 (x−xᵢ) inv_sigma φ α (the correct MLS gradient)
            gw = -2.0 * pts_diff * (inv_sigma[:, None] * phi * alpha)[..., None]
            f, grad_f = estimate(pts_diff, fx, phi * alpha, gw)

        move = f[:, None] * grad_f
        still = torch.linalg.vector_norm(move, dim=-1) > 5e-4
        pts = pts - torch.where((active & mask)[:, None], move, 0.0)
        return pts, active & still

    pts = points
    active = torch.ones((p,), dtype=torch.bool, device=points.device)
    for _ in range(max_proj_iters):
        pts, active = proj_step(pts, active)
    return pts


def _insert_round(
    points: torch.Tensor,
    mask: torch.Tensor,
    n_current: int,
    n_new: int,
    neighborhood_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One insertion round of upsample/upsample_ear (reference
    cloud.py:586-625): candidate midpoints (xᵢ + 2x)/3 per neighbour, each
    scored by its distance to the nearest existing neighbour; each father's
    sparsest candidate wins, and the n_new sparsest fathers insert theirs
    at rows n_current … n_current + n_new − 1."""
    k = neighborhood_size
    p = points.shape[0]
    _, idx = knn_points(points, points, mask, mask, k=k, exclude_self=True)
    nn = masked_gather(points, idx, fill=torch.inf)  # (P, K, 3)
    mid = (torch.where(torch.isfinite(nn), nn, 0.0)
           + 2.0 * points[:, None, :]) / 3.0
    # (P, K, K): midpoint k against neighbour j
    diff = mid[:, :, None, :] - nn[:, None, :, :]
    d = torch.linalg.vector_norm(
        torch.where(torch.isfinite(diff), diff, torch.inf), dim=-1)
    d = torch.where(torch.isfinite(d), d, torch.inf)
    min_d = torch.amin(d, dim=-1)  # (P, K)
    min_d = torch.where(idx >= 0, min_d, -torch.inf)
    father_sparsity = torch.amax(min_d, dim=-1)  # (P,)
    father_nb = torch.argmax(min_d, dim=-1)  # first maximum, as jnp.argmax
    father_sparsity = torch.where(mask, father_sparsity, -torch.inf)
    new_candidates = mid[torch.arange(p, device=points.device), father_nb]
    # the n_new largest, ties to the lower index (jax.lax.top_k's rule)
    top = torch.sort(father_sparsity, descending=True, stable=True).indices[:n_new]
    points = torch.cat([points[:n_current], new_candidates[top],
                        points[n_current + n_new:]])
    rows = torch.arange(p, device=points.device)
    mask = mask | ((rows >= n_current) & (rows < n_current + n_new))
    return points, mask


def upsample(
    points: torch.Tensor,
    mask: torch.Tensor,
    n_current: int,
    n_target: int,
    neighborhood_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative sparsity-seeking upsampling (reference cloud.py:555-632).

    `points` has room for n_target rows; the first `n_current` are the
    valid points.  Each round inserts up to n_current // 10 midpoints at
    the sparsest places."""
    if points.shape[0] < n_target:
        raise ValueError(f"upsample: {points.shape[0]} rows cannot hold "
                         f"{n_target} points")
    while n_current < n_target:
        n_new = min(n_target - n_current, max(n_current // 10, 1))
        points, mask = _insert_round(points, mask, n_current, n_new,
                                     neighborhood_size)
        n_current += n_new
    return points, mask


def upsample_ear(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    n_current: int,
    n_target: int,
    neighborhood_size: int = 16,
    repulsion_mu: float = 0.4,
    denoise: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EAR-style edge-aware resampling (reference cloud.py:634-741): one LOP
    projection step (a data term along the normal-consistency weight and a
    clipped repulsion term), then `upsample`'s insertion loop."""
    n_valid = torch.sum(mask.to(points.dtype))
    diag = _bbox_diag(points, mask)
    inv_sigma_spatial = n_valid / eps_denom(diag)
    spatial_cut = 16.0 / inv_sigma_spatial

    dists, idx = knn_points(points, points, mask, mask, k=neighborhood_size,
                            exclude_self=True)
    valid = idx >= 0
    dists = torch.where(valid, dists, 0.0)
    nn = masked_gather(points, idx)
    d0 = dists[:, 0]
    move_clip = torch.sqrt(
        torch.sum(torch.where(mask, torch.where(torch.isfinite(d0), d0, 0.0),
                              0.0)) / eps_denom(n_valid))

    if denoise:
        normals = denoise_normals_bilateral(points, normals, mask)
    normals = normalize(normals)

    off = points[:, None, :] - nn
    far = (dists > spatial_cut) | ~valid
    w_lop = torch.exp(
        -torch.sum(normals[:, None, :] * off, dim=-1) ** 2 * inv_sigma_spatial)
    w_lop = torch.where(far, 0.0, w_lop)
    spatial_w = torch.exp(-dists * inv_sigma_spatial)
    spatial_w = torch.where(far, 0.0, spatial_w)
    density_w = torch.sum(spatial_w, dim=-1) + 1.0

    move_data = torch.sum(w_lop[..., None] * off, dim=-2) / eps_denom(
        torch.sum(w_lop, dim=-1, keepdim=True))
    move_repul = (
        repulsion_mu * density_w[..., None]
        * torch.sum(spatial_w[..., None] * (nn - points[:, None, :]), dim=-2)
        / eps_denom(torch.sum(spatial_w, dim=-1, keepdim=True)))

    def clip(v):
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return normalize(v) * torch.minimum(n, move_clip)

    points = points - (clip(move_data) + clip(move_repul)) * mask[:, None]
    return upsample(points, mask, n_current, n_target, neighborhood_size)
