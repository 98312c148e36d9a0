"""PCA local frames, PCA normals and the jet normal refinement (counterpart
of dss_tpu/geometry/normals.py).

The neighbourhood covariance goes through `mathutil.symeig3x3` (batched
3×3, ascending eigenvalues: the port's eigensolver kernel, where the JAX
package calls XLA's `jnp.linalg.eigh`) and the jet fit through a batched
6×6 `torch.linalg.solve_ex` (library linear algebra, as the JAX package's
is XLA).  Eigenvector signs are arbitrary in both packages (Jacobi and
LAPACK pick them differently); only
`estimate_normals(reference_normals=...)` and the callers fix a sign.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.utils.mathutil import (eps_denom, normalize, symeig3x3,
                                          tangent_frame)


def local_covariances(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    neighborhood_size: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance (P, 3, 3) and centroid (P, 3) of each point's kNN
    neighbourhood (self included).  The covariance is divided by
    `neighborhood_size`, not by the valid count, as in the JAX package; a
    masked-out point's is zero."""
    p = points.shape[0]
    if mask is None:
        mask = torch.ones((p,), dtype=torch.bool, device=points.device)
    _, idx = knn_points(points, points, mask, mask, k=neighborhood_size)
    nn = masked_gather(points, idx)  # (P, K, 3)
    valid = (idx >= 0).to(points.dtype)[..., None]  # (P, K, 1)
    cnt = eps_denom(torch.sum(valid, dim=1))  # (P, 1)
    mean = torch.sum(nn * valid, dim=1) / cnt
    centered = (nn - mean[:, None, :]) * valid
    cov = torch.einsum("pki,pkj->pij", centered, centered) / neighborhood_size
    return cov, mean


def estimate_local_coord_frames(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    neighborhood_size: int = 8,
    disambiguate_directions: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point PCA frame of `local_covariances`.

    Returns:
      curvatures: (P, 3) eigenvalues of the neighbourhood covariance,
        ascending (index 0 ~ normal direction).
      frames: (P, 3, 3) with columns = principal directions in ascending
        eigenvalue order (frames[:, :, 0] is the normal direction).
    """
    cov, mean = local_covariances(points, mask, neighborhood_size)
    curvatures, frames = symeig3x3(cov)  # ascending

    if disambiguate_directions:
        # normals point from the neighbourhood centroid toward the point
        n = frames[:, :, 0]
        s = torch.where(torch.sum(n * (points - mean), dim=-1) < 0, -1.0, 1.0)
        frames = torch.cat([frames[:, :, :1] * s[:, None, None],
                            frames[:, :, 1:]], dim=-1)
    return curvatures, frames


def estimate_normals(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    neighborhood_size: int = 8,
    reference_normals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PCA normals (P, 3); sign-aligned to `reference_normals` if given."""
    _, frames = estimate_local_coord_frames(points, mask, neighborhood_size)
    n = frames[:, :, 0]
    if reference_normals is not None:
        s = torch.where(
            torch.sum(n * reference_normals, dim=-1, keepdim=True) < 0, -1.0, 1.0)
        n = n * s
    return normalize(n)


def jax_nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of x, as `jnp.nanmedian` computes it
    (its linear quantile at q = 0.5: the mean of the two middle values for
    an even count, where `torch.nanmedian` returns the lower one); NaN when
    every entry is NaN.  Sorts and indexes on the device: no host sync
    (a 0-d index tensor would be read on the host)."""
    v, _ = torch.sort(x.reshape(-1))  # NaN sorts last
    counts = torch.sum(~torch.isnan(v)).to(torch.float32)
    q = 0.5 * (counts - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    last = counts - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, last), min=0.0).to(torch.int64)
    at = lambda i: v.index_select(0, i.reshape(1)).reshape(())
    return at(low) * w_low + at(high) * w_high


def refine_normals(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    neighborhood_size: int = 48,
    jet_passes: int = 2,
    bilateral_sigma: float = 0.5,
    bilateral_k: int = 16,
    bilateral_iters: int = 2,
) -> torch.Tensor:
    """Geometry-driven normal refinement: weighted osculating-jet fit, then
    bilateral smoothing over the kNN graph.

    Per point, the quadric height field w(u, v) = au² + buv + cv² + du + ev
    + f is fitted over the kNN neighbourhood in the current normal's
    tangent frame (Gaussian-weighted least squares), and the normal is
    tilted by the fitted gradient, n ← n − d·t₁ − e·t₂.  Bilateral
    iterations (spatial × normal-similarity weights over the closest
    `bilateral_k` neighbours) then smooth residual noise.  Orientation
    follows the input field; masked-out points keep their input normals.

    As in the JAX package: `k = min(neighborhood_size, P)`; fewer than two
    bilateral neighbours turn the smoothing off; the spatial scale is
    jnp.nanmedian's median of every valid off-self squared spacing, 1.0
    when there is none.  The 6×6 systems carry a Tikhonov term scaled to
    their trace, so masked-out and degenerate neighbourhoods stay
    solvable; `solve_ex` does not check (a check would sync the card), and
    a singular system gives non-finite values, as `jnp.linalg.solve`
    does."""
    p = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones((p,), dtype=torch.bool, device=dev)
    n = normalize(normals)

    k = min(neighborhood_size, p)
    d2, idx = knn_points(points, points, mask, mask, k=k)
    nn = masked_gather(points, idx)  # (P, K, 3)
    valid = (idx >= 0) & mask[:, None]
    rel = (nn - points[:, None, :]) * valid[..., None].to(points.dtype)
    # Gaussian weights at the neighbourhood's own scale
    d2c = torch.where(valid, d2, 0.0)
    h2 = eps_denom(torch.sum(d2c, dim=1)
                   / eps_denom(torch.sum(valid, dim=1).to(points.dtype)))
    wt = torch.exp(-d2c / h2[:, None]) * valid.to(points.dtype)  # (P, K)
    eye6 = torch.eye(6, dtype=points.dtype, device=dev)

    def jet_pass(n_cur):
        frame = tangent_frame(n_cur)  # (P, 2, 3)
        t1, t2 = frame[:, 0, :], frame[:, 1, :]
        u = torch.einsum("pki,pi->pk", rel, t1)
        v = torch.einsum("pki,pi->pk", rel, t2)
        w = torch.einsum("pki,pi->pk", rel, n_cur)
        a = torch.stack([u * u, u * v, v * v, u, v, torch.ones_like(u)],
                        dim=-1)  # (P, K, 6)
        aw = a * wt[..., None]
        g = torch.einsum("pka,pkb->pab", aw, a)  # (P, 6, 6)
        b = torch.einsum("pka,pk->pa", aw, w)  # (P, 6)
        tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        g = g + (1e-7 * tr[:, None, None] + 1e-12) * eye6
        coef = torch.linalg.solve_ex(g, b[..., None],
                                     check_errors=False)[0][..., 0]
        tilted = n_cur - coef[:, 3:4] * t1 - coef[:, 4:5] * t2
        return normalize(tilted)

    for _ in range(jet_passes):
        n = torch.where(mask[:, None], jet_pass(n), n)

    kb = min(bilateral_k, k)
    if kb < 2:
        bilateral_iters = 0
        kb = 1
    idx_b, d2_b, valid_b = idx[:, :kb], d2c[:, :kb], valid[:, :kb]
    if bilateral_iters > 0:
        off_self = torch.where(valid_b[:, 1:], d2_b[:, 1:], torch.nan)
        med = jax_nanmedian(off_self)
        s2 = eps_denom(torch.where(torch.isfinite(med), med, 1.0))
    sig_r = bilateral_sigma
    for _ in range(bilateral_iters):
        nnb = masked_gather(n, idx_b)  # (P, kb, 3)
        cosd = 1.0 - torch.einsum("pki,pi->pk", nnb, n)
        wb = (torch.exp(-d2_b / s2) * torch.exp(-((cosd / sig_r) ** 2))
              * valid_b.to(points.dtype))
        sm = torch.einsum("pk,pki->pi", wb, nnb)
        n = torch.where(mask[:, None], normalize(sm), n)
    return n
