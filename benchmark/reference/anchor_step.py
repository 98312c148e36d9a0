"""The plain reference of one DSS train step with the normal-consistency
term, in float32 PyTorch.

Upstream DSS defines a cosine normal loss (`NormalLoss`,
DSS/training/losses.py:85-101) that its trainer does not wire; this
repository's recipes add it to the step as lambda_dr_normal times the
masked mean over the active points of 1 - cos(n, s * t), n the learned
normal normalised, t a geometric target of the current cloud computed
without gradient, and s = -1 where n . t < 0, else 1 (the learned field
keeps the orientation).  The target is one of two anchors, written here
from the equations of the JAX package's spec (dss_tpu/geometry/normals.py,
dss_tpu/training/losses.py `normal_consistency_loss`):

- "pca": the eigenvector of the smallest eigenvalue of each point's
  k-NN covariance (self included, the centred neighbours' outer products
  over k), normalised;
- "jet": the osculating-jet refinement over max(k, 16) neighbours (self
  included): Gaussian weights exp(-d^2 / h^2) with h^2 the mean of the
  neighbourhood's squared distances; per pass, in the tangent frame of
  the current normal (Duff et al.), the weighted least-squares fit of the
  height w = a u^2 + b uv + c v^2 + d u + e v + f, its 6 x 6 normal
  equations G x = b carried with a Tikhonov term (1e-7 trace(G) + 1e-12)
  I, and the normal tilted to n - d t1 - e t2, normalised; then the
  bilateral passes over the closest min(16, k) neighbours, with weights
  exp(-d^2 / s^2) exp(-((1 - n_j . n_i) / sigma_r)^2), s^2 the median of
  every valid off-self squared spacing among them.

Everything else of the step is `dss_step.py`'s, loaded by path from beside
this file through the harness's loader (which imports nothing of the
program) and reused, not copied.

Departures from the spec:
- the kNN is dss_step's brute force (the float32 matmul expansion
  |q|^2 + |r|^2 - 2 q.r, torch.topk), not the spec's;
- the 6 x 6 systems go through `torch.linalg.solve` (LU with partial
  pivoting), as XLA's `jnp.linalg.solve` does, not through the
  program's call;
- the PCA eigenvectors come from `torch.linalg.eigh`, not XLA's;
- the median is numpy's (the mean of the two middle values of an even
  count, as `jnp.nanmedian` takes it), computed on the values that are
  not NaN; `median="lower"` takes torch's lower middle instead, a reading
  the benchmark reports beside its checks and does not gate on.

TF32 is off unless the caller turns it on (the benchmark's control does).
It imports nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from benchmark.harness import load_module


D = load_module(Path(__file__).resolve().parent / "dss_step.py")

# What the benchmark's work counts and adapters read of a reference module.
Raster, Recipe, Cameras, PointLights = D.Raster, D.Recipe, D.Cameras, D.PointLights
normalize, prepare_splats, rasterize_rows = (D.normalize, D.prepare_splats,
                                             D.rasterize_rows)
visible_points, support_radius2 = D.visible_points, D.support_radius2
backward_scaler = D.backward_scaler
vrk_h_global, vrk_h_isotropic = D.vrk_h_global, D.vrk_h_isotropic


@dataclasses.dataclass(frozen=True)
class Anchor:
    """The normal term: its weight, the anchor ("pca" or "jet"), the
    neighbourhood k, and the jet's passes, bilateral neighbours, passes
    and sigma_r (refine_normals' defaults, as the loss calls it)."""

    weight: float
    kind: str = "pca"
    k: int = 8
    jet_passes: int = 2
    bilateral_k: int = 16
    bilateral_iters: int = 2
    bilateral_sigma: float = 0.5
    median: str = "mean"  # "mean": numpy's; "lower": torch.nanmedian's


def median_of(x: torch.Tensor, rule: str = "mean") -> torch.Tensor:
    """The median of the entries of x that are not NaN, NaN where there is
    none: the mean of the two middle values for an even count ("mean"),
    or the lower of them ("lower")."""
    v = x.reshape(-1)
    v = torch.sort(v[~torch.isnan(v)]).values
    n = v.numel()
    if n == 0:
        return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    if rule == "lower" or n % 2:
        return v[(n - 1) // 2]
    return (v[n // 2 - 1] + v[n // 2]) * 0.5


def pca_target(points, mask, k: int) -> torch.Tensor:
    """Unit PCA normals of each point's k-NN covariance."""
    _, vecs = D.local_frames(points, mask, k)
    return D.normalize(vecs[:, :, 0])


def jet_target(points, normals, mask, a: Anchor) -> torch.Tensor:
    """The jet refinement of `normals` over the cloud (see the module's
    docstring); masked-out points keep their normals, normalised."""
    p = points.shape[0]
    k = min(max(a.k, 16), p)
    d2, idx = D.knn_points(points, points, mask, mask, k=k)
    valid = (idx >= 0) & mask[:, None]
    vf = valid.to(points.dtype)
    rel = (D.masked_gather(points, idx) - points[:, None, :]) * vf[..., None]
    d2 = torch.where(valid, d2, 0.0)
    h2 = D.eps_denom(torch.sum(d2, dim=1) / D.eps_denom(torch.sum(vf, dim=1)))
    wt = torch.exp(-d2 / h2[:, None]) * vf
    eye = torch.eye(6, dtype=points.dtype, device=points.device)
    n = D.normalize(normals)
    for _ in range(a.jet_passes):
        frame = D.tangent_frame(n)
        t1, t2 = frame[:, 0], frame[:, 1]
        u = torch.sum(rel * t1[:, None, :], dim=-1)
        v = torch.sum(rel * t2[:, None, :], dim=-1)
        w = torch.sum(rel * n[:, None, :], dim=-1)
        design = torch.stack([u * u, u * v, v * v, u, v, torch.ones_like(u)],
                             dim=-1)  # (P, K, 6)
        weighted = design * wt[..., None]
        gram = weighted.transpose(1, 2) @ design  # (P, 6, 6)
        rhs = weighted.transpose(1, 2) @ w[..., None]  # (P, 6, 1)
        tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
        gram = gram + (1e-7 * tr + 1e-12)[:, None, None] * eye
        coef = torch.linalg.solve(gram, rhs)[..., 0]
        tilted = D.normalize(n - coef[:, 3:4] * t1 - coef[:, 4:5] * t2)
        n = torch.where(mask[:, None], tilted, n)

    kb = min(a.bilateral_k, k)
    if kb < 2:
        return n
    idx_b, d2_b, valid_b = idx[:, :kb], d2[:, :kb], valid[:, :kb]
    med = median_of(torch.where(valid_b[:, 1:], d2_b[:, 1:], torch.nan),
                    a.median)
    s2 = D.eps_denom(torch.where(torch.isfinite(med), med, 1.0))
    for _ in range(a.bilateral_iters):
        nb = D.masked_gather(n, idx_b)
        cosd = 1.0 - torch.sum(nb * n[:, None, :], dim=-1)
        wb = (torch.exp(-d2_b / s2)
              * torch.exp(-((cosd / a.bilateral_sigma) ** 2))
              * valid_b.to(points.dtype))
        smooth = torch.sum(wb[..., None] * nb, dim=1)
        n = torch.where(mask[:, None], D.normalize(smooth), n)
    return n


def anchor_target(points, normals, mask, a: Anchor) -> torch.Tensor:
    """The anchor's target of the cloud (no gradient); `normals` unit."""
    with torch.no_grad():
        if a.kind == "jet":
            return jet_target(points, normals, mask, a)
        if a.kind == "pca":
            return pca_target(points, mask, a.k)
    raise ValueError(f"unknown normal anchor {a.kind!r}")


def normal_loss(points, normals_raw, mask, a: Anchor) -> torch.Tensor:
    """Masked mean of 1 - cos(n, s * t), unweighted."""
    n = D.normalize(normals_raw)
    t = anchor_target(points.detach(), n.detach(), mask, a)
    s = torch.where(torch.sum(n.detach() * t, dim=-1, keepdim=True) < 0,
                    -1.0, 1.0)
    return D.masked_mean(1.0 - torch.sum(n * t * s, dim=-1), mask)


class AnchorTrainer(D.ReferenceTrainer):
    """dss_step's trainer with the normal term added to the total after
    the surface regularisers, as the program adds it."""

    def __init__(self, raster: Raster, recipe: Recipe, anchor: Anchor,
                 *args, **kwargs):
        super().__init__(raster, recipe, *args, **kwargs)
        self.anchor = anchor

    def loss(self, params, cams: Cameras, lights: PointLights, img, mask_img,
             depth_img):
        total, parts, visibility, inmask = super().loss(
            params, cams, lights, img, mask_img, depth_img)
        if self.anchor.weight > 0:
            parts["loss_dr_normal"] = normal_loss(
                params[0], params[1], self.activation,
                self.anchor) * self.anchor.weight
            total = total + parts["loss_dr_normal"]
        return total, parts, visibility, inmask
