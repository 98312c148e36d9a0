"""Numerically-safe math primitives (counterpart of dss_tpu/utils/mathutil.py).

Sign-preserving epsilon division and clamped sqrt with eps=1e-17, the
reference's helpers, so that the EWA math downstream compares bit for bit
where the operation order allows.
"""
from __future__ import annotations

import torch

DENOM_EPS = 1e-17
SQRT_EPS = 1e-17


def eps_denom(denom: torch.Tensor, eps: float = DENOM_EPS) -> torch.Tensor:
    """Sign-preserving epsilon guard for denominators; zero maps to +eps."""
    sign = torch.sign(denom) + (denom == 0.0).to(denom.dtype)
    return sign * torch.clamp(torch.abs(denom), min=eps)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative convention, d|x|/dx = 1 at x = 0
    (torch.abs gives 0 there); the losses use it so that pixels where the
    prediction equals the target carry the reference's gradient."""
    return torch.where(x >= 0, x, -x)


def eps_sqrt(x: torch.Tensor, eps: float = SQRT_EPS) -> torch.Tensor:
    """sqrt-safe clamp."""
    return torch.clamp(x, min=eps)


def to_homogen(x: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`: v / max(‖v‖, eps)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def det2x2(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 2, 2)."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def psd_regularized_det2x2(m: torch.Tensor, lam: float) -> torch.Tensor:
    """det(A + lam·I) for A PSD in exact arithmetic, floored at the
    cancellation-free bound lam·tr(m) − lam² (see the JAX twin for why a
    sign-flipped determinant must never reach the conic)."""
    return torch.maximum(
        det2x2(m), lam * (m[..., 0, 0] + m[..., 1, 1]) - lam * lam
    )


def tangent_frame(normals: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Deterministic orthonormal tangent basis Sk (…, 2, 3) for unit normals
    (branch-free Duff et al. construction, as in the JAX package)."""
    n = normalize(normals, eps=eps)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z + torch.where(z >= 0, eps, -eps).to(n.dtype))
    b = x * y * a
    u0 = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    u1 = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return torch.stack([u0, u1], dim=-2)
