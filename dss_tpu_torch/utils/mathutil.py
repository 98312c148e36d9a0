"""Numerically-safe math primitives (counterpart of dss_tpu/utils/mathutil.py).

Sign-preserving epsilon division and clamped sqrt with eps=1e-17, the
reference's helpers, so that the EWA math downstream compares bit for bit
where the operation order allows.
"""
from __future__ import annotations

import struct
from typing import Tuple

import torch

from dss_tpu_torch.ops import kernels

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


def safe_sqrt(x: torch.Tensor, eps: float = SQRT_EPS) -> torch.Tensor:
    """sqrt(max(x, eps)).  torch.maximum, not clamp: at x == eps it splits
    the gradient between the two operands, as jnp.maximum does."""
    return torch.sqrt(torch.maximum(x, torch.tensor(eps, dtype=x.dtype,
                                                    device=x.device)))


def to_homogen(x: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`: v / max(‖v‖, eps)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# fdlibm's tanf polynomial (k_tanf.c), and π/4 as a high and a low part.
_TAN_T = [_f32(b) for b in (
    0x3EAAAAAB, 0x3E088889, 0x3D5D0DD1, 0x3CB327A4, 0x3C11371F, 0x3B6B6916,
    0x3ABEDE48, 0x3A1A26C8, 0x398137B9, 0x38A3F445, 0x3895C07A, 0xB79BAE5F,
    0x37D95384)]
_PIO4, _PIO4LO = _f32(0x3F490FDA), _f32(0x33222168)
_HPI = float.fromhex("0x1.921fb54442d18p0")  # π/2 as a double
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/π · 2²⁴


def _clear_low12(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & -4096).view(torch.float32)


def tan_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 tan, bit for bit as the JAX package's `jnp.tan` computes it
    on the CPU, where XLA calls the C library's tanf (glibc's: fdlibm's
    kernel after a double-precision reduction modulo π/2).  Each step is a
    separate float32 (or float64) torch op, so it rounds the same on every
    device and torch build; `torch.tan` is correctly rounded on some hosts
    and not on others, and differs from tanf by an ulp at 60°.  Held
    against `jnp.tan` over every float32 of magnitude in [2⁻¹⁵, π/2] and
    a sample up to 120.  For |x| ≥ 120, outside that reduction, it returns
    `torch.tan`."""
    t = _TAN_T
    big_arg = x.abs() >= 120.0
    reduce = x.abs().view(torch.int32) > 0x3F490FDA  # |x| > π/4
    # Quadrant n = round(x·2/π); x − n·π/2 in double, split in two floats.
    n = (((x.double() * _HPI_INV).to(torch.int32) + 0x800000) >> 24)
    n = torch.where(reduce & ~big_arg, n, 0)
    r = x.double() - n.double() * _HPI
    y0 = r.float()
    y1 = (r - y0.double()).float()
    iy = 1.0 - 2.0 * (n & 1).float()  # +1: tan, −1: −1/tan
    # __kernel_tanf(y0, y1, iy).  Near ±π/4 it works on π/4 − |y|.
    neg = y0 < 0
    big = y0.abs() >= _f32(0x3F2CA140)  # 0.6744
    sgn = torch.where(neg, -1.0, 1.0)
    xb = ((_PIO4 - torch.where(neg, -y0, y0))
          + (_PIO4LO - torch.where(neg, -y1, y1)))
    xx = torch.where(big, xb, y0)
    yy = torch.where(big, 0.0, y1)
    z = xx * xx
    w = z * z
    r = t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * (t[9] + w * t[11]))))
    v = z * (t[2] + w * (t[4] + w * (t[6] + w * (t[8] + w * (t[10]
                                                             + w * t[12])))))
    s = z * xx
    r = yy + z * (s * (r + v) + yy)
    r = r + t[0] * s
    w = xx + r
    out_big = sgn * (iy - 2.0 * (xx - (w * w / (w + iy) - r)))
    out_big = torch.where(xx.abs() < 2.0 ** -13,
                          sgn * iy * (1.0 - (2.0 * iy) * xx), out_big)
    # −1/w, computed with a split of w and of its reciprocal
    zh = _clear_low12(w)
    a = -1.0 / w
    th = _clear_low12(a)
    out_inv = th + a * ((1.0 + th * zh) + th * (r - (zh - xx)))
    out = torch.where(big, out_big, torch.where(iy > 0, w, out_inv))
    tiny = y0.abs() < 2.0 ** -13
    out = torch.where(tiny & ~big, torch.where(iy > 0, y0, -1.0 / (y0 + y1)),
                      out)
    return torch.where(big_arg, torch.tan(x), out)


def det2x2(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 2, 2)."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2x2(m: torch.Tensor, eps: float = DENOM_EPS) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) with an eps-guarded determinant."""
    det = eps_denom(det2x2(m), eps)
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


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


class _SymEig3(torch.autograd.Function):
    """`kernels.symeig3` with the gradient of `jnp.linalg.eigh` (whose input
    is symmetrised): from the eigenvalues V diag(ḡw) Vᵀ, from the
    eigenvectors V (F ∘ Vᵀḡv) Vᵀ with F_ij = 1/(λ_j − λ_i) off the
    diagonal, the sum symmetrised.  An output that the loss does not use
    adds nothing (JAX's symbolic zero), so degenerate eigenvalues leave
    the eigenvalue gradient finite."""

    @staticmethod
    def forward(ctx, mats):
        batch = mats.shape[:-2]
        w, v = kernels.symeig3(mats.reshape(-1, 3, 3).contiguous())
        w, v = w.reshape(*batch, 3), v.reshape(*batch, 3, 3)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, grad_w, grad_v):
        w, v = ctx.saved_tensors
        vt = v.transpose(-1, -2)
        inner = torch.zeros_like(v)
        if grad_w is not None:
            inner = inner + torch.diag_embed(grad_w)
        if grad_v is not None:
            eye = torch.eye(3, dtype=w.dtype, device=w.device)
            f = torch.reciprocal(eye + w[..., None, :] - w[..., :, None]) - eye
            inner = inner + f * (vt @ grad_v)
        g = v @ inner @ vt
        return 0.5 * (g + g.transpose(-1, -2))


def symeig3x3(mats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric 3×3 eigendecomposition of the lower triangle:
    (eigenvalues (..., 3) ascending, eigenvectors (..., 3, 3) as columns),
    through the eigensolver kernel (ops/kernels.py `symeig3`: cyclic
    Jacobi, one launch, no host read, so a CUDA graph captures it).  The
    eigenvectors' signs are the solver's own (LAPACK and XLA pick others);
    differentiable as `jnp.linalg.eigh` is."""
    if mats.shape[-2:] != (3, 3):
        raise ValueError(f"symeig3x3: expected (..., 3, 3), got "
                         f"{tuple(mats.shape)}")
    return _SymEig3.apply(mats)
