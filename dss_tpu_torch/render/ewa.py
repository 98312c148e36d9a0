"""Screen-space EWA splat setup (counterpart of dss_tpu/render/ewa.py).

Per point and view: the projected Gaussian covariance
GV = Mkᵀ Vrk Mk + σ_aa (2/S)² I, the conic (a, b, c) of its inverse
Q(d) = a·dx² + b·dx·dy + c·dy², the axis-aligned NDC radii from the cutoff,
and the normalization scaler |det Mk| / √(4π² det GV).

`prepare_splats` runs for all V views at once: the camera fields carry a
leading view axis and every output is (V, P, ...).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.knn import knn_points
from dss_tpu_torch.geometry.normals import estimate_local_coord_frames
from dss_tpu_torch.utils import spans
from dss_tpu_torch.utils.mathutil import (
    det2x2,
    eps_denom,
    eps_sqrt,
    psd_regularized_det2x2,
    tangent_frame,
    to_homogen,
)


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Rasterization knobs, named as in the JAX package.  The TPU layout
    knobs (tiled_io, mxu_quadric, matmul_scatter) have no counterpart.

    backend: "reference" is the plain-PyTorch spec (render/rasterizer.py);
    "pallas" and "auto" are the tile-binned splat ops, which launch the
    CUDA kernels for CUDA tensors and run their plain versions for CPU
    tensors.  (The JAX package resolves "auto" to "reference" off the TPU;
    the port resolves it to the tile-binned ops on every device.)"""

    image_size: int = 256
    points_per_pixel: int = 5
    cutoff_threshold: float = 1.0
    depth_merging_threshold: float = 0.05
    antialiasing_sigma: float = 1.0
    # Occupancy-gradient support radius multiplier (annealed in training).
    radii_backward_scaler: float = 10.0
    Vrk_invariant: bool = False
    Vrk_isotropic: bool = True
    backface_culling: bool = True
    clip_pts_grad: float = -1.0
    backend: str = "auto"
    # Pixels per tile side, candidate capacity per tile, candidate chunk.
    tile_size: int = 64
    bin_capacity: int = 512
    bin_chunk: int = 128
    # Max tiles a splat may span per axis; -1 = auto (4, or 2 above 20k).
    max_tiles_per_splat: int = -1
    # Live-pair caps per splat for the binning sorts; -1 = auto.
    pair_cap_scale_fwd: float = -1.0
    pair_cap_scale_bwd: float = -1.0
    # Tile-binned path without per-pixel fragment buffers (K1); False
    # renders the K-slot idx/zbuf/qvalue buffers (K5).
    lean_fragments: bool = True
    # Weighted-depth channel: Σw·z rides as a fifth compositor column.
    depth_channel: bool = False

    def replace(self, **kw) -> "RasterSettings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SplatInfo:
    """Per-splat screen-space data for V views (all (V, P, ·))."""

    pts_screen: torch.Tensor  # (V, P, 3) ndc x, y, view z
    ellipse_params: torch.Tensor  # (V, P, 3) conic (a, b, c)
    cutoff: torch.Tensor  # (V, P) Q cutoff; -inf disables a splat
    radii: torch.Tensor  # (V, P, 2) axis-aligned NDC half-extents
    scaler: torch.Tensor  # (V, P) EWA normalization
    mask: torch.Tensor  # (V, P) bool: renderable after culling


def _self_knn7(points, mask):
    sq, _ = knn_points(points, points, mask, mask, k=7)
    return sq


def compute_vrk_h_isotropic(points, mask=None, clamp_lo: float = 5e-5,
                            clamp_hi: float = 0.01) -> torch.Tensor:
    """Per-point isotropic kernel size h_k = clamp(0.5·max of 6-NN sq
    dists), (P,)."""
    with spans.span("model.vrk"):
        sq = _self_knn7(points, mask)
        sq = torch.where(torch.isfinite(sq), sq, 0.0)
        h = 0.5 * torch.amax(sq[:, 1:], dim=-1)
        return torch.clamp(h, clamp_lo, clamp_hi)


_VRK_GLOBAL_EXACT_MAX = 8192  # below: exact mean (flagship 5k)
_VRK_GLOBAL_SAMPLES = 4096


def compute_vrk_h_global(points, mask=None, clamp_lo: float = 5e-5,
                         clamp_hi: float = 1e-3) -> torch.Tensor:
    """Scale-invariant global kernel size: mean over the cloud of the
    per-point h_k, clamped; a scalar ().  Clouds above 8192 points take the
    mean over a deterministic stride of 4096 active query points, each
    matched against the full cloud, as the JAX package does."""
    p = points.shape[0]
    with spans.span("model.vrk"):
        if mask is None:
            mask = torch.ones((p,), dtype=torch.bool, device=points.device)
        if p > _VRK_GLOBAL_EXACT_MAX:
            order = torch.argsort(torch.logical_not(mask).to(torch.int32),
                                  stable=True)
            n_active = torch.clamp(torch.sum(mask.to(torch.int64)), min=1)
            pos = (torch.arange(_VRK_GLOBAL_SAMPLES, device=points.device)
                   * n_active // _VRK_GLOBAL_SAMPLES)
            qi = order[pos]
            sq, _ = knn_points(points[qi], points, mask[qi], mask, k=7)
            qmask = mask[qi]
        else:
            sq = _self_knn7(points, mask)
            qmask = mask
        sq = torch.where(torch.isfinite(sq), sq, 0.0)
        h = 0.5 * torch.amax(sq[:, 1:], dim=-1)
        w = qmask.to(points.dtype)
        h_mean = torch.sum(h * w) / eps_denom(torch.sum(w))
        return torch.clamp(h_mean, clamp_lo, clamp_hi)


def vrk_kernel_size(points, mask, settings: RasterSettings,
                    vrk_h: Optional[torch.Tensor] = None):
    """The kernel size h of the normals' frame: `vrk_h` where given, else
    the global h (Vrk-invariant) or the per-point h (isotropic); None in
    the anisotropic mode, whose Vrk is the neighbourhood's PCA."""
    if not (settings.Vrk_invariant or settings.Vrk_isotropic):
        return None
    if vrk_h is not None:
        return vrk_h
    if settings.Vrk_invariant:
        return compute_vrk_h_global(points, mask)
    return compute_vrk_h_isotropic(points, mask)


def compute_vrk(points, normals, mask, settings: RasterSettings,
                vrk_h: Optional[torch.Tensor] = None):
    """World-space splat covariance Vrk (P, 3, 3) and tangent frame Sk
    (P, 2, 3).

    Vrk-invariant and isotropic: h·SkᵀSk over the normals' tangent frame
    (h from `vrk_kernel_size`).  Anisotropic: the local PCA frame of the
    8-NN neighbourhood, once for all views; the two tangent eigenvalues
    set the splat's principal extents, Vrk = Σₖ curvₖ·tₖtₖᵀ, and Sk is the
    tangents.  A sign flip of one tangent flips det(Sk·Mk) only in sign,
    and the scaler takes |det Mk|, so the eigenvectors' arbitrary signs do
    not matter."""
    h = vrk_kernel_size(points, mask, settings, vrk_h)
    if h is not None:
        sk = tangent_frame(normals)
        h = torch.broadcast_to(h, points.shape[:1])
    else:
        with spans.span("model.vrk"):
            curv, frames = estimate_local_coord_frames(points, mask,
                                                       neighborhood_size=8)
            tangents = frames[:, :, 1:]  # (P, 3, 2): columns = tangent dirs
            vrk = torch.einsum("pik,pk,pjk->pij", tangents, curv[:, 1:],
                               tangents)
            return vrk, tangents.transpose(1, 2)
    vrk = h[:, None, None] * torch.einsum("pia,pib->pab", sk, sk)
    return vrk, sk


def compute_wjk(points: torch.Tensor,
                cameras: FoVPerspectiveCameras) -> torch.Tensor:
    """Jacobian Mk = W @ Jk (V, P, 3, 2) of the full world→NDC projection
    at each point, for every camera."""
    m44 = cameras.full_projection_matrix()  # (V, 4, 4)
    hom = to_homogen(points)  # (P, 4)
    t = hom @ m44[:, :, 3].T  # (P, V)
    t = t.T  # (V, P)
    xy_view = hom @ m44[:, :, :2]  # (V, P, 2)
    inv_t = 1.0 / eps_denom(t)
    inv_t2 = 1.0 / eps_denom(t * t)
    # Jk (4 × 2) is [[1/t, 0], [0, 1/t], [0, 0], [jx, jy]]: each entry of
    # W[:3] @ Jk is the sum of two products, written out so that it rounds
    # the same at every shape (as one batched GEMM its order of summation
    # is cuBLAS's choice by shape: an FMA chain at some, two products and
    # a sum at others).
    jx = (-xy_view[..., 0] * inv_t2)[..., None]
    jy = (-xy_view[..., 1] * inv_t2)[..., None]
    inv_t = inv_t[..., None]
    w = m44[:, None, :3, :]  # (V, 1, 3, 4)
    return torch.stack([w[..., 0] * inv_t + w[..., 3] * jx,
                        w[..., 1] * inv_t + w[..., 3] * jy], dim=-1)


def ellipse_axis_aligned_radius(cutoff, ellipse_params) -> torch.Tensor:
    """Axis-aligned NDC half-extents of {d: Q(d) ≤ cutoff}:
    x = √(4c·C/(4ac−b²)), y = √(4a·C/(4ac−b²))."""
    a = ellipse_params[..., 0]
    b = ellipse_params[..., 1]
    c = ellipse_params[..., 2]
    denom = eps_denom(4.0 * a * c - b * b)
    x = torch.sqrt(eps_sqrt(4.0 * c * cutoff / denom))
    y = torch.sqrt(eps_sqrt(4.0 * a * cutoff / denom))
    return torch.stack([x, y], dim=-1)


def backface_mask(normals, cameras: FoVPerspectiveCameras) -> torch.Tensor:
    """(V, P) True for camera-facing points: view-space normal z < 0."""
    return (normals @ cameras.R[:, :, 2].T).T < 0.0


def prepare_splats(points, normals, mask, cameras: FoVPerspectiveCameras,
                   settings: RasterSettings,
                   vrk_h: Optional[torch.Tensor] = None) -> SplatInfo:
    """Full per-point rasterization setup for V cameras.

    Culling (depth range, backface) is a mask update.  The EWA quantities
    are detached, as in the reference; position gradients flow only
    through `pts_screen`."""
    pts_view = cameras.transform_points_world_to_view(points)  # (V, P, 3)
    depth_ok = ((pts_view[..., 2] >= cameras.znear[:, None])
                & (pts_view[..., 2] <= cameras.zfar[:, None]))
    render_mask = mask[None] & depth_ok
    if settings.backface_culling:
        render_mask = render_mask & backface_mask(normals, cameras)

    # Double-where NaN guard: a depth-culled point near the camera plane
    # has an unbounded d(ndc)/d(point); its rasterizer cotangent is zero,
    # but 0·∞ = NaN would poison the gradient, so the projection never sees
    # it — it is replaced by a dummy at view depth 1 before the transform.
    dummy = (cameras.camera_position() + cameras.R[:, :, 2]).detach()
    safe_points = torch.where(depth_ok[..., None], points[None],
                              dummy[:, None, :])
    pts_screen = cameras.transform_points_screen(safe_points)  # (V, P, 3)

    with torch.no_grad():
        mk = compute_wjk(points, cameras)  # (V, P, 3, 2)
        vrk, sk = compute_vrk(points, normals, mask, settings, vrk_h)
        # GV = Mkᵀ Vrk Mk + σ_aa (2/S)² I in float32 (TF32 is off).
        gv = mk.transpose(-1, -2) @ (vrk[None] @ mk)
        pixel_size = 2.0 / settings.image_size
        lam = settings.antialiasing_sigma * pixel_size**2
        gv = gv + lam * torch.eye(2, device=gv.device)
        det_mk = det2x2(sk[None] @ mk)
        # det(GV) floored at the PSD lower bound λ·tr − λ² (a sign-flipped
        # det makes the conic negative-definite and the composite NaN).
        det_gv = psd_regularized_det2x2(gv, lam)
        ellipse = (
            torch.stack(
                [gv[..., 1, 1], -(gv[..., 0, 1] + gv[..., 1, 0]), gv[..., 0, 0]],
                dim=-1,
            )
            / det_gv[..., None]
        )
        cutoff = torch.full(det_gv.shape, settings.cutoff_threshold,
                            dtype=points.dtype, device=points.device)
        radii = ellipse_axis_aligned_radius(cutoff, ellipse)
        scaler = torch.abs(det_mk) / eps_denom(
            torch.sqrt(eps_sqrt(det_gv * 4.0 * math.pi**2))
        )
        # Culled points: zero radii + -inf cutoff → never rasterized.
        cutoff = torch.where(render_mask, cutoff, -math.inf)
        radii = radii * render_mask[..., None]
    return SplatInfo(
        pts_screen=pts_screen,
        ellipse_params=ellipse,
        cutoff=cutoff,
        radii=radii,
        scaler=scaler,
        mask=render_mask,
    )
