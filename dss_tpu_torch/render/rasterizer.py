"""Elliptical splat rasterization: the reference spec in plain PyTorch, the
fragment containers and the per-point gradient clip (counterpart of
dss_tpu/render/rasterizer.py).

The spec tests every pixel against every point, keeps each pixel's K
nearest covering splats by z and truncates them at the first fragment with
z − z₀ > depth_merging_threshold.  Its backward is the reference's
hand-defined occupancy field (median-radius support disc, d/max(‖d‖², ε))
plus the scatter of the zbuf cotangent into the rasterized points; the
qvalue cotangent is dropped.  It runs on any device with stock PyTorch
ops, works on a leading view axis, and is the `backend="reference"` path
and the oracle the tile-binned path is held to.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dss_tpu_torch.ops.splat import masked_median

_NO_HIT = torch.iinfo(torch.int64).max
# Bound on the (rows × S × P) pairwise working set of one row block.
_BLOCK_PAIRS = 1 << 22


@dataclasses.dataclass
class Fragments:
    """Per-view fragment outputs for a batch of V views.  The lean path
    carries no per-fragment buffers: idx/zbuf/qvalue are (V, S, S, 0)."""

    idx: torch.Tensor  # (V, S, S, K) int32, -1 padded
    zbuf: torch.Tensor  # (V, S, S, K) view-space depth, -1 padded
    qvalue: torch.Tensor  # (V, S, S, K) conic value Q, -1 padded
    occupancy: torch.Tensor  # (V, S, S) float {0, 1}
    # (V,) int32: candidates dropped by the static binning budgets
    # (forward + occupancy-backward tables); nonzero = lost fragments or
    # gradients.  Zero on the reference backend.
    overflow: Optional[torch.Tensor] = None
    # (V, S, S) weighted-mean view-space depth Σw·z/Σw, −1 where uncovered;
    # set when RasterSettings.depth_channel is on.
    wdepth: Optional[torch.Tensor] = None


def pixel_ndc_coords(image_size: int, device) -> torch.Tensor:
    """NDC centres of pixel columns (= rows): index i → 1 − (2i + 1)/S
    (+X left, +Y up), the JAX spec's operation order."""
    i = torch.arange(image_size, dtype=torch.float32, device=device)
    return 1.0 - (2.0 * i + 1.0) / image_size


def _row_blocks(image_size: int, p: int, row_chunk: int,
                rows: Optional[int] = None) -> int:
    """Rows per block: at most row_chunk, and the block's pairwise working
    set bounded; a divisor of the rows rasterized (`rows`, default S: the
    rows are independent)."""
    rows = image_size if rows is None else rows
    r = max(1, min(row_chunk, _BLOCK_PAIRS // max(image_size * p, 1)))
    while rows % r:
        r -= 1
    return r


def _rasterize_rows(pts, ellipse, cutoff, radii, depth_merging_threshold,
                    image_size: int, points_per_pixel: int, row_chunk: int,
                    row_window: Optional[Tuple[int, int]] = None):
    """Forward rasterization of V views, row block by row block; only the
    rows [start, stop) of `row_window` when one is given.

    Per pixel the K smallest z among the covering splats, ascending, ties
    to the lower point index (as jax.lax.top_k): the key is the float32 z's
    bit pattern (monotone for z ≥ 0, which every accept has) above the
    point index.  Returns (idx (V, R, S, K) int32, zbuf, qvalue
    (V, R, S, K), occ (V, R, S)), R the rows rasterized."""
    v, p = pts.shape[:2]
    s, k = image_size, points_per_pixel
    start, stop = (0, s) if row_window is None else row_window
    h = stop - start
    dev = pts.device
    xf = pixel_ndc_coords(s, dev)
    k_eff = min(k, p)
    r = _row_blocks(s, p, row_chunk, h)
    pid = torch.arange(p, device=dev)
    idx = torch.full((v, h, s, k), -1, dtype=torch.int32, device=dev)
    zbuf = torch.full((v, h, s, k), -1.0, device=dev)
    qv = torch.full((v, h, s, k), -1.0, device=dev)
    occ = torch.zeros((v, h, s), device=dev)
    for vi in range(v):
        px, py, pz = pts[vi, :, 0], pts[vi, :, 1], pts[vi, :, 2]
        a, b, c = ellipse[vi, :, 0], ellipse[vi, :, 1], ellipse[vi, :, 2]
        # +0.0 turns −0.0 into +0.0, whose bit pattern orders correctly
        zbits = (pz + 0.0).view(torch.int32).to(torch.int64)
        for r0 in range(start, stop, r):
            dx = torch.broadcast_to(xf[None, :, None] - px, (r, s, p))
            dy = xf[r0:r0 + r, None, None] - py  # (R, 1, P)
            q = a * dx * dx + b * dx * dy + c * dy * dy
            accept = ((pz >= 0.0)
                      & (torch.abs(dx) <= radii[vi, :, 0])
                      & (torch.abs(dy) <= radii[vi, :, 1])
                      & (q <= cutoff[vi]))
            key = torch.where(accept, (zbits << 32) | pid, _NO_HIT)
            top_key, top_idx = torch.topk(key, k_eff, dim=-1, largest=False,
                                          sorted=True)
            hit = top_key != _NO_HIT
            topz = torch.where(hit, pz[top_idx], torch.inf)
            top_q = torch.gather(q, -1, top_idx)
            keep = hit & (topz - topz[..., :1] <= depth_merging_threshold)
            rows = slice(r0 - start, r0 - start + r)
            idx[vi, rows, :, :k_eff] = torch.where(keep, top_idx, -1).to(
                torch.int32)
            zbuf[vi, rows, :, :k_eff] = torch.where(keep, topz, -1.0)
            qv[vi, rows, :, :k_eff] = torch.where(keep, top_q, -1.0)
            occ[vi, rows] = accept.any(dim=-1).to(torch.float32)
    return idx, zbuf, qv, occ


def visible_points_mask(idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """(V, P) True for the points in any pixel's fragment list of their
    view (reference get_per_point_visibility_mask)."""
    v = idx.shape[0]
    flat = idx.reshape(v, -1).to(torch.int64)
    safe = torch.where(flat >= 0, flat, num_points)
    hits = torch.zeros((v, num_points + 1), dtype=torch.int64,
                       device=idx.device)
    hits.scatter_add_(1, safe, torch.ones_like(safe))
    return hits[:, :num_points] > 0


def _occ_backward(pts, radii, visible, grad_occ, radii_backward_scaler,
                  image_size: int, row_chunk: int) -> torch.Tensor:
    """The hand-defined occupancy gradient field → (V, P, 2) xy gradients.
    Each pixel spreads g·d/max(‖d‖², 1e-10) to the visible, on-screen
    points within the support disc ‖d‖ ≤ median(visible radii, both axes
    pooled) · radii_backward_scaler; a pixel with g > 0 pushes only points
    whose splat box covers it.  Only terms that can be nonzero are
    formed: a block of rows visits just its columns with a g ≠ 0 (none:
    the block is skipped) and the points with dy² ≤ cur_r² on one of its
    rows (dist² ≥ dy²)."""
    v, p = pts.shape[:2]
    s = image_size
    dev = pts.device
    xf = pixel_ndc_coords(s, dev)
    cur_r = masked_median(radii.reshape(v, -1),
                          visible.repeat_interleave(2, dim=1))
    cur_r = cur_r * radii_backward_scaler
    cur_r2 = cur_r * cur_r
    r = _row_blocks(s, p, row_chunk)
    out = torch.zeros((v, p, 2), device=dev)
    for vi in range(v):
        px, py, pz = pts[vi, :, 0], pts[vi, :, 1], pts[vi, :, 2]
        pt_ok = (visible[vi] & (pz >= 0.0) & (torch.abs(px) <= 1.0)
                 & (torch.abs(py) <= 1.0))
        for r0 in range(0, s, r):
            cols = torch.nonzero(
                (grad_occ[vi, r0:r0 + r] != 0.0).any(dim=0)).squeeze(1)
            dy = xf[r0:r0 + r, None, None] - py
            q = torch.nonzero(
                pt_ok & (dy * dy <= cur_r2[vi]).any(dim=0)[0]).squeeze(1)
            if cols.numel() == 0 or q.numel() == 0:
                continue
            dx = torch.broadcast_to(xf[cols, None] - px[q],
                                    (r, len(cols), len(q)))
            dy = dy[..., q]
            dist2 = dx * dx + dy * dy
            outside = ((torch.abs(dx) > radii[vi, q, 0])
                       | (torch.abs(dy) > radii[vi, q, 1]))
            g = grad_occ[vi, r0:r0 + r, cols, None]
            contribute = ((dist2 <= cur_r2[vi]) & (g != 0.0)
                          & ~((g > 0.0) & outside))
            w = torch.where(contribute, g / torch.clamp(dist2, min=1e-10),
                            0.0)
            out[vi, q, 0] += torch.einsum("rsp,rsp->p", w, dx)
            out[vi, q, 1] += torch.einsum("rsp,rsp->p", w, dy)
    return out


def _zbuf_backward(idx: torch.Tensor, grad_zbuf: torch.Tensor,
                   num_points: int) -> torch.Tensor:
    """(V, P) z gradients: scatter-add of the zbuf cotangent into the
    rasterized point ids (reference _backward_zbuf)."""
    v = idx.shape[0]
    flat = idx.reshape(v, -1).to(torch.int64)
    safe = torch.where(flat >= 0, flat, num_points)
    out = torch.zeros((v, num_points + 1), dtype=grad_zbuf.dtype,
                      device=idx.device)
    out.scatter_add_(1, safe, torch.where(flat >= 0,
                                          grad_zbuf.reshape(v, -1), 0.0))
    return out[:, :num_points]


class _RasterizePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_screen, ellipse_params, cutoff, radii, image_size,
                points_per_pixel, row_chunk, dmt, rbs, row_window):
        ctx.set_materialize_grads(False)
        idx, zbuf, qv, occ = _rasterize_rows(
            pts_screen.detach(), ellipse_params, cutoff, radii, dmt,
            image_size, points_per_pixel, row_chunk, row_window,
        )
        ctx.save_for_backward(pts_screen.detach(), radii, idx)
        ctx.dims = (image_size, row_chunk, rbs, row_window)
        ctx.mark_non_differentiable(idx)
        return idx, zbuf, qv, occ

    @staticmethod
    def backward(ctx, _g_idx, g_zbuf, _g_q, g_occ):
        pts, radii, idx = ctx.saved_tensors
        image_size, row_chunk, rbs, row_window = ctx.dims
        v, p = pts.shape[:2]
        if g_occ is None:
            grad_xy = torch.zeros((v, p, 2), device=pts.device)
        elif row_window is not None:
            raise NotImplementedError(
                "the occupancy gradient of a row window: its support disc "
                "takes the median radius over the whole view's visible "
                "points, which one window does not see")
        else:
            grad_xy = _occ_backward(pts, radii, visible_points_mask(idx, p),
                                    g_occ, rbs, image_size, row_chunk)
        if g_zbuf is None:
            grad_z = torch.zeros((v, p), device=pts.device)
        else:
            grad_z = _zbuf_backward(idx, g_zbuf, p)
        grad_pts = torch.cat([grad_xy, grad_z[..., None]], dim=-1)
        return (grad_pts,) + (None,) * 9


def rasterize_points(image_size: int, points_per_pixel: int, row_chunk: int,
                     pts_screen, ellipse_params, cutoff, radii,
                     depth_merging_threshold, radii_backward_scaler,
                     row_window: Optional[Tuple[int, int]] = None):
    """Differentiable elliptical splat rasterization of V views (the
    reference spec).  pts_screen (V, P, 3) NDC x, y and view z, the only
    input that gets a gradient; ellipse_params (V, P, 3); cutoff (V, P),
    −inf disables a splat; radii (V, P, 2), 0 disables.  row_chunk bounds
    the rows evaluated at once (it does not change the result).
    `row_window` (start, stop) rasterizes only those rows of the S × S
    image; its occupancy has no gradient (the backward raises).

    Returns (idx (V, R, S, K) int32, zbuf, qvalue (V, R, S, K), occupancy
    (V, R, S)), R = S, or stop − start with a window."""
    if row_window is not None:
        start, stop = row_window
        if not 0 <= start < stop <= image_size:
            raise ValueError(f"row_window {row_window} is not a window of "
                             f"the {image_size} rows")
        row_window = (int(start), int(stop))
    return _RasterizePoints.apply(
        pts_screen, ellipse_params, cutoff, radii, image_size,
        points_per_pixel, row_chunk, depth_merging_threshold,
        radii_backward_scaler, row_window,
    )


class _ClipGradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_norm):
        ctx.max_norm = max_norm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        scale = torch.clamp(n, 0.0, ctx.max_norm) / torch.clamp(n, min=1e-12)
        return g * scale, None


def clip_grad_norm(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Identity whose backward clips per-row gradient norms to `max_norm`
    (reference clip_pts_grad=0.05)."""
    return _ClipGradNorm.apply(x, max_norm)
