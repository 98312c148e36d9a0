"""Coverage-driven point reseeding: spawn new points where the rendered
silhouette misses the GT masks (counterpart of dss_tpu/models/reseed.py).

Silhouette deficit pixels (GT mask on, predicted alpha off) are
back-projected through the visual hull: a candidate must project inside
the GT mask in about every view, the criterion `prune_outside_silhouette`
enforces, so a reseeded point is not pruned again at once.  Candidates sit
at the ends of each ray's hull interval, or at the GT depth where dense
depth is given.

GT-free: only the training masks and cameras, never the GT cloud.  The
deficit masks, the ray subset (numpy's RandomState, the JAX package's
stream), the carving and the greedy dedupe are host numpy, as in the JAX
package; the camera transforms, the mask sampling and the two kNN calls
run on the points' device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.knn import knn_points
from dss_tpu_torch.models.point_model import prune_outside_silhouette


def _np(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _erode(d: np.ndarray) -> np.ndarray:
    d = d & np.roll(d, 1, 1) & np.roll(d, -1, 1)
    return d & np.roll(d, 1, 2) & np.roll(d, -1, 2)


def coverage_deficit_masks(gt_masks, pred_alpha, erode: int = 1) -> np.ndarray:
    """(V, S, S) bool: GT silhouette on, predicted alpha off, eroded so that
    1-pixel silhouette-edge aliasing does not count as deficit."""
    deficit = (_np(gt_masks) > 0.5) & (_np(pred_alpha) < 0.25)
    for _ in range(max(0, erode)):
        deficit = _erode(deficit)
    return deficit


def _pix_to_ndc(idx: np.ndarray, size: int) -> np.ndarray:
    """Pixel index → NDC with the reference's centre rule and the image/NDC
    sign flip (+X left, +Y up; the mask-sampling convention of
    point_model_forward)."""
    return -((2.0 * idx + 1.0) / size - 1.0)


def _none() -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)


def reseed_coverage(
    points: torch.Tensor,
    active: torch.Tensor,
    cameras: FoVPerspectiveCameras,
    gt_masks: torch.Tensor,
    pred_alpha,
    n_new: int = 256,
    depth_samples: int = 48,
    hull_outside_frac: float = 0.05,
    dedupe_radius: Optional[float] = None,
    max_rays: int = 4096,
    seed: int = 0,
    gt_depths=None,
    pred_depths=None,
    depth_tol: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Propose up to n_new world-space positions filling coverage deficits.

    Silhouette deficits: `depth_samples` candidates per deficit ray between
    the active cloud's per-view depth bounds; a candidate survives if it
    projects inside the GT mask in ≥ (1 − hull_outside_frac) of the views,
    and each ray keeps the two ends of its hull interval (they lie on the
    hull boundary, near the surface).  Proposals are then taken
    farthest-from-the-cloud first, each at least `dedupe_radius` (default:
    the median active spacing) from those taken before.

    Depth deficits (gt_depths and pred_depths given): pixels inside the
    mask whose rendered front surface lies more than depth_tol behind the
    GT depth; every deficit ray then places its candidate at the GT depth.

    points (P, 3), active (P,), gt_masks (V, S, S) on the points' device;
    pred_alpha and the depths (V, S, S) tensors or arrays.  Returns
    (positions (M, 3) float32, nearest_idx (M,) int32, the nearest active
    point of each, to copy colours and normals from), M ≤ n_new, as numpy.
    """
    dev = points.device
    rng = np.random.RandomState(seed)
    pts = _np(points).astype(np.float32)
    act = _np(active).astype(bool)
    gm = _np(gt_masks)
    s = gm.shape[-1]
    masks_dev = torch.as_tensor(gm, dtype=torch.float32, device=dev)

    deficit = coverage_deficit_masks(gm, pred_alpha)
    gt_depth_at = None
    if gt_depths is not None and pred_depths is not None:
        gd = _np(gt_depths).astype(np.float32)
        pd = _np(pred_depths).astype(np.float32)
        ddef = (gm > 0.5) & (_np(pred_alpha) >= 0.25) & (pd - gd > depth_tol)
        # eroded like the mask deficit: 1-px depth-edge aliasing is ignored
        deficit = deficit | _erode(ddef)
        gt_depth_at = gd
    vidx, yidx, xidx = np.nonzero(deficit)
    if vidx.size == 0:
        return _none()
    if vidx.size > max_rays:
        sel = rng.choice(vidx.size, max_rays, replace=False)
        vidx, yidx, xidx = vidx[sel], yidx[sel], xidx[sel]
    n_rays = vidx.size

    ndc_x = _pix_to_ndc(xidx.astype(np.float32), s)
    ndc_y = _pix_to_ndc(yidx.astype(np.float32), s)

    def unproject_rays(ray_view, ray_ndc_x, ray_ndc_y, ray_depth):
        """Per-ray unprojection, batched by view."""
        out = np.zeros((ray_view.size, 3), np.float32)
        for view in np.unique(ray_view):
            m = ray_view == view
            nd = torch.as_tensor(np.stack([ray_ndc_x[m], ray_ndc_y[m]], -1),
                                 device=dev)
            dep = torch.as_tensor(ray_depth[m], device=dev)
            sub = FoVPerspectiveCameras(**{
                f: getattr(cameras, f)[view:view + 1]
                for f in ("R", "T", "fov", "znear", "zfar", "aspect_ratio")})
            out[m] = _np(sub.unproject_ndc_depth(nd[None], dep[None])[0])
        return out

    def in_hull(cand: np.ndarray) -> np.ndarray:
        """(C,) bool: inside the GT mask in ≥ (1 − hull_outside_frac) of
        the views."""
        return _np(prune_outside_silhouette(
            torch.as_tensor(cand, device=dev), cameras, masks_dev,
            outside_frac=hull_outside_frac))

    if gt_depth_at is not None:
        # exact placement: the GT depth map gives the missing surface point
        # on every deficit ray (silhouette and occluded deficits alike)
        dep = gt_depth_at[vidx, yidx, xidx]
        valid = dep < 0.99 * _np(cameras.zfar)[vidx]
        best = unproject_rays(vidx[valid], ndc_x[valid], ndc_y[valid],
                              dep[valid])
        if best.shape[0] == 0:
            return _none()
        best = best[in_hull(best)]
    else:
        # per-view depth bounds of the active cloud, padded 15% so that
        # candidates may sit a little outside the current depth envelope
        view_z = _np(cameras.transform_points_world_to_view(
            torch.as_tensor(pts, device=dev)))[..., 2]  # (V, P)
        zsel = np.where(act[None, :], view_z, np.nan)
        zmin = np.nanmin(zsel, axis=1)
        zmax = np.nanmax(zsel, axis=1)
        pad = 0.15 * (zmax - zmin)
        zmin, zmax = zmin - pad, zmax + pad

        frac = (np.arange(depth_samples, dtype=np.float32) + 0.5) / depth_samples
        depths = zmin[vidx, None] + frac[None, :] * (zmax - zmin)[vidx, None]
        cand = unproject_rays(
            np.repeat(vidx, depth_samples),
            np.repeat(ndc_x, depth_samples),
            np.repeat(ndc_y, depth_samples),
            depths.reshape(-1),
        ).reshape(n_rays, depth_samples, 3)

        # visual-hull test: inside the GT mask in about every view
        inside = in_hull(cand.reshape(-1, 3)).reshape(n_rays, depth_samples)
        if not inside.any():
            return _none()

        # per ray the two ends of the hull-interior interval: a deficit ray
        # misses both the front and the back surface, and the interval's
        # ends lie on the hull boundary, tangent to the surface where it
        # makes the silhouette (the midpoint would sit deep inside)
        di = np.arange(depth_samples, dtype=np.float32)[None, :]
        lo = np.where(inside, di, np.inf).min(axis=1)
        hi = np.where(inside, di, -np.inf).max(axis=1)
        ridx = np.nonzero(np.isfinite(lo))[0]
        best = np.concatenate([cand[ridx, lo[ridx].astype(int)],
                               cand[ridx, hi[ridx].astype(int)]])
    if best.shape[0] == 0:
        return _none()

    # distance of each proposal to the active cloud; fill farthest-first
    pts_dev = torch.as_tensor(pts, device=dev)
    act_dev = torch.as_tensor(act, device=dev)
    d2, idx = knn_points(torch.as_tensor(best, device=dev), pts_dev,
                         ref_mask=act_dev, k=1)
    dist = np.sqrt(_np(d2)[:, 0])
    near = _np(idx)[:, 0].astype(np.int32)
    if dedupe_radius is None:
        # the median active spacing (numpy's median: the mean of the two
        # middle values): new points pack as densely as the surface
        dd, _ = knn_points(pts_dev, pts_dev, query_mask=act_dev,
                           ref_mask=act_dev, k=2, exclude_self=True)
        spacing = np.sqrt(_np(dd)[:, 0])
        dedupe_radius = float(np.median(spacing[act]))

    order = np.argsort(dist)[::-1]
    chosen: list = []
    for i in order:
        if len(chosen) >= n_new:
            break
        if dist[i] <= dedupe_radius:
            break  # the rest are closer still to the existing surface
        if chosen:
            sel = best[np.asarray(chosen)]
            if np.min(np.linalg.norm(sel - best[i], axis=-1)) < dedupe_radius:
                continue
        chosen.append(i)
    if not chosen:
        return _none()
    ci = np.asarray(chosen)
    return best[ci].astype(np.float32), near[ci]
