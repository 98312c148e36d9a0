"""Point model: the learnable parameters are the point cloud (counterpart of
dss_tpu/models/point_model.py).

The parameters are three leaf tensors, and with upstream's neural texture
(`renderer.is_neural_texture`) the texture's decoder weights besides; the
activation / visibility / inmask filters travel separately in a
PointFilters, so autograd sees only the learnables.  Besides the train forward (and its multi-scene form over
stacked (S, P, ·) parameters): the eval render, and the three prunes (dead points by zero silhouette gradient, floaters by silhouette
and by front-depth consistency).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.render.ewa import (
    RasterSettings,
    compute_vrk_h_global,
    compute_vrk_h_isotropic,
)
from dss_tpu_torch.render.lighting import Lights
from dss_tpu_torch.render.renderer import render_views, render_views_stacked
from dss_tpu_torch.utils import spans
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import jax_abs, normalize


POINT_LEAVES = ("points", "normals", "colors")


@dataclasses.dataclass
class PointModelParams:
    """Learnable state: points, normals, colors, each (P, 3), and an
    optional neural texture (render/texture.py's NeuralTexture) whose
    decoder parameters are leaves too: with one, the texture replaces the
    lighting shade and `colors` is not read by the render."""

    points: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor
    texture: Optional[nn.Module] = None

    @classmethod
    def create(cls, points, normals=None, colors=None, device=None,
               requires_grad: bool = True,
               texture: Optional[nn.Module] = None) -> "PointModelParams":
        """On the card unless `device` says otherwise (resolve_device); a
        texture is moved to that device."""
        device = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        points = f(points)
        normals = torch.zeros_like(points) if normals is None else f(normals)
        colors = torch.ones_like(points) if colors is None else f(colors)
        out = cls(points=points.clone(), normals=normals.clone(),
                  colors=colors.clone(),
                  texture=None if texture is None else texture.to(device))
        for t in out.tensors():
            t.requires_grad_(requires_grad)
        return out

    def tensors(self):
        """Every leaf, in `names()` order: the three point leaves, then the
        texture's parameters."""
        point = (self.points, self.normals, self.colors)
        if self.texture is None:
            return point
        return point + tuple(self.texture.parameters())

    def names(self):
        """The leaves' names: points, normals, colors, then
        `texture.<parameter name>` (e.g. texture.decoder.layers.0.v)."""
        if self.texture is None:
            return POINT_LEAVES
        return POINT_LEAVES + tuple(
            "texture." + n for n, _ in self.texture.named_parameters())


def refuse_texture(params: PointModelParams, what: str) -> None:
    """A ValueError for the paths that do not take a neural texture."""
    if params.texture is not None:
        raise ValueError(f"{what} does not take a neural texture "
                         "(renderer.is_neural_texture): train it with "
                         "make_train_step or make_train_window")


def sample_image_at_ndc(images: torch.Tensor, p_ndc: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of (V, H, W) images at (V, P, 2) NDC xy
    (grid_sample align_corners=False semantics, borders clamped)."""
    v, h, w = images.shape
    x = (p_ndc[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (p_ndc[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    vidx = torch.arange(v, device=images.device)[:, None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xx = torch.clamp(xx.to(torch.int64), 0, w - 1)
        return images[vidx, yy, xx]

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def point_model_forward(
    params: PointModelParams,
    filters: PointFilters,
    cameras: FoVPerspectiveCameras,
    lights: Optional[Lights],
    settings: RasterSettings,
    mask_img: Optional[torch.Tensor] = None,
    vrk_h: Optional[torch.Tensor] = None,
    **render_kwargs,
) -> Tuple[Dict[str, torch.Tensor], PointFilters]:
    """Render the camera batch and update the point filters: visibility :=
    some view rendered the point; inmask := the point projects inside the
    GT mask in some view and is visible.

    Returns ({img_pred (V,S,S,3), mask_img_pred (V,S,S), bin_overflow ()
    [, depth_pred (V,S,S), −1 where uncovered]}, new_filters)."""
    normals = normalize(params.normals)
    active = filters.activation

    # The kernel size h is world-space and shared by every view: computed
    # once per step.
    if vrk_h is None:
        if settings.Vrk_invariant:
            vrk_h = compute_vrk_h_global(params.points.detach(), active)
        elif settings.Vrk_isotropic:
            vrk_h = compute_vrk_h_isotropic(params.points.detach(), active)

    if params.texture is not None:
        render_kwargs = {**render_kwargs, "texture_fn": params.texture}
    rgba, frags, visible = render_views(
        params.points, normals, params.colors, active, cameras, lights,
        settings, vrk_h=vrk_h, **render_kwargs,
    )
    with spans.span("render.composite"):
        visibility = torch.any(visible, dim=0) & active

        if mask_img is not None:
            with torch.no_grad():
                sampled = _sample_views(cameras, params.points, mask_img)
                inmask = torch.any(sampled > 0.5, dim=0) & visibility
        else:
            inmask = filters.inmask

        new_filters = PointFilters(activation=active, visibility=visibility,
                                   inmask=inmask)
        # Depth: the weighted-depth channel where it is on, else the
        # nearest fragment's z on the paths that carry fragments (its
        # gradient reaches point z through the zbuf scatter).
        depth = frags.wdepth
        if depth is None and frags.zbuf.shape[-1] > 0:
            depth = frags.zbuf[..., 0]
        img_pred, mask_pred, depth = spans.outputs(
            "render.composite", rgba[..., :3], rgba[..., 3], depth)
        out = {
            "img_pred": img_pred,
            "mask_img_pred": mask_pred,
            # candidates dropped by the static binning budgets, all views
            "bin_overflow": torch.sum(frags.overflow),
        }
        if depth is not None:
            out["depth_pred"] = depth
    return out, new_filters


def point_model_forward_stacked(
    params: PointModelParams,
    filters: PointFilters,
    cameras: Sequence[FoVPerspectiveCameras],
    lights: Optional[Sequence[Lights]],
    settings: RasterSettings,
    mask_img: Optional[torch.Tensor] = None,
    **render_kwargs,
) -> Tuple[Dict[str, torch.Tensor], PointFilters]:
    """`point_model_forward` for S independent clouds at once: params with
    (S, P, 3) leaves, filters with (S, P) leaves, S camera batches of V
    views (and S light batches or None), mask_img (S, V, H, W) or None.
    The render folds all S·V views into one lean rasterizer call
    (`render_views_stacked`); vrk_h, the filters and the in-mask sampling
    are per scene, with the single-scene semantics.

    Returns ({img_pred (S, V, H, W, 3), mask_img_pred (S, V, H, W),
    bin_overflow () summed over all S·V views[, depth_pred (S, V, H, W)]},
    new_filters with (S, P) leaves)."""
    refuse_texture(params, "the stacked multi-scene path")
    normals = normalize(params.normals)
    active = filters.activation
    n_scenes = params.points.shape[0]

    vrk_h = None
    if settings.Vrk_invariant or settings.Vrk_isotropic:
        fn = (compute_vrk_h_global if settings.Vrk_invariant
              else compute_vrk_h_isotropic)
        vrk_h = torch.stack([fn(params.points[s].detach(), active[s])
                             for s in range(n_scenes)])

    rgba, frags, visible = render_views_stacked(
        params.points, normals, params.colors, active, cameras, lights,
        settings, vrk_h=vrk_h, **render_kwargs,
    )
    visibility = torch.any(visible, dim=1) & active  # (S, P)

    if mask_img is not None:
        with torch.no_grad():
            inmask = torch.stack([
                torch.any(_sample_views(cameras[s], params.points[s],
                                        mask_img[s]) > 0.5, dim=0)
                for s in range(n_scenes)]) & visibility
    else:
        inmask = filters.inmask

    new_filters = PointFilters(activation=active, visibility=visibility,
                               inmask=inmask)
    out = {
        "img_pred": rgba[..., :3],
        "mask_img_pred": rgba[..., 3],
        "bin_overflow": torch.sum(frags.overflow),
    }
    if frags.wdepth is not None:
        out["depth_pred"] = frags.wdepth
    return out, new_filters


@torch.no_grad()
def render_model(
    params: PointModelParams,
    filters: PointFilters,
    cameras: FoVPerspectiveCameras,
    lights: Optional[Lights],
    settings: RasterSettings,
    **render_kwargs,
) -> torch.Tensor:
    """Eval-time render of the active points → RGBA (V, S, S, 4), through
    the params' texture where they have one."""
    if params.texture is not None:
        render_kwargs = {**render_kwargs, "texture_fn": params.texture}
    vrk_h = None
    if settings.Vrk_invariant:
        vrk_h = compute_vrk_h_global(params.points, filters.activation)
    elif settings.Vrk_isotropic:
        vrk_h = compute_vrk_h_isotropic(params.points, filters.activation)
    rgba, _, _ = render_views(
        params.points, normalize(params.normals), params.colors,
        filters.activation, cameras, lights, settings, vrk_h=vrk_h,
        **render_kwargs,
    )
    return rgba


def prune_dead_points(
    params: PointModelParams,
    filters: PointFilters,
    cameras: FoVPerspectiveCameras,
    settings: RasterSettings,
    mask_gt: torch.Tensor,
) -> torch.Tensor:
    """(P,) bool: False for a dead point, one whose gradient of the
    silhouette loss mean |alpha − mask| is exactly zero.

    The loss takes `jax_abs`: d|x|/dx is 1 at 0, as in the JAX package, so
    pixels where alpha = mask = 0 inside a support disc still carry
    gradient (torch.abs gives 0 there and would call such points dead).
    A point that receives no contribution keeps the zero fill of the
    per-point sums, so the exact-zero test holds under the kernels' float
    atomics."""
    points = params.points.detach().clone().requires_grad_(True)
    rgba, _, _ = render_views(
        points, normalize(params.normals.detach()), params.colors.detach(),
        filters.activation, cameras, None, settings,
    )
    loss = torch.mean(jax_abs(rgba[..., 3] - mask_gt))
    (grad,) = torch.autograd.grad(loss, points)
    return ~torch.all(grad == 0.0, dim=-1)


def _sample_views(cameras: FoVPerspectiveCameras, points: torch.Tensor,
                  images: torch.Tensor) -> torch.Tensor:
    """(V, P) bilinear samples of (V, S, S) images at the points'
    projections; projections outside the frame are clamped onto border
    pixels."""
    p_screen = cameras.transform_points_screen(points)  # (V, P, 3)
    # NDC xy sign flip: image +x right / +y down vs NDC +x left / +y up
    p = torch.clamp(-p_screen[..., :2], -1.0, 1.0)
    return sample_image_at_ndc(images.to(torch.float32), p)


@torch.no_grad()
def prune_outside_silhouette(
    points: torch.Tensor,
    cameras: FoVPerspectiveCameras,
    masks: torch.Tensor,
    outside_frac: float = 0.09,
    mask_threshold: float = 0.5,
) -> torch.Tensor:
    """GT-free floater pruning by silhouette consistency: a surface point
    projects inside the object mask in every view, so a point whose
    sampled mask is ≤ mask_threshold in more than outside_frac of the V
    views is a floater.  masks (V, S, S) in [0, 1].  Returns the (P,) bool
    keep-mask."""
    sampled = _sample_views(cameras, points, masks)
    views_outside = torch.sum(sampled <= mask_threshold, dim=0)
    return views_outside <= outside_frac * masks.shape[0]


@torch.no_grad()
def prune_depth_inconsistent(
    points: torch.Tensor,
    cameras: FoVPerspectiveCameras,
    depth_maps: torch.Tensor,
    tol: float = 0.02,
    min_views: int = 1,
) -> torch.Tensor:
    """Interior-floater pruning by front-depth consistency: keep a point
    whose view-space z lies within `tol` of the dense front depth sampled
    at its projection in at least `min_views` views.  depth_maps
    (V, S, S), zfar where empty.  Returns the (P,) bool keep-mask."""
    view_z = cameras.transform_points_world_to_view(points)[..., 2]  # (V, P)
    sampled = _sample_views(cameras, points, depth_maps)
    near = torch.abs(view_z - sampled) <= tol
    return torch.sum(near, dim=0) >= min_views
