"""Surface-splatting renderer: shade → EWA setup → rasterize → composite
(counterpart of dss_tpu/render/renderer.py).

All V views of one cloud go through the rasterizer in one call: the view
axis is written out in every tensor.  `render_single_view` is that call at
V = 1 with the view axis squeezed away, and `render_views_stacked` folds S
clouds' views into one call on the lean path.  Three paths, as in the JAX
package:

- tile-binned, lean (`lean_fragments=True`): composite and visibility from
  K1, no per-pixel fragment buffers;
- tile-binned, full fragments (`lean_fragments=False`): K5 also writes the
  K-slot idx/zbuf/qvalue buffers;
- `backend="reference"`: the plain-PyTorch spec rasterizer and the
  gather compositor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.ops.kernels import CHUNK
from dss_tpu_torch.ops.splat import (
    TileConfig,
    rasterize_views_fragments,
    rasterize_views_lean,
)
from dss_tpu_torch.render.compositor import norm_weighted_sum, weighted_sum
from dss_tpu_torch.render.ewa import RasterSettings, prepare_splats
from dss_tpu_torch.render.lighting import Lights, shade_points
from dss_tpu_torch.render.rasterizer import (
    Fragments,
    clip_grad_norm,
    rasterize_points,
    visible_points_mask,
)
from dss_tpu_torch.utils import spans


def _check_backend(settings: RasterSettings) -> None:
    if settings.backend not in ("auto", "pallas", "reference"):
        raise ValueError(f"unknown backend {settings.backend!r}: expected "
                         "'auto', 'pallas' or 'reference'")


def _tile_config(p: int, settings: RasterSettings) -> TileConfig:
    """Binning budgets for P points (the JAX package's capacity rules):

    - capacity is at most the padded point count (with few tiles every
      splat can land in every tile);
    - central tiles of a concentrated scene see most candidates: at least
      2048 slots, 4·P/n_tiles, and 0.4·P for 6k < P ≤ 20k clouds;
    - a splat spans at most 4 tiles per axis (2 above 20k points, where
      radii shrink with spacing) unless max_tiles_per_splat says otherwise.
    """
    if settings.bin_chunk != CHUNK:
        raise NotImplementedError(
            f"bin_chunk={settings.bin_chunk}: the kernels are compiled for "
            f"{CHUNK}-candidate chunks (the chunk sets the depth-window rule)"
        )
    p_cap = -(-p // settings.bin_chunk) * settings.bin_chunk
    tile_size = min(settings.tile_size, settings.image_size)
    n_tiles = (settings.image_size // tile_size) ** 2
    conc = (-(-(2 * p) // 5) + 127) // 128 * 128 if 6000 < p <= 20000 else 0
    bin_capacity = min(
        p_cap,
        max(settings.bin_capacity, 2048, 4 * p_cap // max(n_tiles, 1), conc),
    )
    if settings.max_tiles_per_splat > 0:
        max_tiles = max_tiles_bwd = settings.max_tiles_per_splat
    else:
        max_tiles = 4 if p <= 20000 else 2
        max_tiles_bwd = -1
    pair_cap_fwd = (int(settings.pair_cap_scale_fwd * p)
                    if settings.pair_cap_scale_fwd > 0 else -1)
    pair_cap_bwd = (int(settings.pair_cap_scale_bwd * p)
                    if settings.pair_cap_scale_bwd > 0 else -1)
    return TileConfig(
        tile=tile_size,
        cap=bin_capacity,
        max_tiles=max_tiles,
        max_tiles_bwd=max_tiles_bwd,
        pair_cap_fwd=pair_cap_fwd,
        pair_cap_bwd=pair_cap_bwd,
        depth_channel=1 if settings.depth_channel else 0,
    )


def _prep_view(points, normals, colors, mask, cameras, lights, settings,
               vrk_h, shininess, texture_fn=None):
    """Shading (a texture, else the lights, else the raw colours) → EWA
    setup → optional per-point gradient clip, for all V views.  Returns
    (shaded (V, P, 3), splats, pts_screen (V, P, 3))."""
    v = len(cameras)
    with spans.span("render.prep"):
        points, normals, colors = spans.inputs("render.prep", points,
                                               normals, colors)
        if texture_fn is not None:
            shaded = texture_fn(points, normals, cameras)
            if tuple(shaded.shape) != (v, points.shape[0], 3):
                raise ValueError(
                    f"texture_fn(points, normals, cameras) must give (V, P, "
                    f"3) = {(v, points.shape[0], 3)} colours for all views "
                    f"at once, got {tuple(shaded.shape)}")
        elif lights is not None:
            shaded = shade_points(points, normals, colors, lights,
                                  cameras.camera_position(), shininess)
        else:
            shaded = torch.broadcast_to(colors[None], (v,) + colors.shape)
        splats = prepare_splats(points, normals, mask, cameras, settings,
                                vrk_h)
        pts_screen = splats.pts_screen
        if settings.clip_pts_grad > 0:
            pts_screen = clip_grad_norm(pts_screen, settings.clip_pts_grad)
        shaded, pts_screen = spans.outputs("render.prep", shaded, pts_screen)
    return shaded, splats, pts_screen


def _finish_composite(rgbw, occ, normalize_composite):
    """rgbw (…, 4) weighted rgb sums + weight sum → rgba with alpha = occ."""
    if normalize_composite:
        rgb = rgbw[..., :3] / torch.clamp(rgbw[..., 3:4], min=1e-10)
    else:
        rgb = rgbw[..., :3]
    return torch.cat([rgb, occ[..., None]], dim=-1)


def _weighted_depth(wsum, wz):
    """Σw, Σw·z → weighted-mean view-space depth, −1 uncovered.  The
    gradient reaches Σw·z only where covered; Σw's reaches the constant
    weights only."""
    return torch.where(wsum > 0.0, wz / torch.clamp(wsum, min=1e-10), -1.0)


def _frag_scaler(scaler, idx):
    """Per-fragment EWA scaler (V, S, S, K), 0 on empty slots."""
    v = idx.shape[0]
    got = torch.gather(scaler, 1,
                       torch.clamp(idx, min=0).reshape(v, -1).to(torch.int64))
    return torch.where(idx >= 0, got.reshape(idx.shape), 0.0)


def _fragment_wdepth(idx, zbuf, qvalue, scaler):
    """Weighted depth over the fragments, with the compositor's weights
    exp(−Q/2)·scaler (both rasterizers drop the qvalue cotangent, so the
    gradient reaches z through zbuf only)."""
    wf = torch.exp(-0.5 * qvalue) * _frag_scaler(scaler, idx) * (idx >= 0)
    return _weighted_depth(wf.sum(dim=-1), (wf * zbuf).sum(dim=-1))


def render_views(
    points: torch.Tensor,
    normals: torch.Tensor,
    colors: torch.Tensor,
    mask: torch.Tensor,
    cameras: FoVPerspectiveCameras,
    lights: Optional[Lights],
    settings: RasterSettings,
    vrk_h: Optional[torch.Tensor] = None,
    shininess: float = 64.0,
    normalize_composite: bool = True,
    row_chunk: int = 8,
    texture_fn=None,
    row_window: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Fragments, torch.Tensor]:
    """Render V views of one cloud.  points/normals/colors (P, 3), mask (P,).
    `row_chunk` bounds the rows per block of the reference rasterizer; the
    tile-binned paths have no row blocks and ignore it.  `texture_fn`
    (render/texture.py: points, normals, cameras → (V, P, 3)) overrides
    the lights' shading, as a NeuralTexture does in the reference.
    `row_window` (start, stop), on the reference backend only, renders just
    those rows (a row slab of a view split over processes); `visible` then
    holds the points seen in the slab.
    Returns (rgba (V, S, S, 4) — (V, stop − start, S, 4) with a window —,
    fragments, visible (V, P))."""
    _check_backend(settings)
    if row_window is not None and settings.backend != "reference":
        raise ValueError("row_window needs backend='reference': the "
                         "tile-binned paths render whole views")
    shaded, splats, pts_screen = _prep_view(
        points, normals, colors, mask, cameras, lights, settings, vrk_h,
        shininess, texture_fn,
    )
    if settings.backend == "reference":
        return _render_reference(shaded, splats, pts_screen, settings,
                                 normalize_composite, row_chunk, row_window)
    tile_config = _tile_config(points.shape[0], settings)
    if settings.lean_fragments:
        occ, visible, rgbw, overflow = rasterize_views_lean(
            settings.image_size, settings.points_per_pixel, tile_config,
            pts_screen, splats.ellipse_params, splats.cutoff, splats.radii,
            settings.depth_merging_threshold, settings.radii_backward_scaler,
            splats.scaler, shaded,
        )
        with spans.span("render.composite"):
            occ, rgbw = spans.inputs("render.composite", occ, rgbw)
            return _package_lean(occ, visible, rgbw, overflow, settings,
                                 normalize_composite)
    idx, zbuf, qvalue, occ, visible, rgbw, overflow = rasterize_views_fragments(
        settings.image_size, settings.points_per_pixel, tile_config,
        pts_screen, splats.ellipse_params, splats.cutoff, splats.radii,
        settings.depth_merging_threshold, settings.radii_backward_scaler,
        splats.scaler, shaded,
    )
    with spans.span("render.composite"):
        zbuf, qvalue, occ, rgbw = spans.inputs("render.composite", zbuf,
                                               qvalue, occ, rgbw)
        wdepth = (_fragment_wdepth(idx, zbuf, qvalue, splats.scaler)
                  if settings.depth_channel else None)
        fragments = Fragments(idx=idx, zbuf=zbuf, qvalue=qvalue,
                              occupancy=occ, overflow=overflow, wdepth=wdepth)
        # the composite was fused into K5: only the norm division remains
        rgba = _finish_composite(rgbw, occ, normalize_composite)
    return rgba, fragments, visible


def _render_reference(shaded, splats, pts_screen, settings,
                      normalize_composite, row_chunk, row_window=None):
    """Reference path: the spec rasterizer, then weights exp(−Q/2)·scaler
    and the gather compositor; visibility from the fragment ids."""
    idx, zbuf, qvalue, occ = rasterize_points(
        settings.image_size, settings.points_per_pixel, row_chunk,
        pts_screen, splats.ellipse_params, splats.cutoff, splats.radii,
        settings.depth_merging_threshold, settings.radii_backward_scaler,
        row_window,
    )
    weights = torch.exp(-0.5 * qvalue) * _frag_scaler(splats.scaler, idx)
    wdepth = (_fragment_wdepth(idx, zbuf, qvalue, splats.scaler)
              if settings.depth_channel else None)
    compose = norm_weighted_sum if normalize_composite else weighted_sum
    rgba = torch.cat([compose(idx, weights, shaded), occ[..., None]], dim=-1)
    v, p = pts_screen.shape[:2]
    fragments = Fragments(
        idx=idx, zbuf=zbuf, qvalue=qvalue, occupancy=occ,
        overflow=torch.zeros((v,), dtype=torch.int32, device=idx.device),
        wdepth=wdepth,
    )
    return rgba, fragments, visible_points_mask(idx, p)


def _package_lean(occ, visible, rgbw, overflow, settings,
                  normalize_composite):
    """Composite and Fragments packaging (untiled layout)."""
    rgba = _finish_composite(rgbw, occ, normalize_composite)
    wdepth = (_weighted_depth(rgbw[..., 3], rgbw[..., 4])
              if settings.depth_channel else None)
    v = rgba.shape[0]
    empty = torch.zeros((v, settings.image_size, settings.image_size, 0),
                        device=rgba.device)
    fragments = Fragments(
        idx=empty.to(torch.int32), zbuf=empty, qvalue=empty,
        occupancy=occ, overflow=overflow, wdepth=wdepth,
    )
    return rgba, fragments, visible


def _map_fragments(fn, *frags: Fragments) -> Fragments:
    """Fragments whose every field is fn of that field of `frags` (a field
    that is None stays None)."""
    return Fragments(**{
        f.name: (None if getattr(frags[0], f.name) is None
                 else fn(*(getattr(x, f.name) for x in frags)))
        for f in dataclasses.fields(Fragments)})


def render_single_view(
    points: torch.Tensor,
    normals: torch.Tensor,
    colors: torch.Tensor,
    mask: torch.Tensor,
    camera: FoVPerspectiveCameras,
    lights: Optional[Lights],
    settings: RasterSettings,
    vrk_h: Optional[torch.Tensor] = None,
    shininess: float = 64.0,
    normalize_composite: bool = True,
    row_chunk: int = 8,
    texture_fn=None,
    row_window: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Fragments, torch.Tensor]:
    """Render one view: `render_views` over a batch of one camera (and one
    view's lights, or None for the raw albedo), the view axis squeezed
    away.  As in the JAX package, the tile-binned single view is the
    view-batched op at V = 1.  `texture_fn` gives (1, P, 3) colours here;
    `row_window` is `render_views`'.

    Returns (rgba (S, S, 4), fragments (S, S, ...) with a scalar overflow,
    visible (P,))."""
    if len(camera) != 1:
        raise ValueError(f"render_single_view takes one camera, got "
                         f"{len(camera)}")
    rgba, frags, visible = render_views(
        points, normals, colors, mask, camera, lights, settings, vrk_h=vrk_h,
        shininess=shininess, normalize_composite=normalize_composite,
        row_chunk=row_chunk, texture_fn=texture_fn, row_window=row_window,
    )
    return rgba[0], _map_fragments(lambda x: x[0], frags), visible[0]


def render_views_stacked(
    points: torch.Tensor,
    normals: torch.Tensor,
    colors: torch.Tensor,
    mask: torch.Tensor,
    cameras: Sequence[FoVPerspectiveCameras],
    lights: Optional[Sequence[Lights]],
    settings: RasterSettings,
    vrk_h: Optional[torch.Tensor] = None,
    shininess: float = 64.0,
    normalize_composite: bool = True,
    texture_fn=None,
) -> Tuple[torch.Tensor, Fragments, torch.Tensor]:
    """Render S clouds, each from its own V cameras, with ALL S·V views in
    ONE lean rasterizer call.

    points/normals/colors (S, P, 3), mask (S, P); `cameras` is a sequence
    of S batches of V cameras, `lights` one of S batches of V views' lights
    (or None); vrk_h (S,) or (S, P) or None; `texture_fn` is called once
    per scene with its V cameras.  The views are scene-major:
    view j of scene s is row s·V + j of the kernels' view axis, so every
    per-view buffer (the tables, K2's and K3's per-point sums, the
    visibility flags) belongs to one scene only.  Off the lean tile-binned
    path (the reference backend, or full fragments) each scene renders
    through `render_views` and the results are stacked.

    Returns (rgba (S, V, S_img, S_img, 4), fragments with (S, V, ...)
    fields, visible (S, V, P))."""
    _check_backend(settings)
    n_scenes = points.shape[0]
    if len(cameras) != n_scenes or (lights is not None
                                    and len(lights) != n_scenes):
        raise ValueError(f"{n_scenes} scenes need {n_scenes} camera batches "
                         f"(and light batches), got {len(cameras)}")
    n_views = len(cameras[0])
    if any(len(c) != n_views for c in cameras):
        raise ValueError("every scene needs the same number of views: "
                         f"{[len(c) for c in cameras]}")
    scene = lambda s: (points[s], normals[s], colors[s], mask[s], cameras[s],
                       None if lights is None else lights[s], settings,
                       None if vrk_h is None else vrk_h[s])

    if settings.backend == "reference" or not settings.lean_fragments:
        rgba, frags, visible = zip(*(
            render_views(*scene(s), shininess=shininess,
                         normalize_composite=normalize_composite,
                         texture_fn=texture_fn)
            for s in range(n_scenes)))
        return (torch.stack(rgba),
                _map_fragments(lambda *xs: torch.stack(xs), *frags),
                torch.stack(visible))

    prepped = []
    for s in range(n_scenes):
        shaded, splats, pts_screen = _prep_view(*scene(s), shininess,
                                                texture_fn)
        prepped.append((pts_screen, splats.ellipse_params, splats.cutoff,
                        splats.radii, splats.scaler, shaded))
    pts_s, ell, cut, rad, scl, shaded = (torch.cat(x) for x in zip(*prepped))
    occ, visible, rgbw, overflow = rasterize_views_lean(
        settings.image_size, settings.points_per_pixel,
        _tile_config(points.shape[1], settings),
        pts_s, ell, cut, rad, settings.depth_merging_threshold,
        settings.radii_backward_scaler, scl, shaded,
    )
    rgba, frags, visible = _package_lean(occ, visible, rgbw, overflow,
                                         settings, normalize_composite)
    unflat = lambda x: x.reshape((n_scenes, n_views) + x.shape[1:])
    return unflat(rgba), _map_fragments(unflat, frags), unflat(visible)
