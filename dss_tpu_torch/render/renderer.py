"""Surface-splatting renderer: shade → EWA setup → rasterize → composite
(counterpart of the lean path of dss_tpu/render/renderer.py).

All V views of one cloud go through the splat op in one call: the view
axis is written out in every tensor.  Only the lean (fragment-free) path
is ported; the single-view reference path waits for the reference
rasterizer (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.ops.kernels import CHUNK
from dss_tpu_torch.ops.splat import TileConfig, rasterize_views_lean
from dss_tpu_torch.render.ewa import RasterSettings, prepare_splats
from dss_tpu_torch.render.lighting import Lights, shade_points
from dss_tpu_torch.render.rasterizer import Fragments, clip_grad_norm


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
               vrk_h, shininess):
    """Shading → EWA setup → optional per-point gradient clip, for all V
    views.  Returns (shaded (V, P, 3), splats, pts_screen (V, P, 3))."""
    if lights is not None:
        shaded = shade_points(points, normals, colors, lights,
                              cameras.camera_position(), shininess)
    else:
        shaded = torch.broadcast_to(colors[None], (len(cameras),) + colors.shape)
    splats = prepare_splats(points, normals, mask, cameras, settings, vrk_h)
    pts_screen = splats.pts_screen
    if settings.clip_pts_grad > 0:
        pts_screen = clip_grad_norm(pts_screen, settings.clip_pts_grad)
    return shaded, splats, pts_screen


def _weighted_depth(wsum, wz):
    """Σw, Σw·z → weighted-mean view-space depth, −1 uncovered.  The
    gradient reaches Σw·z only where covered; Σw's reaches the constant
    weights only."""
    return torch.where(wsum > 0.0, wz / torch.clamp(wsum, min=1e-10), -1.0)


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
) -> Tuple[torch.Tensor, Fragments, torch.Tensor]:
    """Render V views of one cloud.  points/normals/colors (P, 3), mask (P,).
    Returns (rgba (V, S, S, 4), fragments, visible (V, P))."""
    if not settings.lean_fragments:
        raise NotImplementedError(
            "only the lean splat path is ported; the full-fragment path "
            "waits for kernel K5 (ROADMAP.md)"
        )
    return _render_views_batched(
        points, normals, colors, mask, cameras, lights, settings, vrk_h,
        _tile_config(points.shape[0], settings), shininess,
        normalize_composite,
    )


def _render_views_batched(points, normals, colors, mask, cameras, lights,
                          settings, vrk_h, tile_config, shininess=64.0,
                          normalize_composite=True):
    """Lean path: every view's splats rasterized in one op call."""
    shaded, splats, pts_screen = _prep_view(
        points, normals, colors, mask, cameras, lights, settings, vrk_h,
        shininess,
    )
    occ, visible, rgbw, overflow = rasterize_views_lean(
        settings.image_size, settings.points_per_pixel, tile_config,
        pts_screen, splats.ellipse_params, splats.cutoff, splats.radii,
        settings.depth_merging_threshold, settings.radii_backward_scaler,
        splats.scaler, shaded,
    )
    return _package_lean(occ, visible, rgbw, overflow, settings,
                         normalize_composite)


def _package_lean(occ, visible, rgbw, overflow, settings,
                  normalize_composite):
    """Composite and Fragments packaging (untiled layout)."""
    if normalize_composite:
        rgb = rgbw[..., :3] / torch.clamp(rgbw[..., 3:4], min=1e-10)
    else:
        rgb = rgbw[..., :3]
    rgba = torch.cat([rgb, occ[..., None]], dim=-1)
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
