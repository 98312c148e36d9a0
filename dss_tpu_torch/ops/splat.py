"""Tile binning and the view-batched splat ops (counterpart of the
non-kernel half of dss_tpu/ops/splat_pallas.py).

Forward: each view's splats are binned into per-tile, depth-sorted
candidate tables (a stable sort on one fused key of tile id and quantized
depth), one kernel rasterizes all views' tiles in one launch — K1 on the
lean path, K5 where per-pixel fragment buffers are needed — and writes
each point's visibility flag in its epilogue.  The occupancy-backward
support table is built in the forward too, so its overflow is observable.

Backward: K2 gives the occupancy gradient to screen x/y, K3 the colour
(and, on the lean path's depth channel, depth) gradients through the fused
composite (weights held constant), each summed into the points in the
kernel's epilogue; on the fragment path K4 scatters the zbuf cotangent to
point z.

Every function takes a leading view axis V.  The static budgets (tile
capacity, tiles per splat, live pairs) are semantics, as in the JAX
package: what they drop is counted in `overflow`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dss_tpu_torch.ops import kernels


class BinnedSplats(NamedTuple):
    tile_data: torch.Tensor  # (V, n_tiles, C, M) float32, depth-sorted
    tile_ids: torch.Tensor  # (V, n_tiles, M) int32 splat ids, -1 pad
    tile_counts: torch.Tensor  # (V, n_tiles) int32 candidates per tile
    overflow: torch.Tensor  # (V,) int32 candidates dropped by the budgets


class TileConfig(NamedTuple):
    """The binning budgets (-1 = auto); the JAX package's TileCfg without
    its TPU layout entries."""

    tile: int
    cap: int
    max_tiles: int
    max_tiles_bwd: int = -1
    pair_cap_fwd: int = -1
    pair_cap_bwd: int = -1
    depth_channel: int = 0


def ndc_to_pixel(x: torch.Tensor, image_size: int) -> torch.Tensor:
    """Continuous pixel coordinate of an NDC value: (S·(1 − x) − 1)/2."""
    return (image_size * (1.0 - x) - 1.0) * 0.5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_index(c: torch.Tensor, tile_size: int, nt: int) -> torch.Tensor:
    """floor(c / tile) clipped to [0, nt − 1]; the float is clamped before
    the cast so off-screen coordinates saturate as XLA's cast does."""
    f = torch.clamp(torch.floor(c / tile_size), -1.0, float(nt))
    return torch.clamp(f.to(torch.int64), 0, nt - 1)


def _sorted_pairs(pts, radii, image_size, tile_size, max_tiles_x,
                  max_tiles_y, extra_radius, sort_by_depth):
    """Build and sort each view's (tile, splat) pairs.  Returns (sorted_id
    (V, P·rep), starts (V, n_tiles+1), span_overflow (V,)), sorted by tile
    and, with sort_by_depth, by quantized depth within a tile; ties keep
    pair order (stable sort, as jax.lax.sort_key_val)."""
    v, p = pts.shape[:2]
    s = image_size
    nt = s // tile_size
    n_tiles = nt * nt
    dev = pts.device

    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    rx = radii[..., 0] + extra_radius
    ry = radii[..., 1] + extra_radius
    live = (rx > 0) & (pz >= 0.0)

    # Pixel-space AABB (x flipped: +ndc-x = left = small pixel column).
    cx_lo = ndc_to_pixel(px + rx, s)
    cx_hi = ndc_to_pixel(px - rx, s)
    cy_lo = ndc_to_pixel(py + ry, s)
    cy_hi = ndc_to_pixel(py - ry, s)
    tx_lo, tx_hi = _tile_index(cx_lo, tile_size, nt), _tile_index(cx_hi, tile_size, nt)
    ty_lo, ty_hi = _tile_index(cy_lo, tile_size, nt), _tile_index(cy_hi, tile_size, nt)
    offscreen = (cx_hi < 0) | (cx_lo > s - 1) | (cy_hi < 0) | (cy_lo > s - 1)
    live = live & ~offscreen

    # Replicate into up to max_tiles_x × max_tiles_y tiles.
    tx = tx_lo[..., None] + torch.arange(max_tiles_x, device=dev)  # (V, P, RX)
    ty = ty_lo[..., None] + torch.arange(max_tiles_y, device=dev)  # (V, P, RY)
    vx = tx <= tx_hi[..., None]
    vy = ty <= ty_hi[..., None]
    tile = ty[:, :, None, :] * nt + tx[:, :, :, None]  # (V, P, RX, RY)
    valid = vx[..., :, None] & vy[..., None, :] & live[..., None, None]
    span_overflow = (((tx_hi - tx_lo + 1) > max_tiles_x)
                     | ((ty_hi - ty_lo + 1) > max_tiles_y))
    tile_key = torch.where(valid, tile, n_tiles).reshape(v, -1)

    if sort_by_depth:
        # One fused key: tile id in the high bits, quantized depth in the
        # low bits, computed in float32 in the JAX package's order.
        zq_bits = max(1, 30 - max(n_tiles - 1, 1).bit_length())
        zq_max = (1 << zq_bits) - 1
        z_lo = torch.amin(torch.where(live, pz, torch.inf), dim=1)
        z_hi = torch.amax(torch.where(live, pz, -torch.inf), dim=1)
        z_lo = torch.where(torch.isfinite(z_lo), z_lo, 0.0)
        z_hi = torch.where(torch.isfinite(z_hi), z_hi, 1.0)
        z_range = torch.clamp(z_hi - z_lo, min=1e-9)
        zf = (pz - z_lo[:, None]) / z_range[:, None] * zq_max
        zq = torch.clamp(
            torch.clamp(zf, 0.0, float(zq_max)).to(torch.int64), 0, zq_max)
        zq = torch.broadcast_to(
            zq[:, :, None, None], (v, p, max_tiles_x, max_tiles_y)
        ).reshape(v, -1)
        fused = tile_key * (zq_max + 1) + zq
        sorted_fused, sorted_id = torch.sort(fused, dim=1, stable=True)
        sorted_key = sorted_fused // (zq_max + 1)
    else:
        sorted_key, sorted_id = torch.sort(tile_key, dim=1, stable=True)
    # pair index → splat id (pairs are laid out as (P, RX, RY))
    sorted_id = sorted_id // (max_tiles_x * max_tiles_y)

    starts = torch.searchsorted(
        sorted_key.contiguous(),
        torch.arange(n_tiles + 1, device=dev).expand(v, -1).contiguous(),
    )
    return sorted_id, starts, torch.sum(live & span_overflow, dim=1)


def _channel_matrix(pts, ellipse, cutoff, radii, extra_radius, scaler,
                    features, backward_channels):
    """(V, P, C) per-splat channel matrix and the padding sentinel row."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    dev = pts.device
    zeros = torch.zeros_like(px)
    if backward_channels:
        src = torch.stack([px, py, pz, radii[..., 0], radii[..., 1]], dim=-1)
        sentinel = torch.tensor([2.0, 2.0, -1.0, 0.0, 0.0], device=dev)
    else:
        ids = torch.broadcast_to(
            torch.arange(pts.shape[1], dtype=torch.float32, device=dev),
            px.shape)
        src = torch.stack(
            [
                px, py, pz,
                ellipse[..., 0], ellipse[..., 1], ellipse[..., 2],
                cutoff,
                radii[..., 0] + extra_radius,
                radii[..., 1] + extra_radius,
                scaler if scaler is not None else zeros,
                features[..., 0] if features is not None else zeros,
                features[..., 1] if features is not None else zeros,
                features[..., 2] if features is not None else zeros,
                ids,
            ],
            dim=-1,
        )
        sentinel = torch.tensor(
            [2.0, 2.0, -1.0, 0.0, 0.0, 0.0, -torch.inf, 0.0, 0.0, 0.0, 0.0,
             0.0, 0.0, -1.0], device=dev)
    return src.to(torch.float32), sentinel


def bin_splats(
    pts: torch.Tensor,  # (V, P, 3)
    ellipse: torch.Tensor,  # (V, P, 3)
    cutoff: torch.Tensor,  # (V, P)
    radii: torch.Tensor,  # (V, P, 2)
    image_size: int,
    tile_size: int,
    bin_capacity: int,
    max_tiles_x: int = 4,
    max_tiles_y: int = 4,
    extra_radius=0.0,  # float or (V,) per-view NDC support
    sort_by_depth: bool = True,
    scaler: Optional[torch.Tensor] = None,
    features: Optional[torch.Tensor] = None,
    backward_channels: bool = False,
    pair_cap: Optional[int] = None,
) -> BinnedSplats:
    """Build each view's per-tile candidate table.

    Overflow counts the candidates dropped by the tile capacity, by the
    tiles-per-splat budget (span) and by the live-pair cap (truncation).
    backward_channels builds the 5-channel occupancy-backward table.
    pair_cap bounds the live (tile, splat) pairs kept after the sort
    (default 4·P forward / 10·P backward, halved above 20k points)."""
    v, p = pts.shape[:2]
    dev = pts.device
    if not isinstance(extra_radius, torch.Tensor):
        extra_radius = torch.full((v,), float(extra_radius), device=dev)
    extra_radius = extra_radius.reshape(v, 1)
    sorted_id, starts, span_overflow = _sorted_pairs(
        pts, radii, image_size, tile_size, max_tiles_x, max_tiles_y,
        extra_radius, sort_by_depth,
    )
    n_tiles = (image_size // tile_size) ** 2
    n_pairs = p * max_tiles_x * max_tiles_y
    if pair_cap is None:
        if backward_channels:
            pair_cap = 10 * p if p <= 20000 else 5 * p
        else:
            pair_cap = 4 * p if p <= 20000 else 2 * p
    pair_cap = min(_round_up(pair_cap, 128), n_pairs)
    trunc_overflow = torch.clamp(starts[:, n_tiles] - pair_cap, min=0)

    starts_t = torch.clamp(starts, max=pair_cap)
    counts_full = starts_t[:, 1:] - starts_t[:, :-1]
    counts = torch.clamp(counts_full, max=bin_capacity)
    cap_overflow = torch.sum(torch.clamp(counts_full - bin_capacity, min=0),
                             dim=1)
    overflow = cap_overflow + span_overflow + trunc_overflow

    # Slot j of tile ti is sorted pair starts_t[ti] + j, while j < count.
    src, sentinel = _channel_matrix(
        pts, ellipse, cutoff, radii, extra_radius, scaler, features,
        backward_channels,
    )
    slot = torch.arange(bin_capacity, device=dev)
    valid = slot < counts[..., None]  # (V, nt, M)
    pos = torch.clamp(starts_t[:, :-1, None] + slot, max=pair_cap - 1)
    sid = torch.gather(sorted_id[:, :pair_cap], 1, pos.reshape(v, -1))
    ids = torch.where(valid.reshape(v, -1), sid, -1)
    chans = torch.gather(
        src, 1,
        torch.clamp(ids, min=0)[..., None].expand(-1, -1, src.shape[-1]),
    ).reshape(v, n_tiles, bin_capacity, -1)
    chans = torch.where(valid[..., None], chans, sentinel)
    return BinnedSplats(
        tile_data=chans.permute(0, 1, 3, 2).contiguous(),
        tile_ids=ids.reshape(v, n_tiles, bin_capacity).to(torch.int32),
        tile_counts=counts.to(torch.int32),
        overflow=overflow.to(torch.int32),
    )


def masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row median of vals[mask] for (V, N) inputs via one ascending
    sort (invalid → +inf); 0 where a row has no valid entry."""
    sv, _ = torch.sort(torch.where(mask, vals, torch.inf), dim=-1)
    n = torch.sum(mask.to(torch.int64), dim=-1)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (torch.gather(sv, 1, lo[:, None])[:, 0]
                 + torch.gather(sv, 1, hi[:, None])[:, 0])
    return torch.where(n > 0, med, 0.0)


def bin_for_occ_backward(pts, radii, visible, radii_backward_scaler,
                         image_size: int, tile_size: int, bin_capacity: int,
                         max_tiles_xy: int, pair_cap: Optional[int] = None):
    """Support binning for the occupancy backward, per view.  The search
    radius is the median of the visible splats' radii (both axes pooled)
    × the annealed scaler; invisible points are excluded by a pz = −1
    sentinel.  Returns (binned, cur_r² (V,))."""
    v, p = pts.shape[:2]
    cur_r = masked_median(radii.reshape(v, -1),
                          visible.repeat_interleave(2, dim=1))
    cur_r = cur_r * radii_backward_scaler
    cur_r = torch.where(torch.isfinite(cur_r), cur_r, 0.0)
    cur_r2 = cur_r * cur_r
    radii_for_bin = torch.where(visible[..., None], radii, 0.0)
    pts_for_bin = torch.where(
        visible[..., None], pts,
        torch.tensor([2.0, 2.0, -1.0], dtype=pts.dtype, device=pts.device))
    binned = bin_splats(
        pts_for_bin,
        torch.zeros((v, p, 3), device=pts.device),
        torch.zeros((v, p), device=pts.device),
        radii_for_bin,
        image_size,
        tile_size,
        bin_capacity,
        max_tiles_x=max_tiles_xy,
        max_tiles_y=max_tiles_xy,
        extra_radius=cur_r,
        sort_by_depth=False,
        backward_channels=True,
        pair_cap=pair_cap,
    )
    return binned, cur_r2


def _bwd_tile_budget(cfg: TileConfig, p: Optional[int] = None):
    """(tile, capacity, max_tiles, pair_cap) of the occupancy-backward
    table: the same tile, at least 2048 slots (0.75·P for 6k < P ≤ 20k
    concentrated clouds), and a 4-tile span budget up to 20k points."""
    mt_bwd = cfg.max_tiles_bwd
    if mt_bwd <= 0:
        mt_bwd = (max(cfg.max_tiles, 4) if (p is None or p <= 20000)
                  else min(cfg.max_tiles, 2))
    cap_bwd = max(cfg.cap, 2048)
    if p is not None and 6000 < p <= 20000:
        cap_bwd = max(cap_bwd, (-(-(3 * p) // 4) + 127) // 128 * 128)
    pcb = cfg.pair_cap_bwd
    return cfg.tile, cap_bwd, mt_bwd, (pcb if pcb > 0 else None)


# ---------------------------------------------------------------------------
# The view-batched ops
# ---------------------------------------------------------------------------


def _untile(x: torch.Tensor, image_size: int, tile_size: int) -> torch.Tensor:
    """(V, n_tiles, ch, tt) → (V, S, S, ch)."""
    v, _, ch, _ = x.shape
    nt = image_size // tile_size
    t = tile_size
    x = x.reshape(v, nt, nt, ch, t, t).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(v, image_size, image_size, ch)


def _tile(x: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(V, S, S, ch) → (V, n_tiles, tt, ch), contiguous."""
    v, s, _, ch = x.shape
    nt = s // tile_size
    t = tile_size
    x = x.reshape(v, nt, t, nt, t, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(v, nt * nt, t * t, ch).contiguous()


def _seg(tile_ids: torch.Tensor, p: int) -> torch.Tensor:
    """Table slot → point id (V, nt·M), with the empty slots sent to the
    dump bucket P, as dss_tpu's scatters take it."""
    ids = tile_ids.reshape(tile_ids.shape[0], -1)
    return torch.where(ids >= 0, ids, p).to(torch.int32).contiguous()


class _RasterizeViewsLean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_screen, features, ellipse, cutoff, radii, scaler,
                image_size, points_per_pixel, cfg, dmt, rbs):
        v, p = pts_screen.shape[:2]
        t = cfg.tile
        with_depth = cfg.depth_channel > 0
        pts = pts_screen.detach()
        binned = bin_splats(
            pts, ellipse, cutoff, radii, image_size, t, cfg.cap,
            max_tiles_x=cfg.max_tiles, max_tiles_y=cfg.max_tiles,
            scaler=scaler, features=features.detach(),
            pair_cap=(cfg.pair_cap_fwd if cfg.pair_cap_fwd > 0 else None),
        )
        cnt_t, vis, rgb_t = kernels.fwd_lean(
            binned.tile_counts, binned.tile_data, p, dmt, image_size, t,
            points_per_pixel, with_depth,
        )
        visible = vis > 0.0
        occ = (_untile(cnt_t[:, :, None, :], image_size, t)[..., 0] > 0)
        rgbw = _untile(rgb_t, image_size, t)

        bt, bcap, bmt, bpc = _bwd_tile_budget(cfg, p)
        binned_bwd, cur_r2 = bin_for_occ_backward(
            pts, radii, visible, rbs, image_size, bt, bcap, bmt, pair_cap=bpc,
        )
        overflow = (binned.overflow + binned_bwd.overflow).to(torch.int32)

        ctx.cfg = cfg
        ctx.dims = (image_size, points_per_pixel, float(dmt), p, bt)
        ctx.binned = binned
        ctx.binned_bwd = binned_bwd
        ctx.cur_r2 = cur_r2.to(torch.float32).contiguous()
        ctx.mark_non_differentiable(visible, overflow)
        return occ.to(torch.float32), visible, rgbw, overflow

    @staticmethod
    def backward(ctx, g_occ, _g_vis, g_rgbw, _g_over):
        image_size, k, dmt, p, bt = ctx.dims
        cfg = ctx.cfg
        t = cfg.tile
        with_depth = cfg.depth_channel > 0

        bb = ctx.binned_bwd
        grad_xy = kernels.occ_bwd(
            bb.tile_counts, bb.tile_data, bb.tile_ids,
            _tile(g_occ[..., None], bt)[..., 0].contiguous(),
            ctx.cur_r2, p, image_size, bt,
        )
        if with_depth:
            # Rows 0–2 rgb cotangent, row 3 the Σw·z cotangent, whose
            # per-candidate image Σ_pix g·w is dL/dz; the Σw cotangent
            # reaches only the constant weights and is dropped.
            g_kernel = torch.cat([g_rgbw[..., :3], g_rgbw[..., 4:5]], dim=-1)
        else:
            g_kernel = g_rgbw
        bf = ctx.binned
        grad_feat = kernels.feat_bwd(
            bf.tile_counts, bf.tile_data, _tile(g_kernel, t), p, dmt,
            image_size, t, k,
        )
        grad_z = (grad_feat[..., 3:4] if with_depth
                  else torch.zeros_like(grad_xy[..., :1]))
        grad_pts = torch.cat([grad_xy, grad_z], dim=-1)
        return (grad_pts, grad_feat[..., :3].contiguous()) + (None,) * 9


def rasterize_views_lean(image_size: int, points_per_pixel: int,
                         tile_config: TileConfig, pts_screen, ellipse_params,
                         cutoff, radii, depth_merging_threshold,
                         radii_backward_scaler, scaler, features):
    """View-batched training-path rasterization (counterpart of
    rasterize_views_pallas_lean).  pts_screen (V, P, 3), ellipse (V, P, 3),
    cutoff (V, P), radii (V, P, 2), scaler (V, P), features (V, P, 3).

    Returns (occ (V, S, S), visible (V, P) bool, rgbw (V, S, S, 4(+1)),
    overflow (V,) int32); rgbw carries Σw·[r, g, b, 1] and, with the depth
    channel, Σw·z in channel 4.  Gradients reach pts_screen (x/y from the
    occupancy field, z from the depth channel) and features."""
    return _RasterizeViewsLean.apply(
        pts_screen, features, ellipse_params, cutoff, radii, scaler,
        image_size, points_per_pixel, tile_config, depth_merging_threshold,
        radii_backward_scaler,
    )


# ---------------------------------------------------------------------------
# The view-batched full-fragment op
# ---------------------------------------------------------------------------


def rasterize_forward_fragments(image_size: int, points_per_pixel: int,
                                tile_config: TileConfig, pts_screen, ellipse,
                                cutoff, radii, depth_merging_threshold,
                                scaler, features):
    """Full-fragment forward (counterpart of rasterize_forward_pallas with
    extras, for V views): bin, run K5, untile, truncate each pixel's
    fragments at the first z − z₀ > dmt (the window K5 composited with).
    K5 writes the points' visibility flags.  Occupancy is taken before the
    truncation.

    Returns (idx (V, S, S, K) int32, zbuf, qvalue (V, S, S, K), occ
    (V, S, S), visible (V, P) bool, rgbw (V, S, S, 4), overflow (V,) int32,
    binned)."""
    p = pts_screen.shape[1]
    t = tile_config.tile
    dmt = depth_merging_threshold
    binned = bin_splats(
        pts_screen, ellipse, cutoff, radii, image_size, t, tile_config.cap,
        max_tiles_x=tile_config.max_tiles, max_tiles_y=tile_config.max_tiles,
        scaler=scaler, features=features,
        pair_cap=(tile_config.pair_cap_fwd if tile_config.pair_cap_fwd > 0
                  else None),
    )
    z_t, q_t, id_t, cnt_t, vis, rgb_t = kernels.fwd_frag(
        binned.tile_counts, binned.tile_data, p, dmt, image_size, t,
        points_per_pixel,
    )
    zbuf = _untile(z_t, image_size, t)
    qv = _untile(q_t, image_size, t)
    idx = _untile(id_t, image_size, t)
    # candidates are depth-sorted, so slot 0 holds the window's z₀
    keep = (idx >= 0) & (zbuf - zbuf[..., :1] <= dmt)
    idx = torch.where(keep, idx, -1)
    zbuf = torch.where(keep, zbuf, -1.0)
    qv = torch.where(keep, qv, -1.0)
    occ = (_untile(cnt_t[:, :, None, :], image_size, t)[..., 0] > 0)
    rgbw = _untile(rgb_t, image_size, t)
    return (idx, zbuf, qv, occ.to(torch.float32), vis > 0.0, rgbw,
            binned.overflow, binned)


def zbuf_backward(idx: torch.Tensor, grad_zbuf: torch.Tensor,
                  p: int) -> torch.Tensor:
    """(V, P) z gradients: the zbuf cotangent of every fragment, summed
    into its point through K4 (counterpart of rasterizer._zbuf_backward);
    K4 drops the empty slots' id −1."""
    v = idx.shape[0]
    return kernels.segment_sum(
        grad_zbuf.reshape(v, 1, -1).to(torch.float32).contiguous(),
        idx.reshape(v, -1).to(torch.int32).contiguous(), p,
    )[..., 0]


class _RasterizeViewsFragments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_screen, features, ellipse, cutoff, radii, scaler,
                image_size, points_per_pixel, cfg, dmt, rbs):
        # Unused outputs bring None cotangents: the zbuf scatter (and K2,
        # K3) are skipped without a host sync on the cotangent's values.
        ctx.set_materialize_grads(False)
        p = pts_screen.shape[1]
        pts = pts_screen.detach()
        (idx, zbuf, qv, occ, visible, rgbw, fwd_overflow,
         binned) = rasterize_forward_fragments(
            image_size, points_per_pixel, cfg, pts, ellipse, cutoff, radii,
            dmt, scaler, features.detach(),
        )
        bt, bcap, bmt, bpc = _bwd_tile_budget(cfg, p)
        binned_bwd, cur_r2 = bin_for_occ_backward(
            pts, radii, visible, rbs, image_size, bt, bcap, bmt, pair_cap=bpc,
        )
        overflow = (fwd_overflow + binned_bwd.overflow).to(torch.int32)

        ctx.cfg = cfg
        ctx.dims = (image_size, points_per_pixel, float(dmt), p, bt)
        ctx.idx = idx
        ctx.binned = binned
        ctx.binned_bwd = binned_bwd
        ctx.cur_r2 = cur_r2.to(torch.float32).contiguous()
        ctx.mark_non_differentiable(idx, visible, overflow)
        return idx, zbuf, qv, occ, visible, rgbw, overflow

    @staticmethod
    def backward(ctx, _g_idx, g_zbuf, _g_q, g_occ, _g_vis, g_rgbw, _g_over):
        image_size, k, dmt, p, bt = ctx.dims
        t = ctx.cfg.tile
        v = ctx.idx.shape[0]
        dev = ctx.idx.device
        if g_occ is None:
            grad_xy = torch.zeros((v, p, 2), device=dev)
        else:
            bb = ctx.binned_bwd
            grad_xy = kernels.occ_bwd(
                bb.tile_counts, bb.tile_data, bb.tile_ids,
                _tile(g_occ[..., None], bt)[..., 0].contiguous(),
                ctx.cur_r2, p, image_size, bt,
            )
        if g_zbuf is None:
            grad_z = torch.zeros((v, p), device=dev)
        else:
            grad_z = zbuf_backward(ctx.idx, g_zbuf, p)
        grad_pts = torch.cat([grad_xy, grad_z[..., None]], dim=-1)
        grad_feat = None
        if g_rgbw is not None:
            # K3 recomputes K1's chunk-minimum window, not K5's rank-0
            # window, as the JAX package's _pallas_bwd does; the Σw
            # cotangent (row 3) reaches only the constant weights, so its
            # sums are dropped.
            bf = ctx.binned
            grad_feat = kernels.feat_bwd(
                bf.tile_counts, bf.tile_data, _tile(g_rgbw, t), p, dmt,
                image_size, t, k,
            )[..., :3]
        return (grad_pts, grad_feat) + (None,) * 9


def rasterize_views_fragments(image_size: int, points_per_pixel: int,
                              tile_config: TileConfig, pts_screen,
                              ellipse_params, cutoff, radii,
                              depth_merging_threshold, radii_backward_scaler,
                              scaler, features):
    """View-batched full-fragment rasterization (counterpart of
    rasterize_points_pallas, one call for V views).  Inputs as
    rasterize_views_lean.

    Returns (idx (V, S, S, K) int32, zbuf, qvalue (V, S, S, K), occ
    (V, S, S), visible (V, P) bool, rgbw (V, S, S, 4), overflow (V,)
    int32).  Gradients reach pts_screen (x/y from the occupancy field, z
    from the zbuf scatter) and features (through the fused composite); the
    qvalue cotangent is dropped, as in the reference."""
    return _RasterizeViewsFragments.apply(
        pts_screen, features, ellipse_params, cutoff, radii, scaler,
        image_size, points_per_pixel, tile_config, depth_merging_threshold,
        radii_backward_scaler,
    )
