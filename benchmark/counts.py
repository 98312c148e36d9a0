"""The work a traced step needs, counted by the benchmark itself on the
reference's tables: for each profiled step, from the params the program
held before it and the step's views, the reference's splat set-up and
rasterization give the splats' boxes, the visible points and the support
disc, and from them

- `box_pairs`: (pixel, splat) pairs with the pixel centre inside a
  rendered splat's axis-aligned box (pz >= 0), all views: the pairs the
  forward and the feature backward evaluate;
- `disc_pairs`: (pixel, point) pairs with the pixel centre inside the
  support disc of a visible, on-screen point (pz >= 0), all views: the
  pairs the occupancy backward evaluates;
- `on_screen`: those visible, on-screen (view, point) pairs;
- `rendered`: the (view, splat) pairs that are rasterized;
- `knn`: the (queries, refs, k) of each exact kNN the step runs.

With S scenes stacked (`harness.scenes`), the adapter's reference cameras
are S batches; each scene's table is made apart and the step's one table
is their sum (`add_scenes`).

A roofline file (`roofline/<kernel>.py`) turns these into operations and
bytes.  The reference's module and its raster, recipe and cameras come
from the configuration's adapter (its `REF` and `reference_objects`)."""
from __future__ import annotations

import torch

from benchmark import harness, program


def _span(c, r, s: int):
    """Pixel centres 1 - (2j + 1)/s within [c - r, c + r], per entry."""
    lo = torch.ceil((s * (1.0 - c - r) - 1.0) * 0.5).clamp(0, s)
    hi = torch.floor((s * (1.0 - c + r) - 1.0) * 0.5).clamp(-1, s - 1)
    return torch.clamp(hi - lo + 1.0, min=0.0)


def box_pairs(spl, s: int) -> int:
    """Pixel centres inside the box of each rendered splat (the
    reference's `Splats`)."""
    pts, radii = spl.pts_screen, spl.radii
    on = torch.isfinite(spl.cutoff) & (pts[..., 2] >= 0.0)
    n = _span(pts[..., 0], radii[..., 0], s) * _span(pts[..., 1], radii[..., 1], s)
    return int(torch.sum(torch.where(on, n, 0.0).double()))


def disc_pairs(pts, ok, r2, s: int) -> int:
    """Pixels within sqrt(r2[v]) of each point with `ok`, counted row by
    row of the disc."""
    total = 0.0
    for v in range(pts.shape[0]):
        p = pts[v][ok[v]]
        if p.numel() == 0 or float(r2[v]) <= 0:
            continue
        r = float(r2[v]) ** 0.5
        reach = int(r * s / 2.0) + 2
        row = torch.floor((s * (1.0 - p[:, 1]) - 1.0) * 0.5)
        rows = row[:, None] + torch.arange(-reach, reach + 1,
                                           device=p.device)[None]
        y = 1.0 - (2.0 * rows + 1.0) / s
        dy2 = (y - p[:, 1:2]) ** 2
        inside = (rows >= 0) & (rows < s) & (dy2 <= r2[v])
        half = torch.sqrt(torch.clamp(r2[v] - dy2, min=0.0))
        n = _span(p[:, 0:1].expand_as(half), half, s)
        total += float(torch.sum(torch.where(inside, n, 0.0).double()))
    return int(total)


def knn_calls(raster, recipe, p: int):
    """(queries, refs, k) of the step's exact kNNs: the global kernel
    size's self-7-NN, the anisotropic Vrk's 8-NN, the surface losses'
    (knn_k - 1)-NN without self."""
    calls = []
    if raster.Vrk_invariant or raster.Vrk_isotropic:
        calls.append((4096 if p > 8192 and raster.Vrk_invariant else p, p, 7))
    else:
        calls.append((p, p, 8))
    if recipe.lambda_proj > 0 or recipe.lambda_repel > 0:
        calls.append((p, p, recipe.knn_k - 1))
    return calls


def _table(ref, raster, recipe, cams, lean: bool, points, normals, act,
           views, step) -> dict:
    """One scene's table of one step (see the module's docstring)."""
    s = raster.image_size
    p = points.shape[0]
    vrk_h = None
    if raster.Vrk_invariant:
        vrk_h = ref.vrk_h_global(points, act)
    elif raster.Vrk_isotropic:
        vrk_h = ref.vrk_h_isotropic(points, act)
    c = cams.take(views)
    spl = ref.prepare_splats(points, ref.normalize(normals), act, c,
                             raster, vrk_h)
    idx, _, _, _ = ref.rasterize_rows(
        spl.pts_screen, spl.ellipse, spl.cutoff, spl.radii,
        raster.depth_merging_threshold, s, raster.points_per_pixel)
    vis = ref.visible_points(idx, p)
    r2 = ref.support_radius2(
        spl.radii, vis, ref.backward_scaler(recipe, step, points.device))
    pts = spl.pts_screen
    ok = (vis & (pts[..., 2] >= 0.0) & (pts[..., 0].abs() <= 1.0)
          & (pts[..., 1].abs() <= 1.0))
    return {
        "views": len(views), "points": p, "image_size": s,
        "points_per_pixel": raster.points_per_pixel,
        "lean": lean,
        "depth_channel": not raster.depth_from_fragments,
        "rendered": int((torch.isfinite(spl.cutoff)
                         & (spl.pts_screen[..., 2] >= 0.0)).sum()),
        "box_pairs": box_pairs(spl, s),
        "disc_pairs": disc_pairs(pts, ok, r2, s),
        "on_screen": int(ok.sum()),
        "knn": knn_calls(raster, recipe, p),
    }


# What the tables of S scenes add up to in the step's one table: K1-K3 run
# once over the S·V folded views, each view over its own scene's P points.
SUMMED = ("views", "points", "rendered", "box_pairs", "disc_pairs",
          "on_screen")


def add_scenes(tables) -> dict:
    """The step's table from its scenes' tables: the counts of SUMMED
    added, the kNN lists joined, `scenes` their number (a roofline's
    (view, point) terms count views * points / scenes, since a view sees
    only its own scene's points: `view_points`)."""
    out = {**tables[0], **{k: sum(t[k] for t in tables) for k in SUMMED}}
    out["knn"] = [c for t in tables for c in t["knn"]]
    out["scenes"] = len(tables)
    return out


def view_points(t: dict) -> int:
    """The (view, point) pairs of a table's per-view buffers: each view
    over its own scene's points, views * points / scenes."""
    return t["views"] * t["points"] // t.get("scenes", 1)


@torch.no_grad()
def step_tables(cell, data: dict, inputs) -> list:
    """One dict per profiled step (see the module's docstring); with S
    stacked scenes, each scene's table from its own points, cameras and
    the step's views, added (`add_scenes`)."""
    ad = harness.adapter(cell)
    raster, recipe, cams, _ = ad.reference_objects(cell, data)
    lean = bool(program.run_config(cell)["renderer"]["raster_params"]
                ["lean_fragments"])
    n = harness.scenes(data)
    out = []
    for points, normals, act, views, step in inputs:
        if n is None:
            out.append(_table(ad.REF, raster, recipe, cams, lean, points,
                              normals, act, views, step))
        else:
            out.append(add_scenes([
                _table(ad.REF, raster, recipe, cams[s], lean, points[s],
                       normals[s], act[s], views, step) for s in range(n)]))
    return out
