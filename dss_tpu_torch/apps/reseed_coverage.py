"""Coverage-driven reseeding between training phases (counterpart of
dss_tpu/apps/reseed_coverage.py).

Renders the checkpoint's silhouettes, finds pixels where the GT masks have
coverage that the render lacks, back-projects them through the visual hull
(`models.reseed`), and writes the checkpoint grown by the new points (their
Adam moments zero, their filters on), ready to resume a refine phase: the
train CLI's loader takes the checkpoint's shapes, whatever the config's
n_points_per_cloud.  The npz keeps the key layout both packages share, so
a grown checkpoint resumes in either package's train_mvr.

GT-free (training masks and cameras only).  If the dataset carries a GT
cloud, prints chamfer and Hausdorff before and after.

    python3 -m dss_tpu_torch.apps.reseed_coverage --ckpt <run>/model.npz \\
        --data <dataset> --out <dir>/model.npz [--n-new 256] [--views 32] \\
        [--use-depth] [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.  The render
settings come from `--config`, by default the checkout's configs/dss.yml,
found from this package's location rather than the working directory;
the image size is the dataset's.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from dss_tpu_torch import config as config_mod
from dss_tpu_torch.apps.prune_floaters import checkpoint_activation
from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.geometry.cameras import cameras_from_matrix
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import (
    PointModelParams,
    point_model_forward,
    prune_outside_silhouette,
    render_model,
)
from dss_tpu_torch.models.reseed import reseed_coverage
from dss_tpu_torch.training.metrics import chamfer_hausdorff
from dss_tpu_torch.training.trainer import take_views
from dss_tpu_torch.utils.device import resolve_device

DEFAULT_CONFIG = str(Path(__file__).resolve().parents[2] / "configs" / "dss.yml")
RENDER_BATCH = 8  # views per render


def extend_checkpoint(ck: dict, n_old: int, new_arrays: dict) -> dict:
    """Every per-point array of a checkpoint dict grown from n_old to
    n_old + n_new rows: `new_arrays` gives the rows of named keys (e.g.
    params/points); other per-point arrays grow by zeros (Adam moments) or
    True (boolean filters)."""
    some_new = next(iter(new_arrays.values()))
    n_new = some_new.shape[0]
    out = {}
    for k, v in ck.items():
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] == n_old:
            if k in new_arrays:
                tail = np.asarray(new_arrays[k], v.dtype)
            elif v.dtype == bool:
                tail = np.ones((n_new,) + v.shape[1:], bool)
            else:
                tail = np.zeros((n_new,) + v.shape[1:], v.dtype)
            out[k] = np.concatenate([v, tail], axis=0)
        else:
            out[k] = v
    return out


def main(argv=None):
    """Returns (new points (M, 3), nearest_idx (M,)) as numpy, M = 0 when
    nothing was written."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--out", default=None,
                        help="output npz (default: <ckpt base>_reseed.npz)")
    parser.add_argument("--n-new", type=int, default=256)
    parser.add_argument("--views", type=int, default=32,
                        help="views rendered for deficit detection (evenly "
                             "spaced; the full-view hull re-check uses all)")
    parser.add_argument("--hull-outside-frac", type=float, default=0.05)
    parser.add_argument("--use-depth", action="store_true",
                        help="use the dataset's dense depth maps: exact "
                             "candidate placement and the holes behind "
                             "other geometry that the silhouette cannot see")
    parser.add_argument("--depth-tol", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config", default=DEFAULT_CONFIG,
                        help="config whose raster settings render the "
                             "checkpoint (default: the checkout's "
                             "configs/dss.yml)")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    ds = MVRDataset(args.data, load_dense_depth=args.use_depth)
    all_cams = cameras_from_matrix(ds.camera_mat, **ds.cameras_params,
                                   device=device)
    n_views_total = len(all_cams)

    ck = dict(np.load(args.ckpt))
    p = ck["params/points"].shape[0]
    _, active_np = checkpoint_activation(ck, p)
    params = PointModelParams.create(ck["params/points"], ck["params/normals"],
                                     ck["params/colors"], device=device,
                                     requires_grad=False)
    pts = params.points
    active = torch.as_tensor(active_np, device=device)

    # predicted silhouettes on an evenly spaced view subset
    vsel = np.unique(
        np.linspace(0, n_views_total - 1, min(args.views, n_views_total))
        .round().astype(int))
    _, msk, cams, lights = ds.get_batch(vsel, device)
    settings = config_mod.create_raster_settings(
        config_mod.load_config(args.config))
    # the dataset's resolution, not the config's: the deficit test compares
    # the predicted alpha with the dataset's masks
    settings = settings.replace(image_size=int(msk.shape[-1]))
    if args.use_depth:
        # the fragment path: its render carries the front depth
        settings = settings.replace(lean_fragments=False)
    filters = PointFilters(active, active, active)
    alphas, depths = [], []
    for i in range(0, len(vsel), RENDER_BATCH):
        sl = slice(i, i + RENDER_BATCH)
        sub, sub_lights = take_views(cams, sl), take_views(lights, sl)
        if args.use_depth:
            with torch.no_grad():
                out, _ = point_model_forward(params, filters, sub, sub_lights,
                                             settings)
            a = out["mask_img_pred"]
            zfar = float(cams.zfar[0])
            alphas.append(a)
            depths.append(torch.where(a > 0.5, out["depth_pred"], zfar))
        else:
            alphas.append(render_model(params, filters, sub, sub_lights,
                                       settings)[..., 3])
    pred_alpha = torch.cat(alphas)
    gt_depths = pred_depths = None
    if args.use_depth:
        pred_depths = torch.cat(depths)
        gt_depths = ds.get_depths(vsel)

    new_pts, near_idx = reseed_coverage(
        pts, active, cams, torch.as_tensor(msk, device=device), pred_alpha,
        n_new=args.n_new, hull_outside_frac=args.hull_outside_frac,
        seed=args.seed, gt_depths=gt_depths, pred_depths=pred_depths,
        depth_tol=args.depth_tol,
    )
    print(f"reseeded {new_pts.shape[0]} points (asked {args.n_new})")
    if new_pts.shape[0] == 0:
        print("no coverage deficit found; nothing to write")
        return new_pts, near_idx

    # reseed_coverage tested the hull on the rendered subset's views:
    # re-check against every view and drop what lies outside
    keep = prune_outside_silhouette(
        torch.as_tensor(new_pts, device=device), all_cams,
        torch.as_tensor(ds.masks, device=device),
        outside_frac=args.hull_outside_frac).cpu().numpy()
    if not keep.all():
        print(f"dropping {int((~keep).sum())} proposals outside the full hull")
        new_pts, near_idx = new_pts[keep], near_idx[keep]
    if new_pts.shape[0] == 0:
        print("no proposals survived the full-view hull test")
        return new_pts, near_idx

    if ds.points is not None:
        gt = torch.as_tensor(ds.points, device=device)
        before = chamfer_hausdorff(pts, gt, pred_mask=active)
        allp = torch.cat([pts, torch.as_tensor(new_pts, device=device)])
        allm = torch.cat([active, torch.ones((new_pts.shape[0],),
                                             dtype=torch.bool, device=device)])
        after = chamfer_hausdorff(allp, gt, pred_mask=allm)
        for tag, r in (("before", before), ("after ", after)):
            print(f"{tag}: chamfer {float(r['chamfer']):.6f}"
                  f" hausdorff {float(r['hausdorff']):.4f}")

    new_arrays = {
        "params/points": new_pts,
        "params/normals": np.asarray(ck["params/normals"])[near_idx],
        "params/colors": np.asarray(ck["params/colors"])[near_idx],
    }
    out_ck = extend_checkpoint(ck, p, new_arrays)
    out = args.out or os.path.splitext(args.ckpt)[0] + "_reseed.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, **out_ck)
    print(f"wrote {out} ({p} -> {p + new_pts.shape[0]} points)")
    return new_pts, near_idx


if __name__ == "__main__":
    main()
