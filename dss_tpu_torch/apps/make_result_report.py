"""GT-vs-prediction report of a trained model (counterpart of
scripts/make_result_report.py).

Loads a train_mvr checkpoint and its MVR dataset, renders the active points
for the chosen views with the config's raster settings, and writes

- <out>/<stem>_gt_vs_pred.png: per view, the GT image beside the
  prediction's rgb·alpha (`save_image_grid`, two columns);
- <out>/<json-name>: chamfer, hausdorff and p2f to the dataset's GT cloud,
  chamfer_normal (when the GT has normals), and over the views PSNR of the
  prediction composited over the dataset's background colour
  (rgb·a + (1 − a)·bg, bg the mean GT colour outside the masks) and the
  IoU loss of its alpha against the masks.

    python3 -m dss_tpu_torch.apps.make_result_report --data <dataset> \\
        --ckpt <run>/model.npz [--out docs] [--views 0 5 11 17] \\
        [--config configs/dss.yml] [--recipe "..."] [--device cpu]

It renders on the CUDA card unless `--device` says otherwise.  The images
and masks are read through data/png.py.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dss_tpu_torch import config as config_mod
from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.models.point_model import render_model
from dss_tpu_torch.training.checkpoint import CheckpointIO
from dss_tpu_torch.training.losses import iou_loss
from dss_tpu_torch.training.metrics import chamfer_hausdorff, point_to_surface
from dss_tpu_torch.training.trainer import (
    chamfer_distance,
    create_train_state,
    psnr,
)
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.visualize import save_image_grid

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> dict:
    """Returns the report dict (also written as JSON)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="docs")
    ap.add_argument("--ckpt", default=None, help="checkpoint npz file")
    ap.add_argument("--ckpt-dir", default="exp/dss_proj",
                    help="fallback: directory holding model.npz")
    ap.add_argument("--data", required=True, help="MVR dataset dir")
    ap.add_argument("--views", type=int, nargs="+", default=[0, 5, 11, 17])
    ap.add_argument("--config", default=os.path.join(_REPO, "configs",
                                                     "dss.yml"),
                    help="config whose raster settings render the model")
    ap.add_argument("--recipe", default=None,
                    help="recipe string for the report")
    ap.add_argument("--json-name", default="yoga6_metrics.json",
                    help="output json filename (and the image grid name "
                         "derives from its stem)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cuda:0), "
                         "which must exist; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_mod.load_config(args.config)
    ds = MVRDataset(args.data)
    params, learn = config_mod.create_model_params(cfg, device=device)
    settings = config_mod.create_raster_settings(cfg)
    state = create_train_state(
        params, config_mod.create_optimizer(cfg, params, learn))
    if args.ckpt:
        ckpt_dir, ckpt_file = os.path.split(args.ckpt)
    else:
        ckpt_dir, ckpt_file = args.ckpt_dir, "model.npz"
    state, scalars = CheckpointIO(ckpt_dir).load(ckpt_file, state)
    it = int(scalars.get("it", -1))
    print("loaded checkpoint at it", it)

    img, msk, cams, lights = ds.get_batch(args.views, device=device)
    rgba = render_model(state.params, state.filters, cams, lights,
                        settings).cpu().numpy()
    rows = []
    for i in range(len(args.views)):
        rows.append(img[i])
        rows.append(np.clip(rgba[i, ..., :3], 0, 1) * rgba[i, ..., 3:4])
    os.makedirs(args.out, exist_ok=True)
    save_image_grid(
        np.stack(rows),
        os.path.join(args.out, args.json_name.replace("_metrics.json", "")
                     + "_gt_vs_pred.png"),
        ncols=2,
    )

    pts = state.params.points.detach()
    gt = torch.as_tensor(ds.points, device=device)
    gtn = (None if ds.normals is None
           else torch.as_tensor(ds.normals, device=device))
    active = state.filters.activation
    m = chamfer_hausdorff(pts, gt, pred_mask=active)
    p2f = point_to_surface(pts, gt, gtn, pred_mask=active)
    report = {
        "iters": it,
        "chamfer": float(m["chamfer"]),
        "hausdorff": float(m["hausdorff"]),
        "p2f": float(p2f),
    }
    if args.recipe:
        report["recipe"] = args.recipe
    if gtn is not None:
        _, cn = chamfer_distance(gt, pts, gtn,
                                 state.params.normals.detach(), y_mask=active)
        report["chamfer_normal"] = float(cn)
    # The prediction over the dataset's background colour (the mean GT
    # colour outside the masks): mesh datasets are white-background, cloud
    # datasets black.  The train loss never sees the background, but a
    # whole-image PSNR would measure the background convention.
    outside = 1.0 - msk[..., None]
    bg = (img * outside).sum(axis=(0, 1, 2)) / np.maximum(
        outside.sum(axis=(0, 1, 2)), 1.0)
    pred_rgb = rgba[..., :3] * rgba[..., 3:4] + (1.0 - rgba[..., 3:4]) * bg
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    report["psnr_%dviews" % len(args.views)] = float(psnr(f32(pred_rgb),
                                                          f32(img)))
    report["iou_loss_%dviews" % len(args.views)] = float(
        iou_loss(f32(rgba[..., 3]), f32(msk)))
    with open(os.path.join(args.out, args.json_name), "w") as f:
        json.dump(report, f, indent=1)
    print(report)
    return report


if __name__ == "__main__":
    main()
