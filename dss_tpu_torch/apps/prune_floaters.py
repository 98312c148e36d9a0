"""Post-training floater pruning (the flagship recipe's third stage;
counterpart of dss_tpu/apps/prune_floaters.py).

Loads a train_mvr checkpoint and its MVR dataset, computes the GT-free
silhouette-consistency keep-mask (`point_model.prune_outside_silhouette`:
a surface point projects inside the object mask in every view, a floater
does not), ANDs it into the checkpoint's activation filter, and writes the
pruned checkpoint and PLY.  With --depth-tol the interior-floater test
(`prune_depth_inconsistent`: points never on the dataset's dense front
depth) is ANDed in.  If the dataset carries a GT cloud, prints chamfer and
Hausdorff before and after.

    python3 -m dss_tpu_torch.apps.prune_floaters --ckpt <run>/model_best.npz \\
        --data <dataset> [--outside-frac 0.09] [--depth-tol 0.03] \\
        [--depth-min-views 3] [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.geometry.cameras import cameras_from_matrix
from dss_tpu_torch.models.point_model import (
    prune_depth_inconsistent,
    prune_outside_silhouette,
)
from dss_tpu_torch.training.metrics import chamfer_hausdorff
from dss_tpu_torch.utils.device import resolve_device


def checkpoint_activation(ck: dict, n_points: int):
    """(activation keys, (P,) bool activation) of a checkpoint dict: the
    keys ending in `activation`, all ones when there is none."""
    keys = [k for k in ck if k.endswith("activation")]
    if keys:
        return keys, np.asarray(ck[keys[0]]).astype(bool)
    return keys, np.ones((n_points,), bool)


def main(argv=None) -> np.ndarray:
    """Returns the new (P,) bool activation."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data", required=True,
                        help="MVR dataset dir (masks + cameras)")
    parser.add_argument("--out", default=None,
                        help="output npz (default: <ckpt base>_pruned.npz)")
    parser.add_argument("--outside-frac", type=float, default=0.09)
    parser.add_argument("--mask-threshold", type=float, default=0.5)
    parser.add_argument(
        "--depth-tol", type=float, default=None,
        help="also prune interior floaters: keep only points within this "
        "view-space depth tolerance of the dataset's dense front depth in "
        ">= --depth-min-views views",
    )
    parser.add_argument("--depth-min-views", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    ds = MVRDataset(args.data, load_dense_depth=args.depth_tol is not None)
    cams = cameras_from_matrix(ds.camera_mat, **ds.cameras_params,
                               device=device)

    ck = dict(np.load(args.ckpt))
    pts = torch.as_tensor(ck["params/points"], device=device)
    act_keys, active_np = checkpoint_activation(ck, pts.shape[0])
    active = torch.as_tensor(active_np, device=device)

    keep = prune_outside_silhouette(
        pts, cams, torch.as_tensor(ds.masks, device=device),
        outside_frac=args.outside_frac, mask_threshold=args.mask_threshold,
    )
    if args.depth_tol is not None:
        keep_depth = prune_depth_inconsistent(
            pts, cams, torch.as_tensor(ds.get_depths(), device=device),
            tol=args.depth_tol, min_views=args.depth_min_views,
        )
        print(f"depth-consistency drops "
              f"{int(torch.sum(active & ~keep_depth))} active points")
        keep = keep & keep_depth
    new_active = active & keep
    n_pruned = int(torch.sum(active & ~keep))
    print(f"pruned {n_pruned}/{int(active.sum())} active points")

    if ds.points is not None:
        gt = torch.as_tensor(ds.points, device=device)
        for tag, m in (("before", active), ("after ", new_active)):
            r = chamfer_hausdorff(pts, gt, pred_mask=m)
            print(f"{tag}: chamfer {float(r['chamfer']):.6f}"
                  f" hausdorff {float(r['hausdorff']):.4f}")

    out = args.out or os.path.splitext(args.ckpt)[0] + "_pruned.npz"
    am = new_active.cpu().numpy()
    for k in act_keys or ["filters/activation"]:
        ck[k] = am
    np.savez(out, **ck)
    print(f"wrote {out}")

    nrm = ck.get("params/normals")
    save_ply(os.path.splitext(out)[0] + ".ply", ck["params/points"][am],
             normals=None if nrm is None else np.asarray(nrm)[am])
    return am


if __name__ == "__main__":
    main()
