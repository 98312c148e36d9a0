"""Post-training normal refinement (the flagship recipe's fourth stage;
counterpart of dss_tpu/apps/refine_normals.py).

Loads a train_mvr checkpoint, re-estimates the normal field from the point
geometry with `geometry.normals.refine_normals` (weighted osculating-jet
fit and bilateral smoothing, oriented by the trained normals), and writes
the refined checkpoint and PLY.  With --data, prints chamfer_point and
chamfer_normal before and after (`training.trainer.chamfer_distance`, as
the train CLI's eval).

    python3 -m dss_tpu_torch.apps.refine_normals --ckpt <run>/model.npz \\
        [--out <run>/model_jet.npz] [--data <dataset>] [--k 48] \\
        [--jet-passes 2] [--sigma 0.5] [--bilateral-iters 2] [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dss_tpu_torch.apps.prune_floaters import checkpoint_activation
from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.geometry.normals import refine_normals
from dss_tpu_torch.training.trainer import chamfer_distance
from dss_tpu_torch.utils.device import resolve_device


def main(argv=None) -> np.ndarray:
    """Returns the refined (P, 3) normals."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", default=None,
                        help="output npz (default: <ckpt base>_jet.npz)")
    parser.add_argument("--data", default=None,
                        help="MVR dataset dir for before/after eval")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    parser.add_argument("--k", type=int, default=48)
    parser.add_argument("--jet-passes", type=int, default=2)
    parser.add_argument("--sigma", type=float, default=0.5)
    parser.add_argument("--bilateral-k", type=int, default=16)
    parser.add_argument("--bilateral-iters", type=int, default=2)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    ck = dict(np.load(args.ckpt))
    pts = torch.as_tensor(ck["params/points"], device=device)
    nrm = torch.as_tensor(ck["params/normals"], device=device)
    _, mask_np = checkpoint_activation(ck, pts.shape[0])
    mask = torch.as_tensor(mask_np, device=device)

    refined = refine_normals(
        pts, nrm, mask, neighborhood_size=args.k,
        jet_passes=args.jet_passes, bilateral_sigma=args.sigma,
        bilateral_k=args.bilateral_k, bilateral_iters=args.bilateral_iters,
    )

    if args.data:
        gt_pts, gt_nrm, _ = MVRDataset(args.data).get_pointclouds()
        if gt_pts is None or gt_nrm is None:
            raise SystemExit(
                f"--data {args.data} has no ground-truth point cloud; "
                "drop --data or point it at a dataset with GT points+normals")
        for tag, n in (("before", nrm), ("after ", refined)):
            cd, cn = chamfer_distance(
                torch.as_tensor(gt_pts, device=device), pts,
                torch.as_tensor(gt_nrm, device=device), n, y_mask=mask)
            print(f"{tag}: chamfer_point {float(cd):.6f}"
                  f" chamfer_normal {float(cn):.4f}")

    out = args.out or os.path.splitext(args.ckpt)[0] + "_jet.npz"
    if not out.endswith(".npz"):
        out += ".npz"  # np.savez appends it anyway; keep the log truthful
    refined_np = refined.cpu().numpy().astype(np.float32)
    ck["params/normals"] = refined_np
    np.savez(out, **ck)
    print(f"wrote {out}")
    save_ply(os.path.splitext(out)[0] + ".ply", ck["params/points"][mask_np],
             normals=refined_np[mask_np])
    return refined_np


if __name__ == "__main__":
    main()
