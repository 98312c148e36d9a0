"""Point-cloud evaluation CLI: chamfer, Hausdorff, point-to-surface and NUC
of each predicted cloud against a GT cloud, as a table and an optional CSV
(counterpart of dss_tpu/apps/evaluate_pcl.py).

    python3 -m dss_tpu_torch.apps.evaluate_pcl --pred out1.ply out2.ply \\
        --gt gt.ply [--csv metrics.csv] [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse
import csv
import os

import torch

from dss_tpu_torch.data.io import read_ply
from dss_tpu_torch.training.metrics import (
    chamfer_hausdorff,
    point_to_surface,
    uniformity_nuc,
)
from dss_tpu_torch.utils.device import resolve_device


def main(argv=None):
    """Returns one dict per predicted cloud: name, chamfer, hausdorff, p2f,
    nuc."""
    parser = argparse.ArgumentParser(description="Evaluate point clouds vs GT")
    parser.add_argument("--pred", nargs="+", required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--csv", default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    gt = read_ply(args.gt)
    gt_pts = torch.as_tensor(gt.points, device=device)
    gt_normals = (None if gt.normals is None
                  else torch.as_tensor(gt.normals, device=device))

    rows = []
    for pred_path in args.pred:
        pp = torch.as_tensor(read_ply(pred_path).points, device=device)
        m = chamfer_hausdorff(pp, gt_pts)
        row = {
            "name": os.path.basename(pred_path),
            "chamfer": float(m["chamfer"]),
            "hausdorff": float(m["hausdorff"]),
            "p2f": float(point_to_surface(pp, gt_pts, gt_normals)),
            "nuc": float(uniformity_nuc(pp)),
        }
        rows.append(row)
        print("%-40s chamfer %.6g  hausdorff %.6g  p2f %.6g  nuc %.4f"
              % (row["name"], row["chamfer"], row["hausdorff"], row["p2f"],
                 row["nuc"]))

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print("wrote", args.csv)
    return rows


if __name__ == "__main__":
    main()
