"""Point-cloud denoising CLI, the paper's denoising application
(counterpart of dss_tpu/apps/denoise_pcl.py).

The reference's geometry ops chained: optional outlier removal, PCA
normals (or the PLY's own), then per round bilateral normal denoising,
one RIMLS projection to the latent surface and optional uniform
resampling; final PCA normals, and optional EAR upsampling to a target
count.  Reads and writes PLY through `data/io.py`.

    python3 -m dss_tpu_torch.apps.denoise_pcl --input noisy.ply \\
        --out denoised.ply [--iters 3] [--remove-outliers] [--upsample N] \\
        [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse

import torch

from dss_tpu_torch.data.io import read_ply, save_ply
from dss_tpu_torch.geometry.denoise import (
    denoise_normals_bilateral,
    project_to_latent_surface,
    remove_outliers,
    resample_uniformly,
    upsample_ear,
)
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.utils.device import resolve_device


def main(argv=None):
    """Returns (points (N, 3), normals (N, 3)) as written, numpy."""
    parser = argparse.ArgumentParser(description="Denoise a point cloud")
    parser.add_argument("--input", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--iters", type=int, default=1,
                        help="project+resample rounds")
    parser.add_argument("--remove-outliers", action="store_true")
    parser.add_argument("--outlier-tolerance", type=float, default=0.05)
    parser.add_argument("--neighborhood-size", type=int, default=16)
    parser.add_argument("--normal-k", type=int, default=32,
                        help="PCA neighbourhood for normal estimation; it "
                             "must out-scale the noise (k=16 patches are "
                             "noise balls at sigma ~ the point spacing)")
    parser.add_argument("--sharpness-sigma", type=float, default=30.0)
    parser.add_argument("--repulsion-mu", type=float, default=0.0,
                        help="uniform-resampling strength; 0 disables it "
                             "(resampling trades a little p2f for "
                             "uniformity)")
    parser.add_argument("--ignore-input-normals", action="store_true",
                        help="estimate normals even if the .ply has them")
    parser.add_argument("--upsample", type=int, default=0,
                        help="target point count")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    ply = read_ply(args.input)
    pts = torch.as_tensor(ply.points, dtype=torch.float32, device=device)
    p = pts.shape[0]
    mask = torch.ones((p,), dtype=torch.bool, device=device)
    print("loaded %d points from %s" % (p, args.input))

    if args.remove_outliers:
        mask = remove_outliers(pts, mask, args.neighborhood_size,
                               args.outlier_tolerance)
        print("outlier removal: %d points kept" % int(mask.sum()))

    if ply.normals is not None and not args.ignore_input_normals:
        normals = torch.as_tensor(ply.normals, dtype=torch.float32,
                                  device=device)
    else:
        normals = estimate_normals(pts, mask,
                                   neighborhood_size=min(args.normal_k, p - 1))

    for i in range(args.iters):
        normals = denoise_normals_bilateral(pts, normals, mask,
                                            args.sharpness_sigma,
                                            args.neighborhood_size)
        # the JAX package's tuning on its σ = 0.3%-of-the-bbox-diagonal
        # benchmark: k 15, one projection step, 5 robust reweightings
        pts = project_to_latent_surface(pts, normals, mask,
                                        neighborhood_size=min(15, p - 1),
                                        max_proj_iters=1, max_est_iter=5)
        if args.repulsion_mu > 0:
            pts = resample_uniformly(pts, mask, normals=normals,
                                     neighborhood_size=8, iters=1,
                                     repulsion_mu=args.repulsion_mu)
        if args.iters > 1 and i + 1 < args.iters:
            normals = estimate_normals(
                pts, mask, neighborhood_size=min(args.normal_k, p - 1),
                reference_normals=normals)
        print("round %d/%d done" % (i + 1, args.iters))

    normals = estimate_normals(pts, mask, neighborhood_size=8,
                               reference_normals=normals)

    n_cur = int(mask.sum())
    if args.upsample > n_cur:
        cap = args.upsample
        pts_c = torch.zeros((cap, 3), device=device)
        nrm_c = torch.zeros((cap, 3), device=device)
        pts_c[:n_cur] = pts[mask]
        nrm_c[:n_cur] = normals[mask]
        m_c = torch.arange(cap, device=device) < n_cur
        pts, mask = upsample_ear(pts_c, nrm_c, m_c, n_cur, cap)
        normals = estimate_normals(pts, mask, neighborhood_size=8)
        print("upsampled to %d points" % int(mask.sum()))

    keep = mask.cpu().numpy()
    out_pts = pts.cpu().numpy()[keep]
    out_nrm = normals.cpu().numpy()[keep]
    save_ply(args.out, out_pts, normals=out_nrm)
    print("wrote", args.out)
    return out_pts, out_nrm


if __name__ == "__main__":
    main()
