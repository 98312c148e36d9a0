"""Write a small self-rendered MVR dataset and its train config (the torch
counterpart of scripts/make_tiny_dataset.py).

Renders the same colour-banded ground-truth sphere through dss_tpu_torch
and writes image/, mask/, depth/ (the weighted depth, zfar outside the
object), data_dict.npz, optionally DTU-style cameras.npz, and config.yml,
with data/png.py and utils/yaml_lite.py:

    python3 -m dss_tpu_torch.apps.make_tiny_dataset --out <dir> \\
        [--views 8] [--image-size 64] [--points 1500] [--device cpu]

then

    python3 -m dss_tpu_torch.apps.train_mvr --config <dir>/config.yml \\
        --max-iters 30 [--device cpu]

It renders on the CUDA card unless `--device` says otherwise.  The render
backend "auto" is the tile-binned splat ops here; the JAX script's "auto"
is the reference rasterizer off the TPU, so `backend="reference"` makes the
same images as the JAX script on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dss_tpu_torch.data import png
from dss_tpu_torch.geometry.cameras import (
    FoVPerspectiveCameras,
    look_at_view_transform,
)
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.utils import yaml_lite
from dss_tpu_torch.utils.device import resolve_device

ZFAR = 100.0


def make_tiny_dataset(out: str, views: int = 8, image_size: int = 64,
                      points: int = 1500, n_train_points: int = 1500,
                      fmt: str = "mvr", device=None,
                      backend: str = "auto") -> dict:
    """Render and write the dataset to `out`; returns its config dict."""
    device = resolve_device(device)
    v, s = views, image_size
    verts, faces = ico_sphere(level=4, radius=0.5)
    pts_np, normals_np = sample_points_from_mesh(verts, faces, points)
    pts = torch.as_tensor(pts_np, device=device)
    # colour bands, so that the rgb loss has signal
    colors = torch.stack(
        [
            0.5 + 0.5 * torch.sin(6.0 * pts[:, 0]),
            0.5 + 0.5 * torch.cos(6.0 * pts[:, 1]),
            torch.full((points,), 0.6, device=device),
        ],
        dim=1,
    )
    r, t = look_at_view_transform(
        dist=torch.full((v,), 2.0),
        elev=torch.tensor(np.linspace(-20, 40, v), dtype=torch.float32),
        azim=torch.tensor(np.linspace(0, 315, v), dtype=torch.float32),
    )
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=device)
    st = RasterSettings(
        image_size=s, points_per_pixel=5, Vrk_invariant=True,
        Vrk_isotropic=False, backface_culling=True, cutoff_threshold=1.0,
        depth_channel=True, backend=backend,
    )
    with torch.no_grad():
        rgba, frags, _ = render_views(
            pts, torch.as_tensor(normals_np, device=device), colors,
            torch.ones(points, dtype=torch.bool, device=device), cams, None,
            st)
    rgba = rgba.cpu().numpy()
    # the weighted-depth channel as dense depth, zfar where uncovered
    depth = frags.wdepth.cpu().numpy()
    depth = np.where(depth > 0.0, depth, np.float32(ZFAR))

    for sub in ("image", "mask", "depth"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    for i in range(v):
        png.write_png(
            os.path.join(out, "image", f"{i:03d}.png"),
            (np.clip(rgba[i, ..., :3], 0, 1) * 255).astype(np.uint8),
        )
        png.write_png(
            os.path.join(out, "mask", f"{i:03d}.png"),
            (rgba[i, ..., 3] * 255).astype(np.uint8),
        )
        np.save(os.path.join(out, "depth", f"{i:03d}.npy"),
                depth[i].astype(np.float32))
    m44 = np.zeros((v, 4, 4), np.float32)
    m44[:, :3, :3] = r.numpy()
    m44[:, 3, :3] = t.numpy()
    m44[:, 3, 3] = 1
    np.savez(
        os.path.join(out, "data_dict.npz"),
        camera_mat=m44,
        points=pts_np,
        normals=normals_np,
        colors=colors.cpu().numpy(),
        cameras_type="FoVPerspectiveCameras",
        cameras_params={"fov": 60.0, "znear": 0.1, "zfar": ZFAR},
    )
    if fmt == "dtu":
        # IDR/DTU cameras.npz: per-view world_mat and scale_mat with
        # camera_mat = scale.T @ world.T
        np.savez(
            os.path.join(out, "cameras.npz"),
            **{f"world_mat_{i}": m44[i].T for i in range(v)},
            **{f"scale_mat_{i}": np.eye(4, dtype=np.float32) for i in range(v)},
        )
    cfg = {
        "name": "tiny_verify",
        "data": {"type": "MVR" if fmt == "mvr" else "DTU", "data_dir": out},
        "renderer": {
            "raster_params": {
                "image_size": s,
                "points_per_pixel": 5,
                "cutoff_threshold": 1.0,
                "Vrk_invariant": True,
                "Vrk_isotropic": False,
                "backface_culling": True,
                "radii_backward_scaler": 10.0,
                "clip_pts_grad": 0.05,
            },
        },
        "model": {
            "type": "point",
            "model_kwargs": {
                "learn_points": True,
                "learn_normals": True,
                "learn_colors": True,
                "n_points_per_cloud": n_train_points,
            },
        },
        "training": {
            "out_dir": os.path.join(out, "exp"),
            "lambda_dr_rgb": 1.0,
            "lambda_dr_silhouette": 1.0,
            "lambda_dr_proj": 0.01,
            "lambda_dr_repel": 0.01,
            "batch_size": 4,
            "print_every": 10,
            "checkpoint_every": 50,
            "validate_every": 25,
            "visualize_every": -1,
            "steps_dss_backward_radii": 20,
        },
    }
    yaml_lite.dump(cfg, os.path.join(out, "config.yml"))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--points", type=int, default=1500)
    ap.add_argument("--n-train-points", type=int, default=1500)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--format", choices=["mvr", "dtu"], default="mvr",
                    help="dtu: also write IDR-style cameras.npz "
                         "(world_mat_i/scale_mat_i) and a type: DTU config")
    args = ap.parse_args(argv)
    make_tiny_dataset(args.out, args.views, args.image_size, args.points,
                      args.n_train_points, args.format, args.device)
    print(f"wrote {args.out}: {args.views} views @ {args.image_size}², "
          f"config.yml")


if __name__ == "__main__":
    main()
