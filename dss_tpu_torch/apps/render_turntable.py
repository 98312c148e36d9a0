"""Turntable rendering CLI: 360° orbit renders of a point cloud
(counterpart of dss_tpu/apps/render_turntable.py).

The cloud is centred and scaled into the unit ball; a PLY without normals
gets PCA normals (k = 8).  Each frame is one `render_single_view` on the
lean path (Vrk_isotropic, K = 5, backface culling) under one directional
light, composited over a white background and written as
frame_%03d.png with data/png.py.

    python3 -m dss_tpu_torch.apps.render_turntable --points shape.ply \\
        --out <dir> [--num-frames 36] [--image-size 256] [--device cpu]

It renders on the CUDA card unless `--device` says otherwise.  `--gif`
raises: the orbit GIF needs imageio, which the port does not use.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dss_tpu_torch.data.io import read_ply
from dss_tpu_torch.data.png import write_png
from dss_tpu_torch.geometry.cameras import (
    FoVPerspectiveCameras,
    look_at_view_transform,
)
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.lighting import DirectionalLights
from dss_tpu_torch.render.renderer import render_single_view
from dss_tpu_torch.utils.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Render a 360 turntable of a point cloud")
    parser.add_argument("--points", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--num-frames", type=int, default=36)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--elev", type=float, default=15.0)
    parser.add_argument("--dist", type=float, default=2.0)
    parser.add_argument("--gif", action="store_true",
                        help="not ported: the GIF needs imageio; raises")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    if args.gif:
        raise NotImplementedError(
            "--gif needs imageio, which dss_tpu_torch does not use; the "
            "frames are written as PNGs")
    device = resolve_device(args.device)

    ply = read_ply(args.points)
    pts = torch.as_tensor(ply.points, dtype=torch.float32, device=device)
    center = (pts.amax(0) + pts.amin(0)) / 2.0
    pts = pts - center
    pts = pts / torch.linalg.vector_norm(pts, dim=-1).max()
    p = pts.shape[0]
    mask = torch.ones((p,), dtype=torch.bool, device=device)
    with torch.no_grad():
        normals = (torch.as_tensor(ply.normals, dtype=torch.float32,
                                   device=device)
                   if ply.normals is not None
                   else estimate_normals(pts, mask, neighborhood_size=8))
    colors = (torch.as_tensor(ply.colors, dtype=torch.float32, device=device)
              if ply.colors is not None else torch.full_like(pts, 0.75))

    settings = RasterSettings(image_size=args.image_size, points_per_pixel=5,
                              Vrk_isotropic=True, backface_culling=True)
    lights = DirectionalLights.create(direction=(0.3, 1.0, -0.5),
                                      device=device)

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.num_frames):
        azim = 360.0 * i / args.num_frames
        r, t = look_at_view_transform(dist=args.dist, elev=args.elev,
                                      azim=azim)
        cam = FoVPerspectiveCameras.create(r, t, fov=60.0, device=device)
        with torch.no_grad():
            rgba, _, _ = render_single_view(pts, normals, colors, mask, cam,
                                            lights, settings)
        rgba = rgba.cpu().numpy()
        rgb = np.clip(rgba[..., :3], 0, 1)
        alpha = rgba[..., 3:4]
        frame = (255 * (rgb * alpha + (1 - alpha))).astype(np.uint8)
        write_png(os.path.join(args.out, "frame_%03d.png" % i), frame)
        print("frame %d/%d" % (i + 1, args.num_frames))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
