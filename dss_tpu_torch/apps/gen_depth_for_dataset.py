"""Backfill dense per-view depth maps for an existing MVR dataset
(counterpart of scripts/gen_depth_for_dataset.py).

Renders the GT geometry's nearest depth for the dataset's OWN cameras
(data_dict.npz camera_mat) and writes depth/%06d.npy, view-space depth with
zfar on the background: the files `create_mvr_data` writes at generation
time, for a dataset made before it wrote them (making the dataset again
would draw other cameras and orphan the checkpoints trained on it).  The
geometry is normalized and rendered by `create_mvr_data`'s own
`normalize_unit_sphere` and `gt_renderer`: a mesh through
`render/mesh_raster.py`'s z-buffer, a PLY without faces through the
fragment path of `render_single_view` (`lean_fragments=False`, cutoff 1,
backface culling: K5 once per view on the card).

    python3 -m dss_tpu_torch.apps.gen_depth_for_dataset --data <dataset> \\
        --mesh <gt>.ply [--device cpu]

It renders on the CUDA card unless `--device` says otherwise; the image
size is read from the first mask through data/png.py.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dss_tpu_torch.apps.create_mvr_data import (
    depth_map,
    gt_renderer,
    normalize_unit_sphere,
)
from dss_tpu_torch.data.io import read_ply
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.cameras import cameras_from_matrix
from dss_tpu_torch.utils.device import resolve_device


def main(argv=None) -> str:
    """Returns the depth directory."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cuda:0), "
                         "which must exist; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dd = np.load(os.path.join(args.data, "data_dict.npz"), allow_pickle=True)
    cp = dd["cameras_params"].item() if "cameras_params" in dd else {}
    cam_mat = np.asarray(dd["camera_mat"], np.float32)
    n = cam_mat.shape[0]
    zfar = float(cameras_from_matrix(cam_mat[:1], **cp, device=device).zfar[0])
    mask_dir = os.path.join(args.data, "mask")
    image_size = read_png(
        os.path.join(mask_dir, sorted(os.listdir(mask_dir))[0])).shape[0]

    mesh = read_ply(args.mesh)
    render, _ = gt_renderer(mesh, normalize_unit_sphere(mesh.points),
                            image_size, device)

    out_dir = os.path.join(args.data, "depth")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        cam_i = cameras_from_matrix(cam_mat[i:i + 1], **cp, device=device)
        with torch.no_grad():
            zbuf = render(cam_i, None)[1].cpu().numpy()
        np.save(os.path.join(out_dir, "%06d.npy" % i), depth_map(zbuf, zfar))
        if (i + 1) % 16 == 0:
            print("view %d/%d" % (i + 1, n), flush=True)
    print("wrote %d depth maps to %s" % (n, out_dir))
    return out_dir


if __name__ == "__main__":
    main()
