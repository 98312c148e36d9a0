"""Data-generation CLI: render ground-truth multi-view data from a mesh or
a point cloud (counterpart of dss_tpu/apps/create_mvr_data.py).

The input is normalized into the unit sphere and seen by random look-at
cameras (distance 1.2–2.2, znear 0.1), each view under a tri-colour RGB
light rig or one random light.  A mesh is flat-shaded through
`render/mesh_raster.py`; a PLY without faces is splat-rendered with full
fragments (`render_single_view`, K5 on the card) with vrk_h from
compute_vrk_h_isotropic computed once.  Per view it writes image/%06d.png
and mask/%06d.png (data/png.py) and depth/%06d.npy (view-space depth, zfar
on the background), then data_dict.npz (camera_mat, lights_%d, the GT
cloud) and cameras.npz, with the JAX CLI's keys, dtypes and shapes.

    python3 -m dss_tpu_torch.apps.create_mvr_data --mesh bunny.ply \\
        --out <dir> [--num-cameras 16] [--image-size 256] \\
        [--tri-color-lights] [--device cpu]

It renders on the CUDA card unless `--device` says otherwise.  The cameras
come from `sample_random_cameras` with a torch.Generator seeded with
`--seed`, whose stream cannot match jax.random: the same seed gives other
cameras than the JAX CLI.  Every draw after the cameras (the light rigs,
the GT cloud's samples) takes the JAX CLI's numpy calls in its order.
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
    sample_random_cameras,
)
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.geometry.shapes import sample_points_from_mesh
from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_isotropic
from dss_tpu_torch.render.lighting import DirectionalLights, PointLights
from dss_tpu_torch.render.mesh_raster import render_mesh_flat
from dss_tpu_torch.render.renderer import render_single_view
from dss_tpu_torch.utils.device import resolve_device


def tri_color_light_rig(cam_pos: np.ndarray, rng: np.random.Generator,
                        point_lights: bool = True, has_specular: bool = False):
    """Three RGB lights on the half dome, rotated into a random frame around
    the camera axis (reference common.py:47-89).  Returns dict of (L, 3)."""
    elev = np.deg2rad(np.array([30.0, 30.0, 30.0]))
    azim = np.deg2rad(np.array([-60.0, 60.0, 180.0]))
    dirs = np.stack(
        [np.cos(elev) * np.sin(azim), np.sin(elev), np.cos(elev) * np.cos(azim)],
        axis=-1,
    )
    # random frame with up = camera direction
    up = cam_pos / max(np.linalg.norm(cam_pos), 1e-9)
    at = np.cross(cam_pos, rng.standard_normal(3))
    at /= max(np.linalg.norm(at), 1e-9)
    z = at
    x = np.cross(up, z)
    x /= max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    frame = np.stack([x, y, z], axis=0)  # rows
    dirs = dirs @ frame
    diffuse = np.array([[0.0, 0.0, 0.8], [0.0, 0.8, 0.0], [0.8, 0.0, 0.0]])
    if has_specular:
        specular = 0.15 * diffuse
        diffuse = diffuse * 0.85
    else:
        specular = np.zeros_like(diffuse)
    out = {
        "ambient_color": np.tile([[0.2, 0.2, 0.2]], (3, 1)).astype(np.float32),
        "diffuse_color": diffuse.astype(np.float32),
        "specular_color": specular.astype(np.float32),
    }
    if point_lights:
        out["location"] = (dirs * 5.0).astype(np.float32)
    else:
        out["direction"] = dirs.astype(np.float32)
    return out


def random_light_rig(cam_to_world, rng: np.random.Generator,
                     point_lights: bool = True, has_specular: bool = False):
    """One random light per view, direction drawn in camera space and
    transformed to world (reference common.py:91-121)."""
    elev = np.deg2rad(rng.integers(10, 90))
    azim = np.deg2rad(rng.integers(0, 360))
    d = np.array(
        [np.cos(elev) * np.sin(azim), np.sin(elev), np.cos(elev) * np.cos(azim)]
    )
    d = d @ cam_to_world[:3, :3]
    diffuse = np.array([[0.2, 0.2, 0.2]])
    if has_specular:
        specular = 0.15 * diffuse
        diffuse = diffuse * 0.85
    else:
        specular = np.zeros_like(diffuse)
    out = {
        "ambient_color": np.array([[0.6, 0.6, 0.6]], np.float32),
        "diffuse_color": diffuse.astype(np.float32),
        "specular_color": specular.astype(np.float32),
    }
    if point_lights:
        out["location"] = (d[None] * 5.0).astype(np.float32)
    else:
        out["direction"] = d[None].astype(np.float32)
    return out


def _lights(rig: dict, device):
    """One view's lights (a batch of one view) from a rig of (L, 3)
    arrays."""
    colors = {k: rig[k] for k in ("ambient_color", "diffuse_color",
                                  "specular_color")}
    if "location" in rig:
        return PointLights.create(**colors, location=rig["location"],
                                  device=device)
    return DirectionalLights.create(**colors, direction=rig["direction"],
                                    device=device)


def normalize_unit_sphere(points: np.ndarray) -> np.ndarray:
    """float32 points centred on their bounding box's centre and scaled so
    the farthest lies on the unit sphere (reference
    create_mvr_data_from_mesh.py:122-126)."""
    verts = points.astype(np.float64)
    verts = verts - (verts.max(0) + verts.min(0)) / 2.0
    return (verts / np.linalg.norm(verts, axis=-1).max()).astype(np.float32)


def gt_renderer(mesh, verts: np.ndarray, image_size: int, device):
    """The GT render of `mesh` (a PlyData) at its normalized vertices:
    (render, cloud_normals), render(cam, lights) → (rgba (S, S, 4), zbuf
    (S, S), 0 where nothing was hit) for one view.  A mesh is flat-shaded
    through render/mesh_raster.py.  A PLY without faces is splat-rendered
    with full fragments (K5 on the card: the depth product reads the
    nearest zbuf), with the normals it carries or estimates from 8
    neighbours (returned as cloud_normals; None for a mesh), its colours
    or 0.8 grey, and vrk_h computed once for every view."""
    verts_t = torch.as_tensor(verts, device=device)
    if mesh.faces is not None:
        faces_t = torch.as_tensor(mesh.faces, device=device)

        def render_mesh(cam, lights):
            return render_mesh_flat(verts_t, faces_t, cam, lights, image_size,
                                    return_zbuf=True)
        return render_mesh, None

    cloud_mask = torch.ones((verts_t.shape[0],), dtype=torch.bool,
                            device=device)
    with torch.no_grad():
        normals = (torch.as_tensor(mesh.normals, dtype=torch.float32,
                                   device=device)
                   if mesh.normals is not None
                   else estimate_normals(verts_t, cloud_mask,
                                         neighborhood_size=8,
                                         reference_normals=verts_t))
        vrk_h = compute_vrk_h_isotropic(verts_t, cloud_mask)
    colors = (torch.as_tensor(mesh.colors, dtype=torch.float32, device=device)
              if mesh.colors is not None else torch.full_like(verts_t, 0.8))
    st = RasterSettings(
        image_size=image_size, points_per_pixel=5, cutoff_threshold=1.0,
        Vrk_isotropic=True, backface_culling=True, lean_fragments=False,
    )

    def render_cloud(cam, lights):
        rgba, frags, _ = render_single_view(verts_t, normals, colors,
                                            cloud_mask, cam, lights, st,
                                            vrk_h=vrk_h)
        return rgba, frags.zbuf[..., 0]
    return render_cloud, normals


def depth_map(zbuf: np.ndarray, zfar: float) -> np.ndarray:
    """Dense float32 depth, zfar on the background (the reference writes
    torch.where(mask, zbuf, zfar), create_mvr_data_from_mesh.py:216-222)."""
    return np.where(zbuf > 0.0, zbuf, np.float32(zfar)).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Render GT multi-view data from a mesh")
    parser.add_argument("--mesh", required=True, help="input mesh .ply")
    parser.add_argument("--out", required=True, help="output dataset dir")
    parser.add_argument("--num-cameras", type=int, default=16)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--min-dist", type=float, default=1.2)
    parser.add_argument("--max-dist", type=float, default=2.2)
    parser.add_argument("--fov", type=float, default=60.0)
    parser.add_argument("--znear", type=float, default=0.1)
    parser.add_argument("--zfar", type=float, default=100.0)
    parser.add_argument("--n-points", type=int, default=20000,
                        help="GT cloud samples")
    parser.add_argument("--tri-color-lights", action="store_true")
    parser.add_argument("--point-lights", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    mesh = read_ply(args.mesh)
    verts = normalize_unit_sphere(mesh.points)

    cams = sample_random_cameras(
        args.num_cameras, args.min_dist, args.max_dist, fov=args.fov,
        znear=args.znear, zfar=args.zfar,
        generator=torch.Generator().manual_seed(args.seed), device=device,
    )
    cam_pos = cams.camera_position().cpu().numpy()

    for sub in ("image", "mask", "depth"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)

    data = {}
    m44 = np.zeros((args.num_cameras, 4, 4), np.float32)
    m44[:, :3, :3] = cams.R.cpu().numpy()
    m44[:, 3, :3] = cams.T.cpu().numpy()
    m44[:, 3, 3] = 1.0

    render, cloud_normals = gt_renderer(mesh, verts, args.image_size,
                                        device)

    lights_type = "PointLights" if args.point_lights else "DirectionalLights"
    for i in range(args.num_cameras):
        if args.tri_color_lights:
            rig = tri_color_light_rig(cam_pos[i], rng, args.point_lights)
        else:
            rig = random_light_rig(m44[i], rng, args.point_lights)
        with torch.no_grad():
            cam = FoVPerspectiveCameras.create(
                cams.R[i:i + 1], cams.T[i:i + 1], fov=args.fov,
                znear=args.znear, zfar=args.zfar, device=device)
            rgba, zbuf = render(cam, _lights(rig, device))
        rgba, zbuf = rgba.cpu().numpy(), zbuf.cpu().numpy()
        write_png(os.path.join(args.out, "image", "%06d.png" % i),
                  (np.clip(rgba[..., :3], 0, 1) * 255).astype(np.uint8))
        write_png(os.path.join(args.out, "mask", "%06d.png" % i),
                  (rgba[..., 3] * 255).astype(np.uint8))
        np.save(os.path.join(args.out, "depth", "%06d.npy" % i),
                depth_map(zbuf, args.zfar))
        data["lights_%d" % i] = {k: v[None] for k, v in rig.items()}
        print("view %d/%d" % (i + 1, args.num_cameras))

    if mesh.faces is None:
        sel = rng.choice(len(verts), size=min(args.n_points, len(verts)),
                         replace=False)
        pts = verts[sel]
        normals = (mesh.normals[sel].astype(np.float32)
                   if mesh.normals is not None
                   else cloud_normals.cpu().numpy()[sel])
    else:
        pts, normals = sample_points_from_mesh(verts, mesh.faces,
                                               args.n_points, rng=rng)
    data.update(
        camera_mat=m44,
        points=pts,
        normals=normals,
        colors=np.ones_like(pts),
        cameras_type="FoVPerspectiveCameras",
        cameras_params={"fov": args.fov, "znear": args.znear,
                        "zfar": args.zfar},
        lights_type=lights_type,
    )
    np.savez(os.path.join(args.out, "data_dict.npz"), **data)
    np.savez(os.path.join(args.out, "cameras.npz"),
             **{"world_mat_%d" % i: m44[i] for i in range(args.num_cameras)})
    print("wrote", args.out)


if __name__ == "__main__":
    main()
