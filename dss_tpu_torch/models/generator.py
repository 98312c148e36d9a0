"""Artifacts of a trained point model: meshes, point clouds and rendered
image sets (counterpart of dss_tpu/models/generator.py).

Reference: DSS/models/point_modeling.py `Generator` — generate_mesh
(pymeshlab's screened Poisson there; here the FFT-grid Poisson
reconstruction by default, MLS with marching tetrahedra as the
alternative, see `geometry.meshing`), generate_pointclouds with a
colour-mapped feature, and generate_images, which writes PNGs through
`data/png.py`.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.data.png import write_png
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.meshing import (
    generate_mesh_from_points,
    poisson_mesh_from_points,
)
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams, render_model
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.utils.mathutil import normalize


class Generator:
    def __init__(self, settings: RasterSettings, mesh_resolution: int = 96,
                 mesh_method: str = "poisson"):
        self.settings = settings
        self.mesh_resolution = mesh_resolution
        self.mesh_method = mesh_method  # "poisson" (the default) | "mls"

    def generate_mesh(
        self, params: PointModelParams, filters: Optional[PointFilters] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Point cloud → triangle mesh (verts (V, 3), faces (F, 3)): the FFT
        Poisson reconstruction at resolution max(mesh_resolution, 96), or
        the MLS field at mesh_resolution."""
        mask = None if filters is None else filters.activation
        points = params.points.detach()
        normals = normalize(params.normals.detach())
        if self.mesh_method == "poisson":
            return poisson_mesh_from_points(
                points, normals, mask=mask,
                resolution=max(self.mesh_resolution, 96))
        return generate_mesh_from_points(points, normals, mask=mask,
                                         resolution=self.mesh_resolution)

    def generate_pointclouds(
        self,
        params: PointModelParams,
        filters: Optional[PointFilters],
        path: str,
        colormap_by: Optional[str] = None,
    ) -> str:
        """Write the active cloud as PLY, optionally colour-mapping a
        scalar per-point feature ("height")."""
        pts = params.points.detach().cpu().numpy()
        active = (np.ones(pts.shape[0], bool) if filters is None
                  else filters.activation.cpu().numpy())
        pts = pts[active]
        normals = normalize(params.normals.detach()).cpu().numpy()[active]
        colors = np.clip(params.colors.detach().cpu().numpy(), 0, 1)[active]
        if colormap_by == "height":
            h = (pts[:, 1] - pts[:, 1].min()) / max(np.ptp(pts[:, 1]), 1e-9)
            colors = np.stack([h, 0.4 * np.ones_like(h), 1.0 - h], axis=-1)
        save_ply(path, pts, normals=normals, colors=colors)
        return path

    def generate_images(
        self,
        params: PointModelParams,
        filters: PointFilters,
        cameras: FoVPerspectiveCameras,
        lights,
        out_dir: str,
        prefix: str = "render",
    ) -> list:
        """Render every view (one `render_model` call) and write each as a
        PNG composited over white; returns the paths."""
        os.makedirs(out_dir, exist_ok=True)
        rgba = render_model(params, filters, cameras, lights,
                            self.settings).cpu().numpy()
        paths = []
        for i in range(rgba.shape[0]):
            rgb = np.clip(rgba[i, ..., :3], 0, 1)
            a = rgba[i, ..., 3:4]
            img = (255 * (rgb * a + (1 - a))).astype(np.uint8)
            path = os.path.join(out_dir, f"{prefix}_{i:03d}.png")
            write_png(path, img)
            paths.append(path)
        return paths

    def generate_mesh_ply(self, params, filters, path: str) -> str:
        verts, faces = self.generate_mesh(params, filters)
        save_ply(path, verts, faces=faces)
        return path
