"""Minimal flat-shaded mesh rasterizer for ground-truth data generation
(counterpart of dss_tpu/render/mesh_raster.py).

A brute-force z-buffer: every pixel of a block of rows is tested against
every face with barycentric inside tests, and the nearest face in front
of the camera wins.  The JAX package writes it in XLA, not Pallas, so
torch ops are its port.  Per-face flat shading uses the splat renderer's
multi-light model, and pixel centres follow the splat rasterizer's NDC
rule.  An offline tool: simple rather than fast (≤ 50k faces at ≤ 512²).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.render.lighting import Lights, apply_lighting
from dss_tpu_torch.render.rasterizer import pixel_ndc_coords
from dss_tpu_torch.utils.mathutil import eps_denom, normalize


def rasterize_mesh(
    verts: torch.Tensor,
    faces: torch.Tensor,
    camera: FoVPerspectiveCameras,
    image_size: int,
    row_chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Z-buffer rasterize one view: verts (Nv, 3), faces (F, 3), a batch of
    one camera.  The rows go in blocks of `row_chunk` (1 when it does not
    divide the image), so each temporary holds row_chunk × S × F floats.
    Ties in depth go to the lowest face index, as `jnp.argmin` takes them.

    Returns (face_idx (S, S) int32, −1 empty; zbuf (S, S) view-space depth,
    −1 empty; bary (S, S, 3), 0 empty)."""
    s = image_size
    pts_screen = camera.transform_points_screen(verts)[0]  # ndc x, y, view z
    tri = pts_screen[faces.to(torch.int64)]  # (F, 3, 3)
    ax, ay, az = tri[:, 0, 0], tri[:, 0, 1], tri[:, 0, 2]
    bx, by, bz = tri[:, 1, 0], tri[:, 1, 1], tri[:, 1, 2]
    cx, cy, cz = tri[:, 2, 0], tri[:, 2, 1], tri[:, 2, 2]
    # signed area, the barycentric denominator
    denom = eps_denom((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))
    front_ok = (az > 0) & (bz > 0) & (cz > 0)

    coords = pixel_ndc_coords(s, verts.device)
    if s % row_chunk != 0:
        row_chunk = 1
    px = coords[None, :, None]  # (1, S, 1)
    fids, zbufs, barys = [], [], []
    for r0 in range(0, s, row_chunk):
        py = coords[r0:r0 + row_chunk, None, None]  # (R, 1, 1)
        w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) / denom
        w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & front_ok
        z = torch.where(inside, w0 * az + w1 * bz + w2 * cz, torch.inf)
        zmin, fid = torch.min(z, dim=-1)  # first index on ties
        hit = torch.isfinite(zmin)
        at = lambda w: torch.gather(w, -1, fid[..., None])[..., 0]
        bary = torch.stack([at(w0), at(w1), at(w2)], dim=-1)
        fids.append(torch.where(hit, fid, -1).to(torch.int32))
        zbufs.append(torch.where(hit, zmin, -1.0))
        barys.append(torch.where(hit[..., None], bary, 0.0))
    return torch.cat(fids), torch.cat(zbufs), torch.cat(barys)


def render_mesh_flat(
    verts: torch.Tensor,
    faces: torch.Tensor,
    camera: FoVPerspectiveCameras,
    lights: Optional[Lights],
    image_size: int,
    base_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    shininess: float = 64.0,
    return_zbuf: bool = False,
):
    """Flat-shaded RGBA render of one view (a HardFlatShader): one colour
    per face from its centroid and its normal, turned toward the camera,
    under one view's lights (None: the base colour); white background,
    alpha 1 on the mesh.

    Returns rgba (S, S, 4), and with return_zbuf also the view-space depth
    (S, S), −1 where empty."""
    fid, zbuf, _ = rasterize_mesh(verts, faces, camera, image_size)
    tri = verts[faces.to(torch.int64)]
    centroids = torch.mean(tri, dim=1)
    fnormals = normalize(torch.linalg.cross(tri[:, 1] - tri[:, 0],
                                            tri[:, 2] - tri[:, 0]))
    campos = camera.camera_position()  # (1, 3)
    to_cam = normalize(campos - centroids)
    sgn = torch.where(torch.sum(fnormals * to_cam, dim=-1, keepdim=True) < 0,
                      -1.0, 1.0)
    fnormals = fnormals * sgn

    base = torch.broadcast_to(
        torch.tensor(base_color, dtype=torch.float32, device=verts.device),
        centroids.shape)
    if lights is not None:
        ambient, diffuse, specular = apply_lighting(
            centroids, fnormals, lights, campos, shininess)
        face_rgb = base * (ambient[0][None, :] + diffuse[0]) + specular[0]
    else:
        face_rgb = base

    hit = fid >= 0
    rgb = torch.where(hit[..., None],
                      face_rgb[torch.clamp(fid, min=0).to(torch.int64)], 1.0)
    rgba = torch.cat([torch.clamp(rgb, 0.0, 1.0),
                      hit[..., None].to(torch.float32)], dim=-1)
    if return_zbuf:
        return rgba, zbuf
    return rgba
