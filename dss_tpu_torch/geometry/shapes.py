"""Primitive shape generation: icosphere + mesh surface sampling.

Replaces pytorch3d's `ico_sphere` + `sample_points_from_meshes`, which the
reference uses to build the initial optimization cloud (config.py:177-183:
ico_sphere(level=4) scaled 0.5, sampled to n_points_per_cloud with normals).
Pure numpy — runs once at setup time.  A copy of dss_tpu/geometry/shapes.py:
importing any dss_tpu module imports jax, which the port does not need.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def ico_sphere(level: int = 0, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron on the sphere. Returns (verts (V,3), faces (F,3))."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)

    for _ in range(level):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def sample_points_from_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    rng: Optional[np.random.Generator] = None,
    return_normals: bool = True,
):
    """Area-weighted uniform surface sampling with per-sample face normals
    (pytorch3d sample_points_from_meshes semantics)."""
    rng = rng or np.random.default_rng(0)
    v = verts.astype(np.float64)
    tri = v[faces]  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    cross = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    prob = area / area.sum()
    fidx = rng.choice(len(faces), size=num_points, p=prob)
    u = rng.random(num_points)
    w = rng.random(num_points)
    flip = u + w > 1.0
    u = np.where(flip, 1.0 - u, u)
    w = np.where(flip, 1.0 - w, w)
    pts = tri[fidx, 0] + e1[fidx] * u[:, None] + e2[fidx] * w[:, None]
    if not return_normals:
        return pts.astype(np.float32)
    n = cross[fidx]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return pts.astype(np.float32), n.astype(np.float32)
