"""Surface reconstruction: point cloud → triangle mesh (counterpart of
dss_tpu/geometry/meshing.py).

The reference meshes through pymeshlab's screened Poisson, which neither
package has.  Two fields, contoured by marching tetrahedra (a 6-tet cube
split, with a small exact case table):

- an MLS signed distance of the oriented cloud (the local-plane field of
  the projection loss), sampled on a grid on the points' device in query
  chunks, each through the chunked kNN;
- a Poisson indicator (Kazhdan's formulation on a regular grid, solved
  spectrally), default of `models.generator.Generator`.  Its trilinear
  splat (`index_put_` with accumulation) and float64 FFT solve run on the
  points' device too: at 96³–128³ they are the bulk of the work, and the
  card computes both; only the contouring is host numpy.

Marching tetrahedra is a numpy copy of the JAX package's host function,
which this package may not import.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.geometry.normals import jax_nanmedian
from dss_tpu_torch.utils.mathutil import eps_denom, normalize


def mls_signed_distance(
    queries: torch.Tensor,
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    k: int = 8,
    bandwidth_scale: float = 2.0,
) -> torch.Tensor:
    """Signed distance of (Q, 3) queries to the MLS surface of an oriented
    cloud: f(q) = Σ w nᵢ·(q − xᵢ) / Σ w with Gaussian weights over the kNN."""
    d2, idx = knn_points(queries, points, None, mask, k=k)
    valid = (idx >= 0).to(queries.dtype)
    d2 = torch.where(valid > 0, d2, 0.0)
    nn = masked_gather(points, idx)
    nnn = masked_gather(normalize(normals), idx)
    # the bandwidth from the local spacing (the nearest neighbour's distance)
    h2 = eps_denom(d2[:, :1]) * bandwidth_scale
    w = torch.exp(-d2 / h2) * valid
    fx = torch.sum((queries[:, None, :] - nn) * nnn, dim=-1)
    f = torch.sum(w * fx, dim=-1) / eps_denom(torch.sum(w, dim=-1))
    # far from the cloud: the plain nearest distance, so empty space stays
    # empty
    near = torch.sqrt(torch.clamp(d2[:, 0], min=0.0))
    return torch.where(near > 3.0 * torch.sqrt(h2[:, 0]), near, f)


def sdf_grid_points(lo, hi, resolution: int, device) -> torch.Tensor:
    """(R³, 3) nodes of the regular grid over the [lo, hi] box, x-major.
    torch.linspace and jnp.linspace round some nodes 1 ulp apart."""
    axes = [torch.linspace(float(lo[i]), float(hi[i]), resolution,
                           device=device) for i in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def sample_sdf_grid(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor],
    lo: torch.Tensor,
    hi: torch.Tensor,
    resolution: int = 64,
    k: int = 8,
    chunk: int = 16384,
) -> torch.Tensor:
    """(R, R, R) samples of the MLS field over the [lo, hi] box, `chunk`
    grid points at a time (never the whole grid's distance matrix)."""
    r = resolution
    grid = sdf_grid_points(lo, hi, r, points.device)
    f = torch.cat([mls_signed_distance(grid[s:s + chunk], points, normals, mask,
                                       k=k)
                   for s in range(0, grid.shape[0], chunk)])
    return f.reshape(r, r, r)


# 6-tetrahedra decomposition of the unit cube around its 0–7 diagonal
# (corner ids 0..7, bit i = axis i).
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]]
)
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]]
)


def marching_tetrahedra(
    sdf: np.ndarray, lo: np.ndarray, hi: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Contour an (R, R, R) scalar grid at `level` by marching tetrahedra;
    "< level" is inside.  Host numpy.  Returns (verts (V, 3) float32,
    faces (F, 3) int32)."""
    sdf = np.asarray(sdf)
    r = sdf.shape[0]
    spacing = (np.asarray(hi) - np.asarray(lo)) / (r - 1)

    # corner values and positions of every cube: (Ncube, 8)
    base = np.stack(
        np.meshgrid(np.arange(r - 1), np.arange(r - 1), np.arange(r - 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    corner_idx = base[:, None, :] + _CUBE_CORNERS[None, :, :]  # (N, 8, 3)
    vals = sdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    pos = corner_idx * spacing + np.asarray(lo)

    tris = []
    for tet in _TETS:
        v = vals[:, tet]  # (N, 4)
        p = pos[:, tet]  # (N, 4, 3)
        inside = v < level  # (N, 4)
        code = (
            inside[:, 0].astype(np.int32)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )

        def interp(sel, a, b):
            va, vb = v[sel, a], v[sel, b]
            t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return p[sel, a] * (1 - t) + p[sel, b] * t

        # one corner inside (or all but one) → 1 triangle; two inside → 2.
        # Edge orders give a consistent winding (outward = toward positive).
        single = {
            1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)),
            8: (3, (0, 2, 1)),
            14: (0, (1, 3, 2)), 13: (1, (0, 2, 3)), 11: (2, (0, 3, 1)),
            7: (3, (0, 1, 2)),
        }
        for c, (apex, others) in single.items():
            sel = np.nonzero(code == c)[0]
            if len(sel) == 0:
                continue
            e0 = interp(sel, apex, others[0])
            e1 = interp(sel, apex, others[1])
            e2 = interp(sel, apex, others[2])
            tris.append(np.stack([e0, e1, e2], axis=1))

        double = {
            3: ((0, 1), (2, 3)), 5: ((0, 2), (3, 1)), 9: ((0, 3), (1, 2)),
            6: ((1, 2), (0, 3)), 10: ((1, 3), (2, 0)), 12: ((2, 3), (0, 1)),
        }
        for c, ((a, b), (x, y)) in double.items():
            sel = np.nonzero(code == c)[0]
            if len(sel) == 0:
                continue
            ax = interp(sel, a, x)
            ay = interp(sel, a, y)
            bx = interp(sel, b, x)
            by = interp(sel, b, y)
            tris.append(np.stack([ax, ay, bx], axis=1))
            tris.append(np.stack([bx, ay, by], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri_pts = np.concatenate(tris, axis=0)  # (F, 3, 3)

    # weld duplicate vertices
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat / (spacing.min() * 1e-4)).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[uniq_idx]
    # reshape, not inv's own shape: np.unique(axis=0)'s inverse is 1-D in
    # some numpy 2.0.x releases and (N, 1) in others
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


def _active(points: torch.Tensor, normals: torch.Tensor,
            mask: Optional[torch.Tensor]):
    if mask is None:
        return points, normals
    return points[mask], normals[mask]


def generate_mesh_from_points(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    resolution: int = 64,
    k: int = 8,
    padding: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud and normals → mesh through the MLS field and marching
    tetrahedra.  points, normals (P, 3) and mask (P,) on one device."""
    pts = points.to(torch.float32)
    valid, _ = _active(pts, normals, mask)
    lo = torch.amin(valid, dim=0) - padding
    hi = torch.amax(valid, dim=0) + padding
    sdf = sample_sdf_grid(pts, normals.to(torch.float32), mask, lo, hi,
                          resolution=resolution, k=k)
    return marching_tetrahedra(sdf.cpu().numpy(), lo.cpu().numpy(),
                               hi.cpu().numpy(), 0.0)


def _grid_index(p: torch.Tensor, r: int) -> Tuple[torch.Tensor, ...]:
    """Nearest grid node of grid coordinates p (numpy's round: half to
    even), clamped into the grid."""
    i = torch.clamp(torch.round(p).to(torch.int64), 0, r - 1)
    return i[:, 0], i[:, 1], i[:, 2]


def poisson_indicator_grid(
    points: torch.Tensor,
    normals: torch.Tensor,
    lo,
    hi,
    resolution: int = 128,
    smooth_cells: float = 1.5,
) -> torch.Tensor:
    """Poisson surface reconstruction on a regular grid (Kazhdan's original
    formulation: the indicator's gradient equals the smoothed oriented-
    normal field, so ∇²χ = ∇·V is solved spectrally by FFT — the
    regular-grid variant of the reference's screened-Poisson step), in
    float64 on the points' device.

    Returns an (R, R, R) float64 field, higher inside the surface."""
    dev = points.device
    f64 = torch.float64
    r = resolution
    lo = np.asarray(torch.as_tensor(lo).cpu(), np.float64)
    hi = np.asarray(torch.as_tensor(hi).cpu(), np.float64)
    spacing = (hi - lo) / (r - 1)

    # trilinear splat of unit normals into the vector grid V
    p = (points.to(f64) - torch.as_tensor(lo, device=dev)) / torch.as_tensor(
        spacing, device=dev)  # grid coordinates
    n = normals.to(f64)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    i0 = torch.clamp(torch.floor(p).to(torch.int64), 0, r - 2)
    f = torch.clamp(p - i0, 0.0, 1.0)
    v = torch.zeros((r, r, r, 3), dtype=f64, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                v.index_put_((i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz),
                             w[:, None] * n, accumulate=True)

    # spectral solve: χ̂ = i k·V̂ / −|k|², with Gaussian pre-smoothing (the
    # splat is a sum of deltas; the smoothing stands in for the Poisson
    # octree's B-spline basis)
    k = [torch.fft.fftfreq(r, d=float(spacing[a]), dtype=f64, device=dev)
         * 2.0 * np.pi for a in range(3)]
    kx, ky, kz = torch.meshgrid(*k, indexing="ij")
    k2 = kx * kx + ky * ky + kz * kz
    sig = smooth_cells * spacing.mean()
    gauss = torch.exp(-0.5 * sig * sig * k2)
    vh = [torch.fft.fftn(v[..., a]) * gauss for a in range(3)]
    div_h = 1j * (kx * vh[0] + ky * vh[1] + kz * vh[2])
    chi_h = torch.where(k2 > 0, div_h / torch.where(k2 > 0, -k2, 1.0), 0.0)
    chi = torch.fft.ifftn(chi_h).real

    # outward normals make ∇χ ≈ −V; the points lie on the surface, where
    # the inside's values are the more extreme: fix the sign so that the
    # field is higher inside
    at_pts = chi[_grid_index(p, r)]
    return torch.where(torch.mean(at_pts) < torch.mean(chi), -chi, chi)


def poisson_mesh_from_points(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    resolution: int = 128,
    padding: float = 0.15,
    smooth_cells: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud and outward normals → mesh through the FFT Poisson
    indicator and marching tetrahedra, on a cube padded by `padding` of the
    cloud's extent.  The iso level is the median (numpy's rule) of the
    indicator at the input points, which lie on the surface."""
    pts, nrm = _active(points.to(torch.float32), normals.to(torch.float32),
                       mask)
    mn, mx = torch.amin(pts, dim=0), torch.amax(pts, dim=0)
    lo = mn - padding * torch.amax(mx - mn)
    hi = mx + padding * torch.amax(mx - mn)
    # cubic voxels: the box grown to a cube keeps the wavenumbers isotropic
    size = torch.amax(hi - lo)
    center = (hi + lo) / 2
    lo, hi = center - size / 2, center + size / 2

    chi = poisson_indicator_grid(pts, nrm, lo, hi, resolution=resolution,
                                 smooth_cells=smooth_cells)
    r = resolution
    spacing = (hi - lo) / (r - 1)
    iso = jax_nanmedian(chi[_grid_index((pts - lo) / spacing, r)])
    # marching_tetrahedra's inside is "< level"; χ is higher inside
    return marching_tetrahedra(-chi.cpu().numpy(), lo.cpu().numpy(),
                               hi.cpu().numpy(), level=-float(iso))
