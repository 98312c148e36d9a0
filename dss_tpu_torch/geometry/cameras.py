"""FoV perspective cameras, row-vector convention (counterpart of
dss_tpu/geometry/cameras.py).

- Row-vector transforms: ``x_out = [x, 1] @ M`` with M (4, 4).
- World-to-view: ``x_view = x_world @ R + T`` (R columns are the camera axes).
- The camera looks down +Z; NDC has +X pointing LEFT and +Y pointing UP.
- ``transform_points_screen`` returns (ndc_x, ndc_y, view_z).

Every camera field carries a leading view axis N.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import eps_denom, tan_f32, to_homogen


@dataclasses.dataclass(frozen=True)
class FoVPerspectiveCameras:
    """Batch of N perspective cameras defined by a vertical FoV in degrees.

    R (N, 3, 3), T (N, 3), fov / znear / zfar / aspect_ratio (N,).  Frozen,
    as the JAX package's cameras are immutable: the projection matrix is
    built once per batch."""

    R: torch.Tensor
    T: torch.Tensor
    fov: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor
    aspect_ratio: torch.Tensor

    @classmethod
    def create(cls, R, T, fov=60.0, znear=0.1, zfar=100.0, aspect_ratio=1.0,
               device=None) -> "FoVPerspectiveCameras":
        """On the card unless `device` says otherwise (resolve_device)."""
        R = torch.as_tensor(R, dtype=torch.float32,
                            device=resolve_device(device))
        T = torch.as_tensor(T, dtype=torch.float32, device=R.device)
        if R.ndim == 2:
            R = R[None]
        if T.ndim == 1:
            T = T[None]
        n = R.shape[0]

        def bcast(v):
            v = torch.as_tensor(v, dtype=torch.float32, device=R.device)
            return torch.broadcast_to(torch.atleast_1d(v), (n,)).clone()

        return cls(R=R, T=T, fov=bcast(fov), znear=bcast(znear),
                   zfar=bcast(zfar), aspect_ratio=bcast(aspect_ratio))

    def __len__(self) -> int:
        return self.R.shape[0]

    def to(self, device) -> "FoVPerspectiveCameras":
        return FoVPerspectiveCameras(
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)}
        )

    # ---- matrices -------------------------------------------------------

    def world_to_view_matrix(self) -> torch.Tensor:
        """(N, 4, 4) row-vector world-to-view matrix [[R, 0], [T, 1]]."""
        n = self.R.shape[0]
        m = torch.zeros((n, 4, 4), dtype=torch.float32, device=self.R.device)
        m[:, :3, :3] = self.R
        m[:, 3, :3] = self.T
        m[:, 3, 3] = 1.0
        return m

    def projection_matrix(self) -> torch.Tensor:
        """(N, 4, 4) row-vector FoV perspective projection:
        [x y z 1] @ K = [s1·x, s2·y, f1·z + f2, z].  Shared by every call
        on this batch: do not write into it."""
        return self._projection

    @functools.cached_property
    def _projection(self) -> torch.Tensor:
        # Built once: tan_f32 is ~45 small ops, each a launch on the card,
        # and a train step projects through the same cameras several times.
        n = self.R.shape[0]
        # tan_f32, not torch.tan: the JAX package's value on every device
        tanhalf = tan_f32(torch.deg2rad(self.fov) / 2.0)
        s1 = 1.0 / (self.aspect_ratio * tanhalf)
        s2 = 1.0 / tanhalf
        zr = eps_denom(self.zfar - self.znear)
        f1 = self.zfar / zr
        f2 = -(self.zfar * self.znear) / zr
        k = torch.zeros((n, 4, 4), dtype=torch.float32, device=self.R.device)
        k[:, 0, 0] = s1
        k[:, 1, 1] = s2
        k[:, 2, 2] = f1
        k[:, 3, 2] = f2
        k[:, 2, 3] = 1.0
        return k

    def full_projection_matrix(self) -> torch.Tensor:
        """(N, 4, 4) world → NDC-homogeneous (row-vector): W2V @ K."""
        return self.world_to_view_matrix() @ self.projection_matrix()

    # ---- point transforms ----------------------------------------------

    def transform_points_world_to_view(self, points: torch.Tensor) -> torch.Tensor:
        """points (N, P, 3) or (P, 3) → view space (N, P, 3)."""
        if points.ndim == 2:
            points = points[None]
        return points @ self.R + self.T[:, None, :]

    def transform_points_screen(self, points: torch.Tensor) -> torch.Tensor:
        """points (N, P, 3) or (P, 3) → (N, P, 3) = (ndc_x, ndc_y, view_z)."""
        if points.ndim == 2:
            points = torch.broadcast_to(points[None], (len(self),) + points.shape)
        pts_view = self.transform_points_world_to_view(points)
        hom = to_homogen(points) @ self.full_projection_matrix()  # (N, P, 4)
        w = eps_denom(hom[..., 3:4])
        ndc_xy = hom[..., :2] / w
        return torch.cat([ndc_xy, pts_view[..., 2:3]], dim=-1)

    def camera_position(self) -> torch.Tensor:
        """(N, 3) camera centres in world space: −T @ Rᵀ."""
        return -torch.einsum("nj,nij->ni", self.T, self.R)

    def unproject_ndc_depth(self, ndc_xy: torch.Tensor,
                            depth: torch.Tensor) -> torch.Tensor:
        """Inverse of transform_points_screen: (N, P, 2) NDC xy and (N, P)
        view-space depth → (N, P, 3) world points.  ndc_x = s1·x/z and
        ndc_y = s2·y/z give x_view = ndc_x·z/s1 (s1, s2 the projection's
        diagonal, through tan_f32); then x_world = (x_view − T) @ Rᵀ."""
        k = self.projection_matrix()
        s1, s2 = k[:, 0, 0], k[:, 1, 1]
        x = ndc_xy[..., 0] * depth / s1[:, None]
        y = ndc_xy[..., 1] * depth / s2[:, None]
        view = torch.stack([x, y, depth], dim=-1)
        return torch.einsum("npj,nij->npi", view - self.T[:, None, :], self.R)


# ---- look-at construction ------------------------------------------------


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def look_at_rotation(camera_position, at=None, up=None) -> torch.Tensor:
    """(N, 3, 3) rotation with columns = camera axes: z from the camera
    toward `at`, x = up × z so +X is screen-left."""
    camera_position = torch.atleast_2d(
        torch.as_tensor(camera_position, dtype=torch.float32))
    n = camera_position.shape[0]
    dev = camera_position.device
    if at is None:
        at = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    at = torch.broadcast_to(
        torch.atleast_2d(torch.as_tensor(at, dtype=torch.float32)), (n, 3))
    up = torch.broadcast_to(
        torch.atleast_2d(torch.as_tensor(up, dtype=torch.float32)), (n, 3))

    z_axis = _norm(at - camera_position)
    x_axis = _norm(torch.linalg.cross(up, z_axis))
    # Degenerate case: up parallel to z → substitute an orthogonal x.
    bad = torch.linalg.vector_norm(x_axis, dim=-1, keepdim=True) < 0.5
    zz = torch.broadcast_to(torch.tensor([0.0, 0.0, 1.0], device=dev),
                            z_axis.shape)
    alt = _norm(torch.linalg.cross(zz, z_axis))
    x_axis = torch.where(bad, alt, x_axis)
    y_axis = _norm(torch.linalg.cross(z_axis, x_axis))
    return torch.stack([x_axis, y_axis, z_axis], dim=-1)  # columns


def camera_position_from_spherical_angles(distance, elevation, azimuth,
                                          degrees: bool = True) -> torch.Tensor:
    """(N, 3) positions; elevation/azimuth as in pytorch3d."""
    f = lambda v: torch.atleast_1d(torch.as_tensor(v, dtype=torch.float32))
    distance, elevation, azimuth = f(distance), f(elevation), f(azimuth)
    if degrees:
        elevation = torch.deg2rad(elevation)
        azimuth = torch.deg2rad(azimuth)
    x = distance * torch.cos(elevation) * torch.sin(azimuth)
    y = distance * torch.sin(elevation)
    z = distance * torch.cos(elevation) * torch.cos(azimuth)
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def look_at_view_transform(dist=1.0, elev=0.0, azim=0.0, at=None, up=None,
                           degrees: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (R (N, 3, 3), T (N, 3)) for world-to-view x @ R + T."""
    pos = camera_position_from_spherical_angles(dist, elev, azim, degrees)
    if at is not None:
        at = torch.atleast_2d(torch.as_tensor(at, dtype=torch.float32))
        pos = pos + at
    r = look_at_rotation(pos, at=at, up=up)
    t = -torch.einsum("ni,nij->nj", pos, r)
    return r, t


def sample_random_cameras(
    num_cams: int,
    min_dist: float,
    max_dist: float,
    at_jitter: float = 0.05,
    fov: float = 60.0,
    znear: float = 0.1,
    zfar: float = 100.0,
    sort_distances: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> FoVPerspectiveCameras:
    """Random look-at cameras: distance uniform in [min_dist, max_dist]
    (sorted descending), azimuth in [-180, 180), elevation in [-90, 90),
    look-at point jittered by ±at_jitter.  Draws from `generator` on the
    CPU (the JAX package's stream comes from a jax.random key and cannot
    be matched), then builds the cameras on `device`."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return lo + (hi - lo) * u

    dist = uniform((num_cams,), min_dist, max_dist)
    if sort_distances:
        dist = torch.sort(dist, descending=True).values
    azim = uniform((num_cams,), -180.0, 180.0)
    elev = uniform((num_cams,), -90.0, 90.0)
    at = uniform((num_cams, 3), -at_jitter, at_jitter)
    r, t = look_at_view_transform(dist, elev, azim, at=at)
    return FoVPerspectiveCameras.create(r, t, fov=fov, znear=znear, zfar=zfar,
                                        device=device)


def cameras_from_matrix(camera_mat, fov=60.0, znear=0.1, zfar=100.0,
                        device=None) -> FoVPerspectiveCameras:
    """Cameras from (N, 4, 4) row-major world-to-view matrices, as stored in
    data_dict.npz: R = m[:3, :3], T = m[3, :3]; a (4, 4) matrix is a batch
    of one."""
    camera_mat = torch.as_tensor(camera_mat, dtype=torch.float32,
                                 device=resolve_device(device))
    if camera_mat.ndim == 2:
        camera_mat = camera_mat[None]
    return FoVPerspectiveCameras.create(
        camera_mat[:, :3, :3], camera_mat[:, 3, :3], fov=fov, znear=znear,
        zfar=zfar, device=camera_mat.device)
