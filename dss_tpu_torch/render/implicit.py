"""Implicit-surface (SDF) ray rendering: camera rays, ray/sphere and
ray/box intersections, sphere tracing, shaded RGBA (counterpart of
dss_tpu/render/implicit.py).

Reference capability: DSS/utils/__init__.py ray helpers (343-486) feeding
the implicit-surface eval path (`Generator.raytrace_images`).  As in the
JAX package: rays under the splat NDC convention, a bounding-sphere clip,
a fixed number of sphere-tracing steps, normals from the SDF's gradient.

The march is a Python loop of `n_steps` SDF calls; it records autograd
only when the caller has grad enabled.  At 512² and a full-width SDF,
recorded steps do not fit a card, so a caller that wants only the image
calls `render_sdf` under `torch.no_grad()`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.render.lighting import Lights, shade_points
from dss_tpu_torch.render.rasterizer import pixel_ndc_coords
from dss_tpu_torch.utils.mathutil import jax_abs, normalize, tan_f32

SdfFn = Callable[[torch.Tensor], torch.Tensor]


def camera_rays(camera: FoVPerspectiveCameras,
                image_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world rays of the first camera of the batch (+X left, +Y
    up, pixel centres (2i+1)/S − 1).  Returns (origins (S, S, 3), unit
    dirs (S, S, 3))."""
    s = image_size
    dev = camera.R.device
    coord = pixel_ndc_coords(s, dev)
    # tan_f32, not torch.tan: the camera's projection takes the same value
    tanhalf = tan_f32(torch.deg2rad(camera.fov[0]) / 2.0)
    # view-space direction for NDC (x, y) at depth 1, inverting the FoV
    # projection: ndc_x = x_v / (z · aspect · tan)
    xv = coord[None, :] * tanhalf * camera.aspect_ratio[0]
    yv = coord[:, None] * tanhalf
    d_view = torch.stack([torch.broadcast_to(xv, (s, s)),
                          torch.broadcast_to(yv, (s, s)),
                          torch.ones((s, s), device=dev)], dim=-1)
    # view → world for directions: d_view @ R⁻¹ = d_view @ Rᵀ
    d_world = normalize(d_view @ camera.R[0].T)
    origin = camera.camera_position()[0]
    return torch.broadcast_to(origin, (s, s, 3)), d_world


def ray_sphere_intersect(origins: torch.Tensor, dirs: torch.Tensor,
                         center: torch.Tensor, radius: float):
    """(t_near, t_far, hit) of rays with a sphere."""
    oc = origins - center
    b = torch.sum(oc * dirs, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return -b - sq, -b + sq, disc >= 0


def ray_box_intersect(origins: torch.Tensor, dirs: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor):
    """Slab test: (t_near, t_far, hit) of rays with an axis-aligned box."""
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmin, tmax, tmax >= torch.clamp(tmin, min=0.0)


def sphere_trace(sdf_fn: SdfFn, origins: torch.Tensor, dirs: torch.Tensor,
                 t_near: torch.Tensor, t_far: torch.Tensor, n_steps: int = 64,
                 eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration sphere tracing; sdf_fn maps (N, 3) → (N,).  A ray
    stops once |f| < eps or t > t_far; it hits if |f| < 10·eps and
    t ≤ t_far after the last step.  Returns (t (...), hit (...) bool)."""
    shape = t_near.shape
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    t = torch.clamp(t_near.reshape(-1), min=0.0)
    t_far_f = t_far.reshape(-1)
    done = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for _ in range(n_steps):
        f = sdf_fn(o + t[:, None] * d)
        done = done | (torch.abs(f) < eps) | (t > t_far_f)
        t = torch.where(done, t, t + f)
    hit = (torch.abs(sdf_fn(o + t[:, None] * d)) < 10 * eps) & (t <= t_far_f)
    return t.reshape(shape), hit.reshape(shape)


def sdf_normals(sdf_fn: SdfFn, points: torch.Tensor) -> torch.Tensor:
    """Unit SDF gradients at (N, 3) points.  With grad enabled the gradient
    keeps its graph (`create_graph`), and when the points themselves
    require grad (the traced hit points of `render_sdf`) it is taken on
    them, so a differentiated image gets both ∂n/∂θ at fixed points and
    ∂n/∂p · ∂p/∂θ through the trace, as jax.vmap(jax.grad(sdf))(p) gives.
    Otherwise it is taken on a detached copy, and under no_grad it is
    plain values."""
    keep = torch.is_grad_enabled()
    q = points if keep and points.requires_grad else points.detach()
    with torch.enable_grad():
        if not q.requires_grad:
            q = q.requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_fn(q).sum(), q, create_graph=keep)
    return normalize(g)


def render_sdf(sdf_fn: SdfFn, camera: FoVPerspectiveCameras, image_size: int,
               lights: Optional[Lights] = None, bound_radius: float = 1.5,
               base_color=(0.8, 0.8, 0.8), n_steps: int = 64) -> torch.Tensor:
    """The SDF's zero set as (S, S, 4) RGBA by sphere tracing from the
    first camera of the batch: shaded by one view's `lights`, or by a
    headlight |n·view| without them; alpha 1 on a hit."""
    origins, dirs = camera_rays(camera, image_size)
    dev = dirs.device
    t0, t1, hit0 = ray_sphere_intersect(origins, dirs,
                                        torch.zeros(3, device=dev), bound_radius)
    t, hit = sphere_trace(sdf_fn, origins, dirs, t0,
                          torch.where(hit0, t1, -1.0), n_steps)
    p = (origins + t[..., None] * dirs).reshape(-1, 3)
    normals = sdf_normals(sdf_fn, p)
    cam_pos = camera.camera_position()[:1]
    rgb_base = torch.broadcast_to(
        torch.as_tensor(base_color, dtype=torch.float32, device=dev), p.shape)
    if lights is not None:
        rgb = shade_points(p, normals, rgb_base, lights, cam_pos)[0]
    else:
        view = normalize(cam_pos - p)
        rgb = rgb_base * jax_abs(torch.sum(normals * view, -1, keepdim=True))
    s = image_size
    alpha = hit.to(torch.float32)[..., None]
    return torch.cat([torch.clamp(rgb.reshape(s, s, 3), 0, 1) * alpha, alpha],
                     dim=-1)
