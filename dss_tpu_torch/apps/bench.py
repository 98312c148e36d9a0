"""Bench harness: Msplats/s of the forward + backward render at 512²
(counterpart of bench.py).

The workload is bench.py's: 5000 points sampled from ico_sphere(4, 0.5)
with colours 0.7, 8 look-at views (elevation −30…30°, azimuth 0…315°,
distance 2, fov 60), 512² images, K = 5, Vrk_invariant with vrk_h from
compute_vrk_h_global once per step, backface culling, cutoff 1.0; the loss
is the L1 of rgb and alpha against zero targets, with gradients to the
points, normals and colours.  2 warm-up iterations, then the best of three
windows of 5 iterations, each window closed by a device synchronize.

    python3 -m dss_tpu_torch.apps.bench [--device cpu]

It prints ONE JSON line with bench.py's keys: metric
`msplats_per_sec_fwd_bwd_512`, value, unit and vs_baseline, against the
same 1.0 Msplats/s anchor (derived from the reference's CPU code,
bench.py:13-17).  Where it differs from bench.py:

- layout: it renders untiled (the port has no `tiled_io`; bench.py's own
  comment says the tiled layout is bitwise the untiled one);
- dispatch: one forward + backward per iteration, no scan window; between
  iterations the points move by 1e-6·grad, as in bench.py's scan body, so
  no two iterations are the same work;
- no DSS_BENCH_* environment switches: the port has none of those
  branches;
- `--points`, `--views`, `--image-size` and `--device` shrink it for a CPU
  test; the defaults are the flagship values, on the CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dss_tpu_torch.geometry.cameras import (
    FoVPerspectiveCameras,
    look_at_view_transform,
)
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.mathutil import jax_abs

N_POINTS = 5000
N_VIEWS = 8
IMAGE_SIZE = 512
K = 5
WARMUP = 2
ITERS = 5
WINDOWS = 3
BASELINE_MSPLATS_PER_S = 1.0


def build_inputs(n_points: int = N_POINTS, n_views: int = N_VIEWS,
                 image_size: int = IMAGE_SIZE, device=None) -> dict:
    """bench.py's cloud, cameras, settings and zero targets on `device`."""
    device = resolve_device(device)
    verts, faces = ico_sphere(level=4, radius=0.5)
    pts, normals = sample_points_from_mesh(verts, faces, n_points)
    r, t = look_at_view_transform(
        dist=torch.full((n_views,), 2.0),
        elev=torch.tensor(np.linspace(-30.0, 30.0, n_views)),
        azim=torch.tensor(np.linspace(0.0, 315.0, n_views)),
    )
    s = image_size
    return dict(
        points=torch.as_tensor(pts, device=device),
        normals=torch.as_tensor(normals, device=device),
        colors=torch.full((n_points, 3), 0.7, device=device),
        mask=torch.ones((n_points,), dtype=torch.bool, device=device),
        cameras=FoVPerspectiveCameras.create(r, t, fov=60.0, device=device),
        settings=RasterSettings(
            image_size=s, points_per_pixel=K, cutoff_threshold=1.0,
            Vrk_invariant=True, Vrk_isotropic=False, backface_culling=True,
        ),
        target_rgb=torch.zeros((n_views, s, s, 3), device=device),
        target_mask=torch.zeros((n_views, s, s), device=device),
    )


def loss_fn(inputs: dict, points, normals, colors) -> torch.Tensor:
    """L1 of rgb and alpha against the targets, vrk_h computed once per
    step from the (constant) point positions, as the train step does.  The
    L1 takes `jax_abs` (d|x|/dx = 1 at 0, as in bench.py): the background,
    where prediction and target are both 0, carries the occupancy
    gradient."""
    mask = inputs["mask"]
    vrk_h = compute_vrk_h_global(points.detach(), mask)
    rgba, _, _ = render_views(points, normals, colors, mask,
                              inputs["cameras"], None, inputs["settings"],
                              vrk_h=vrk_h)
    return (torch.mean(jax_abs(rgba[..., :3] - inputs["target_rgb"]))
            + torch.mean(jax_abs(rgba[..., 3] - inputs["target_mask"])))


def grad_step(inputs: dict, points, normals, colors):
    """(loss, (grad points, grad normals, grad colours)) of one forward +
    backward; zeros for an input the loss does not reach (the normals,
    with no lights and the view-invariant Vrk)."""
    leaves = [x.detach().requires_grad_(True)
              for x in (points, normals, colors)]
    loss = loss_fn(inputs, *leaves)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, tuple(torch.zeros_like(x) if g is None else g
                       for x, g in zip(leaves, grads))


def run(n_points: int = N_POINTS, n_views: int = N_VIEWS,
        image_size: int = IMAGE_SIZE, device=None) -> dict:
    """Warm up, time the best of three windows, and return the JSON
    record; its `iterations` entry (not printed) is the number of forward
    + backward passes run."""
    inputs = build_inputs(n_points, n_views, image_size, device)
    dev = inputs["points"].device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    pts, normals, colors = (inputs["points"], inputs["normals"],
                            inputs["colors"])
    n_iters = 0

    def step(p):
        nonlocal n_iters
        n_iters += 1
        _, (gp, _gn, _gc) = grad_step(inputs, p, normals, colors)
        return p - 1e-6 * gp

    for _ in range(WARMUP):
        pts = step(pts)
    sync()
    dt = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            pts = step(pts)
        sync()
        dt = min(dt, (time.perf_counter() - t0) / ITERS)
    value = n_points * n_views / dt / 1e6
    return {
        "metric": "msplats_per_sec_fwd_bwd_512",
        "value": round(value, 4),
        "unit": "Msplats/s",
        "vs_baseline": round(value / BASELINE_MSPLATS_PER_S, 4),
        "iterations": n_iters,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--views", type=int, default=N_VIEWS)
    ap.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card (cuda:0), "
                         "which must exist; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    result = run(args.points, args.views, args.image_size, args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "iterations"}))
    return result


if __name__ == "__main__":
    main()
