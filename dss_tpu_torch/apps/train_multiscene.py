"""Batched multi-scene inverse rendering: train S independent clouds at once
(counterpart of dss_tpu/apps/train_multiscene.py; BASELINE.md config 5).

Each scene has its own GT cloud (an ellipsoid with its own aspect and
colour, its GT images rendered with the port itself), its own camera ring
and its own slice of the stacked Adam state: Adam is elementwise, so one
optimizer over the stacked (S, P, 3) tensors is S independent ones.  Two
dispatch modes over the same per-scene semantics:

- `--dispatch folded` (default): all S·V views render in ONE lean
  rasterizer call per step (`make_stacked_loss_fn` →
  `render_views_stacked`): one launch each of K1, K2 and K3;
- `--dispatch vmap`: a loop over scenes through the flagship
  `make_loss_fn`, the loss the mean of the scenes' totals: S launches of
  each kernel per step.

    python3 -m dss_tpu_torch.apps.train_multiscene --scenes 4 \\
        --points 25000 --views 8 --image-size 512 --iters 60

It trains on the CUDA card unless `--device` says otherwise; `--device`
replaces the JAX CLI's `--platform`, and `--profile-dir` writes a
torch.profiler trace of iterations 10–12.  As in the JAX CLI, the update
is plain Adam in optax's order: `trainer.guarded_adam_` under a guard that
always holds, with no milestones.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dss_tpu_torch.geometry.cameras import (
    FoVPerspectiveCameras,
    look_at_view_transform,
)
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.models.point_model import (
    PointModelParams,
    point_model_forward,
)
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training import trainer
from dss_tpu_torch.training.trainer import (
    AnnealSchedule,
    TrainConfig,
    chamfer_distance,
    make_loss_fn,
    make_optimizer,
    make_stacked_loss_fn,
)
from dss_tpu_torch.utils.device import resolve_device


def build_scenes(n_scenes, n_points, rng):
    """Per-scene GT clouds: ellipsoids with distinct aspect ratios."""
    verts, faces = ico_sphere(level=4, radius=0.5)
    pts_list, normals_list, colors_list = [], [], []
    for _ in range(n_scenes):
        scale = 0.6 + 0.8 * rng.random(3)  # per-axis in [0.6, 1.4)
        v = verts * scale
        p, _ = sample_points_from_mesh(v, faces, n_points, rng=rng)
        # exact ellipsoid normals: n ∝ p / scale², for x²/a²+… = r²
        n = p / np.maximum(scale**2, 1e-6)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        c = np.broadcast_to(0.25 + 0.7 * rng.random(3), p.shape)
        pts_list.append(p)
        normals_list.append(n)
        colors_list.append(c.copy())
    return (
        np.stack(pts_list).astype(np.float32),
        np.stack(normals_list).astype(np.float32),
        np.stack(colors_list).astype(np.float32),
    )


def camera_ring(seed, n_views, device):
    """V look-at cameras at distance 2, elevation in [−45, 45) and azimuth
    in [0, 360) drawn from a numpy generator seeded with `seed`."""
    r = np.random.default_rng(seed)
    elev = r.uniform(-45, 45, n_views)
    azim = r.uniform(0, 360, n_views)
    rr, tt = look_at_view_transform(dist=torch.full((n_views,), 2.0),
                                    elev=torch.as_tensor(elev),
                                    azim=torch.as_tensor(azim))
    return FoVPerspectiveCameras.create(rr, tt, fov=60.0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--points", type=int, default=25000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr-points", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card (cuda:0), "
                         "which must exist; 'cpu' runs on the CPU")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="write a torch.profiler trace of iterations 10-12 "
                         "into this directory")
    ap.add_argument(
        "--dispatch", choices=["folded", "vmap"], default="folded",
        help="folded: all S·V views in ONE rasterizer call per step "
             "(make_stacked_loss_fn); vmap: a loop over scenes through the "
             "flagship make_loss_fn (S calls per step)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))

    rng = np.random.default_rng(args.seed)
    S, P, V = args.scenes, args.points, args.views
    gt_pts, gt_normals, gt_colors = build_scenes(S, P, rng)
    cams = [camera_ring(args.seed + s, V, device) for s in range(S)]

    settings = RasterSettings(
        image_size=args.image_size,
        points_per_pixel=5,
        cutoff_threshold=1.0,
        Vrk_invariant=True,
        Vrk_isotropic=False,
        backface_culling=True,
        radii_backward_scaler=5.0,
    )

    # GT images: the GT clouds rendered with the port itself
    gt_filters = PointFilters.ones(P, device=device)
    gt_img, gt_mask = [], []
    with torch.no_grad():
        for s in range(S):
            gt = PointModelParams.create(gt_pts[s], gt_normals[s],
                                         gt_colors[s], device=device,
                                         requires_grad=False)
            out, _ = point_model_forward(gt, gt_filters, cams[s], None,
                                         settings)
            gt_img.append(out["img_pred"])
            gt_mask.append(out["mask_img_pred"])
    gt_img, gt_mask = torch.stack(gt_img), torch.stack(gt_mask)
    sync()
    print(f"GT rendered: {tuple(gt_img.shape)}")

    # Init: spheres of radius 0.5 (the flagship init)
    verts, faces = ico_sphere(level=4, radius=0.5)
    init = [sample_points_from_mesh(verts, faces, P, rng=rng)
            for _ in range(S)]
    params = PointModelParams.create(
        np.stack([p for p, _ in init]), np.stack([n for _, n in init]),
        np.full((S, P, 3), 0.5, np.float32), device=device)
    ones = torch.ones((S, P), dtype=torch.bool, device=device)
    filters = PointFilters(activation=ones, visibility=ones.clone(),
                           inmask=ones.clone())

    cfg = TrainConfig(lambda_repel=0.05, lambda_proj=0.0)
    schedule = AnnealSchedule(
        init_backward_radii=5.0, steps_backward_radii=50,
        gamma_backward_radii=0.9, limit_backward_radii=1.0,
    )
    optimizer = make_optimizer(params, lr_points=args.lr_points,
                               lr_normals=args.lr_points, lr_colors=0.1)

    if args.dispatch == "folded":
        stacked_loss = make_stacked_loss_fn(settings, cfg, schedule)

        def batched_loss(params, filters, it):
            total, (parts, new_f) = stacked_loss(
                params, filters, cams, None, gt_img, gt_mask, it)
            return total, new_f, parts["bin_overflow"]
    else:
        loss_fn = make_loss_fn(settings, cfg, schedule)

        def batched_loss(params, filters, it):
            totals, news, overflow = [], [], 0
            for s in range(S):
                total, (parts, new_f) = loss_fn(
                    PointModelParams(params.points[s], params.normals[s],
                                     params.colors[s]),
                    PointFilters(filters.activation[s], filters.visibility[s],
                                 filters.inmask[s]),
                    cams[s], None, gt_img[s], gt_mask[s], it)
                totals.append(total)
                news.append(new_f)
                overflow = overflow + parts["bin_overflow"]
            new_f = PointFilters(*(torch.stack([getattr(f, k) for f in news])
                                   for k in ("activation", "visibility",
                                             "inmask")))
            return torch.mean(torch.stack(totals)), new_f, overflow

    always = torch.ones((), dtype=torch.bool, device=device)  # the guard

    def train_step(filters, it):
        loss, new_filters, overflow = batched_loss(params, filters, it)
        grads = torch.autograd.grad(loss, params.tensors(),
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params.tensors(), grads)]
        trainer.guarded_adam_(optimizer, grads, always)
        new_filters = PointFilters(
            activation=new_filters.activation,
            visibility=new_filters.visibility.detach(),
            inmask=new_filters.inmask.detach())
        return new_filters, loss.detach(), overflow

    # the first step (the kernels' build included)
    t0 = time.perf_counter()
    filters, loss, overflow = train_step(filters, 0)
    loss0 = float(loss)
    print(f"compiled in {time.perf_counter() - t0:.1f}s, loss0={loss0:.4f}")
    print(f"bin_overflow at it 0: {int(overflow)}", flush=True)

    times, overflows = [], [int(overflow)]
    prof = None
    for i in range(1, args.iters):
        if args.profile_dir and i == 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        filters, loss, overflow = train_step(filters, i)
        sync()
        times.append(time.perf_counter() - t0)
        if prof is not None and i == 12:
            prof = _stop_trace(prof, args.profile_dir)
        if i % 10 == 0:
            overflows.append(int(overflow))
            print(f"it {i} loss {float(loss):.4f} ({times[-1]:.3f}s/it) "
                  f"bin_overflow {overflows[-1]}", flush=True)
    if prof is not None:
        # --iters too small to reach the stop step: write what was traced
        _stop_trace(prof, args.profile_dir)

    steady = (float(np.median(times[5:])) if len(times) > 10
              else float(np.median(times)))
    msplats = S * P * V / steady / 1e6

    cds = []
    for s in range(S):
        cd, _ = chamfer_distance(torch.as_tensor(gt_pts[s], device=device),
                                 params.points[s].detach())
        cds.append(float(cd))
    result = {
        "scenes": S, "points_per_scene": P, "views": V,
        "dispatch": args.dispatch,
        "image_size": args.image_size, "iters": args.iters,
        "sec_per_iter": round(steady, 4),
        "msplats_per_s": round(msplats, 3),
        "final_loss": round(float(loss), 5),
        "chamfer_per_scene": [round(c, 5) for c in cds],
    }
    print(json.dumps(result))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    return {**result, "loss0": loss0, "bin_overflow": overflows,
            "step_times": times}


def _stop_trace(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)
    return None


if __name__ == "__main__":
    main()
