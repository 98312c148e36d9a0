"""Batched multi-scene inverse rendering: train S independent clouds at once
(counterpart of dss_tpu/apps/train_multiscene.py; BASELINE.md config 5).

Each scene has its own GT cloud (an ellipsoid with its own aspect and
colour, its GT images rendered with the port itself), its own camera ring
and its own slice of the stacked Adam state: Adam is elementwise, so one
optimizer over the stacked (S, P, 3) tensors is S independent ones.  Every
step trains on all V views of each scene.  Two dispatch modes over the
same per-scene semantics:

- `--dispatch folded` (default): the train window
  (`trainer.make_train_window` over the stacked state), k steps per
  dispatch, on a CUDA card each a replay of one captured CUDA graph, as
  `train_mvr` runs the flagship.  All S·V views render in ONE lean
  rasterizer call per step (`make_stacked_loss_fn` →
  `render_views_stacked`): one launch each of K1, K2 and K3;
- `--dispatch vmap`: eager steps, a loop over scenes through the flagship
  `make_loss_fn`, the loss the mean of the scenes' totals: S launches of
  each kernel per step.

    python3 -m dss_tpu_torch.apps.train_multiscene --scenes 4 \\
        --points 25000 --views 8 --image-size 512 --iters 60

Both update through the NaN guard of `train_mvr` (`trainer.apply_update`:
a non-finite gradient skips the step's update), with plain Adam in
optax's order and no milestones.  The loss and `bin_overflow` (summed over
the steps since the last line) are read on the host every 10 steps, with
`bin_long_tiles` as `train_mvr` logs it.  `--bin-capacity` raises the
binning's slots per tile: the rule's 2048 above 20,000 points drops
candidates at 25,000 points a scene, 8192 drops none there.

It trains on the CUDA card unless `--device` says otherwise; `--device`
replaces the JAX CLI's `--platform`.  `--profile-dir` writes a
torch.profiler trace of the dispatch from iteration 10 and turns
utils/spans on for the whole run: each log line carries `span_<name>_ms`,
the mean ms per step of each span over the steps since the last line
(`span_render.fold_ms` among them), as `train_mvr --profile-dir` logs them.
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
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.trainer import (
    AnnealSchedule,
    TrainConfig,
    TrainState,
    chamfer_distance,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    make_train_window,
    steps_per_dispatch,
)
from dss_tpu_torch.utils import spans
from dss_tpu_torch.utils.spans import span_ms
from dss_tpu_torch.utils.device import resolve_device

# The host reads the loss and the counts every LOG_EVERY steps.
LOG_EVERY = 10


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
    try:
        return _main(argv)
    finally:
        spans.disable()


def _main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--points", type=int, default=25000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr-points", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bin-capacity", type=int,
                    default=RasterSettings.bin_capacity,
                    help="the binning's slots per tile, at least (the "
                         "rule of render/renderer._tile_config gives 2048 "
                         "above 20,000 points, which drops candidates at "
                         "25,000 points a scene; 8192 drops none there)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card (cuda:0), "
                         "which must exist; 'cpu' runs on the CPU")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="write a torch.profiler trace of the dispatch "
                         "from iteration 10 into this directory; spans are "
                         "on for the whole run and logged as "
                         "span_<name>_ms")
    ap.add_argument(
        "--dispatch", choices=["folded", "vmap"], default="folded",
        help="folded: the train window, k steps per dispatch (CUDA graph "
             "replays on a card), all S·V views in ONE rasterizer call per "
             "step (make_stacked_loss_fn); vmap: eager steps, a loop over "
             "scenes through the flagship make_loss_fn (S calls per step)",
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
        bin_capacity=args.bin_capacity,
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
    state = TrainState(params, make_optimizer(
        params, lr_points=args.lr_points, lr_normals=args.lr_points,
        lr_colors=0.1), PointFilters(ones, ones.clone(), ones.clone()))

    cfg = TrainConfig(lambda_repel=0.05, lambda_proj=0.0)
    schedule = AnnealSchedule(
        init_backward_radii=5.0, steps_backward_radii=50,
        gamma_backward_radii=0.9, limit_backward_radii=1.0,
    )

    if args.profile_dir:
        spans.enable()  # before the window captures its graph
    if args.dispatch == "folded":
        # every step takes all V views of each scene: an epoch of LOG_EVERY
        # such steps, so that train_mvr's rule gives k = LOG_EVERY
        epoch_idx = torch.arange(V, device=device).repeat(LOG_EVERY, 1)
        k = steps_per_dispatch(-1, LOG_EVERY, LOG_EVERY)
        window = make_train_window(settings, cfg, schedule, state, cams,
                                   None, gt_img, gt_mask,
                                   graph=device.type == "cuda")
        mode = ("each a CUDA graph replay" if window.graph
                else "eager")

        def dispatch(state, n):
            return window(state, epoch_idx, n)
    else:
        k = 1
        mode = "eager, a loop over scenes"
        loss_fn = make_loss_fn(settings, cfg, schedule)

        def scene_loop_loss(params, filters, cameras, lights, img, mask_img,
                            it, depth_img=None):
            totals, news, overflow = [], [], 0
            for s in range(S):
                total, (parts, new_f) = loss_fn(
                    PointModelParams(params.points[s], params.normals[s],
                                     params.colors[s]),
                    PointFilters(filters.activation[s], filters.visibility[s],
                                 filters.inmask[s]),
                    cameras[s], None, img[s], mask_img[s], it)
                totals.append(total)
                news.append(new_f)
                overflow = overflow + parts["bin_overflow"]
            new_f = PointFilters(*(torch.stack([getattr(f, name)
                                                for f in news])
                                   for name in ("activation", "visibility",
                                                "inmask")))
            total = torch.mean(torch.stack(totals))
            return total, ({"bin_overflow": overflow}, new_f)

        train_step = make_train_step(settings, cfg, schedule,
                                     loss_fn=scene_loop_loss)

        def dispatch(state, n):
            overflow = 0
            for _ in range(n):
                state, m = train_step(state, cams, None, gt_img, gt_mask)
                overflow = overflow + m["bin_overflow"]
            return state, {**m, "bin_overflow": overflow}
    # the first step (the kernels' build and the graph's capture included)
    t0 = time.perf_counter()
    state, m = dispatch(state, 1)
    loss0 = float(m["loss"])
    print(f"compiled in {time.perf_counter() - t0:.1f}s, loss0={loss0:.4f}")
    print(f"bin_overflow at it 0: {int(m['bin_overflow'])}", flush=True)
    print(f"{k} train step{'s' if k > 1 else ''} per dispatch, {mode}",
          flush=True)

    times, overflows = [], [int(m["bin_overflow"])]
    counts = 0  # bin_overflow since the last line, summed on the device
    span_next = spans.begun(device) if spans.enabled() else 0
    traced = False
    it = 1
    while it < args.iters:
        n = min(k - it % k, args.iters - it)  # up to a multiple of k
        prof = None
        if args.profile_dir and not traced and it >= 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        state, m = dispatch(state, n)
        sync()
        times += [(time.perf_counter() - t0) / n] * n
        counts = counts + m["bin_overflow"]
        if prof is not None:
            _stop_trace(prof, args.profile_dir)
            traced = True
        prev, it = it, it + n
        if it // LOG_EVERY > prev // LOG_EVERY:
            overflows.append(int(counts))
            counts = 0
            line = (f"it {it} loss {float(m['loss']):.4f} ({times[-1]:.3f}"
                    f"s/it) bin_overflow {overflows[-1]} bin_long_tiles "
                    f"{kernels.read_bin_long_tiles(device)}")
            if spans.enabled():
                record = spans.read(first=span_next, device=device)
                span_next = record["next"]
                line += "".join(
                    f" {name} {ms:.4f}" for name, ms in
                    span_ms(record["steps"][-(it - prev):]).items())
            print(line, flush=True)

    steady = (float(np.median(times[5:])) if len(times) > 10
              else float(np.median(times)))
    msplats = S * P * V / steady / 1e6
    params = state.params

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
        "final_loss": round(float(m["loss"]), 5),
        "chamfer_per_scene": [round(c, 5) for c in cds],
    }
    print(json.dumps(result))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    return {**result, "loss0": loss0, "bin_overflow": overflows,
            "step_times": times, "steps_per_dispatch": k}


def _stop_trace(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


if __name__ == "__main__":
    main()
