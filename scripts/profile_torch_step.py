"""Profile the dss_tpu_torch flagship train step on one CUDA card.

Builds chip_smoke.py's flagship case (512², 5000 points, 8 views, depth
L1; the lean path, or with `--fragments` the fragment path, whose depth
loss reads zbuf[..., 0]), runs `--warmup` steps, then profiles
`--profile-steps` steps with
torch.profiler and prints the device time by kernel, the device-busy
share of the profiled wall time, and the median step time; user
annotations (spans, which cover kernels that have rows of their own) are
printed on a line of their own and left out of the device time.  With `--graph` the steps run through the train
window (trainer.make_train_window, as train_mvr runs them): the step is
captured once as a CUDA graph, and the profiled steps are dispatches of
`--k` replays each (the warm-up includes the capture).  `--recipe` swaps
in a recipe that estimates normals every step: `anisotropic` (the
anisotropic Vrk: the 8-NN PCA frames through the eigensolver kernel),
`pca` (the PCA normal anchor, λ_normal 0.1, k 8) or `jet` (the jet
anchor of configs/exp_e21_jetanchor.yml: λ_normal 0.1, k 48, batched 6×6
solves).  Then it trains on to `--steps` steps, printing the loss and the
chamfer distance to the ground truth every `--every` steps.

    python3 scripts/profile_torch_step.py --steps 300
    python3 scripts/profile_torch_step.py --graph          # the graphed step
    python3 scripts/profile_torch_step.py --graph --recipe anisotropic
"""
import argparse
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dss_tpu_torch.render.ewa import RasterSettings  # noqa: E402
from dss_tpu_torch.training.trainer import (  # noqa: E402
    AnnealSchedule, TrainConfig, chamfer_distance, create_train_state,
    make_optimizer, make_train_step, make_train_window)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=0,
                    help="train on to this many steps in all (0: stop after "
                         "the profile)")
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--fragments", action="store_true",
                    help="train on the fragment path (lean_fragments false)")
    ap.add_argument("--trace", default="",
                    help="write a chrome trace of the profiled steps here")
    ap.add_argument("--graph", action="store_true",
                    help="run the steps as CUDA graph replays of the train "
                         "window")
    ap.add_argument("--k", type=int, default=5,
                    help="with --graph: steps per dispatch (divides "
                         "--profile-steps)")
    ap.add_argument("--rows", type=int, default=40,
                    help="device rows to print, largest first (0: all)")
    ap.add_argument("--recipe", default="flagship",
                    choices=("flagship", "anisotropic", "pca", "jet"),
                    help="the flagship step, or it with the anisotropic Vrk "
                         "or a normal anchor")
    args = ap.parse_args(argv)
    k = args.k if args.graph else 1
    if args.profile_steps % k:
        ap.error("--k must divide --profile-steps")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0])
    raster = (chip_smoke.FLAGSHIP_FRAG_RASTER if args.fragments
              else chip_smoke.FLAGSHIP_RASTER)
    train = chip_smoke.FLAGSHIP_TRAIN
    if args.recipe == "anisotropic":
        raster = {**raster, "Vrk_invariant": False, "Vrk_isotropic": False}
    elif args.recipe == "pca":
        train = chip_smoke.PCA_TRAIN
    elif args.recipe == "jet":
        train = {**train, "lambda_normal": 0.1, "normal_anchor": "jet",
                 "normal_anchor_k": 48}
    print(f"recipe {args.recipe}: raster {raster}, train {train}")
    settings = RasterSettings(**raster)
    data = chip_smoke.make_data("cuda")
    targets = chip_smoke.render_targets(data, settings)
    params = chip_smoke.initial_params(data)
    state = create_train_state(params, make_optimizer(params, **chip_smoke.FLAGSHIP_OPT))
    cfg = TrainConfig(**train)
    schedule = AnnealSchedule(**chip_smoke.FLAGSHIP_SCHEDULE)
    batch = (data["cams"], data["lights"], targets["img"], targets["mask_img"],
             targets["depth"])
    if args.graph:
        # the whole 8-view batch is one epoch's only row
        window = make_train_window(settings, cfg, schedule, state, *batch)
        rows = torch.arange(chip_smoke.N_VIEWS, device="cuda")[None]

        def step(state, *_):
            return window(state, rows, k)
    else:
        step = make_train_step(settings, cfg, schedule)

    def report(i, m):
        cd, _ = chamfer_distance(state.params.points.detach(), data["gt_pts"])
        print(f"it {i}: loss {float(m['loss']):.6f} chamfer {float(cd):.6f} "
              f"overflow {int(m['bin_overflow'])}")

    t0 = time.perf_counter()
    for _ in range(args.warmup):
        state, m = step(state, *batch)
    torch.cuda.synchronize()
    if args.graph:
        print(f"warm-up {args.warmup} dispatches of {k} in "
              f"{time.perf_counter() - t0:.3f} s: capture "
              f"{window.capture_s:.3f} s, graph pool "
              f"{window.pool_bytes / 2**20:.1f} MiB, launches per replay "
              f"{window.per_replay}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    times = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.profile_steps // k):
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            times += [(time.perf_counter() - t0) * 1e3 / k] * k
    # device-side rows only (kernels, memcpy, memset): operator rows would
    # count a kernel launched through ctypes a second time, and a user
    # annotation's device span the kernels inside it
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    ka, spans = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.key.startswith(("Optimizer.", "ProfilerStep")))
        (spans if annotation else ka).append(e)
    rows = sorted(ka, key=dev_us, reverse=True)
    total_dev_ms = sum(dev_us(e) for e in ka) / 1e3
    wall_ms = sum(times)
    print(f"median step {statistics.median(times):.3f} ms; device busy "
          f"{total_dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * total_dev_ms / wall_ms:.1f}%) over {args.profile_steps} steps")
    print(f"device time per step {total_dev_ms / args.profile_steps:.4f} ms")
    print("user annotations, left out (ms per step): " + (", ".join(
        f"{e.key} {dev_us(e) / 1e3 / args.profile_steps:.4f}" for e in spans)
        or "none"))
    print("device time per step by kernel (ms):")
    for e in rows[:args.rows or None]:
        if dev_us(e) <= 0:
            break
        print(f"  {dev_us(e) / 1e3 / args.profile_steps:9.4f}  x{e.count // args.profile_steps:<4d} {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    done = args.warmup * k + args.profile_steps
    report(done, m)
    while done < args.steps:
        state, m = step(state, *batch)
        done += k
        if done % args.every < k or done >= args.steps:
            report(done, m)


if __name__ == "__main__":
    main()
