"""Run dss_tpu_torch's train CLI at the flagship width on one CUDA card, as
its users run it, and summarize the run.

1. The dataset twin writes 16 views of a 20,000-point sphere at 512² in a
   process of its own (the kernels' build included), timed.
2. The dataset's decode is timed (`MVRDataset`: images, masks, depth), and
   so is the decode of the same images re-encoded with all five PNG row
   filters (row y takes filter y mod 5), which must give the images back.
3. `python3 -m dss_tpu_torch.apps.train_mvr --config configs/dss_depth.yml
   --data-dir <dataset> --max-iters <iters>` trains in a process of its
   own; the script prints the seconds per iteration of its print windows
   (the first apart, then the median of the rest), the losses, the evals
   and the artifacts.
4. A second run of `--profile-iters` iterations writes a torch.profiler
   trace (`--profile-dir`); the script counts its device events and the
   launches of the port's kernels in it.

    python3 scripts/run_torch_cli.py [--iters 500] [--out exp/cli_run]

The dataset lies under `--out`, the two runs under the config's out_dir
as `cli_flagship` and `cli_flagship_prof`.  `--device cpu`, with a small
`--image-size` and a `--config` of that size, rehearses it on the CPU.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dss_tpu_torch.config import load_config  # noqa: E402
from dss_tpu_torch.data import png  # noqa: E402
from dss_tpu_torch.data.dataset import MVRDataset  # noqa: E402

KERNELS = ("fwd_lean_kernel", "occ_bwd_kernel", "feat_bwd_kernel",
           "fwd_frag_kernel", "segment_sum_kernel")


def write_all_filters(path, img):
    """Write `img` (H, W, C) uint8 as a PNG whose row y has filter y mod 5
    (None, Sub, Up, Average, Paeth); the filtered bytes are computed from
    the image itself, so every row is filtered at once."""
    x = img.astype(np.int16)
    h, w, c = x.shape
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    ftype = np.arange(h) % 5
    pred = np.choose(ftype[:, None, None],
                     (np.zeros_like(x), a, b, (a + b) >> 1, paeth))
    rows = ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), rows], 1)
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    header = np.array([w, h], ">u4").tobytes() + bytes([8, colour, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(png._SIGNATURE + png._chunk(b"IHDR", header)
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


def _run(label, cmd):
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{label} exited {res.returncode}:\n{res.stdout}\n"
                           f"{res.stderr}")
    return res, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("exp", "cli_run"))
    ap.add_argument("--config", default=os.path.join("configs", "dss_depth.yml"))
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--profile-iters", type=int, default=20)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--n-train-points", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    if args.device is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    else:
        smi = f"device {args.device}"
    print(smi)
    out = os.path.join(ROOT, args.out)
    shutil.rmtree(out, ignore_errors=True)
    ds = os.path.join(out, "data")

    # 1. the twin, in a process of its own
    _, dt = _run("make_tiny_dataset", [
        sys.executable, "-m", "dss_tpu_torch.apps.make_tiny_dataset",
        "--out", ds, "--views", str(args.views), "--image-size",
        str(args.image_size), "--points", str(args.points),
        "--n-train-points", str(args.n_train_points), *dev])
    print(f"twin: {args.views} views at {args.image_size}², {args.points}-point "
          f"sphere, written by its own process in {dt:.3f} s")

    # 2. decode times
    t0 = time.perf_counter()
    dataset = MVRDataset(ds, load_dense_depth=True)
    print(f"decode: {len(dataset)} views (images, masks, depth; filter-0 "
          f"rows) in {time.perf_counter() - t0:.3f} s")
    src = sorted(os.listdir(os.path.join(ds, "image")))
    imgs = png.read_pngs([os.path.join(ds, "image", f) for f in src])
    filt_dir = os.path.join(out, "filtered")
    os.makedirs(filt_dir)
    paths = [os.path.join(filt_dir, f) for f in src]
    for p, im in zip(paths, imgs):
        write_all_filters(p, im)
    t0 = time.perf_counter()
    back = png.read_pngs(paths)
    dt = time.perf_counter() - t0
    if not all(np.array_equal(x, y) for x, y in zip(back, imgs)):
        raise AssertionError("the filtered PNGs decode to other images")
    print(f"decode: {len(paths)} RGB images at {args.image_size}² with rows "
          f"of all five filters in {dt:.3f} s, equal to the originals")

    # 3. the CLI, as the README runs it
    cfg = load_config(os.path.join(ROOT, args.config))
    run_root = os.path.join(ROOT, cfg["training"]["out_dir"])
    name = "cli_flagship"
    shutil.rmtree(os.path.join(run_root, name), ignore_errors=True)
    cli = [sys.executable, "-m", "dss_tpu_torch.apps.train_mvr", "--config",
           args.config, "--data-dir", ds, *dev]
    _, dt = _run("train_mvr", cli + ["--name", name, "--max-iters",
                                     str(args.iters)])
    run_dir = os.path.join(run_root, name)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r for r in rows if "sec_per_iter" in r]
    spi = [r["sec_per_iter"] for r in losses]
    print(f"train_mvr: {args.iters} iterations in {dt:.3f} s (process); "
          f"sec_per_iter first window {spi[0]} (it {losses[0]['step']}), "
          f"median of the other {len(spi) - 1} windows "
          f"{statistics.median(spi[1:])}, min {min(spi[1:])}, "
          f"max {max(spi[1:])}  [{smi}]")
    for r in (losses[0], losses[-1]):
        print(f"train_mvr it {r['step']}: " + "  ".join(
            f"{k} {v}" for k, v in sorted(r.items())
            if k.startswith("loss") or k in ("bin_overflow", "params_finite")))
    print(f"train_mvr: max bin_overflow {max(r['bin_overflow'] for r in losses)}, "
          f"params finite at every print: "
          f"{all(r['params_finite'] == 1.0 for r in losses)}")
    for r in rows:
        if "val/psnr" in r:
            print(f"train_mvr eval at it {r['step']}: " + "  ".join(
                f"{k} {v}" for k, v in sorted(r.items()) if k.startswith("val/")))
    print("train_mvr artifacts: " + ", ".join(
        f for f in ("model.npz", "model_best.npz", "shape_pts.ply",
                    "metrics.jsonl", "config.yaml",
                    os.path.join("vis", "points_animation.html"))
        if os.path.exists(os.path.join(run_dir, f))))

    # 4. a profiled run
    prof_dir = os.path.join(out, "prof")
    shutil.rmtree(os.path.join(run_root, name + "_prof"), ignore_errors=True)
    _run("train_mvr --profile-dir", cli + [
        "--name", name + "_prof", "--max-iters", str(args.profile_iters),
        "--profile-dir", prof_dir])
    trace = os.path.join(prof_dir, "trace.json")
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # the trace may name a kernel by its mangled symbol
    ours = {k: sum(1 for e in device if k in e.get("name", ""))
            for k in KERNELS}
    print(f"profile: {os.path.getsize(trace)} bytes of trace, {len(device)} "
          f"device events, {sum(e.get('dur', 0) for e in device):.1f} us of "
          f"device time; the port's kernels in it: {ours}")


if __name__ == "__main__":
    main()
