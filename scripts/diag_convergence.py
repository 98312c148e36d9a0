"""Does the port's training converge on a ground truth other than its
initial sphere?  create_mvr_data renders an ellipsoid mesh (ico_sphere(4)
scaled by 1.0, 0.7, 0.5; 16 cameras, tri-colour lights) at each image
size, and train_mvr trains 5000 points on it from a config inheriting
configs/dss_depth.yml, on each device asked for.  Prints, for each run,
the chamfer of the initial cloud and the chamfer, IoU loss and losses at
every eval, and writes them all as JSON.

    python3 scripts/diag_convergence.py \\
        --runs 64:cuda:200 64:cpu:200 512:cuda:1000 [--eval-every 20] \\
        [--out exp/convergence.json]

A run is SIZE:DEVICE:ITERS.  Datasets are rendered on the first run's
device for each size (on the CPU for a `jax` run).  DEVICE `jax` runs the
JAX package's CLI (train_mvr.py --platform cpu) in a subprocess on the
same dataset and config, for comparison; this script imports no jax.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dss_tpu_torch import config as config_mod  # noqa: E402
from dss_tpu_torch.apps import create_mvr_data, train_mvr  # noqa: E402
from dss_tpu_torch.data.io import save_ply  # noqa: E402
from dss_tpu_torch.geometry.shapes import ico_sphere  # noqa: E402
from dss_tpu_torch.training.trainer import chamfer_distance  # noqa: E402
from dss_tpu_torch.utils import yaml_lite  # noqa: E402

AXES = (1.0, 0.7, 0.5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=["64:cuda:200",
                                                  "64:cpu:200",
                                                  "512:cuda:1000"])
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--cameras", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "exp",
                                                  "convergence.json"))
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    runs = [(int(s), d, int(n)) for s, d, n in
            (r.split(":") for r in args.runs)]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        verts, faces = ico_sphere(level=4, radius=1.0)
        mesh = os.path.join(tmp, "ellipsoid.ply")
        save_ply(mesh, verts * np.asarray(AXES, np.float32), faces=faces)
        datasets = {}
        for k, (size, device, iters) in enumerate(runs):
            if size not in datasets:
                ds = os.path.join(tmp, f"data{size}")
                create_mvr_data.main(
                    ["--mesh", mesh, "--out", ds, "--num-cameras",
                     str(args.cameras), "--image-size", str(size),
                     "--tri-color-lights", "--seed", str(args.seed),
                     "--device", "cpu" if device == "jax" else device])
                datasets[size] = ds
            ds = datasets[size]
            name = f"run{k}_s{size}_{device}_{iters}"
            cfg = {"inherit_from": os.path.join(REPO, "configs",
                                                "dss_depth.yml"),
                   "name": name, "data": {"data_dir": ds},
                   "renderer": {"raster_params": {"image_size": size}},
                   "training": {"out_dir": os.path.join(tmp, "exp"),
                                "validate_every": args.eval_every,
                                "checkpoint_every": iters,
                                "print_every": args.eval_every}}
            path = os.path.join(tmp, name + ".yml")
            yaml_lite.dump(cfg, path)
            # the initial cloud, as train_mvr makes it from --seed
            full = config_mod.load_config(path)
            init, _ = config_mod.create_model_params(
                full, np.random.default_rng(args.seed), device="cpu")
            with np.load(os.path.join(ds, "data_dict.npz"),
                         allow_pickle=True) as f:
                gt = torch.as_tensor(f["points"])
            cd0, _ = chamfer_distance(gt, init.points.detach())
            t0 = time.perf_counter()
            argv = ["--config", path, "--max-iters", str(iters), "--seed",
                    str(args.seed)]
            if device == "jax":
                subprocess.run([sys.executable, "train_mvr.py", *argv,
                                "--platform", "cpu"], cwd=REPO, check=True,
                               env={**os.environ, "JAX_PLATFORMS": "cpu"})
            else:
                train_mvr.main(argv + ["--device", device])
            dt = time.perf_counter() - t0
            with open(os.path.join(tmp, "exp", name, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            evals = [(r["step"], r["val/chamfer_point"], r["val/iou_loss"])
                     for r in rows if "val/chamfer_point" in r]
            losses = [(r["step"], r["loss"], r.get("loss_dr_silhouette"),
                       r.get("loss_dr_depth")) for r in rows if "loss" in r]
            rec = {"size": size, "device": device, "iters": iters,
                   "seconds": dt, "chamfer_init": float(cd0),
                   "evals": evals, "losses": losses}
            results.append(rec)
            print(f"RUN {name}: chamfer init {float(cd0):.6f}, then "
                  + ", ".join(f"{c:.6f} (it {i}, iou_loss {u:.4f})"
                              for i, c, u in evals)
                  + f"; {dt:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
