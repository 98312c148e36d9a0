"""Hold K1 and K5 of this tree against the build of another tree of the
repo (an older commit unpacked with `git archive`) on one CUDA card, at
chip_smoke.py's flagship tables: every output bit for bit, the sums
included, and each kernel's mean time over `--reps` launches (CUDA events)
in turns: other, this, this, other.

    python3 scripts/compare_fwd_builds.py --other exp/parent
"""
import argparse
import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dss_tpu_torch.ops import kernels  # noqa: E402


def load_kernels(tree):
    """The other tree's ops/kernels.py as a module of its own: its sources,
    its build directory, its loaded library."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", os.path.join(tree, "dss_tpu_torch", "ops", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load_library()
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other tree")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_fwd_builds: no CUDA device")
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0])
    other = load_kernels(args.other)
    kernels.load_library()
    st, cfg, _pts, _spl, b = chip_smoke.flagship_tables(
        chip_smoke.make_data("cuda"))
    s, t, k = st.image_size, cfg.tile, st.points_per_pixel
    dmt = st.depth_merging_threshold
    calls = {"fwd_lean": (b.tile_counts, b.tile_data, dmt, s, t, k, True),
             "fwd_frag": (b.tile_counts, b.tile_data, dmt, s, t, k)}
    for name, call in calls.items():
        labels = chip_smoke.EXACT_OUTPUTS[name] + ("rgbw",)
        mine = getattr(kernels, name)(*call)
        theirs = getattr(other, name)(*call)
        differ = {lab: int((a != o).sum())
                  for lab, a, o in zip(labels, mine, theirs)}
        print(f"{name}: entries that differ from the other build: {differ}")
        fns = {"other": lambda: getattr(other, name)(*call),
               "this": lambda: getattr(kernels, name)(*call)}
        ms = [(who, chip_smoke._time_ms(fns[who], args.reps))
              for who in ("other", "this", "this", "other")]
        print(f"{name} ms over {args.reps} launches, in turns: "
              + ", ".join(f"{who} {v:.4f}" for who, v in ms))


if __name__ == "__main__":
    main()
