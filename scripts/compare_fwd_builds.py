"""Hold the splat kernels of this tree against the build of another tree of
the repo (an older commit unpacked with `git archive`) on one CUDA card, at
chip_smoke.py's flagship tables, timing both in turns in one process
(other, this, this, other; CUDA events, mean over `--reps` launches):

- K1 and K5, whose per-point visibility this tree writes in the kernel:
  every output bit for bit, the sums included, against the other tree's K1
  or K5 followed by its K4 over the per-candidate flags (with its id map),
  as its splat ops ran them, `visible` as both ops test it (> 0);
- K4 on the fragment step's zbuf scatter (chip_smoke.zbuf_scatter_case),
  the other tree's kernel on its own input (ids −1 sent to the dump
  bucket P), held to this tree's within K4's tolerance.

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
from dss_tpu_torch.ops import kernels, splat  # noqa: E402


def load_kernels(tree):
    """The other tree's ops/kernels.py as a module of its own: its sources,
    its build directory, its loaded library."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", os.path.join(tree, "dss_tpu_torch", "ops", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load_library()
    return mod


def in_turns(fns, reps):
    ms = [(who, chip_smoke._time_ms(fns[who], reps))
          for who in ("other", "this", "this", "other")]
    return ", ".join(f"{who} {v:.4f}" for who, v in ms)


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
    st, cfg, pts_s, spl, shaded, b = chip_smoke.flagship_tables(
        chip_smoke.make_data("cuda"))
    s, t, k = st.image_size, cfg.tile, st.points_per_pixel
    dmt = st.depth_merging_threshold
    v, p = b.tile_counts.shape[0], chip_smoke.N_POINTS
    calls = {"fwd_lean": (dmt, s, t, k, True), "fwd_frag": (dmt, s, t, k)}

    def theirs(name):
        # the other tree's op: the kernel, its id map, K4 over the flags
        *out, vis, rgbw = getattr(other, name)(b.tile_counts, b.tile_data,
                                               *calls[name])
        seg = splat._seg(b.tile_ids, p)
        vis = other.segment_sum(vis.reshape(v, 1, -1), seg, p)[..., 0]
        return (*out, vis > 0, rgbw)

    def mine(name):
        *out, vis, rgbw = getattr(kernels, name)(b.tile_counts, b.tile_data,
                                                 p, *calls[name])
        return (*out, vis > 0, rgbw)

    with torch.no_grad():
        for name in calls:
            labels = chip_smoke.EXACT_OUTPUTS[name] + ("rgbw",)
            differ = {lab: int((a != o).sum())
                      for lab, a, o in zip(labels, mine(name), theirs(name))}
            print(f"{name}: entries that differ from the other build: {differ}")
            fns = {"other": lambda: theirs(name), "this": lambda: mine(name)}
            print(f"{name} (other: + K4) ms over {args.reps} launches, in "
                  f"turns: {in_turns(fns, args.reps)}")

        vals, seg = chip_smoke.zbuf_scatter_case(
            st, cfg, pts_s, spl, shaded,
            torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
        dump = torch.where(seg >= 0, seg, p)
        fns = {"other": lambda: other.segment_sum(vals, dump, p),
               "this": lambda: kernels.segment_sum(vals, seg, p)}
        err = chip_smoke._close("segment_sum against the other build",
                                fns["this"](), fns["other"](), 1e-4, 1e-6)
        print(f"segment_sum (zbuf scatter, {seg.numel()} slots): max |Δ| to "
              f"the other build {err:.3e}; ms over {args.reps} launches, in "
              f"turns: {in_turns(fns, args.reps)}")


if __name__ == "__main__":
    main()
