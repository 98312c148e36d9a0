"""The readings that a cell's limits are set from, on the card at the
cell's own size (no timed window):

- for each of `--seeds`: the program's first steps against the plain
  reference (the lower readings);
- for each of `--control-seeds`: the reference (the trainer that the
  configuration's adapter builds) computed with TF32 matmuls put in the
  program's place (the control), and the reference with each planted
  fault (half of the batch left out, of each scene's views where the
  data stacks scenes, the mean taken over the rest; the loss altered by
  a part in a thousand where it is produced; Adam run with torch's
  default betas in place of the configuration's; the state left
  unchanged), each against the clean reference (the upper readings).

Each row holds, under a side's name, the numbers a run compares, and
under "<side>@<n>", for every n up to `--steps` (the cell's
`check_steps` by default), those over the first n steps, `change_gap`
over the same n, from one run of each side.

    python3 benchmark/control.py --workload dss_depth.window \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 1 2 3 \\
        --out control.json

The benchmark's own runs do not run it.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402

FAULTS = ("half_batch", "altered", "adam_betas", "unchanged")


def readings_for(cell, seed: int, device, program_side: bool,
                 control_side: bool, n: int = None) -> dict:
    """One seed's readings (see above)."""
    data = harness.make_data(cell, seed, device)
    n = n or int(cell.workload["check_steps"])
    out = {"seed": seed}
    prog = None
    if program_side:
        cls = harness.load_module(
            cell.root / "loops" / f"{cell.traffic['loop']}.py").Loop
        drv = cls(cell, data, device)
        prog = drv.first_steps(n)
        del drv
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = harness.reference_first_steps(cell, data, n)
    harness.sync(device)
    out["reference_s"] = time.perf_counter() - t0
    out["losses_ref"] = ref["losses"]
    args = (data["moments"], ref["betas"], [lr > 0 for lr in ref["lr"]])
    scenes = harness.scenes(data)
    sides = {}
    if prog is not None:
        sides["program"] = prog
        out["losses_program"] = prog["losses"]
    if control_side:
        sides["control_tf32"] = harness.reference_first_steps(
            cell, data, n, tf32=True)
        for fault in FAULTS:
            sides[fault] = harness.reference_first_steps(cell, data, n,
                                                         fault=fault)
    for key, run in sides.items():
        # what a run compares
        out[key] = check.readings(run, ref, *args, scenes=scenes)
        for k in range(1, n + 1):
            got, want = check.first(run, k), check.first(ref, k)
            out[f"{key}@{k}"] = check.readings(got, want, *args, k, scenes)
            out[f"{key}_leaves@{k}"] = check.leaves(got, want, *args, k,
                                                    scenes)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        row = readings_for(cell, seed, device, seed in args.seeds,
                           seed in args.control_seeds, args.steps)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for key in sorted({k for r in rows for k in r
                       if "@" in k and "_leaves" not in k}):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {
                name: {"min": min(g[name] for g in got),
                       "max": max(g[name] for g in got)}
                for name in check.NAMES}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
