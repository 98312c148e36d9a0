"""Run one cell of the dss_tpu_torch benchmark and print its result.

    python3 benchmark/run.py --workload dss_depth.window --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card.  The
last line of standard output is one JSON object: `correct`, `attempted`
(train steps in the timed window), `failed` (steps the NaN guard
skipped), `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`compared`: each number that decided `correct` beside its limit, which
the last lines of standard error repeat.  It exits 1 without a result
when there is no card, and when a module of JAX or of the JAX package is
loaded once the window has closed.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.time()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dss_tpu")


def process_start() -> float:
    """The process's start on the wall clock, from /proc (Linux); the
    harness's first statement where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_START


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    harness.load_cell(args.workload)  # an unknown cell fails here
    chips = next((w["chips"] for w in harness.benchmark_spec(BENCH)
                  .get("workloads", []) if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", t_start=process_start())
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
