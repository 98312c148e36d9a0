"""Train-step time with the train step's spans (dss_tpu_torch/utils/spans.py)
on against off, in one benchmark cell on one card.

Two program loops of the cell on the same data, one captured with spans
off and one with them on, timed in turns (off, on, on, off, ...) over
whole cycles, as benchmark/run.py times its window (host clock, ended by
a synchronise).  Prints each turn's ms per step, the medians and the
overhead.

    python3 scripts/spans_overhead.py --workload dss_depth.window \\
        --seed 7 --seconds 3 --rounds 4
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def timed(drv, seconds: float, dev) -> float:
    """ms per step over whole cycles of at least `seconds`."""
    from benchmark.harness import sync

    sync(dev)
    t0, steps = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        steps += drv.cycle()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from dss_tpu_torch.utils import spans

    dev = torch.device("cuda:0")
    cell = harness.load_cell(args.workload)
    data = harness.make_data(cell, args.seed, dev)
    loop = harness.load_module(harness.ROOT / "loops"
                               / f"{cell.traffic['loop']}.py").Loop
    drv = {}
    for on in (False, True):
        spans.enable() if on else spans.disable()
        drv[on] = loop(cell, data, dev)
        drv[on].cycle()  # the capture, with the marks where on
    times = {False: [], True: []}
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            # the switch as the loop was captured: no capture anew
            spans.enable() if on else spans.disable()
            ms = timed(drv[on], args.seconds, dev)
            times[on].append(ms)
            print(f"round {r} spans {'on ' if on else 'off'} {ms:.4f} ms/step",
                  flush=True)
    spans.disable()
    off, on = (statistics.median(times[k]) for k in (False, True))
    print(f"{args.workload}: median off {off:.4f}, on {on:.4f} ms/step, "
          f"overhead {100.0 * (on / off - 1.0):+.3f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
