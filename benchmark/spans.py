"""The program's own spans of the train step (dss_tpu_torch/utils/spans.py)
for the per-layer readers of a `--trace 1` run, made once and cached in
`ctx["spans"]`.

`collect` builds, in a process of its own (`_collect` says why), a second
program loop for the cell (`loops/<loop>.py` on `ctx["data"]`, shared
with the run, on the data's device) with spans on, runs one untimed
cycle (its graph capture holds the marks), then a cycle's first
`profile_steps` steps with the profiler off: the metrics come from that
pass.  On a card it runs the same steps once more under torch.profiler:
each mark is a device row there, so each stamp maps onto the trace's
clock by its own row (the stamp-to-row offset's spread is reported); with
that the ten longest device idle gaps are named by the span they fall in
(or "between steps") and the program's host span over them, the device's
idle time inside each span is summed, and the port's kernels and the
top-k rows are checked to lie inside their spans (standard error).  Then
the process ends.  Where the program has no spans module, `collect`
returns None and the readers report nothing.

Reductions, in ms per step over the traced steps: each module's self time
(its span less its child spans) summed by group; `geometry_knn_ms` all
outermost `geometry.knn` spans and `update_ms` the `update` span, whole;
`no_module_ms` the step's device time in no module span (the root's and
`backward`'s own); `step_gap_ms` the mean device time from one step's end
stamp to the next step's start stamp; `launch_host_ms` the host time per
replay inside `CUDAGraph.replay()` (`TrainWindow.replay_host_ns` over
`replays`).  The groups, the no-module time and the gap sum to the
device's wall time per step."""
from __future__ import annotations

import queue
import re
import statistics
import sys
import time
import traceback

import torch

from benchmark import trace
from benchmark.harness import load_module, sync

# module groups by span name prefix: self time, summed
SELF_GROUPS = (("render_ms", ("model.", "render.", "bwd.render.")),
               ("splat_ms", ("splat.", "bwd.splat")),
               ("loss_ms", ("loss.", "bwd.loss.")))
KNN = "geometry.knn"
UPDATE = "update"
NOT_MODULES = ("step", "backward")  # the root and the engine's own time
KERNEL_ROWS = re.compile(
    r"(^|::)(fwd_lean|occ_bwd|feat_bwd|segment_sum|fwd_frag)_kernel\(")
TOPK_ROWS = re.compile(r"topk|TopK")
MARK_ROWS = "span_mark"
HOST_SPANS = ("window.", "train.")


def _union(intervals):
    """Merged, sorted [[start, end]] of (start, end) pairs."""
    return trace.union((None, s, e) for s, e in intervals)


def _covered(lo, hi, merged) -> float:
    """Length of [lo, hi] inside the merged intervals."""
    return sum(max(0, min(hi, e) - max(lo, s)) for s, e in merged)


def self_times(spans) -> list:
    """Each span's length less the union of its children's intervals
    inside it; spans are (name, parent, start, end), parent an index."""
    kids = {}
    for s in spans:
        if s[1] >= 0:
            kids.setdefault(s[1], []).append((s[2], s[3]))
    return [s[3] - s[2] - _covered(s[2], s[3], _union(kids.get(i, [])))
            for i, s in enumerate(spans)]


def _group(name: str):
    for key, prefixes in SELF_GROUPS:
        if name.startswith(prefixes):
            return key
    return None


def reduce(steps) -> dict:
    """Per-step ms of each group from the steps' spans ({"index", "spans"}
    in step order); see the module's docstring."""
    if not steps:
        return None
    acc = dict.fromkeys(("render_ms", "splat_ms", "loss_ms",
                         "geometry_knn_ms", "update_ms", "no_module_ms",
                         "backward_self_ms", "step_ms"), 0.0)
    unknown = set()
    for st in steps:
        sp = st["spans"]
        own = self_times(sp)
        modules = []
        for i, s in enumerate(sp):
            name = s[0]
            if name in NOT_MODULES:
                if name == "backward":
                    acc["backward_self_ms"] += own[i]
                continue
            modules.append((s[2], s[3]))
            if name == KNN:
                if sp[s[1]][0] != KNN:
                    acc["geometry_knn_ms"] += s[3] - s[2]
            elif name == UPDATE:
                acc["update_ms"] += s[3] - s[2]
            elif _group(name):
                acc[_group(name)] += own[i]
            else:
                unknown.add(name)
        root = sp[0]
        acc["step_ms"] += root[3] - root[2]
        acc["no_module_ms"] += (root[3] - root[2]
                                - _covered(root[2], root[3], _union(modules)))
    out = {k: v / len(steps) / 1e6 for k, v in acc.items()}
    gaps = [b["spans"][0][2] - a["spans"][0][3]
            for a, b in zip(steps, steps[1:]) if b["index"] == a["index"] + 1]
    out["step_gap_ms"] = statistics.mean(gaps) / 1e6 if gaps else None
    out["unknown"] = sorted(unknown)
    return out


def align(steps, dev, host) -> dict:
    """The spans on the profiler's clock (us): each mark is a device row,
    so the stamps and the mark rows pair one to one in order and each
    stamp takes its own row's start.  Returns the stamp-to-row offset's
    spread (over all marks, and the widest inside one step), the share of
    the port's kernels and of the top-k rows inside their spans, the
    device's idle time inside each span name per step, and the ten longest
    device idle gaps with the span they fall in and the host spans over
    them."""
    rows = sorted(s for n, s, _ in dev if MARK_ROWS in n)
    flat = [(st["index"], s) for st in steps for s in st["spans"]]
    marks = sorted((s[2 + end], i, end) for i, (_, s) in enumerate(flat)
                   for end in (0, 1))
    if not rows or len(rows) != len(marks):
        return {"marks": len(rows), "stamps": len(marks)}
    at = {}
    offs, step_of = [], []
    for r, (t, i, end) in zip(rows, marks):
        at[i, end] = r
        offs.append(r * 1e3 - t)
        step_of.append(flat[i][0])
    spans = [(s[0], at[i, 0], at[i, 1]) for i, (_, s) in enumerate(flat)]
    per_step = {}
    for o, k in zip(offs, step_of):
        lo, hi = per_step.get(k, (o, o))
        per_step[k] = (min(lo, o), max(hi, o))

    def inside(pattern, prefixes):
        merged = _union([(a, b) for n, a, b in spans
                         if n.startswith(prefixes)])
        rows_ = [(s, e) for n, s, e in dev if pattern.search(n)]
        total = sum(e - s for s, e in rows_)
        return (100.0 * sum(_covered(s, e, merged) for s, e in rows_)
                / total if total else None)

    merged = _union([(s, e) for _, s, e in dev])
    idle = {}
    for n, a, b in spans:
        idle[n] = idle.get(n, 0.0) + (b - a) - _covered(a, b, merged)
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        holds = [(b - a, n) for n, a, b in spans if a <= mid <= b]
        over = [(min(hi, e) - max(lo, s), -(e - s), n) for n, s, e in host
                if s < hi and e > lo]
        prog = [o for o in over if o[2].startswith(HOST_SPANS)]
        named.append({"ms": (hi - lo) / 1e3,
                      "device_span": min(holds)[1] if holds
                      else "between steps",
                      "host_span": max(prog)[2] if prog else "none",
                      "host_op": max(over)[2] if over else "none"})
    # a rate between the clocks: the offset's straight-line fit over the
    # stamps, and the spread left about it
    t = [m[0] for m in marks]
    slope, icpt = statistics.linear_regression(t, offs)
    resid = [o - (icpt + slope * x) for x, o in zip(t, offs)]
    return {"marks": len(rows), "offset_spread_ns": max(offs) - min(offs),
            "step_offset_spread_ns": max(hi - lo for lo, hi
                                         in per_step.values()),
            "offset_ppm": slope * 1e6,
            "offset_fit_spread_ns": max(resid) - min(resid),
            "kernels_in_splat_pct": inside(KERNEL_ROWS, ("splat.",
                                                         "bwd.splat")),
            "topk_in_knn_pct": inside(TOPK_ROWS, (KNN,)),
            "idle_ms": {n: v / 1e3 / len(steps) for n, v in idle.items()},
            "idle_gaps": named}


def collect(ctx):
    """The spans' readings for this run (None where the program has no
    spans), made once."""
    if "spans" not in ctx:
        ctx["spans"] = _collect(ctx)
    return ctx["spans"]


def _collect(ctx):
    """The passes run in a process of their own, on the run's data (shared
    with it, not copied): a profiler session leaves the process's graph
    launches 5-8 times slower on the host, and a later session in it has
    lost mark rows; the harness's trace has had one."""
    try:
        from dss_tpu_torch.utils import spans  # noqa: F401  (the program's)
    except ImportError:
        return None
    mp = torch.multiprocessing.get_context("spawn")
    got = mp.Queue()
    proc = mp.Process(target=_child, args=(
        got, ctx["root"], ctx["cell"], ctx["data"], torch.get_num_threads()))
    proc.start()
    try:
        while True:
            try:
                kind, out = got.get(timeout=5)
                break
            except queue.Empty:
                if not proc.is_alive():
                    raise RuntimeError("spans: the passes' process ended "
                                       f"with exit code {proc.exitcode}")
    finally:
        proc.join()
    if kind == "error":
        raise RuntimeError("spans: the passes failed:\n" + out)
    return out


def _child(got, root, cell, data, threads) -> None:
    try:
        torch.set_num_threads(threads)
        got.put(("ok", _passes(root, cell, data)))
    except Exception:
        got.put(("error", traceback.format_exc()))


def _passes(root, cell, data):
    from dss_tpu_torch.utils import spans as program_spans

    dev = data["img"].device
    n = int(cell.traffic["profile_steps"])
    loop_cls = load_module(root / "loops" / f"{cell.traffic['loop']}.py").Loop
    aligned = None
    program_spans.enable()
    drv = loop_cls(cell, data, dev)
    drv.cycle()  # untimed: the capture, with the marks
    window = getattr(drv, "window", None)
    drv.restore()
    sync(dev)
    if window is not None:
        window.replay_host_ns = window.replays = 0
    first = program_spans.begun(dev)
    t0 = time.perf_counter()
    drv.run_steps(n)
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    steps = program_spans.read(first=first, device=dev)["steps"]
    launch = (window.replay_host_ns, window.replays) if window else (0, 0)
    if dev.type == "cuda":
        drv.restore()
        sync(dev)
        first = program_spans.begun(dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            drv.run_steps(n)
            sync(dev)
        traced = program_spans.read(first=first, device=dev)["steps"]
        aligned = align(traced, *trace.events(prof))
    out = reduce(steps)
    if out is None:
        return None
    out["wall_ms"] = wall_ms
    out["launch_host_ms"] = launch[0] / launch[1] / 1e6 if launch[1] else None
    _report(out, aligned, len(steps))
    return out


def _report(out, aligned, n) -> None:
    parts = ("render_ms", "splat_ms", "loss_ms", "geometry_knn_ms",
             "update_ms", "no_module_ms", "step_gap_ms")
    total = sum(out[k] or 0.0 for k in parts)
    print(f"spans: {n} steps, ms per step: " + ", ".join(
        f"{k[:-3]} {out[k]:.4f}" for k in parts if out[k] is not None)
          + f"; backward's own {out['backward_self_ms']:.4f}, step span "
          f"{out['step_ms']:.4f}; sum {total:.4f} against the wall's "
          f"{out['wall_ms']:.4f} ({100.0 * total / out['wall_ms']:.2f}%); "
          f"launch_host_ms {out['launch_host_ms']}", file=sys.stderr)
    if out["unknown"]:
        print(f"spans: in no group: {', '.join(out['unknown'])}",
              file=sys.stderr)
    if aligned is None:
        return
    if "idle_gaps" not in aligned:
        print(f"spans: {aligned['marks']} mark rows for {aligned['stamps']} "
              "stamps: the clocks were not aligned", file=sys.stderr)
        return
    print(f"spans: {aligned['marks']} marks, stamp-to-row offset spread "
          f"{aligned['offset_spread_ns']:.0f} ns, inside one step at most "
          f"{aligned['step_offset_spread_ns']:.0f} ns, about a straight line "
          f"({aligned['offset_ppm']:.1f} ppm) "
          f"{aligned['offset_fit_spread_ns']:.0f} ns; K1-K5 device time "
          f"inside splat spans {aligned['kernels_in_splat_pct']}%; top-k "
          f"inside geometry.knn {aligned['topk_in_knn_pct']}%",
          file=sys.stderr)
    print("spans: device idle ms per step inside each span: " + ", ".join(
        f"{n} {v:.4f}" for n, v in sorted(aligned["idle_ms"].items(),
                                          key=lambda kv: -kv[1])),
          file=sys.stderr)
    for i, g in enumerate(aligned["idle_gaps"], 1):
        print(f"spans: idle gap {i}: {g['ms']:.4f} ms in {g['device_span']}, "
              f"host span {g['host_span']} ({g['host_op']})",
              file=sys.stderr)
