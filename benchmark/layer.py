"""What the per-layer readers share: device time and kernel counts per
step by group of the trace, the idle share, and the work each roofline
file counts for the traced steps.  A reader that finds nothing to read
returns None, and the metric is left out of the result line."""
from __future__ import annotations

import re

from benchmark import counts
from benchmark.harness import load_module


def group_ms(ctx, group: str):
    """Device ms per step in a group's rows; None where it has none."""
    s = ctx["summary"]
    if not s or not s["group_n"].get(group):
        return None
    return s["group_us"][group] / 1e3 / s["steps"]


def group_kernels(ctx, group: str):
    s = ctx["summary"]
    if not s or not s["group_n"].get(group):
        return None
    return s["group_n"][group] / s["steps"]


def idle_pct(ctx):
    s = ctx["summary"]
    if not s or s["window_us"] <= 0 or s["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])


def tables(ctx):
    """The traced steps' work tables (counts.step_tables), made once."""
    if "tables" not in ctx:
        ctx["tables"] = counts.step_tables(ctx["cell"], ctx["data"],
                                           ctx["inputs"])
    return ctx["tables"]


def roofline(ctx, kernel: str):
    """The kernel's roofline file."""
    return load_module(ctx["root"] / "roofline" / f"{kernel}.py")


def work(ctx, kernel: str):
    """(operations, bytes) per step of a kernel, the mean over the traced
    steps; None where the kernel does not run on this path."""
    mod = roofline(ctx, kernel)
    got = [mod.work(t) for t in tables(ctx)]
    if not got or any(g is None for g in got):
        return None
    return (sum(g[0] for g in got) / len(got), sum(g[1] for g in got) / len(got))


def bound_ms(ctx, ops: float, n_bytes: float) -> float:
    return max(ops / ctx["peak_f32"], n_bytes / ctx["peak_bytes"]) * 1e3


def kernel_ms_per_launch(ctx, name: str):
    """Mean device ms per launch of the rows of the kernel `name` (a
    profiler row names it `name(...)`, inside a namespace or not); None
    where none ran."""
    s = ctx["summary"]
    pat = re.compile(rf"(^|::){re.escape(name)}\(")
    us = sum(v for k, v in s["name_us"].items() if pat.search(k))
    n = sum(v for k, v in s["name_n"].items() if pat.search(k))
    return us / 1e3 / n if n else None
