"""From a torch.profiler trace to what the per-layer readers read: the
device rows by kernel name, their groups (`kernel_groups.json`, ordered,
the first pattern that matches wins, `other` for the rest), the union of
the device intervals, and the longest idle gaps named by what the host
was doing in them.  User annotations (spans over kernels that have rows
of their own) are left out of the device rows."""
from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
_SPANS = ("ProfilerStep", "Optimizer.")


def load_groups(root: Path = HERE):
    with open(root / "kernel_groups.json") as f:
        return [(re.compile(pat), grp) for pat, grp in json.load(f)["groups"]]


def group_of(name: str, groups) -> str:
    for pat, grp in groups:
        if pat.search(name):
            return grp
    return "other"


def _is_span(e) -> bool:
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(_SPANS))


def events(prof):
    """(device [(name, start_us, end_us)], host [(name, start, end)])."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _is_span(e):
                dev.append((e.name, tr.start, tr.end))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.name, tr.start, tr.end))
    return dev, host


def union(intervals):
    """Merged, sorted [(start, end)]."""
    out = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(dev, host, window_us: float, steps: int, groups) -> dict:
    """What the readers take: per group device us and kernel counts, per
    kernel name device us and counts, busy us (the union), the window, the
    steps, and the breakdown for the result line."""
    by_group = defaultdict(float)
    n_group = defaultdict(int)
    by_name = defaultdict(float)
    n_name = defaultdict(int)
    for name, s, e in dev:
        g = group_of(name, groups)
        by_group[g] += e - s
        n_group[g] += 1
        by_name[name] += e - s
        n_name[name] += 1
    merged = union(dev)
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = []
    for s, e in gaps[:10]:
        over = [(min(e, he) - max(s, hs), -(he - hs), n)
                for n, hs, he in host if hs < e and he > s]
        idle.append([max(over)[2] if over else "(no host op)",
                     (e - s) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "group_us": dict(by_group), "group_n": dict(n_group),
        "name_us": dict(by_name), "name_n": dict(n_name),
        "busy_us": busy, "window_us": window_us, "steps": steps,
        "n_device_ops": len(dev),
        "breakdown": {"device_ops": [[n[:120], us * 1e-6] for n, us in top],
                      "idle_gaps": idle},
    }
