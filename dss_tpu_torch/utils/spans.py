"""Device-timed spans of the train step that survive CUDA-graph capture and
replay.  Off by default.

A span is two marks.  A mark is one launch of `kernels.span_mark` on the
current stream: on the card a one-thread kernel that writes the device's
%globaltimer (ns) into a ring of stamps, on the CPU the same arithmetic
with `time.perf_counter_ns()`.  The ring has one row per step and one
column per mark of the step; the row is picked on the device from a step
count that the step's first mark advances, so a captured graph replayed k
times fills k rows and the host reads nothing until it asks (`read`).
The names are fixed on the host while the step is recorded (or
captured): the step's last mark writes the id of its layout, the list of
(name, opens) of its marks, into the row.

    spans.enable()
    with spans.step(device):          # the root, `step`
        with spans.span("loss.image"):
            ...
    record = spans.read()             # one host read

Marks outside an open `step` do nothing, so an eval render or a prune
that shares the model's code records nothing.  With spans off nothing is
launched and no autograd node is added; with them on the numbers are the
same bit for bit, since a mark reads and writes only the ring.

The backward of a module is timed by one identity autograd Function
(`inputs`, `outputs`): applied to the tensors that leave a module, its
backward opens `bwd.<module>` when their gradient arrives; applied to the
tensors that enter it, its backward closes the span when the gradient
leaves.  `host(name)` is a `torch.profiler.record_function` range (with
spans on), so host spans land in the traces that `--profile-dir` and the
benchmark take.

The switch and the rings are process-wide, as the profiler's are.  A
ring is allocated at a device's first step, before any capture, and is
never freed or moved: a graph captured with marks keeps the ring's
address and may be replayed after `disable()` (trainer.TrainWindow
captures anew when the switch has changed).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Tuple

import torch

from dss_tpu_torch.ops import kernels

STEPS = 1024  # rows of a ring: the steps it holds before it wraps
MARKS = 255  # columns of a row after the layout id: marks per step
ROOT = "step"

_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the step's list; -1: root
    start_ns: int
    end_ns: int


class _Ring:
    def __init__(self, device: torch.device):
        self.device = device
        self.stamps = torch.full((STEPS, 1 + MARKS), -1, dtype=torch.int64,
                                 device=device)
        self.count = torch.zeros((1,), dtype=torch.int64, device=device)


class _Step:
    """The open step: its ring and the (name, opens) of its marks so far."""

    def __init__(self, ring: _Ring):
        self.ring = ring
        self.keys: List[Tuple[str, bool]] = []


_on = False
_open: "_Step | None" = None
_rings: Dict[torch.device, _Ring] = {}
_layouts: List[tuple] = []  # layout id → ((name, opens), ...)
_layout_ids: Dict[tuple, int] = {}
# layout id → [(name, open col, close col, parent)]
_structure: Dict[int, list] = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _ring(device) -> _Ring:
    d = _device(device)
    if d not in _rings:
        if d.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("spans: the ring must be allocated before a "
                               "CUDA graph capture (record one step first)")
        _rings[d] = _Ring(d)
    return _rings[d]


def _layout_id(keys: tuple) -> int:
    if keys not in _layout_ids:
        _layout_ids[keys] = len(_layouts)
        _layouts.append(keys)
    return _layout_ids[keys]


def _mark(name: str, opens: bool, flags: int = 0) -> None:
    st = _open
    col = len(st.keys)
    if col >= MARKS:
        raise RuntimeError(f"spans: more than {MARKS} marks in one step")
    st.keys.append((name, opens))
    layout = _layout_id(tuple(st.keys)) if flags & kernels.SPAN_END else 0
    kernels.span_mark(st.ring.stamps, st.ring.count, col, flags, layout)


@contextlib.contextmanager
def _root(device):
    global _open
    _open = _Step(_ring(device))
    try:
        _mark(ROOT, True, kernels.SPAN_BEGIN)
        yield
        _mark(ROOT, False, kernels.SPAN_END)
    finally:
        _open = None


def step(device):
    """The root span of one train step on `device`; nothing with spans off
    or inside a step that is already open."""
    return _root(device) if _on and _open is None else _NULL


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _mark(self.name, True)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            _mark(self.name, False)


def span(name: str):
    """A forward span inside the open step (nothing outside one)."""
    return _NULL if _open is None else _Span(name)


def host(name: str):
    """A host range of the profiler's trace (record_function), with spans
    on."""
    return torch.profiler.record_function(name) if _on else _NULL


class _Boundary(torch.autograd.Function):
    """Identity; its backward marks the open or the close of a backward
    span when the gradient crosses it."""

    @staticmethod
    def forward(ctx, key, *xs):
        ctx.key = key
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if _open is not None:
            _mark(*ctx.key)
        return (None, *grads)


def _boundary(name: str, opens: bool, tensors: tuple) -> tuple:
    if _open is None:
        return tensors
    at = [i for i, t in enumerate(tensors)
          if t is not None and t.requires_grad]
    if not at or not torch.is_grad_enabled():
        return tensors
    out = list(tensors)
    got = _Boundary.apply(("bwd." + name, opens), *(tensors[i] for i in at))
    for i, t in zip(at, got):
        out[i] = t
    return tuple(out)


def outputs(name: str, *tensors) -> tuple:
    """The tensors that leave module `name`, unchanged; in the backward
    their gradient opens `bwd.<name>`.  Tensors that need no gradient (and
    None) pass as they are."""
    return _boundary(name, True, tensors)


def inputs(name: str, *tensors) -> tuple:
    """The tensors that enter module `name`, unchanged; in the backward
    their gradient leaving the module closes `bwd.<name>`."""
    return _boundary(name, False, tensors)


def _pairs(layout_id: int) -> list:
    """[(name, open col, close col, parent index)] in the order the spans
    open: each close pairs with the latest open of its name, and a span's
    parent is the latest-opened span that holds both of its marks."""
    if layout_id not in _structure:
        keys = _layouts[layout_id]
        opened, spans = {}, []
        for col, (name, opens) in enumerate(keys):
            if opens:
                opened.setdefault(name, []).append(len(spans))
                spans.append([name, col, None])
            elif opened.get(name):
                spans[opened[name].pop()][2] = col
        spans = [s for s in spans if s[2] is not None]
        out = []
        for i, (name, o, c) in enumerate(spans):
            parent = -1
            for j in range(i - 1, -1, -1):
                if spans[j][1] < o and spans[j][2] > c:
                    parent = j
                    break
            out.append((name, o, c, parent))
        _structure[layout_id] = out
    return _structure[layout_id]


def _only_ring(device):
    if device is not None:
        return _rings.get(_device(device))
    if len(_rings) > 1:
        raise ValueError("spans: steps on several devices: name one")
    return next(iter(_rings.values()), None)


def begun(device=None) -> int:
    """Steps begun so far: the index the next step will take (one host
    read of the device)."""
    ring = _only_ring(device)
    return 0 if ring is None else int(ring.count[0])


def read(first: int = 0, device=None) -> dict:
    """The spans of the complete steps from step `first` on (steps count
    from 0, in the order the device began them) that the ring still holds:

        {"steps": [{"index": i, "spans": [Span, ...]}, ...],
         "dropped": steps from `first` on that the ring no longer holds,
         "next": the index the next step will take,
         "clock": "globaltimer" (the card's, ns) or "perf_counter" (ns)}

    A step's spans are listed as they open, the root first.  One host
    read of the device (it waits for the work queued before it)."""
    ring = _only_ring(device)
    if ring is None:
        return {"steps": [], "dropped": 0, "next": 0, "clock": None}
    n = int(ring.count[0])
    lo = max(first, n - STEPS, 0)
    idx = list(range(lo, n))
    rows = (ring.stamps[torch.tensor([i % STEPS for i in idx],
                                     device=ring.device)].cpu().tolist()
            if idx else [])
    steps = []
    for i, row in zip(idx, rows):
        if row[0] < 0:
            continue  # begun, not complete
        stamps = row[1:]
        steps.append({"index": i, "spans": [
            Span(name, parent, stamps[o], stamps[c])
            for name, o, c, parent in _pairs(row[0])]})
    return {"steps": steps, "dropped": max(0, min(lo, n) - first),
            "next": n,
            "clock": "globaltimer" if ring.device.type == "cuda"
            else "perf_counter"}


def span_ms(steps) -> dict:
    """`span_<name>_ms`: each span name's ms per step (its spans' lengths
    summed in a step), the mean over the steps (utils/spans.read's)."""
    total = {}
    for st in steps:
        for s in st["spans"]:
            total[s.name] = total.get(s.name, 0) + s.end_ns - s.start_ns
    n = max(len(steps), 1)
    return {f"span_{name}_ms": ns / n / 1e6 for name, ns in total.items()}


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's self time: its length less the union of its children's
    intervals (clipped to it)."""
    kids: Dict[int, list] = {}
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append(s)
    out = []
    for i, s in enumerate(spans):
        covered, end = 0, s.start_ns
        for c in sorted(kids.get(i, []), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                end = hi
        out.append(s.end_ns - s.start_ns - covered)
    return out
