"""The numbers that decide `correct`: the first steps of a run against the
plain reference's, from the same start (the data's parameters and Adam
state) and on the same views.  A cell compares the numbers its workload
file gives limits for.  Only the leaves that the configuration trains
(lr above 0) count.

- `loss_gap`: the largest |loss - reference loss| / |reference loss| over
  the steps;
- `grad_gap`: per leaf, | |g| - |g_ref| | of the first step's gradient
  over the larger of the leaf's |g_ref| and the median leaf's; g is read
  from the optimizer's state after that step as
  (exp_avg - b1 exp_avg_start) / (1 - b1), with the reference's b1;
  the largest over the leaves;
- `sq_gap`: the same for the gradient's square, read from exp_avg_sq
  with the reference's b2, against g_ref^2;
- `change_gap`: the same for the parameters' change over the first
  step, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf with a gradient nought to rounding moves
  by round-off alone).  The change after later steps is not compared:
  round-off in the first step's parameters flips a few of the next
  renders' discrete choices (which splats a pixel keeps), and those
  changes spread over three orders of magnitude from seed to seed
  (PERF.md); the later steps' losses are compared.

With S scenes stacked along the leaves' leading axis, each scene's slice of
a leaf counts as a leaf of its own: the median and the largest gap run
over the (leaf, scene) slices, so that one wrong scene cannot hide in the
norm of a stacked leaf.
"""
from __future__ import annotations

import statistics

import torch

NAMES = ("loss_gap", "grad_gap", "sq_gap", "change_gap")


def _norms(ts):
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def _gaps(got, want, keep):
    """Per kept leaf: | |got| - |want| | over the larger of |want| and the
    median kept leaf's |want|."""
    kept = [w for w, k in zip(want, keep) if k]
    med = statistics.median(kept) if kept else 0.0
    return [abs(g - w) / max(w, med) for g, w, k in zip(got, want, keep)
            if k and max(w, med) > 0] or [0.0]


def _by_scene(prog: dict, ref: dict, start_moments, learned, n: int):
    """The arguments of `leaves` with each leaf cut into its n scene
    slices (leaf-major): a leaf of its own each."""
    cut = lambda ts: [t[s] for t in ts for s in range(n)]
    pairs = lambda ms: [(m[s], v[s]) for m, v in ms for s in range(n)]
    run = lambda r: {**r, "start": cut(r["start"]),
                     "ends": [cut(e) for e in r["ends"]]}
    return ({**run(prog), "moments": pairs(prog["moments"])},
            {**run(ref), "grad": cut(ref["grad"])}, pairs(start_moments),
            [k for k in learned for _ in range(n)])


def leaves(prog: dict, ref: dict, start_moments, betas, learned,
           change_after: int = 1, scenes: int = None) -> dict:
    """Per-leaf gaps of the first gradient, its square and the change
    over the first `change_after` steps.
    prog and ref: {"losses": [...], "moments": [(exp_avg, exp_avg_sq)],
    "start": [leaves], "ends": [[leaves] after each step]}, ref also
    "grad": [leaves] of its first step; start_moments: Adam's state both
    started from; learned: a flag per leaf; scenes: the number of scenes
    stacked along every leaf's leading axis, each slice then a leaf of
    its own (None: the leaves whole)."""
    if scenes is not None:
        prog, ref, start_moments, learned = _by_scene(
            prog, ref, start_moments, learned, scenes)
    b1, b2 = betas
    grad = [(m - b1 * m0) / (1.0 - b1)
            for (m, _), (m0, _) in zip(prog["moments"], start_moments)]
    sq = [(v - b2 * v0) / (1.0 - b2)
          for (_, v), (_, v0) in zip(prog["moments"], start_moments)]
    g_ref = _norms(ref["grad"])
    med = statistics.median(g for g, k in zip(g_ref, learned) if k)
    moved = [k and g >= 1e-3 * med for g, k in zip(g_ref, learned)]
    change = lambda r: _norms([e - s for s, e in zip(
        r["start"], r["ends"][change_after - 1])])
    return {"grad": _gaps(_norms(grad), g_ref, learned),
            "sq": _gaps(_norms(sq), _norms([g * g for g in ref["grad"]]),
                        learned),
            "change": _gaps(change(prog), change(ref), moved)}


def readings(prog: dict, ref: dict, start_moments, betas, learned,
             change_after: int = 1, scenes: int = None) -> dict:
    """The numbers of NAMES, the losses over the steps that prog and ref
    hold."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    per = leaves(prog, ref, start_moments, betas, learned, change_after,
                 scenes)
    return {"loss_gap": max(losses), "grad_gap": max(per["grad"]),
            "sq_gap": max(per["sq"]), "change_gap": max(per["change"])}


def first(run: dict, n: int) -> dict:
    """A run's record cut to its first n steps."""
    return {**run, "losses": run["losses"][:n], "ends": run["ends"][:n]}


def verdict(values: dict, limits: dict) -> bool:
    """True where every number the limits name is finite and within its
    limit."""
    return all(values[k] == values[k] and values[k] <= limit
               for k, limit in limits.items())
