"""One run of one cell: set-up, the timed window, the optional trace, the
check against the reference, and the result.

Everything a cell is made of is found by name under the benchmark's root:
`workloads/<cell>.json` names its configuration (`configs/<name>.json`),
its traffic (`traffic/<name>.json`, whose `loop` names
`loops/<loop>.py` and whose `dataset` names `datasets/<name>.json`), its
start step, cycle, gradient scale and limits; its configuration may
name an adapter (`adapters/<name>.py`, `dss_point` where it names none),
which builds the program's objects, the start state's leaves past the
generator's own and the reference's trainer; each per-layer metric is
`metrics/<metric>.py` and each kernel's work count
`roofline/<kernel>.py`.  `BENCHMARK.json` says which metrics a cell
reports.  The timed loop runs whole cycles: at each cycle's start the
state (params, Adam's state, filters, step) is restored in place from a
snapshot taken at the start step, so that every run times the same steps
whatever its speed.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import check, generate, program, trace

ROOT = Path(__file__).resolve().parent
PEAK_F32 = 67e12  # H100 SXM, float32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12  # its HBM3
# A fault of the update for the control: optax's and torch's default
# betas in place of the configuration's
WRONG_BETAS = (0.9, 0.999)
DEFAULT_ADAPTER = "dss_point"


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    dataset: dict
    root: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _json(root / "workloads" / f"{name}.json")
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    return Cell(name, w, _json(root / "configs" / f"{w['config']}.json"),
                traffic, _json(root / "datasets" / f"{traffic['dataset']}.json"),
                root)


def load_module(path: Path):
    """The module in the file `path`, loaded once per process and kept in
    `sys.modules` under a name made from the whole path: a dataclass needs
    its module there, and two copies of the benchmark share no name."""
    path = Path(path).resolve()
    name = (f"benchmark_{path.stem.replace('.', '_')}_"
            f"{hashlib.sha1(str(path).encode()).hexdigest()[:12]}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def load_adapter(name: str, root: Path = ROOT):
    """`adapters/<name>.py` under the benchmark's root."""
    return load_module(root / "adapters" / f"{name}.py")


def adapter(cell: Cell):
    """The adapter that the cell's configuration names (`"adapter"`), the
    default where it names none."""
    return load_adapter(cell.config.get("adapter", DEFAULT_ADAPTER),
                        cell.root)


def make_data(cell: Cell, seed: int, device) -> dict:
    """The cell's data and start state from the seed (generate.py), with
    the adapter's extra leaves where it has any; with the configuration's
    `model.model_kwargs.n_scenes`, that many scenes stacked
    (`generate.make_scenes`)."""
    n_epochs = (int(cell.workload["cycle_steps"])
                // program.steps_per_epoch(cell))
    extra = getattr(adapter(cell), "extra_leaves", None)
    n_scenes = cell.config["model"]["model_kwargs"].get("n_scenes")
    if n_scenes is None:
        return generate.make(cell.config, cell.dataset, seed, device,
                             n_epochs, cell.workload["grad_rms"], extra)
    if extra is not None:
        raise ValueError(f"{cell.name}: the adapter's extra leaves and "
                         "n_scenes do not go together (the scenes stack "
                         "the generator's leaves only)")
    return generate.make_scenes(cell.config, cell.dataset, seed, device,
                                n_epochs, cell.workload["grad_rms"],
                                int(n_scenes))


def scenes(data: dict):
    """The number of scenes stacked in the data, None where it holds one
    scene unstacked."""
    return data.get("n_scenes")


def take_views(data: dict, x, views):
    """The views `views` of a tensor of the data with a view axis (`img`,
    `mask`, `depth`: axis 0, or axis 1 under the scene axis of stacked
    data); None stays None."""
    if x is None:
        return None
    return x[:, views] if scenes(data) is not None else x[views]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Loop:
    """The program's train state at the cell's start step, run in steps of
    `self.k` with the CLI's host reads at its print cadence.  A loop
    file subclasses it with `_setup` and `_dispatch`."""

    def __init__(self, cell: Cell, data: dict, device):
        self.cell, self.data, self.device = cell, data, device
        (self.settings, self.tcfg, self.schedule, self.state, self.cams,
         self.lights) = adapter(cell).program_objects(cell, data, device)
        self.spe = program.steps_per_epoch(cell)
        self.s0 = int(cell.workload["start_step"])
        self.cycle_steps = int(cell.workload["cycle_steps"])
        self.print_every = int(cell.config["training"]["print_every"])
        self.state.step = self.s0
        self.finite = []  # (params_finite tensor, steps it covers)
        self.done = 0  # steps run, for the print cadence
        self._setup()
        self._snap = self._save()

    def _setup(self):
        raise NotImplementedError

    def _dispatch(self, epoch):
        """Run self.k steps; returns the last step's metrics."""
        raise NotImplementedError

    def _tensors(self):
        """The state's tensors that the run updates in place."""
        raise NotImplementedError

    def _save(self):
        return [t.detach().clone() for t in self._tensors()]

    def restore(self):
        with torch.no_grad():
            for t, s in zip(self._tensors(), self._snap):
                t.copy_(s)
        self.state.step = self.s0

    def views(self, i: int) -> torch.Tensor:
        """The views of step i after the start."""
        return self.data["epochs"][i // self.spe][(self.s0 + i) % self.spe]

    def run_steps(self, n: int):
        """n steps from the current state, in dispatches of k, reading the
        metrics on the host where a multiple of print_every is crossed."""
        first = self.state.step - self.s0
        for i in range(first, first + n, self.k):
            m = self._dispatch(self.data["epochs"][i // self.spe])
            self.finite.append((m["params_finite"], self.k))
            before, self.done = self.done, self.done + self.k
            if self.done // self.print_every > before // self.print_every:
                # train_mvr's log line: every scalar read on the host
                self.printed = {k: float(v) for k, v in m.items()
                                if v.ndim == 0}
        return n

    def cycle(self) -> int:
        self.restore()
        return self.run_steps(self.cycle_steps)

    def failed(self) -> int:
        """Steps whose update the NaN guard skipped; a window whose
        params_finite reads false counts all its steps."""
        if not self.finite:
            return 0
        ok = torch.stack([f.reshape(()) for f, _ in self.finite]).cpu()
        return sum(n for (_, n), good in zip(self.finite, ok.tolist())
                   if not good)

    def first_steps(self, n: int) -> dict:
        """n steps from the start, one per call: each step's loss, Adam's
        moments after the first, the params at the start and after each
        step."""
        k, self.k = self.k, 1
        self.restore()
        tensors = self.state.params.tensors()
        start = [t.detach().clone() for t in tensors]
        losses, moments, ends = [], None, []
        for i in range(n):
            m = self._dispatch(self.data["epochs"][i // self.spe])
            losses.append(float(m["loss"]))
            if i == 0:
                st = self.state.optimizer.state
                moments = [(st[t]["exp_avg"].clone(),
                            st[t]["exp_avg_sq"].clone()) for t in tensors]
            ends.append([t.detach().clone() for t in tensors])
        self.k = k
        self.restore()
        return {"losses": losses, "moments": moments, "start": start,
                "ends": ends}

    def step_inputs(self, n: int):
        """What the work counts read before each of the first n steps of a
        cycle: the adapter's (points, normals, activation), the step's
        views and number."""
        k, self.k = self.k, 1
        self.restore()
        count_inputs = adapter(self.cell).count_inputs
        out = []
        for i in range(n):
            out.append((*count_inputs(self.state), self.views(i),
                        self.state.step))
            self._dispatch(self.data["epochs"][i // self.spe])
        self.k = k
        self.restore()
        return out


def _event(on_card: bool):
    if not on_card:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def reference_first_steps(cell: Cell, data: dict, n: int, tf32: bool = False,
                          fault=None) -> dict:
    """The reference's first n steps from the harness's start, as
    Loop.first_steps gives the program's, with each leaf's gradient of the
    first step and the trainer's betas and lr per leaf.  The adapter's
    trainer runs them.  `tf32` computes its matmuls in TF32 (the control);
    `fault` plants one of the faults a run must be caught in (see
    control.py)."""
    tr, cams, lights = adapter(cell).reference_trainer(
        cell, data, WRONG_BETAS if fault == "adam_betas" else None)
    s0 = int(cell.workload["start_step"])
    spe = program.steps_per_epoch(cell)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = [t.clone() for t in tr.params]
        losses, grad, moments, ends = [], None, None, []
        for i in range(n):
            v = data["epochs"][i // spe][(s0 + i) % spe]
            if fault == "half_batch":
                v = v[: max(1, len(v) // 2)]
            loss, _ = tr.train_step(cams.take(v), lights.take(v),
                                    *(take_views(data, data[k], v)
                                      for k in ("img", "mask", "depth")))
            if fault == "altered":
                loss = loss * (1.0 + 1e-3)
            losses.append(loss)
            if i == 0:
                grad, moments = tr.grads, list(zip(tr.mu, tr.nu))
            ends.append(list(tr.params))
        if fault == "unchanged":
            moments, ends = data["moments"], [start] * n
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"losses": losses, "grad": grad, "moments": moments,
            "start": start, "ends": ends, "betas": tuple(tr.betas),
            "lr": tuple(tr.lr)}


def compare(data: dict, prog: dict, refr: dict) -> dict:
    """The numbers that decide `correct` (check.py), with the reference's
    betas and the leaves that it trains (lr above 0), each scene of
    stacked data a leaf of its own."""
    return check.readings(prog, refr, data["moments"], refr["betas"],
                          [lr > 0 for lr in refr["lr"]],
                          scenes=scenes(data))


def benchmark_spec(root: Path) -> dict:
    path = root.parent / "BENCHMARK.json"
    return _json(path) if path.exists() else {}


def _metric_names(spec: dict, cell: str, kind: str):
    return [m for m in spec.get(kind, [])
            if cell in m.get("workloads", [cell])]


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device,
        root: Path = ROOT, t_start: float = None, spec: dict = None) -> dict:
    """One run; returns the result line's dict (without the JAX check)."""
    t_start = time.time() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if trace_on and not on_card:
        raise RuntimeError("a traced run reads device time: it needs a card")
    cell = load_cell(cell_name, root)
    spec = benchmark_spec(root) if spec is None else spec
    n_check = int(cell.workload["check_steps"])
    marks = [("import and load", time.time())]
    data = make_data(cell, seed, dev)
    sync(dev)
    marks.append(("data", time.time()))
    loop_cls = load_module(root / "loops" / f"{cell.traffic['loop']}.py").Loop
    drv = loop_cls(cell, data, dev)
    marks.append(("program", time.time()))
    prog = drv.first_steps(n_check)
    sync(dev)
    marks.append(("first steps", time.time()))
    drv.cycle()  # warm-up: every shape of the window, untimed
    sync(dev)
    marks.append(("warm-up cycle", time.time()))
    setup_s = time.time() - t_start
    ends = [t_start] + [t for _, t in marks]
    print("set-up: " + ", ".join(f"{name} {t - t0:.3f} s" for (name, t), t0
                                 in zip(marks, ends)), file=sys.stderr)

    # device events at cycle ends, read after the window: how the cycles'
    # times spread inside a run (standard error only)
    marks = [_event(on_card)]
    drv.finite.clear()  # `failed` counts the window's steps only
    t0 = time.perf_counter()
    steps = 0
    while True:
        steps += drv.cycle()
        marks.append(_event(on_card))
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    step_ms = window_s * 1e3 / steps
    if on_card:
        per = sorted(a.elapsed_time(b) / drv.cycle_steps
                     for a, b in zip(marks, marks[1:]))
        q = [per[int(f * (len(per) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
        print(f"cycles: {len(per)}, device ms per step min, quartiles, max "
              + " ".join(f"{x:.4f}" for x in q), file=sys.stderr)
    failed = drv.failed()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    summary, inputs = None, None
    if trace_on:
        n_prof = int(cell.traffic["profile_steps"])
        summary = profile(drv, n_prof, dev, root)
        inputs = drv.step_inputs(n_prof)

    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    if not trace_on:
        e2e = {"setup_s": setup_s, cell.traffic["step_metric"]: step_ms}
        for m in _metric_names(spec, cell_name, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "data": data, "summary": summary,
               "inputs": inputs, "step_ms": step_ms, "root": root,
               "peak_f32": PEAK_F32, "peak_bytes": PEAK_BYTES}
        for m in _metric_names(spec, cell_name, "per_layer"):
            value = load_module(root / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    refr = reference_first_steps(cell, data, n_check)
    values = compare(data, prog, refr)
    limits = cell.workload["limits"]
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
    }
    out = {"correct": check.verdict(values, limits),
           "attempted": steps, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace_on:
        device_info["busy_s"] = summary["busy_us"] * 1e-6
        device_info["window_s"] = summary["window_us"] * 1e-6
        out["breakdown"] = summary["breakdown"]
    out["compared"] = {k: {"value": values[k], "limit": limit}
                       for k, limit in limits.items()}
    return out


def profile(drv: Loop, n_steps: int, dev, root: Path) -> dict:
    """Trace n_steps from the start of a cycle with torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    drv.restore()
    sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drv.run_steps(n_steps)
        sync(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    dev_ev, host_ev = trace.events(prof)
    return trace.summarise(dev_ev, host_ev, window_us, n_steps,
                           trace.load_groups(root))

