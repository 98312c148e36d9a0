"""The stacked scenes through the benchmark's own window loop
(`loops/window.py`: `trainer.make_train_window` over the stacked state, as
the cell `dss_multiscene.window` runs it) on the CPU at a tiny size: 2
scenes of 300 points at 64^2 (tile 16), 4 of 16 views per step.  The
two-scene cell, added as files only, reads correct through `harness.run`
against `reference/multiscene_step.py`, and not correct under each
planted fault; `dss_multiscene`'s files differ from the flagship's only
where the cell means them to; `knn_roofline_pct.window` reads the kNN
rows of a trace against `roofline/knn.py`, and nothing where there are
none."""
import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from test_bench_anchor import KNN
from test_bench_multiscene import NAME, SEED, _break_stacked, _multi_copy

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _window_copy(dest: Path) -> Path:
    """test_bench_multiscene's two-scene cell, driven by the benchmark's
    own window loop (the traffic `tiny_window`) in place of the eager
    test loop."""
    root = _multi_copy(dest)
    path = root / "workloads" / f"{NAME}.json"
    work = json.loads(path.read_text())
    work["traffic"] = "tiny_window"
    path.write_text(json.dumps(work))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == NAME:
            w["traffic"] = "tiny_window"
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_bench_two_scene_window_cell_reads_correct(tmp_path):
    """The two-scene cell through loops/window.py and harness.run: the
    window is the stacked one, and the run reads correct."""
    root = _window_copy(tmp_path)
    cell = harness.load_cell(NAME, root)
    assert cell.traffic["loop"] == "window"
    data = harness.make_data(cell, SEED, "cpu")
    loop = harness.load_module(root / "loops" / "window.py").Loop(
        cell, data, torch.device("cpu"))
    assert loop.window.stacked and not loop.window.graph
    out = harness.run(NAME, SEED, 0.3, False, "cpu", root=root)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    print(NAME, {k: c["value"] for k, c in out["compared"].items()})


@pytest.mark.parametrize("fault", ["scene_swap", "summed", "unchanged",
                                   "half_batch", "altered", "adam_betas"])
def test_bench_two_scene_window_broken_step_reads_not_correct(
        tmp_path, monkeypatch, fault):
    """The program's stacked step broken underneath the window (the
    faults of test_bench_multiscene), the run as the benchmark drives it:
    `correct` comes out false."""
    root = _window_copy(tmp_path)
    _break_stacked(monkeypatch, fault)
    out = harness.run(NAME, SEED, 0.3, False, "cpu", root=root)
    print(fault, {k: c["value"] for k, c in out["compared"].items()})
    assert out["correct"] is False, out["compared"]


def test_bench_multiscene_config_is_the_flagship_stacked():
    """dss_multiscene's configuration is dss_depth's but for its
    provenance, n_scenes 4 of 25,000 points, the stacked adapter and the
    binning's 8192 slots; its cell runs the flagship's traffic and start,
    one epoch a cycle, on one chip, and reports the metrics that read it."""
    load = lambda p: json.loads((BENCH / p).read_text())
    depth, multi = (load(f"configs/{n}.json")
                    for n in ("dss_depth", "dss_multiscene"))
    free = {"source", "source_notes", "assumed", "name", "adapter"}
    assert {k: v for k, v in multi.items() if k not in free | {
        "renderer", "model"}} == {k: v for k, v in depth.items()
                                  if k not in free | {"renderer", "model"}}
    assert multi["adapter"] == "multiscene_point" and multi["reduced"] == []
    raster = dict(depth["renderer"]["raster_params"], bin_capacity=8192)
    assert multi["renderer"] == dict(depth["renderer"], raster_params=raster)
    kw = dict(depth["model"]["model_kwargs"], n_points_per_cloud=25000,
              n_scenes=4)
    assert multi["model"] == dict(depth["model"], model_kwargs=kw)
    cell = harness.load_cell("dss_multiscene.window")
    flag = harness.load_cell("dss_depth.window")
    assert cell.traffic == flag.traffic
    for key in ("start_step", "cycle_steps"):
        assert cell.workload[key] == flag.workload[key]
    assert len(cell.workload["grad_rms"]) == 3
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (entry,) = [w for w in spec["workloads"]
                if w["name"] == "dss_multiscene.window"]
    assert entry["chips"] == 1 and entry["config"] == "dss_multiscene"
    reads = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
             if "dss_multiscene.window" in m.get("workloads", [])}
    assert {"train_step_ms", "step_mfu_pct.window",
            "occ_bwd_roofline_pct.window",
            "knn_roofline_pct.window"} <= reads
    assert not reads & {"texture_gemm_ms.window", "anchor_ms.window"}


def _ctx(name_us, steps, tables):
    return {"summary": {"name_us": name_us, "steps": steps},
            "tables": tables, "root": BENCH, "peak_f32": 67e12,
            "peak_bytes": 3.35e12}


def test_bench_knn_roofline_reads_the_knn_rows():
    """By hand: two steps, each with a 25,000^2 11-NN and a 4096 x 25,000
    7-NN of each of two scenes, and 6 ms of knn_topk_kernel rows a step;
    the share is the kNNs' least time over 6 ms.  No kNN row (a trace of
    another kernel only): nothing."""
    knn = harness.load_module(BENCH / "roofline" / "knn.py")
    metric = harness.load_module(BENCH / "metrics"
                                 / "knn_roofline_pct.window.py")
    calls = [(4096, 25000, 7), (25000, 25000, 11)] * 2
    table = {"knn": calls}
    ops, n_bytes = knn.work(table)
    assert ops == 2 * 3 * 2 * (4096 + 25000) * 25000
    want = 100.0 * max(ops / 67e12, n_bytes / 3.35e12) * 1e3 / 6.0
    rows = {KNN.format(1): 9000.0, KNN.format(2): 3000.0,
            "(anonymous namespace)::occ_bwd_kernel(float*)": 5000.0}
    got = metric.read(_ctx(rows, 2, [table, table]))
    assert got == pytest.approx(want, rel=1e-12) and 0 < got < 100
    assert metric.read(_ctx({"occ_bwd_kernel(float*)": 5.0}, 2,
                            [table])) is None
    assert metric.read(_ctx({}, 0, [table]) | {"summary": None}) is None
