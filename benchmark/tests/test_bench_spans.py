"""benchmark/spans.py: its reductions on hand-made span records and
profiler rows, and the whole helper on the tiny CPU cell, where the
program's marks take the host's clock and no profiler pass runs."""
import pytest
import torch

import tiny
from benchmark import harness, spans

SEED = 2 ** 31 + 77

# one step, ns: the root 0-1000; the Vrk (its kNN inside), the prep, the
# binning, the raster, the composite, a loss and the regularizers (their
# kNN inside), the backward (two module spans and the engine's own
# time), the update
STEP = [("step", -1, 0, 1000),
        ("model.vrk", 0, 10, 60), ("geometry.knn", 1, 20, 50),
        ("render.prep", 0, 60, 100),
        ("splat.bin", 0, 100, 150), ("splat.raster", 0, 150, 250),
        ("render.composite", 0, 250, 270),
        ("loss.image", 0, 270, 300),
        ("loss.reg", 0, 300, 400), ("geometry.knn", 8, 310, 390),
        ("backward", 0, 400, 900), ("bwd.loss.image", 10, 410, 430),
        ("bwd.splat", 10, 430, 800), ("bwd.render.prep", 10, 800, 880),
        ("update", 0, 900, 990)]


def _shift(spans_, t):
    return [(n, p, a + t, b + t) for n, p, a, b in spans_]


def test_bench_spans_reduce_hand_made_steps():
    """Self times by group, the kNN and the update whole, the time in no
    module, and the gap from one step's end to the next one's start
    (consecutive steps only); the groups, the no-module time and the gap
    sum to the device's wall time per step."""
    steps = [{"index": 4, "spans": STEP},
             {"index": 5, "spans": _shift(STEP, 1200)},
             {"index": 7, "spans": _shift(STEP, 5000)}]
    got = spans.reduce(steps)
    ms = 1e-6
    assert got["render_ms"] == pytest.approx((50 - 30 + 40 + 20 + 80) * ms)
    assert got["splat_ms"] == pytest.approx((50 + 100 + 370) * ms)
    assert got["loss_ms"] == pytest.approx((30 + 100 - 80 + 20) * ms)
    assert got["geometry_knn_ms"] == pytest.approx((30 + 80) * ms)
    assert got["update_ms"] == pytest.approx(90 * ms)
    # the root's own 10 + 10 and backward's own 30
    assert got["no_module_ms"] == pytest.approx(50 * ms)
    assert got["backward_self_ms"] == pytest.approx(30 * ms)
    assert got["step_gap_ms"] == pytest.approx(200 * ms)
    parts = ("render_ms", "splat_ms", "loss_ms", "geometry_knn_ms",
             "update_ms", "no_module_ms")
    assert sum(got[k] for k in parts) == pytest.approx(got["step_ms"])
    assert got["step_ms"] == pytest.approx(1000 * ms)
    assert got["unknown"] == []
    assert spans.reduce([]) is None
    odd = spans.reduce([{"index": 0, "spans": STEP + [("mystery", 0, 995,
                                                       999)]}])
    assert odd["unknown"] == ["mystery"] and odd["step_gap_ms"] is None


def test_bench_spans_align_the_clocks_and_name_the_gaps():
    """Marks' rows 5 us after their stamps: the offset spreads by 0; the
    port's kernel inside bwd.splat and the top-k row inside the kNN count
    fully, a kernel half outside counts half; the longest idle gap inside
    bwd.splat is named by the innermost span, the program's host span over
    it and the host op."""
    steps = [{"index": 0, "spans": STEP}]
    off_us = 5.0
    stamps = sorted(t for s in STEP for t in (s[2], s[3]))
    dev = [("span_mark_kernel(long*)", t / 1e3 + off_us, t / 1e3 + off_us
            + 0.001) for t in stamps]
    dev += [("occ_bwd_kernel(float*)", 0.45 + off_us, 0.70 + off_us),
            ("fwd_lean_kernel(float*)", 0.20 + off_us, 0.30 + off_us),
            ("void at::native::mbtopk::gatherTopK<float>", 0.32 + off_us,
             0.38 + off_us)]
    host = [("window.replay", 5.0, 6.2), ("cudaGraphLaunch", 5.0, 6.1)]
    got = spans.align(steps, dev, host)
    assert got["marks"] == len(stamps)
    assert got["offset_spread_ns"] == pytest.approx(0.0, abs=1e-6)
    assert got["offset_ppm"] == pytest.approx(0.0, abs=1e-6)
    assert got["step_offset_spread_ns"] == pytest.approx(0.0, abs=1e-6)
    # bwd.splat, 0.370 us, holds device rows for 0.251 us
    assert got["idle_ms"]["bwd.splat"] == pytest.approx(0.119e-3, rel=1e-3)
    assert got["kernels_in_splat_pct"] == pytest.approx(
        100.0 * (0.25 + 0.05) / 0.35)
    assert got["topk_in_knn_pct"] == pytest.approx(100.0)
    # the widest space between device rows: after the K2 row, 5.70-5.80
    # us, in bwd.splat
    first = got["idle_gaps"][0]
    assert first["ms"] == pytest.approx(1e-4)
    assert first["device_span"] == "bwd.splat"
    assert first["host_span"] == "window.replay"
    assert first["host_op"] == "cudaGraphLaunch"
    assert spans.align(steps, dev[1:], host)["marks"] == len(stamps) - 1


def test_bench_spans_collect_on_the_tiny_cell(tmp_path):
    """The helper end to end on the CPU: a second loop with spans on, the
    metrics read from it (the launch time is None: no graph replays on
    the CPU), cached in ctx, the spans off again after it."""
    from dss_tpu_torch.utils import spans as program_spans

    torch.set_num_threads(2)
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell("tiny.window", root)
    ctx = {"cell": cell, "data": harness.make_data(cell, SEED, "cpu"),
           "root": root}
    got = spans.collect(ctx)
    assert not program_spans.enabled()
    assert spans.collect(ctx) is got
    for key in ("render_ms", "splat_ms", "loss_ms", "geometry_knn_ms",
                "update_ms", "step_gap_ms"):
        assert got[key] > 0, key
    assert got["launch_host_ms"] is None and got["unknown"] == []
    for name in ("render_ms", "splat_ms", "loss_ms", "geometry_knn_ms",
                 "update_ms", "step_gap_ms", "launch_host_ms"):
        mod = harness.load_module(root / "metrics" / f"{name}.window.py")
        assert mod.read(ctx) == got[name]
