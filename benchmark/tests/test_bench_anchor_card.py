"""On a card, at the cell's own size: `dss_jet.window`'s control (the
reference computed with TF32 matmuls, put in the program's place), the
planted faults of control.py and the anchor's two (the normal term
dropped from the reference; one jet pass in place of two), each against
the clean reference, read not correct by the cell's limits; the gradient's
square and the parameters' change are each read above their own limit by
every fault that moves them (the loss altered by a part in a thousand
moves neither: Adam's step does not see a scale).  A third reading, the
reference with torch's lower-middle median in place of the mean of the
two middle values, is printed and not gated: the median only scales the
bilateral weights, and the gaps it leaves may lie under the limits.

And the rows that `anchor_ms.window` reads in `dss_jet.window` are the
anchor's alone: its pattern picks cuBLAS's kernels by their names, which
cuBLAS chooses by shape, and a traced window of the cell without its
normal term, or of the flagship, launches none.  Skips where there is no
card."""
import dataclasses

import pytest
import torch

from benchmark import check, control, harness

SEED = 2 ** 31 + 99
FAULTS = {"anchor_dropped": dict(weight=0.0),
          "one_jet_pass": dict(jet_passes=1)}
REPORTED = {"lower_median": dict(median="lower")}
# control.py's faults that move the first step's gradient, its square and
# the parameters' change
MOVING = ("half_batch", "adam_betas", "unchanged")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the cell's size and the device "
                    "trace exist only there")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_bench_jet_control_and_faults_read_not_correct(monkeypatch):
    dev = _card()
    cell = harness.load_cell("dss_jet.window")
    limits = cell.workload["limits"]
    row = control.readings_for(cell, SEED, dev, False, True)
    for key in ["control_tf32", *control.FAULTS]:
        print(f"{key}: {row[key]} (limits {limits})")
        assert not check.verdict(row[key], limits), (key, row[key])
    for key in MOVING:
        for name in ("sq_gap", "change_gap"):
            assert row[key][name] > limits[name], (key, row[key])

    data = harness.make_data(cell, SEED, dev)
    n = int(cell.workload["check_steps"])
    clean = harness.reference_first_steps(cell, data, n)
    args = (data["moments"], clean["betas"], [lr > 0 for lr in clean["lr"]])
    ad = harness.adapter(cell)
    base = ad.anchor_of
    got = {}
    for name, change in {**FAULTS, **REPORTED}.items():
        monkeypatch.setattr(ad, "anchor_of", lambda c, change=change:
                            dataclasses.replace(base(c), **change))
        got[name] = check.readings(
            harness.reference_first_steps(cell, data, n), clean, *args)
    monkeypatch.setattr(ad, "anchor_of", base)
    for name, values in got.items():
        print(f"{name}: {values} (limits {limits})")
    for name in FAULTS:
        # each number alone: every limit of the cell sees both faults
        for key, limit in limits.items():
            assert got[name][key] > limit, (name, key, got[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name,term", [("dss_jet.window", True),
                                       ("dss_jet.window", False),
                                       ("dss_depth.window", False)])
def test_bench_only_the_anchor_launches_its_rows(name, term):
    """A traced window of the cell's own profile steps, as a traced run
    takes it: rows match `anchor_ms.window`'s pattern in `dss_jet.window`,
    and none once its normal term is taken out (lambda_dr_normal 0) or in
    the flagship.  Other cells' shapes do make cuBLAS pick such kernels
    (`dss_default.window` a 32x32x8 GEMM, `dss_neural.window` a
    strided-batched GEMV), so the metric reads `dss_jet.window` alone."""
    dev = _card()
    pattern = harness.load_module(
        harness.ROOT / "metrics" / "anchor_ms.window.py").PATTERN
    cell = harness.load_cell(name)
    if name == "dss_jet.window" and not term:
        cell = harness.adapter(cell).without_normal_term(cell)
    data = harness.make_data(cell, SEED, dev)
    loop = harness.load_module(
        harness.ROOT / "loops" / f"{cell.traffic['loop']}.py").Loop
    drv = loop(cell, data, dev)
    drv.cycle()  # the graph's capture and every shape, untraced
    summary = harness.profile(drv, int(cell.traffic["profile_steps"]), dev,
                              harness.ROOT)
    rows = [k for k in summary["name_us"] if pattern.search(k)]
    assert summary["name_us"] and bool(rows) == term, rows
