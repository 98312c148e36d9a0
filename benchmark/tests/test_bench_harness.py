"""The harness on the CPU at a tiny size (64^2, 300 points, 16 views),
through its own functions: a run end to end and its result line, a cell
added as files only, the cycle's restore, and the faults a run must be
caught in."""
import json

import pytest
import torch

import tiny
from benchmark import check, generate, harness, program

SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(root, name="tiny.window"):
    return harness.run(name, SEED, 0.3, False, "cpu", root=root)


def test_bench_tiny_cell_prints_the_contract_line(tmp_path):
    root = tiny.make_copy(tmp_path)
    out = _run(root)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 4 == 0 and line["attempted"] >= 4
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert line["device"]["platform"] == "cpu"
    assert set(line["compared"]) <= set(check.NAMES)
    for c in line["compared"].values():
        assert 0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("overrides", [
    None, {"lean_fragments": False, "depth_channel": False}])
def test_bench_added_cell_is_found_by_name(tmp_path, overrides):
    """A cell added to a copy as files only (a config, a dataset, a
    traffic and a workload file, and its entry in BENCHMARK.json) runs
    with no code edit."""
    root = tiny.make_copy(tmp_path, overrides=overrides, name="tiny.added")
    cell = harness.load_cell("tiny.added", root)
    assert cell.dataset["n_views"] == 16
    assert program.run_config(cell)["renderer"]["raster_params"][
        "lean_fragments"] is (overrides is None)
    out = _run(root, "tiny.added")
    assert out["correct"] is True
    assert cell.traffic["step_metric"] in out["metrics"]


def test_bench_start_state_is_made_from_the_seed(tmp_path):
    """Adam's start state comes from the seed at the cell's scale, the
    same for the same seed, and both sides start from it."""
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell("tiny.window", root)
    a, b, c = (harness.make_data(cell, s, "cpu") for s in (SEED, SEED, 5))
    for (m, v), (m2, v2), (m3, _), rms in zip(
            a["moments"], b["moments"], c["moments"], tiny.GRAD_RMS):
        assert torch.equal(m, m2) and torch.equal(v, v2)
        assert not torch.equal(m, m3)
        assert bool((v >= m * m).all())
        assert 0.2 * rms < float(m.std()) < 0.8 * rms
    drv = harness.load_module(root / "loops" / "window.py").Loop(
        cell, a, torch.device("cpu"))
    st = drv.state.optimizer.state
    for t, (m, v) in zip(drv.state.params.tensors(), a["moments"]):
        assert torch.equal(st[t]["exp_avg"], m)
        assert torch.equal(st[t]["exp_avg_sq"], v)
        assert float(st[t]["step"]) == drv.s0


def test_bench_cycle_restore_is_bit_equal(tmp_path):
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell("tiny.window", root)
    data = harness.make_data(cell, SEED, "cpu")
    cls = harness.load_module(root / "loops" / "window.py").Loop
    drv = cls(cell, data, torch.device("cpu"))
    start = drv._save()
    drv.cycle()
    after_one = drv._save()
    assert any(not torch.equal(a, b) for a, b in zip(start, after_one))
    drv.restore()
    assert drv.state.step == drv.s0
    for a, b in zip(drv._save(), start):
        assert torch.equal(a, b)
    drv.cycle()
    for a, b in zip(drv._save(), after_one):
        assert torch.equal(a, b)


def _break_window(monkeypatch, fault):
    from dss_tpu_torch.training import trainer

    if fault == "unchanged":
        monkeypatch.setattr(trainer, "guarded_adam_", lambda *a, **k: None)
    elif fault == "half_batch":
        make = trainer.make_loss_fn

        def half(settings, cfg, schedule):
            fn = make(settings, cfg, schedule)

            def loss_fn(params, filters, cams, lights, img, mask, it,
                        depth=None):
                h = img.shape[0] // 2
                cut = lambda b: trainer.take_views(b, slice(0, h))
                return fn(params, filters, cut(cams), cut(lights), img[:h],
                          mask[:h], it, None if depth is None else depth[:h])
            return loss_fn
        monkeypatch.setattr(trainer, "make_loss_fn", half)
    elif fault == "adam_betas":
        adam = trainer.guarded_adam_

        def wrong_betas(optimizer, grads, finite):
            for group in optimizer.param_groups:
                group["betas"] = harness.WRONG_BETAS
            return adam(optimizer, grads, finite)
        monkeypatch.setattr(trainer, "guarded_adam_", wrong_betas)
    elif fault == "altered":
        post = trainer._post_render_loss

        def altered(*a, **k):
            total, parts = post(*a, **k)
            return total * (1.0 + 1e-3), parts
        monkeypatch.setattr(trainer, "_post_render_loss", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "adam_betas"])
def test_bench_a_broken_step_reads_not_correct(tmp_path, monkeypatch, fault):
    """The run's timed path broken underneath, the rest of the run as
    the benchmark drives it: `correct` comes out false.  (The cells run
    on one chip: there is no exchange between chips to leave out.)"""
    root = tiny.make_copy(tmp_path)
    _break_window(monkeypatch, fault)
    out = _run(root)
    assert out["correct"] is False, out["compared"]


def test_bench_limits_sit_between_the_readings():
    """Every cell's limits lie above the program's readings and below the
    control's, as PERF.md records them (benchmark/limits_readings.json)."""
    readings = json.loads((harness.ROOT / "limits_readings.json").read_text())
    for name in (n for n in readings if n != "about"):
        limits = harness.load_cell(name).workload["limits"]
        for key, r in readings[name].items():
            assert r["lower"] < limits[key] < r["upper"], (name, key)


def test_bench_reference_objects_follow_the_config():
    cell = harness.load_cell("dss_default.window")
    data = generate.make(
        {**cell.config, "renderer": {"raster_params": {
            **cell.config["renderer"]["raster_params"], "image_size": 16}},
         "model": {"model_kwargs": {"n_points_per_cloud": 40}}},
        {**cell.dataset, "n_views": 4}, 3, "cpu", 1)
    raster, recipe, cams, lights = program.reference_objects(cell, data)
    assert not raster.Vrk_invariant and not raster.Vrk_isotropic
    assert raster.cutoff_threshold == 0.5 and raster.depth_from_fragments
    assert recipe.limit_radii == 2.0 and recipe.lr == (0.01, 0.01, 0.0)
    assert recipe.milestones == (500 * 128, 800 * 128)
