"""The harness on the CPU at a tiny size (64^2, 300 points, 16 views),
through its own functions: a run end to end and its result line, a cell
added as files only, the cycle's restore, and the faults a run must be
caught in."""
import hashlib
import json
import math
import statistics

import pytest
import torch

import tiny
from benchmark import check, counts, generate, harness, program

SEED = 2 ** 31 + 12345
# The tiny cell at SEED, recorded: a SHA-256 prefix of each tensor's
# bytes of its data, and each number it compares (float repr).
TINY_DATA = {
    "R": "97dde5c840059b7b", "T": "1a32d6a96395df70",
    "lights:ambient_color": "e9ba60cc30669b57",
    "lights:diffuse_color": "58a0d8c174e9d2c3",
    "lights:specular_color": "1a0295f4bf5986c5",
    "lights:location": "28749b05b9993c19",
    "img": "c94f404e9de430f6", "mask": "7871851ad76559a1",
    "depth": "9022a71fded30a05",
    "leaves:points": "ce525d92c6923b99",
    "leaves:normals": "9b9d952e6ba03daa",
    "leaves:colors": "d9cc38ad35d2f383",
    "epochs": "70df363816f60c93",
    "moments:0:exp_avg": "39d7fc682e635db9",
    "moments:0:exp_avg_sq": "806ab45d5740f316",
    "moments:1:exp_avg": "eb2f40165116c842",
    "moments:1:exp_avg_sq": "bc14a184f0bf3c9b",
    "moments:2:exp_avg": "4428cc18158248d9",
    "moments:2:exp_avg_sq": "fb03da30180f7834",
}
TINY_COMPARED = {"loss_gap": "0.0", "grad_gap": "7.040695057461797e-09",
                 "sq_gap": "2.538606417174972e-08",
                 "change_gap": "1.910987486472272e-08"}

# The tiny cell's work tables (counts.step_tables) of its first two steps
# at SEED, and each roofline's (operations, bytes) on them (the jet's at
# k 48, the decoder's at IDR's widths), recorded
TINY_TABLES = [
    {"views": 4, "points": 300, "image_size": 64, "points_per_pixel": 5,
     "lean": True, "depth_channel": True, "rendered": 1200,
     "box_pairs": 10700, "disc_pairs": 6755, "on_screen": 1059,
     "knn": [(300, 300, 7), (300, 300, 11)]},
    {"views": 4, "points": 300, "image_size": 64, "points_per_pixel": 5,
     "lean": True, "depth_channel": True, "rendered": 1200,
     "box_pairs": 7937, "disc_pairs": 5034, "on_screen": 998,
     "knn": [(300, 300, 7), (300, 300, 11)]}]
TINY_WORK = {
    "fwd_lean": [(278200, 465216), (206362, 465216)],
    "fwd_frag": [None, None],
    "occ_bwd": [(108080, 96332), (80544, 95112)],
    "feat_bwd": [(256800, 414080), (190488, 414080)],
    "knn": [(1080000, 85200), (1080000, 85200)],
    "jet_anchor": [(3088800, 691200), (3088800, 691200)],
    "texture_mlp": [(5795020800, 69159168), (5795020800, 69159168)]}


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


def _small(cell, points=40):
    """The cell's configuration at 16^2 with `points` points."""
    return {**cell.config, "renderer": {"raster_params": {
        **cell.config["renderer"]["raster_params"], "image_size": 16}},
        "model": {"model_kwargs": {"n_points_per_cloud": points}}}


def test_bench_reference_objects_follow_the_config():
    cell = harness.load_cell("dss_default.window")
    ad = harness.adapter(cell)
    assert ad is harness.load_adapter(harness.DEFAULT_ADAPTER)
    data = generate.make(_small(cell), {**cell.dataset, "n_views": 4}, 3,
                         "cpu", 1)
    raster, recipe, cams, lights = ad.reference_objects(cell, data)
    assert not raster.Vrk_invariant and not raster.Vrk_isotropic
    assert raster.cutoff_threshold == 0.5 and raster.depth_from_fragments
    assert recipe.limit_radii == 2.0 and recipe.lr == (0.01, 0.01, 0.0)
    assert recipe.milestones == (500 * 128, 800 * 128)


def _fingerprint(data: dict) -> dict:
    """A SHA-256 prefix of the bytes of each tensor in the data."""
    h = lambda t: hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    out = {}
    for key, v in data.items():
        if isinstance(v, torch.Tensor):
            out[key] = h(v)
        elif isinstance(v, dict):
            out.update({f"{key}:{k}": h(t) for k, t in v.items()})
        elif isinstance(v, list):
            for i, (m, sq) in enumerate(v):
                out[f"{key}:{i}:exp_avg"] = h(m)
                out[f"{key}:{i}:exp_avg_sq"] = h(sq)
    return out


def test_bench_tiny_cell_reads_as_before_adapters(tmp_path):
    """The tiny cell's data and the numbers it compares, through the
    default adapter, are bit-equal to their recorded values."""
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell("tiny.window", root)
    assert _fingerprint(harness.make_data(cell, SEED, "cpu")) == TINY_DATA
    got = _run(root)["compared"]
    assert {k: repr(c["value"]) for k, c in got.items()} == TINY_COMPARED


def test_bench_tiny_cell_count_tables_as_recorded(tmp_path):
    """The tiny cell's work tables and each roofline's work on them are
    equal to their recorded values."""
    root = tiny.make_copy(tmp_path)
    cell = harness.load_cell("tiny.window", root)
    data = harness.make_data(cell, SEED, "cpu")
    drv = harness.load_module(root / "loops" / "window.py").Loop(
        cell, data, torch.device("cpu"))
    tables = counts.step_tables(cell, data, drv.step_inputs(2))
    assert tables == TINY_TABLES
    extra = {"jet_k": 48, "texture_widths": [33, 512, 512, 512, 512, 3]}
    for name, want in TINY_WORK.items():
        work = harness.load_module(root / "roofline" / f"{name}.py").work
        assert [work({**t, **extra}) for t in tables] == want, name


@pytest.mark.parametrize("scale", [None, 1e-3])
def test_bench_a_configuration_brings_its_own_adapter(tmp_path, scale):
    """A configuration added as files only names its own adapter, whose
    reference is a copy of reference/dss_step.py under another name: the
    cell runs end to end and reads correct; with that copy's loss scaled
    by (1 + scale) it reads not correct, so the run used the reference
    that the configuration named."""
    root = tiny.make_copy(tmp_path, name="tiny.own", adapter="own_point")
    ref_file = root / "reference" / "own_point_step.py"
    if scale is not None:
        text = ref_file.read_text()
        old = "        return total, parts, visibility, inmask\n"
        assert text.count(old) == 1
        ref_file.write_text(text.replace(old, (
            f"        return total * (1.0 + {scale!r}), parts, visibility, "
            "inmask\n")))
    cell = harness.load_cell("tiny.own", root)
    ad = harness.adapter(cell)
    assert ad.__file__ == str((root / "adapters" / "own_point.py").resolve())
    assert ad.REF.__file__ == str(ref_file.resolve())
    out = _run(root, "tiny.own")
    assert out["correct"] is (scale is None), out["compared"]


def _extra(config, g, device):
    """Three leaves of other shapes than the points', drawn from g."""
    return [("w1", torch.randn((4, 7), generator=g, device=device)),
            ("b1", torch.randn((7,), generator=g, device=device)),
            ("gain", torch.randn((), generator=g, device=device))]


def test_bench_extra_leaves_draw_last_in_their_own_shapes():
    """A dict grad_rms and an adapter's extra leaves: each leaf's Adam
    state in the leaf's shape at its own scale, and everything the
    generator made before bit-equal to a run without the extras."""
    cell = harness.load_cell("dss_depth.window")
    cfg, ds = _small(cell, 200), {**cell.dataset, "n_views": 8}
    rms = {"points": 1e-3, "normals": 4e-5, "colors": 5e-5, "w1": 2e-2,
           "b1": 3e-3, "gain": 7e-4}
    base = generate.make(cfg, ds, SEED, "cpu", 2,
                         [rms["points"], rms["normals"], rms["colors"]])
    got = generate.make(cfg, ds, SEED, "cpu", 2, rms, _extra)
    assert list(got["leaves"]) == list(rms)
    for name, leaf in base["leaves"].items():
        assert torch.equal(got["leaves"][name], leaf)
    for (m, v), (m0, v0) in zip(got["moments"], base["moments"]):
        assert torch.equal(m, m0) and torch.equal(v, v0)
    for key in ("R", "T", "img", "mask", "depth", "epochs"):
        assert torch.equal(got[key], base[key]), key
    assert [m.shape for m, _ in got["moments"][3:]] == [(4, 7), (7,), ()]
    for (name, leaf), (m, v) in zip(got["leaves"].items(), got["moments"]):
        assert m.shape == v.shape == leaf.shape, name
        assert bool((v >= m * m).all()), name
    w1_m = got["moments"][3][0]
    assert 0.2 * rms["w1"] < float(w1_m.std()) < 0.8 * rms["w1"]
    # a list in leaf order draws the same; too few scales, or a leaf's
    # name missing, raises
    listed = generate.make(cfg, ds, SEED, "cpu", 2, list(rms.values()),
                           _extra)
    for (m, v), (m2, v2) in zip(got["moments"], listed["moments"]):
        assert torch.equal(m, m2) and torch.equal(v, v2)
    with pytest.raises(ValueError):
        generate.make(cfg, ds, SEED, "cpu", 2, list(rms.values())[:3], _extra)
    with pytest.raises(ValueError):
        generate.make(cfg, ds, SEED, "cpu", 2,
                      {k: v for k, v in rms.items() if k != "b1"}, _extra)
    with pytest.raises(KeyError):
        generate.make(cfg, ds, SEED, "cpu", 2,
                      {("b2" if k == "b1" else k): v for k, v in rms.items()},
                      _extra)


def test_bench_readings_over_mixed_leaves_by_hand():
    """check.readings over five leaves of mixed shapes, the second and
    fourth frozen (lr 0) and the fifth with a gradient nought beside the
    median's, against the gaps worked out by hand.  Every leaf is a
    constant c times ones: its norm is |c| sqrt(n)."""
    shapes = [(4, 3), (5,), (2, 2, 2), (3, 3), (6,)]
    size = [12, 5, 8, 9, 6]
    lr = (0.01, 0.0, 0.01, 0.0, 0.01)
    b1, b2 = 0.5, 0.75
    ref_g = [1.0, 0.5, 0.25, 2.0, 2.0 ** -20]
    prog_g = [1.0 + 2.0 ** -10, 0.75, 0.25 - 2.0 ** -11, 4.0, 2.0 ** -19]
    ref_d = [2.0 ** -7, 2.0 ** -6, 2.0 ** -8, 2.0 ** -5, 2.0 ** -7]
    prog_d = [2.0 ** -7 + 2.0 ** -15, 0.0, 2.0 ** -8 - 2.0 ** -14, 0.0,
              2.0 ** -5]
    full = lambda c, shape: torch.full(shape, c, dtype=torch.float64)
    start_m = [(full(0.25, sh), full(0.5, sh)) for sh in shapes]
    prog = {"losses": [2.0, 1.5 + 2.0 ** -12, 1.0 - 2.0 ** -11],
            "moments": [(full((1 - b1) * g + b1 * 0.25, sh),
                         full((1 - b2) * g * g + b2 * 0.5, sh))
                        for g, sh in zip(prog_g, shapes)],
            "start": [full(0.0, sh) for sh in shapes],
            "ends": [[full(d, sh) for d, sh in zip(prog_d, shapes)]] * 3}
    ref = {"losses": [2.0, 1.5, 1.0],
           "grad": [full(g, sh) for g, sh in zip(ref_g, shapes)],
           "start": prog["start"],
           "ends": [[full(d, sh) for d, sh in zip(ref_d, shapes)]] * 3}
    got = check.readings(prog, ref, start_m, (b1, b2),
                         [x > 0 for x in lr])
    r3 = lambda n: math.sqrt(n)
    # gradients: the learned leaves' median norm is leaf 2's, 0.25 sqrt 8
    med = 0.25 * r3(8)
    grad = [2.0 ** -10, 2.0 ** -11 * r3(8) / med,
            2.0 ** -20 * r3(6) / med]
    # squares: median 0.25^2 sqrt 8, leaf 2's again
    med_sq = 0.0625 * r3(8)
    sq = [(1.0 + 2.0 ** -10) ** 2 - 1.0,
          (0.0625 - (0.25 - 2.0 ** -11) ** 2) * r3(8) / med_sq,
          (2.0 ** -38 - 2.0 ** -40) * r3(6) / med_sq]
    # changes over leaves 0 and 2 (leaf 4's gradient is under a thousandth
    # of the median's): median of their reference changes
    med_d = statistics.median([2.0 ** -7 * r3(12), 2.0 ** -8 * r3(8)])
    change = [2.0 ** -15 * r3(12) / max(2.0 ** -7 * r3(12), med_d),
              2.0 ** -14 * r3(8) / max(2.0 ** -8 * r3(8), med_d)]
    per = check.leaves(prog, ref, start_m, (b1, b2), [x > 0 for x in lr])
    assert per["grad"] == pytest.approx(grad, rel=1e-12)
    assert per["sq"] == pytest.approx(sq, rel=1e-9)
    assert per["change"] == pytest.approx(change, rel=1e-12)
    assert got == pytest.approx({"loss_gap": 2.0 ** -11,
                                 "grad_gap": max(grad), "sq_gap": max(sq),
                                 "change_gap": max(change)}, rel=1e-9)
