"""Stacked scenes (`model.model_kwargs.n_scenes`, adapter
`multiscene_point`, reference `reference/multiscene_step.py`) on the CPU at
a tiny size: 2 scenes of 300 points at 64^2 (tile 16), 4 of 16 views per
step, through the harness's own functions.  The data of scene 0 is the
single-scene data of the seed; a two-scene cell added as files only runs
the port's eager stacked step (`stacked_loop.py`, copied in as a loop)
and reads correct, and reads not correct under each planted fault; the
reference steps S single-scene trainers as one; the work counts add up
over the scenes."""
import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

import tiny
from benchmark import check, counts, generate, harness, program

SEED = 2 ** 31 + 12345
NAME = "tiny.multi"
HERE = Path(__file__).resolve().parent
# The rooflines whose work adds up over the scenes of a folded step (not
# texture_mlp: a decoder's weights are read once a pass however many views
# it serves, and the stacked path takes no texture)
ROOFLINES = ("fwd_lean", "fwd_frag", "occ_bwd", "feat_bwd", "knn",
             "jet_anchor")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _multi_copy(dest: Path, n_scenes: int = 2) -> Path:
    """A copy of the benchmark with tiny.py's cell and, added as files
    only, a cell of `n_scenes` scenes: tiny.py's configuration with
    `n_scenes` and the adapter `multiscene_point`, and the test loop
    `stacked_loop.py` as `loops/stacked_eager.py` under a traffic of its
    own."""
    root = tiny.make_copy(dest)
    tiny.make_copy(dest, name=NAME)
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["adapter"] = "multiscene_point"
    cfg["model"]["model_kwargs"]["n_scenes"] = n_scenes
    (root / "configs" / "tiny_multi.json").write_text(json.dumps(cfg))
    shutil.copy(HERE / "stacked_loop.py", root / "loops" / "stacked_eager.py")
    traffic = json.loads((root / "traffic" / "tiny_window.json").read_text())
    traffic["loop"] = "stacked_eager"
    (root / "traffic" / "tiny_stacked.json").write_text(json.dumps(traffic))
    work = json.loads((root / "workloads" / f"{NAME}.json").read_text())
    work.update(config="tiny_multi", traffic="tiny_stacked")
    (root / "workloads" / f"{NAME}.json").write_text(json.dumps(work))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == NAME:
            w.update(config="tiny_multi", traffic="tiny_stacked")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _cell(tmp_path, n_scenes=2):
    root = _multi_copy(tmp_path, n_scenes)
    return root, harness.load_cell(NAME, root)


def test_bench_scene_zero_is_the_single_scene_data(tmp_path):
    """n_scenes 1: scene 0 of the stacked data is the seed's single-scene
    data bit for bit; 2 scenes: scene 1 is the single-scene data of its
    own seed, differs from scene 0 in ground truth, cameras, lights and
    start points, and shares its epochs."""
    root, cell = _cell(tmp_path, 1)
    single = harness.make_data(harness.load_cell("tiny.window", root), SEED,
                               "cpu")
    one = harness.make_data(cell, SEED, "cpu")
    assert harness.scenes(one) == 1 and harness.scenes(single) is None
    ad = harness.adapter(cell)

    def same(a, b):
        for key in ("R", "T", "img", "mask", "depth", "epochs"):
            assert torch.equal(a[key], b[key]), key
        for group in ("lights", "leaves"):
            assert list(a[group]) == list(b[group])
            for k in a[group]:
                assert torch.equal(a[group][k], b[group][k]), (group, k)
        for (m, v), (m2, v2) in zip(a["moments"], b["moments"], strict=True):
            assert torch.equal(m, m2) and torch.equal(v, v2)
        assert (a["fov"], a["znear"], a["zfar"]) == (
            b["fov"], b["znear"], b["zfar"])

    same(ad.scene(one, 0), single)
    two = harness.make_data(harness.load_cell(NAME, _multi_copy(
        tmp_path / "two")), SEED, "cpu")
    assert two["img"].shape[:2] == (2, 16)
    assert two["leaves"]["points"].shape == (2, 300, 3)
    assert two["moments"][0][0].shape == (2, 300, 3)
    assert two["lights"]["location"].shape == (2, 16, 3, 3)
    same(ad.scene(two, 0), single)
    other = generate.make(cell.config, cell.dataset,
                          generate.scene_seed(SEED, 1), "cpu",
                          int(cell.workload["cycle_steps"])
                          // program.steps_per_epoch(cell),
                          cell.workload["grad_rms"])
    same(ad.scene(two, 1), {**other, "epochs": single["epochs"]})
    for key in ("img", "mask", "depth", "R", "T"):
        assert not torch.equal(two[key][0], two[key][1]), key
    assert not torch.equal(two["lights"]["location"][0],
                           two["lights"]["location"][1])
    assert not torch.equal(two["leaves"]["points"][0],
                           two["leaves"]["points"][1])
    assert torch.equal(two["epochs"], single["epochs"])


def test_bench_scenes_refuse_extra_leaves(tmp_path):
    root, cell = _cell(tmp_path)
    cfg = dict(cell.config, adapter="neural_point")
    with pytest.raises(ValueError, match="n_scenes"):
        harness.make_data(harness.Cell(NAME, cell.workload, cfg, cell.traffic,
                                       cell.dataset, root), SEED, "cpu")


def test_bench_two_scene_cell_runs_as_files(tmp_path):
    """The two-scene cell, added as files only (no file of the benchmark
    changed but BENCHMARK.json's lists), runs through harness.run and
    reads correct."""
    root, _ = _cell(tmp_path)
    before = _digests(harness.ROOT)
    after = _digests(root)
    changed = [k for k, h in before.items() if k in after and after[k] != h]
    assert changed == []
    assert {"adapters/multiscene_point.py",
            "reference/multiscene_step.py"} <= set(before)
    out = harness.run(NAME, SEED, 0.3, False, "cpu", root=root)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    print(NAME, {k: c["value"] for k, c in out["compared"].items()})


def _break_stacked(monkeypatch, fault):
    """Plant a fault in the program's stacked step."""
    from dss_tpu_torch.training import trainer

    make = trainer.make_stacked_loss_fn

    def wrap(change):
        def factory(settings, cfg, schedule):
            fn = make(settings, cfg, schedule)

            def loss_fn(params, filters, cams, lights, img, mask, it,
                        depth=None):
                return change(fn, params, filters, cams, lights, img, mask,
                              it, depth)
            return loss_fn
        monkeypatch.setattr(trainer, "make_stacked_loss_fn", factory)

    if fault == "scene_swap":
        # scene 1 trained on scene 0's ground truth
        def swap(fn, params, filters, cams, lights, img, mask, it, depth):
            first = lambda x: None if x is None else torch.stack([x[0], x[0]])
            return fn(params, filters, cams, lights, first(img), first(mask),
                      it, first(depth))
        wrap(swap)
    elif fault == "summed":
        def summed(fn, params, filters, *args):
            total, rest = fn(params, filters, *args)
            return total * params.points.shape[0], rest
        wrap(summed)
    elif fault == "half_batch":
        # half of each scene's views left out, the mean over the rest
        def half(fn, params, filters, cams, lights, img, mask, it, depth):
            h = img.shape[1] // 2
            cut = lambda bs: [trainer.take_views(b, slice(0, h)) for b in bs]
            return fn(params, filters, cut(cams), cut(lights), img[:, :h],
                      mask[:, :h], it, None if depth is None else depth[:, :h])
        wrap(half)
    elif fault == "unchanged":
        monkeypatch.setattr(trainer, "guarded_adam_", lambda *a, **k: None)
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


@pytest.mark.parametrize("fault", ["scene_swap", "summed", "unchanged",
                                   "half_batch", "altered", "adam_betas"])
def test_bench_two_scene_broken_step_reads_not_correct(tmp_path, monkeypatch,
                                                       fault):
    """The program's stacked step broken underneath, the rest of the run
    as the benchmark drives it: `correct` comes out false."""
    root, _ = _cell(tmp_path)
    _break_stacked(monkeypatch, fault)
    out = harness.run(NAME, SEED, 0.3, False, "cpu", root=root)
    print(fault, {k: c["value"] for k, c in out["compared"].items()})
    assert out["correct"] is False, out["compared"]


def _first_step(tr, cams, lights, data, views):
    take = lambda key: harness.take_views(data, data[key], views)
    loss, parts = tr.train_step(cams.take(views), lights.take(views),
                                take("img"), take("mask"), take("depth"))
    return loss, parts, [g.clone() for g in tr.grads], [
        p.clone() for p in tr.params]


def _halved(tr):
    """A single-scene trainer whose loss is halved before its gradient."""
    loss = tr.loss
    tr.loss = lambda *a: (lambda total, *rest: (total * 0.5, *rest))(*loss(*a))
    return tr


@pytest.mark.parametrize("n_scenes,clip", [(1, True), (2, True), (2, False)])
def test_bench_multiscene_reference_steps_single_scene_trainers(
        tmp_path, n_scenes, clip):
    """At S = 1 the reference's step is dss_step's bit for bit.  At S = 2
    each scene's gradient and step are those of dss_step's trainer on that
    scene with its loss halved, and the loss is the scenes' mean; without
    the clip of the points' screen gradient (a row's norm clipped to
    clip_pts_grad, which halving moves), each scene's gradient is
    dss_step's, halved (by a power of two: exact)."""
    root, cell = _cell(tmp_path, n_scenes)
    if not clip:
        cfg = json.loads(json.dumps(cell.config))
        cfg["renderer"]["raster_params"]["clip_pts_grad"] = -1.0
        cell = harness.Cell(NAME, cell.workload, cfg, cell.traffic,
                            cell.dataset, root)
    data = harness.make_data(cell, SEED, "cpu")
    ad = harness.adapter(cell)
    base = harness.load_adapter("dss_point", root)
    v = data["epochs"][0][int(cell.workload["start_step"])
                          % program.steps_per_epoch(cell)]
    loss, parts, grads, params = _first_step(*ad.reference_trainer(cell, data),
                                             data, v)

    def single(s, halve):
        tr, cams, lights = base.reference_trainer(cell, ad.scene(data, s))
        return _first_step(_halved(tr) if halve else tr, cams, lights,
                           ad.scene(data, s), v)

    if n_scenes == 1:
        s_loss, s_parts, s_grads, s_params = single(0, False)
        assert loss == s_loss and parts == s_parts
        for a, b in zip(grads + params, s_grads + s_params, strict=True):
            assert torch.equal(a[0], b)
        return
    whole = [single(s, False) for s in range(n_scenes)]
    assert loss == pytest.approx(sum(w[0] for w in whole) / 2, rel=1e-6)
    for s in range(n_scenes):
        if clip:
            _, _, h_grads, h_params = single(s, True)
            for a, b in zip(grads + params, h_grads + h_params, strict=True):
                assert torch.equal(a[s], b)
        else:
            for g, sg in zip(grads, whole[s][2], strict=True):
                assert torch.equal(g[s], sg * 0.5)


def test_bench_two_scene_count_table_is_the_scenes_sum(tmp_path):
    """The step's table of two scenes is the sum of each scene's own table
    (each from the single-scene data of that scene), and every roofline's
    work on it the sum of its work on the scenes' tables."""
    root, cell = _cell(tmp_path)
    data = harness.make_data(cell, SEED, "cpu")
    ad = harness.adapter(cell)
    single = harness.load_cell("tiny.window", root)
    views = data["epochs"][0][0]
    leaves = [data["leaves"][n] for n in ("points", "normals")]
    act = torch.ones(leaves[0].shape[:2], dtype=torch.bool)
    (got,) = counts.step_tables(cell, data, [(*leaves, act, views, 3200)])
    per = [counts.step_tables(single, ad.scene(data, s),
                              [(leaves[0][s], leaves[1][s], act[s], views,
                                3200)])[0] for s in range(2)]
    a, b = per
    assert a["box_pairs"] != b["box_pairs"]
    for key in ("views", "points", "rendered", "box_pairs", "disc_pairs",
                "on_screen"):
        assert got[key] == a[key] + b[key], key
    assert got["knn"] == a["knn"] + b["knn"]
    assert got["scenes"] == 2
    assert counts.view_points(got) == (counts.view_points(a)
                                       + counts.view_points(b))
    extra = {"jet_k": 48}
    for name in ROOFLINES:
        work = harness.load_module(harness.ROOT / "roofline"
                                   / f"{name}.py").work
        w, wa, wb = (work({**t, **extra}) for t in (got, a, b))
        if w is None:
            assert wa is None and wb is None, name
        else:
            assert w == (wa[0] + wb[0], wa[1] + wb[1]), name


def test_bench_check_takes_each_scene_as_a_leaf():
    """Two scenes stacked in one leaf, scene 1's gradient a tenth of scene
    0's and read double: the stacked norm's gap is under 2%, each scene's
    slice as a leaf of its own reads scene 1's whole gap."""
    b1, b2 = 0.5, 0.75
    ref_g = torch.stack([torch.ones(4, 3), torch.full((4, 3), 0.1)])
    prog_g = torch.stack([torch.ones(4, 3), torch.full((4, 3), 0.2)])
    zero = torch.zeros_like(ref_g)
    moments = lambda g: [((1 - b1) * g, (1 - b2) * g * g)]
    prog = {"losses": [1.0], "moments": moments(prog_g), "start": [zero],
            "ends": [[zero]]}
    ref = {"losses": [1.0], "grad": [ref_g], "start": [zero], "ends": [[zero]]}
    start = [(zero, zero)]
    whole = check.readings(prog, ref, start, (b1, b2), [True])
    per = check.readings(prog, ref, start, (b1, b2), [True], scenes=2)
    assert whole["grad_gap"] < 0.02
    # scene 1's gap over the larger of its norm and the median of the two
    # scenes' norms: 0.1 sqrt(12) over 0.55 sqrt(12)
    assert per["grad_gap"] == pytest.approx(0.1 / 0.55, rel=1e-6)


def test_bench_the_multiscene_reference_loads_nothing_of_the_program(
        tmp_path):
    """The two-scene cell's data and the reference's first steps, in a
    process of their own: nothing of the program, of JAX or of the JAX
    package is loaded."""
    from test_bench_imports import ROOT, TOP, _modules

    mods = _modules(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(HERE)!r}]
        from pathlib import Path
        import torch
        torch.set_num_threads(2)
        import test_bench_multiscene as m
        from benchmark import harness
        root = m._multi_copy(Path({str(tmp_path)!r}))
        cell = harness.load_cell(m.NAME, root)
        data = harness.make_data(cell, 5, "cpu")
        assert harness.scenes(data) == 2
        harness.reference_first_steps(cell, data, 2)
        print({TOP})
    """)
    assert not mods & {"dss_tpu_torch", "dss_tpu", "jax", "jaxlib", "flax"}
