"""The train step's spans (dss_tpu_torch/utils/spans.py) on the CPU, at
32², 300 points: off they record nothing and add no autograd node; on,
the numbers are bit-equal to off (lean, fragment and anisotropic-Vrk
paths), every step of a window has the step's tree, self times are the
spans less their children, the ring reports the steps it dropped, and
`train_mvr --profile-dir` writes spans.json and logs span_<name>_ms.

On the CPU a mark is span_mark_plain (the host's perf_counter_ns); the
kernel and the CUDA graph are the card's (tests/test_torch_cuda.py)."""
import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as train_mvr
from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                            look_at_view_transform)
from dss_tpu_torch.models.decoders import RenderingNetwork
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.render.texture import NeuralTexture
from dss_tpu_torch.training import trainer
from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                            create_train_state,
                                            make_loss_fn, make_optimizer,
                                            make_train_step,
                                            make_train_window)
from dss_tpu_torch.utils import spans

torch.set_num_threads(2)

S, V_ALL, P = 32, 6, 300
LEAN = RasterSettings(image_size=S, tile_size=16, points_per_pixel=5,
                      Vrk_invariant=True, Vrk_isotropic=False,
                      backface_culling=False, depth_channel=True,
                      max_tiles_per_splat=1)
PATHS = {
    "lean": LEAN,
    # depth from the nearest fragment's z: K5, and K4 in the backward
    "fragment": dataclasses.replace(LEAN, lean_fragments=False,
                                    depth_channel=False),
    # the default recipe's Vrk: 8-NN PCA frames and the eigensolver
    "anisotropic": dataclasses.replace(LEAN, Vrk_invariant=False),
}
CFG = TrainConfig(lambda_proj=0.01, lambda_repel=0.1, lambda_depth=0.1)
SCHEDULE = AnnealSchedule(steps_backward_radii=2)
ROWS = [[0, 1], [2, 3], [4, 5]]
# the step's tree (Tentpole of the spans): the forward modules in order,
# then the backward's spans, then the update
FORWARD = ["model.vrk", "render.prep", "splat.bin", "splat.raster",
           "splat.bin", "render.composite", "render.composite",
           "loss.image", "loss.reg", "backward", "update"]
BACKWARD = {"bwd.loss.reg", "bwd.loss.image", "bwd.render.composite",
            "bwd.splat", "bwd.render.prep"}


@pytest.fixture(autouse=True)
def _off():
    spans.disable()
    yield
    spans.disable()


@pytest.fixture(scope="module")
def scene():
    """6 views of a 600-point sphere at 32² and a 300-point start cloud."""
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((600, 3)).astype(np.float32)
    gt = 0.5 * gt / np.linalg.norm(gt, axis=1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((V_ALL,), 2.0),
                                  elev=torch.linspace(-20.0, 30.0, V_ALL),
                                  azim=torch.linspace(0.0, 300.0, V_ALL))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device="cpu")
    g = torch.tensor(gt)
    with torch.no_grad():
        rgba, frags, _ = render_views(
            g, g / g.norm(dim=1, keepdim=True), torch.full_like(g, 0.7),
            torch.ones(600, dtype=torch.bool), cams, None, LEAN)
    img, mask = rgba[..., :3].contiguous(), rgba[..., 3].contiguous()
    depth = torch.where(mask > 0.5, frags.wdepth, 100.0).contiguous()
    init = rng.standard_normal((P, 3)).astype(np.float32)
    init = 0.45 * init / np.linalg.norm(init, axis=1, keepdims=True)
    return cams, img, mask, depth, init


def _state(init):
    params = PointModelParams.create(init, init / np.linalg.norm(
        init, axis=1, keepdims=True), np.full_like(init, 0.5), device="cpu")
    return create_train_state(params, make_optimizer(params, lr_colors=0.5))


def _tensors(state):
    """The parameters and Adam's state, in a fixed order."""
    out = list(state.params.tensors())
    for t in state.params.tensors():
        st = state.optimizer.state[t]
        out += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
    return out


def _run_window(scene, settings, k, on, cfg=CFG):
    cams, img, mask, depth, init = scene
    state = _state(init)
    window = make_train_window(settings, cfg, SCHEDULE, state, cams, None,
                               img, mask, depth)
    first = spans.begun("cpu")
    if on:
        spans.enable()
    state, m = window(state, torch.tensor(ROWS), k)
    spans.disable()
    return state, m, spans.read(first=first, device="cpu")


def _grads(scene, settings, on, cfg=CFG):
    """The first step's loss and gradients, the loss taken as the window
    takes it, inside a step root."""
    cams, img, mask, depth, init = scene
    state = _state(init)
    idx = torch.tensor(ROWS[0])
    if on:
        spans.enable()
    with spans.step("cpu"):
        total, _ = make_loss_fn(settings, cfg, SCHEDULE)(
            state.params, state.filters, trainer.take_views(cams, idx),
            None, img[idx], mask[idx], 0, depth[idx])
        grads = torch.autograd.grad(total, state.params.tensors(),
                                    allow_unused=True)
    spans.disable()
    return [total, *(g for g in grads if g is not None)]


@pytest.mark.parametrize("entry", ["window", "make_train_step"])
def test_spans_off_record_nothing_and_add_no_node(scene, monkeypatch, entry):
    """With spans off the window and make_train_step launch no mark, apply
    no boundary Function (no autograd node) and open no host range."""
    cams, img, mask, depth, init = scene
    calls = {"mark": 0, "boundary": 0}

    def count(name, real):
        def spy(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return spy

    monkeypatch.setattr(kernels, "span_mark", count("mark", kernels.span_mark))
    monkeypatch.setattr(spans._Boundary, "apply",
                        count("boundary", spans._Boundary.apply))
    first = spans.begun("cpu")
    state = _state(init)
    if entry == "window":
        window = make_train_window(LEAN, CFG, SCHEDULE, state, cams, None,
                                   img, mask, depth)
        window(state, torch.tensor(ROWS), 2)
        assert window.replays == 0 and window.replay_host_ns == 0
    else:
        step = make_train_step(LEAN, CFG, SCHEDULE)
        idx = torch.tensor(ROWS[0])
        step(state, trainer.take_views(cams, idx), None, img[idx], mask[idx],
             depth[idx])
    assert calls == {"mark": 0, "boundary": 0}
    assert spans.begun("cpu") == first
    assert spans.host("window.replay") is spans.span("update") is spans._NULL


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_on_are_bit_equal_to_off(scene, path):
    """Spans on against off: the first step's loss and gradients, and after
    a window of k = 8 the parameters, Adam's state and the metrics, bit for
    bit; the on run recorded its 8 steps."""
    settings = PATHS[path]
    off, on = _grads(scene, settings, False), _grads(scene, settings, True)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert float(off[1].abs().max()) > 0
    s_off, m_off, rec_off = _run_window(scene, settings, 8, False)
    s_on, m_on, rec_on = _run_window(scene, settings, 8, True)
    for a, b in zip(_tensors(s_off), _tensors(s_on)):
        assert torch.equal(a, b)
    assert m_off.keys() == m_on.keys()
    for key in m_off:
        assert torch.equal(m_off[key], m_on[key]), key
    assert rec_off["steps"] == [] and len(rec_on["steps"]) == 8
    names = {s.name for s in rec_on["steps"][0]["spans"]}
    assert {"splat.raster", "bwd.splat", "model.vrk"} <= names


def _check_tree(step):
    """The step's spans: the root first, each span inside its parent, the
    spans listed as they open, siblings apart in time."""
    sp = step["spans"]
    assert sp[0].name == "step" and sp[0].parent == -1
    assert all(s.parent >= 0 for s in sp[1:])
    for i, s in enumerate(sp):
        assert s.start_ns <= s.end_ns
        if i:
            assert sp[i - 1].start_ns <= s.start_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns
            assert s.end_ns <= p.end_ns
    kids = {}
    for s in sp:
        kids.setdefault(s.parent, []).append(s)
    for group in kids.values():
        for a, b in zip(group, group[1:]):
            assert a.end_ns <= b.start_ns
    return sp


def test_every_step_of_a_window_has_the_tree(scene):
    """Spans on, one window of k = 4 (the lean path with the surface
    losses and the depth L1): four steps, each with the step's tree: the
    forward modules in order under `step`, the kNNs under the Vrk and the
    regularizers, the modules' backward spans under `backward` in the
    order the gradient crosses them, then `update`."""
    _, _, rec = _run_window(scene, LEAN, 4, True)
    assert [st["index"] for st in rec["steps"]] == list(
        range(rec["next"] - 4, rec["next"]))
    assert rec["dropped"] == 0 and rec["clock"] == "perf_counter"
    layouts = set()
    for st in rec["steps"]:
        sp = _check_tree(st)
        top = [s.name for s in sp if s.parent == 0]
        assert top == FORWARD
        by_name = {s.name: i for i, s in enumerate(sp)}
        bwd = [s.name for s in sp if s.parent == by_name["backward"]]
        assert set(bwd) == BACKWARD and len(bwd) == len(BACKWARD)
        order = [bwd.index(n) for n in ("bwd.loss.image",
                                        "bwd.render.composite", "bwd.splat",
                                        "bwd.render.prep")]
        assert order == sorted(order)
        knn = [sp[s.parent].name for s in sp if s.name == "geometry.knn"]
        assert knn == ["model.vrk", "loss.reg"]
        layouts.add(tuple((s.name, s.parent) for s in sp))
    assert len(layouts) == 1


@pytest.mark.parametrize("texture", [False, True])
def test_a_neural_texture_records_its_spans(scene, texture):
    """A window step with a neural texture (a RenderingNetwork of width 16)
    records `render.texture` inside `render.prep` and `bwd.render.texture`
    inside `bwd.render.prep`, once each; a texture-off step records
    neither, and its forward modules are the same."""
    cams, img, mask, depth, init = scene
    tex = (NeuralTexture(RenderingNetwork(
        hidden_size=16, n_layers=2, generator=torch.Generator().manual_seed(0),
        device="cpu")) if texture else None)
    params = PointModelParams.create(init, init / np.linalg.norm(
        init, axis=1, keepdims=True), np.full_like(init, 0.5), device="cpu",
        texture=tex)
    state = create_train_state(params, make_optimizer(params, lr_colors=0.5))
    window = make_train_window(LEAN, CFG, SCHEDULE, state, cams, None, img,
                               mask, depth)
    first = spans.begun("cpu")
    spans.enable()
    window(state, torch.tensor(ROWS), 2)
    spans.disable()
    rec = spans.read(first=first, device="cpu")
    assert len(rec["steps"]) == 2
    for st in rec["steps"]:
        sp = _check_tree(st)
        names = [s.name for s in sp]
        assert [s.name for s in sp if s.parent == 0] == FORWARD
        if not texture:
            assert "render.texture" not in names
            assert "bwd.render.texture" not in names
            continue
        for name, parent in (("render.texture", "render.prep"),
                             ("bwd.render.texture", "bwd.render.prep")):
            assert names.count(name) == 1, name
            assert sp[sp[names.index(name)].parent].name == parent, name


ANCHORED = {
    "pca": CFG._replace(lambda_normal=0.1, normal_anchor="pca",
                        normal_anchor_k=8),
    "jet": CFG._replace(lambda_normal=0.1, normal_anchor="jet",
                        normal_anchor_k=48),
}


@pytest.mark.parametrize("anchor", list(ANCHORED))
def test_the_normal_anchor_records_its_span(scene, anchor):
    """With the normal term, spans on against off are bit-equal (the first
    step's loss and gradients, a window of k = 3's parameters, Adam's
    state and metrics), and each step records `loss.anchor` once, inside
    `loss.reg`, with the anchor's kNN (`geometry.knn`) inside it beside
    the surface losses' kNN in `loss.reg`."""
    cfg = ANCHORED[anchor]
    off, on = _grads(scene, LEAN, False, cfg), _grads(scene, LEAN, True, cfg)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    s_off, m_off, _ = _run_window(scene, LEAN, 3, False, cfg)
    s_on, m_on, rec = _run_window(scene, LEAN, 3, True, cfg)
    for a, b in zip(_tensors(s_off), _tensors(s_on)):
        assert torch.equal(a, b)
    assert m_off.keys() == m_on.keys() and "anchor_nonfinite" in m_on
    for key in m_off:
        assert torch.equal(m_off[key], m_on[key]), key
    assert int(m_on["anchor_nonfinite"]) == 0
    assert len(rec["steps"]) == 3
    for st in rec["steps"]:
        sp = _check_tree(st)
        names = [s.name for s in sp]
        assert [s.name for s in sp if s.parent == 0] == FORWARD
        assert names.count("loss.anchor") == 1
        at = names.index("loss.anchor")
        assert sp[sp[at].parent].name == "loss.reg"
        knn = [sp[s.parent].name for s in sp if s.name == "geometry.knn"]
        assert knn == ["model.vrk", "loss.reg", "loss.anchor"]


def test_anchor_nonfinite_counts_the_points_whose_target_is_not_finite():
    """`anchor_nonfinite`: 0 on a clean sphere; with 60 of its points moved
    into a cluster at 1e10 (their 6x6 jet systems overflow float32 and
    their targets are NaN) it counts those 60, and of them only the ones
    the mask keeps."""
    from dss_tpu_torch.training.losses import normal_consistency_terms

    g = torch.Generator().manual_seed(0)
    p = torch.randn((P, 3), generator=g)
    p = 0.5 * p / torch.linalg.vector_norm(p, dim=1, keepdim=True)
    n = p / 0.5 + 0.3 * torch.randn((P, 3), generator=g)
    mask = torch.ones(P, dtype=torch.bool)
    for anchor, k in (("jet", 48), ("pca", 8)):
        loss, bad = normal_consistency_terms(p, n, mask, k, anchor)
        assert bool(torch.isfinite(loss)) and bad.dtype == torch.int64
        assert int(bad) == 0
    far = p.clone()
    far[:60] = far[:60] * 1e10 + 5e13
    loss, bad = normal_consistency_terms(far, n, mask, 48, "jet")
    assert int(bad) == 60 and not bool(torch.isfinite(loss))
    mask[:20] = False
    assert int(normal_consistency_terms(far, n, mask, 48, "jet")[1]) == 40


def test_self_time_is_the_span_less_its_children(scene):
    """Hand-made spans (overlapping and nested children, a child that
    runs past its parent) and a recorded step: self time = the span's
    length less the union of its children's intervals inside it."""
    sp = [spans.Span("step", -1, 0, 100), spans.Span("a", 0, 10, 30),
          spans.Span("b", 0, 20, 50), spans.Span("c", 2, 25, 35),
          spans.Span("d", 0, 90, 120)]
    assert spans.self_ns(sp) == [100 - 40 - 10, 20, 20, 10, 30]
    _, _, rec = _run_window(scene, LEAN, 1, True)
    sp = rec["steps"][0]["spans"]
    own = spans.self_ns(sp)
    for i, s in enumerate(sp):
        kids = sum(c.end_ns - c.start_ns for c in sp if c.parent == i)
        assert own[i] == s.end_ns - s.start_ns - kids
    assert sum(own) == sp[0].end_ns - sp[0].start_ns


def test_ring_reports_the_steps_it_dropped(monkeypatch):
    """A ring of 4 rows after 6 steps holds the last 4: read from step 0
    reports 2 dropped, read from step 3 none; the steps' spans keep their
    names, and a step begun but not ended is not read."""
    monkeypatch.setattr(spans, "STEPS", 4)
    monkeypatch.setattr(spans, "_rings", {})
    spans.enable()
    for i in range(6):
        with spans.step("cpu"):
            with spans.span(f"work{i % 2}"):
                pass
    rec = spans.read()
    assert rec["dropped"] == 2 and rec["next"] == 6
    assert [st["index"] for st in rec["steps"]] == [2, 3, 4, 5]
    assert [[s.name for s in st["spans"]] for st in rec["steps"]] == [
        ["step", "work0"], ["step", "work1"]] * 2
    rec = spans.read(first=3)
    assert rec["dropped"] == 0 and [st["index"] for st in rec["steps"]] == [
        3, 4, 5]
    with pytest.raises(RuntimeError, match="stop"):
        with spans.step("cpu"):
            raise RuntimeError("stop")
    assert spans.begun() == 7 and len(spans.read(first=6)["steps"]) == 0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = tmp_path_factory.mktemp("spans")
    make_tiny_dataset(str(base / "ds"), views=4, image_size=16, points=200,
                      n_train_points=120, device="cpu")
    return base


def test_profile_dir_writes_spans_and_logs_span_ms(dataset):
    """train_mvr --profile-dir on the CPU, 16 iterations at k = 4: trace.json
    and spans.json (the traced dispatch's 4 steps, each rooted at `step`)
    in the directory, span_<name>_ms in every log line, the spans off
    after the run."""
    base = dataset
    cfg = {
        "name": "spans",
        "data": {"data_dir": str(base / "ds"), "type": "MVR"},
        "model": {"type": "point", "model_kwargs": {
            "n_points_per_cloud": 120}},
        "renderer": {"raster_params": {
            "image_size": 16, "points_per_pixel": 3, "cutoff_threshold": 1.0,
            "radii_backward_scaler": 10.0}},
        "training": {
            "batch_size": 1, "out_dir": str(base / "exp"), "print_every": 4,
            "validate_every": 8, "visualize_every": -1,
            "checkpoint_every": 8, "lambda_dr_repel": 0.01,
            "lambda_dr_proj": 0.01},
    }
    path = base / "spans.yml"
    path.write_text(yaml.safe_dump(cfg))
    prof = base / "prof"
    train_mvr(["--config", str(path), "--max-iters", "16", "--device", "cpu",
               "--profile-dir", str(prof), "--steps-per-dispatch", "4"])
    assert not spans.enabled()
    assert (prof / "trace.json").is_file()
    record = json.loads((prof / "spans.json").read_text())
    assert len(record["steps"]) == 4 and record["dropped"] == 0
    for st in record["steps"]:
        names = [s["name"] for s in st["spans"]]
        assert names[0] == "step" and "bwd.splat" in names
        assert "update" in names
    log = base / "exp" / "spans" / "metrics.jsonl"
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    logged = [r for r in rows if "loss" in r]
    assert len(logged) == 4
    for r in logged:
        assert r["span_step_ms"] > r["span_backward_ms"] > 0
        assert r["span_splat.raster_ms"] > 0
