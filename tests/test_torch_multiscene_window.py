"""The train window over stacked scenes (`trainer.make_train_window` with
(S, P, 3) leaves, S camera and light batches and (S, N, ...) images) on
the CPU, where the window runs its step eagerly: its k steps against the
eager stacked step (`make_stacked_loss_fn`, `_grads`, `apply_update`, one
step at a time, as `benchmark/tests/stacked_loop.py` drives it), bit for
bit; the single-scene window against `make_train_step`, bit for bit; the
refusals; the `render.fold` spans of a stacked step; and the
train_multiscene CLI through the window."""
import json

import numpy as np
import pytest
import torch

from dss_tpu_torch.apps import train_multiscene
from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                            look_at_view_transform)
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.decoders import RenderingNetwork
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.lighting import PointLights
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.render.texture import NeuralTexture
from dss_tpu_torch.training import trainer
from dss_tpu_torch.training.trainer import (AnnealSchedule, COUNTS,
                                            TrainConfig, TrainState,
                                            make_optimizer, make_train_step,
                                            make_train_window)
from dss_tpu_torch.utils import spans

torch.set_num_threads(2)

DEV = "cpu"
N_SCENES, P, N_VIEWS, S = 2, 300, 6, 64
# the flagship's raster and recipe at 64^2, tile 16
SETTINGS = RasterSettings(image_size=S, tile_size=16, points_per_pixel=5,
                          Vrk_invariant=True, Vrk_isotropic=False,
                          backface_culling=False, depth_channel=True,
                          clip_pts_grad=0.05)
CFG = TrainConfig(lambda_proj=0.01, lambda_repel=0.1, lambda_depth=0.1)
SCHEDULE = AnnealSchedule(init_backward_radii=10.0, steps_backward_radii=2,
                          gamma_backward_radii=0.9, limit_backward_radii=2.0)
OPT = dict(lr_points=0.01, lr_normals=0.01, lr_colors=0.5, milestones=(1, 3),
           gamma=0.5)
# the epoch's view slots, shared by the scenes: three steps of two views
EPOCH = torch.tensor([[0, 1], [2, 3], [4, 5]])
K = 3


def _cameras(seed, n_views):
    r = np.random.default_rng(seed)
    rr, tt = look_at_view_transform(
        dist=torch.tensor(r.uniform(1.8, 2.2, n_views)),
        elev=torch.tensor(r.uniform(-40, 40, n_views)),
        azim=torch.tensor(r.uniform(0, 360, n_views)))
    return FoVPerspectiveCameras.create(rr, tt, fov=60.0, device=DEV)


def _lights(seed, n_views):
    g = torch.Generator().manual_seed(seed)
    u = lambda: torch.rand((n_views, 2, 3), generator=g)
    return PointLights(ambient_color=0.1 + 0.2 * u(),
                       diffuse_color=0.2 + 0.3 * u(),
                       specular_color=0.1 + 0.2 * u(),
                       location=4.0 * u() - 2.0)


@pytest.fixture(scope="module")
def scenes():
    """Each scene: an ellipsoid of 600 points rendered from its own six
    cameras under its own two point lights a view (images, masks, depths),
    and a start cloud of 300 points on a sphere."""
    rng = np.random.default_rng(0)
    gt_pts, gt_nrm, gt_col = train_multiscene.build_scenes(N_SCENES, 600, rng)
    cams = [_cameras(10 + s, N_VIEWS) for s in range(N_SCENES)]
    lights = [_lights(20 + s, N_VIEWS) for s in range(N_SCENES)]
    img, mask, depth = [], [], []
    for s in range(N_SCENES):
        with torch.no_grad():
            rgba, frags, _ = render_views(
                torch.tensor(gt_pts[s]), torch.tensor(gt_nrm[s]),
                torch.tensor(gt_col[s]), torch.ones(600, dtype=torch.bool),
                cams[s], lights[s], SETTINGS)
        m = rgba[..., 3].contiguous()
        img.append(rgba[..., :3].contiguous())
        mask.append(m)
        depth.append(torch.where(m > 0.5, frags.wdepth, 100.0))
    init = rng.standard_normal((N_SCENES, P, 3)).astype(np.float32)
    init = 0.45 * init / np.linalg.norm(init, axis=-1, keepdims=True)
    return (cams, lights, torch.stack(img), torch.stack(mask),
            torch.stack(depth), init)


def _state(init, texture=None):
    params = PointModelParams.create(
        init, init / np.linalg.norm(init, axis=-1, keepdims=True),
        np.full_like(init, 0.5), device=DEV, texture=texture)
    on = torch.ones(init.shape[:-1], dtype=torch.bool)
    return TrainState(params, make_optimizer(params, **OPT),
                      PointFilters(on, on.clone(), on.clone()))


def _adam(state):
    return [state.optimizer.state[t][key] for t in state.params.tensors()
            for key in ("step", "exp_avg", "exp_avg_sq")]


def _eager_steps(state, data, stacked):
    """K eager steps, one at a time: the stacked chain of
    benchmark/tests/stacked_loop.py, or make_train_step.  Returns (state,
    the last step's metrics, the COUNTS summed over the steps)."""
    cams, lights, img, mask, depth = data
    loss_fn = trainer.make_stacked_loss_fn(SETTINGS, CFG, SCHEDULE)
    step = make_train_step(SETTINGS, CFG, SCHEDULE)
    counts = {}
    for _ in range(K):
        v = EPOCH[state.step % len(EPOCH)]
        if stacked:
            take = lambda bs: [trainer.take_views(b, v) for b in bs]
            grads, total, parts, new_filters = trainer._grads(
                state.params, lambda: loss_fn(
                    state.params, state.filters, take(cams), take(lights),
                    img[:, v], mask[:, v], state.step, depth[:, v]))
            state, m = trainer.apply_update(state, grads, total, parts,
                                            new_filters)
        else:
            state, m = step(state, trainer.take_views(cams, v),
                            trainer.take_views(lights, v), img[v], mask[v],
                            depth[v])
        for k in COUNTS:
            if k in m:
                counts[k] = counts.get(k, 0) + m[k]
    return state, m, counts


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked scenes", "one scene"])
def test_window_equals_the_eager_steps_bit_for_bit(scenes, stacked):
    """K = 3 steps in one window (graph=False) against K eager steps:
    parameters, Adam's state, the filters, the last step's metrics and
    the COUNTS summed over the window equal bit for bit.  Stacked: two
    scenes, each with its own cameras, lights, images, masks and depths,
    against make_stacked_loss_fn → _grads → apply_update; one scene (scene
    0's data): the window unchanged, against make_train_step."""
    cams, lights, img, mask, depth, init = scenes
    data = ((cams, lights, img, mask, depth) if stacked else
            (cams[0], lights[0], img[0], mask[0], depth[0]))
    init = init if stacked else init[0]
    eager, want, counts = _eager_steps(_state(init), data, stacked)
    state = _state(init)
    window = make_train_window(SETTINGS, CFG, SCHEDULE, state, *data,
                               graph=False)
    assert window.stacked is stacked
    state, got = window(state, EPOCH, K)
    assert state.step == eager.step == K
    assert bool(got["params_finite"])
    for a, b in zip([*state.params.tensors(), *_adam(state)],
                    [*eager.params.tensors(), *_adam(eager)], strict=True):
        assert torch.equal(a, b)
    for name in ("activation", "visibility", "inmask"):
        assert torch.equal(getattr(state.filters, name),
                           getattr(eager.filters, name)), name
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], counts.get(k, v).reshape(v.shape)), k
    assert float(got["bin_overflow"]) == 0.0
    moved = state.params.points.detach() - torch.tensor(init)
    assert float(moved.abs().max()) > 0


def test_stacked_window_refuses_a_texture(scenes):
    cams, lights, img, mask, depth, init = scenes
    tex = NeuralTexture(RenderingNetwork(
        hidden_size=8, n_layers=1, generator=torch.Generator().manual_seed(0),
        device=DEV))
    state = _state(init, texture=tex)
    with pytest.raises(ValueError, match="neural texture"):
        make_train_window(SETTINGS, CFG, SCHEDULE, state, cams, lights, img,
                          mask, depth, graph=False)


@pytest.mark.parametrize("what", ["cameras", "lights", "images", "masks",
                                  "depths"])
def test_stacked_window_refuses_unmatched_scenes(scenes, what):
    """Two scenes with three camera batches, three light batches, or one
    scene's images, masks or depths: refused when the window is made."""
    cams, lights, img, mask, depth, init = scenes
    if what == "cameras":
        cams = cams + cams[:1]
    elif what == "lights":
        lights = lights + lights[:1]
    elif what == "images":
        img = img[:1]
    elif what == "masks":
        mask = mask[:1]
    else:
        depth = depth[:1]
    with pytest.raises(ValueError, match="stacked scenes need"):
        make_train_window(SETTINGS, CFG, SCHEDULE, _state(init), cams, lights,
                          img, mask, depth, graph=False)


def test_stacked_step_spans_render_fold(scenes):
    """With spans on, each step of a stacked window records one
    `render.fold` and one `bwd.render.fold` (the split of the folded
    splats' gradient, one boundary each way), in the render group's
    prefixes, and the numbers equal those with spans off bit for bit."""
    cams, lights, img, mask, depth, init = scenes
    off = _state(init)
    make_train_window(SETTINGS, CFG, SCHEDULE, off, cams, lights, img, mask,
                      depth, graph=False)(off, EPOCH, 2)
    state = _state(init)
    window = make_train_window(SETTINGS, CFG, SCHEDULE, state, cams, lights,
                               img, mask, depth, graph=False)
    spans.enable()
    try:
        first = spans.begun(DEV)
        state, _ = window(state, EPOCH, 2)
        record = spans.read(first=first, device=DEV)
    finally:
        spans.disable()
    assert len(record["steps"]) == 2
    for st in record["steps"]:
        names = [s.name for s in st["spans"]]
        assert names.count("render.fold") == 1
        assert names.count("bwd.render.fold") == 1
        assert names.count("render.prep") == N_SCENES
        assert names.count("loss.image") == N_SCENES
        fold = st["spans"][names.index("bwd.render.fold")]
        assert fold.end_ns >= fold.start_ns
        assert st["spans"][fold.parent].name == "backward"
    for a, b in zip([*state.params.tensors(), *_adam(state)],
                    [*off.params.tensors(), *_adam(off)], strict=True):
        assert torch.equal(a, b)


def test_cli_steps_through_the_window(tmp_path, capsys):
    """train_multiscene's folded mode through the window (k = 10 a
    dispatch, eager on the CPU), with --bin-capacity and --profile-dir: its
    log lines carry bin_overflow, bin_long_tiles and each span's ms per
    step, span_render.fold_ms among them; the trace is written; the loss
    falls."""
    out = train_multiscene.main([
        "--scenes", "2", "--points", "300", "--views", "2", "--image-size",
        "32", "--iters", "21", "--bin-capacity", "1024", "--profile-dir",
        str(tmp_path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[3] == "10 train steps per dispatch, eager"
    logs = [ln for ln in lines if ln.startswith("it ")]
    assert [ln.split()[1] for ln in logs] == ["10", "20"]
    for ln in logs:
        words = ln.split()
        at = words.index("bin_overflow")  # after "it n loss x (t s/it)"
        fields = dict(zip(words[at::2], words[at + 1::2]))
        assert fields["bin_overflow"] == "0"
        assert fields["bin_long_tiles"] == "0"
        for name in ("span_step_ms", "span_render.fold_ms",
                     "span_bwd.render.fold_ms", "span_update_ms"):
            assert float(fields[name]) > 0, name
    assert (tmp_path / "trace.json").exists()
    assert out["steps_per_dispatch"] == 10 and out["bin_overflow"] == [0, 0, 0]
    assert len(out["step_times"]) == 20
    assert out["final_loss"] < out["loss0"]
    assert json.loads(lines[-1])["iters"] == 21
    assert not spans.enabled()


def test_cli_vmap_is_guarded(capsys, monkeypatch):
    """--dispatch vmap steps eagerly through the guarded update: a
    gradient made non-finite at the second step skips that update alone
    (Adam's count 2 after 3 steps)."""
    grads = trainer._grads
    seen = []

    def poisoned(params, loss):
        g, *rest = grads(params, loss)
        seen.append(len(seen))
        if len(seen) == 2:
            g = [x * float("nan") for x in g]
        return (g, *rest)

    monkeypatch.setattr(trainer, "_grads", poisoned)
    counts = []
    adam = trainer.guarded_adam_

    def record(optimizer, grads, finite):
        adam(optimizer, grads, finite)
        counts.append(float(optimizer.state[
            optimizer.param_groups[0]["params"][0]]["step"]))

    monkeypatch.setattr(trainer, "guarded_adam_", record)
    out = train_multiscene.main([
        "--scenes", "2", "--points", "200", "--views", "2", "--image-size",
        "32", "--iters", "3", "--dispatch", "vmap", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[3] == (
        "1 train step per dispatch, eager, a loop over scenes")
    assert counts == [1.0, 1.0, 2.0]
    assert np.isfinite(out["final_loss"])
