"""The train window of dss_tpu_torch (trainer.make_train_window, train_mvr
--steps-per-dispatch) against the eager step and against dss_tpu's scan
window, and the grid kNN against dss_tpu's, on the CPU.

On the CPU the window runs its step eagerly (the CUDA graph is the card's,
tests/test_torch_cuda.py), so what is held here is the window's math: the
batch picked by the device step, the NaN guard, the anneal and the
milestone lrs on the device, the metrics of the window, and the k rule.

Tolerances, from what was measured on the CPU when this test was written:

- The window and make_train_step run one step body and one update
  (`guarded_adam_`, in optax's order), so on the CPU they take equal
  steps: parameters, Adam's moments and the last step's loss parts are
  held bit for bit (torch.equal).
- The port's CLI at k = 4 against the JAX CLI at k = 4 on the reference
  backend, the first window: loss parts within 8.7e-8 relative,
  parameters within 6.9e-7.  Held at test_torch_train_cli.py's
  SAME_STATE tolerance.
- The grid kNN against dss_tpu's: distances within 4.8e-7 (XLA and torch
  round the per-coordinate sums apart), indices equal on these clouds.
  Held at 2e-6.
"""
import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dss_tpu.apps.train_mvr import main as jax_main
from dss_tpu.geometry.knn import grid_knn_points as jax_grid_knn
from dss_tpu.training.losses import build_knn as jax_build_knn
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as torch_main
from dss_tpu_torch.apps.train_mvr import steps_per_dispatch
from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                            look_at_view_transform)
from dss_tpu_torch.geometry.knn import grid_knn_points, knn_points
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import trainer
from dss_tpu_torch.training.losses import build_knn
from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                            create_train_state, make_optimizer,
                                            make_train_step, make_train_window)

torch.set_num_threads(2)

DEV = "cpu"
# test_torch_train_cli.py's SAME_STATE: (loss parts rtol, params atol)
SAME_STATE = (1e-4, 1e-4)
PARAMS = ("params/points", "params/normals", "params/colors")


# ---------------------------------------------------------------------------
# The window against make_train_step (API level)
# ---------------------------------------------------------------------------

S, V_ALL, B, P = 32, 6, 2, 300
SETTINGS = RasterSettings(image_size=S, tile_size=16, points_per_pixel=5,
                          Vrk_invariant=True, Vrk_isotropic=False,
                          backface_culling=False, depth_channel=True,
                          max_tiles_per_splat=1)
CFG = TrainConfig(lambda_proj=0.01, lambda_repel=0.1, lambda_depth=0.1)
SCHEDULE = AnnealSchedule(init_backward_radii=10.0, steps_backward_radii=2,
                          gamma_backward_radii=0.9, limit_backward_radii=2.0,
                          steps_proj=3, gamma_proj=0.5, limit_proj=1.0)
OPT = dict(lr_points=0.01, lr_normals=0.01, lr_colors=0.5, milestones=(1, 3),
           gamma=0.5)
# three batches of B views; the middle one has a NaN in its mask
ROWS = [[0, 1], [2, 3], [4, 5]]


@pytest.fixture(scope="module")
def scene():
    """6 views of a 600-point sphere rendered at 32², and a 300-point
    start cloud (numpy, seed 0).  View 3's mask holds a NaN."""
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((600, 3)).astype(np.float32)
    gt = 0.5 * gt / np.linalg.norm(gt, axis=1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((V_ALL,), 2.0),
                                  elev=torch.linspace(-20.0, 30.0, V_ALL),
                                  azim=torch.linspace(0.0, 300.0, V_ALL))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=DEV)
    g = torch.tensor(gt)
    with torch.no_grad():
        rgba, frags, _ = render_views(
            g, g / g.norm(dim=1, keepdim=True), torch.full_like(g, 0.7),
            torch.ones(600, dtype=torch.bool), cams, None, SETTINGS)
    img, mask = rgba[..., :3].contiguous(), rgba[..., 3].contiguous()
    depth = torch.where(mask > 0.5, frags.wdepth, 100.0).contiguous()
    mask[3, 0, 0] = float("nan")
    init = rng.standard_normal((P, 3)).astype(np.float32)
    init = 0.45 * init / np.linalg.norm(init, axis=1, keepdims=True)
    return cams, img, mask, depth, init


def _state(init):
    params = PointModelParams.create(init, init / np.linalg.norm(
        init, axis=1, keepdims=True), np.full_like(init, 0.5), device=DEV)
    return create_train_state(params, make_optimizer(params, **OPT))


def _adam(state):
    return [(state.optimizer.state[t]["exp_avg"],
             state.optimizer.state[t]["exp_avg_sq"],
             float(state.optimizer.state[t]["step"]))
            for t in state.params.tensors()]


def test_window_skips_a_nan_step_as_the_eager_step_does(scene):
    """(c) Three steps in one window, the middle batch with a NaN in its
    mask, against make_train_step one step at a time: the NaN step is
    skipped (parameters and Adam's moments and counts as the eager run
    that skipped it), params_finite is False, bin_overflow is the window's
    sum, the other metrics the last step's."""
    cams, img, mask, depth, init = scene
    eager = _state(init)
    step = make_train_step(SETTINGS, CFG, SCHEDULE)
    eager_metrics = []
    for row in ROWS:
        idx = torch.tensor(row)
        eager, m = step(eager, trainer.take_views(cams, idx), None, img[idx],
                        mask[idx], depth[idx])
        eager_metrics.append(m)
    assert [bool(m["params_finite"]) for m in eager_metrics] == [True, False, True]

    state = _state(init)
    window = make_train_window(SETTINGS, CFG, SCHEDULE, state, cams, None,
                               img, mask, depth)
    assert not window.graph
    state, metrics = window(state, torch.tensor(ROWS), 3)
    assert state.step == eager.step == 3
    for (a, b) in zip(state.params.tensors(), eager.params.tensors()):
        assert torch.equal(a, b)
    for got, want in zip(_adam(state), _adam(eager)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2] == 2.0
    assert not bool(metrics["params_finite"])
    overflow = sum(int(m["bin_overflow"]) for m in eager_metrics)
    assert overflow > 0 and int(metrics["bin_overflow"]) == overflow
    for k in ("loss", "loss_dr_rgb", "loss_dr_silhouette", "loss_dr_depth",
              "loss_dr_proj", "loss_dr_repel"):
        assert torch.equal(metrics[k], eager_metrics[-1][k]), k
    # the moved points: the comparison is not of two untouched clouds
    assert (state.params.points - torch.tensor(init)).abs().max() > 1e-3


class _Recording(AnnealSchedule):
    """An AnnealSchedule that records the step it is asked at and what it
    returns."""

    def __init__(self, base, log):
        super().__init__(**dataclasses.asdict(base))
        object.__setattr__(self, "log", log)

    def backward_radii(self, it):
        out = super().backward_radii(it)
        self.log.append(("radii", int(it), out.clone()))
        return out

    def proj_scale(self, it):
        out = super().proj_scale(it)
        self.log.append(("proj", int(it), out.clone()))
        return out


def test_window_anneal_and_lrs_follow_the_device_step(scene, monkeypatch):
    """(d) One window of 4 steps crosses a backward-radii boundary (every
    2 steps), a projection-scale boundary (every 3) and both lr milestones
    (1 and 3 applied updates): each value the window computes from its
    device step equals AnnealSchedule's at that host step, and each lr
    base·gamma^(milestones ≤ count)."""
    cams, img, mask, depth, init = scene
    log, lrs = [], []
    real_lr = trainer.group_lr

    def recording_lr(group, count):
        out = real_lr(group, count)
        lrs.append((group["name"], float(count), float(out)))
        return out

    monkeypatch.setattr(trainer, "group_lr", recording_lr)
    state = _state(init)
    window = make_train_window(SETTINGS, CFG, _Recording(SCHEDULE, log),
                               state, cams, None, img, mask, depth)
    rows = torch.tensor([[0, 1], [4, 5]])
    window(state, rows, 4)
    assert [(kind, it) for kind, it, _ in log] == [
        (kind, it) for it in range(4) for kind in ("radii", "proj")]
    radii = [float(v) for kind, _, v in log if kind == "radii"]
    assert radii[0] == radii[1] > radii[2] == radii[3]
    for kind, it, got in log:
        fn = getattr(SCHEDULE, "backward_radii" if kind == "radii"
                     else "proj_scale")
        assert torch.equal(got, fn(it)), (kind, it)
    assert [c for name, c, _ in lrs if name == "points"] == [0.0, 1.0, 2.0, 3.0]
    for name, count, lr in lrs:
        group = next(g for g in state.optimizer.param_groups
                     if g["name"] == name)
        want = group["base_lr"] * group["gamma"] ** sum(
            count >= m for m in group["milestones"])
        assert lr == pytest.approx(want, rel=1e-7), (name, count)
    assert sorted({lr for name, _, lr in lrs if name == "points"}) == (
        pytest.approx([0.0025, 0.005, 0.01], rel=1e-7))


def test_window_updates_through_the_module_attribute(scene, monkeypatch):
    """The window's step calls `trainer.guarded_adam_` by its module
    attribute, where the benchmark plants its faults: patched to a no-op,
    a window of 2 steps leaves the parameters and Adam's state (moments
    and counts) as they were, while the step and the metrics advance;
    unpatched, the same window moves them."""
    cams, img, mask, depth, init = scene
    rows = torch.tensor([[0, 1], [4, 5]])
    for patched in (True, False):
        if patched:
            monkeypatch.setattr(trainer, "guarded_adam_",
                                lambda *a, **k: None)
        state = _state(init)
        window = make_train_window(SETTINGS, CFG, SCHEDULE, state, cams,
                                   None, img, mask, depth)
        before = ([t.detach().clone() for t in state.params.tensors()],
                  [[x.clone() for x in a[:2]] + [a[2]] for a in _adam(state)])
        state, metrics = window(state, rows, 2)
        after = ([t.detach() for t in state.params.tensors()],
                 [list(a[:2]) + [a[2]] for a in _adam(state)])
        assert state.step == 2 and bool(metrics["params_finite"])
        same = [torch.equal(a, b) for a, b in zip(before[0], after[0])]
        same += [torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                 for a, b in zip(before[1], after[1]) for x, y in zip(a, b)]
        if patched:
            assert all(same)
            monkeypatch.undo()
        else:
            assert not same[0] and [c for *_, c in after[1]] == [2.0] * 3


def test_window_storage_is_the_callers_and_replaced_filters_are_copied(scene):
    """The window updates the parameters and Adam's state in place, copies
    filters replaced between calls (as a prune does) into its own, and
    refuses parameters whose storage changed."""
    cams, img, mask, depth, init = scene
    state = _state(init)
    pts = state.params.points
    window = make_train_window(SETTINGS, CFG, SCHEDULE, state, cams, None,
                               img, mask, depth)
    rows = torch.tensor([[0, 1]])
    state, _ = window(state, rows, 1)
    filters = state.filters
    moments = state.optimizer.state[pts]["exp_avg"]
    off = filters.activation.clone()
    off[:10] = False
    state.filters = dataclasses.replace(state.filters, activation=off)
    state, _ = window(state, rows, 1)
    assert state.params.points is pts and state.step == 2
    assert state.filters is filters and state.optimizer.state[pts]["exp_avg"] is moments
    assert torch.equal(state.filters.activation, off)
    pts.data = pts.data.clone()
    with pytest.raises(ValueError, match="make a new window"):
        window(state, rows, 1)


def test_grid_route_runs_inside_the_window(scene, monkeypatch):
    """DSS_KNN_GRID_THRESHOLD=0 sends the surface losses' kNN to the grid:
    the window and make_train_step take it alike."""
    cams, img, mask, depth, init = scene
    monkeypatch.setenv("DSS_KNN_GRID_THRESHOLD", "0")
    calls = []
    real = trainer.build_knn.__globals__["grid_knn_points"]

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setitem(trainer.build_knn.__globals__, "grid_knn_points", spy)
    eager = _state(init)
    step = make_train_step(SETTINGS, CFG, SCHEDULE)
    for row in ([0, 1], [4, 5]):
        idx = torch.tensor(row)
        eager, _ = step(eager, trainer.take_views(cams, idx), None, img[idx],
                        mask[idx], depth[idx])
    state = _state(init)
    window = make_train_window(SETTINGS, CFG, SCHEDULE, state, cams, None,
                               img, mask, depth)
    state, m = window(state, torch.tensor([[0, 1], [4, 5]]), 2)
    assert calls == [P] * 4 and bool(m["params_finite"])
    for a, b in zip(state.params.tensors(), eager.params.tensors()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The CLI: --steps-per-dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The port's twin: 4 views at 16², a 200-point sphere (as dss_tpu's
    scan-dispatch test trains: one view per step, 4 steps per epoch)."""
    base = tmp_path_factory.mktemp("window")
    ds = str(base / "ds")
    make_tiny_dataset(ds, views=4, image_size=16, points=200,
                      n_train_points=120, device=DEV)
    return base, ds


def _cli_config(base, name, backend="auto", **training):
    cfg = {
        "name": name,
        "data": {"data_dir": str(base / "ds"), "type": "MVR"},
        "model": {"type": "point", "model_kwargs": {
            "learn_colors": True, "learn_normals": True, "learn_points": True,
            "n_points_per_cloud": 120}},
        "renderer": {"raster_params": {
            "image_size": 16, "points_per_pixel": 3, "cutoff_threshold": 1.0,
            "radii_backward_scaler": 10.0, "backend": backend}},
        "training": {
            "batch_size": 1, "out_dir": str(base / "exp"), "print_every": 4,
            "validate_every": -1, "visualize_every": -1,
            "checkpoint_every": 100, "lambda_dr_repel": 0.01,
            "lambda_dr_proj": 0.01, **training},
    }
    path = base / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _checkpoint(run_dir):
    with np.load(run_dir / "model.npz") as f:
        return {k: f[k] for k in f.files}


def _first_row(run_dir):
    return json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[0])


def test_cli_four_steps_per_dispatch_match_one(dataset, caplog):
    """(a) --steps-per-dispatch 4 lands on the parameters of 1 (atol 1e-5,
    dss_tpu's test_scan_dispatch_matches_per_step), with the anneal (every
    3 steps) and the milestones (1 and 3 epochs) inside the windows."""
    base, _ = dataset
    cfg = _cli_config(base, "k", steps_dss_backward_radii=3,
                      scheduler_milestones=[1, 3])
    out = {}
    for k in (1, 4):
        with caplog.at_level(logging.INFO, logger="train_mvr"):
            torch_main(["--config", cfg, "--name", f"k{k}", "--max-iters",
                        "8", "--steps-per-dispatch", str(k), "--seed", "0",
                        "--device", DEV])
        assert f"{k} train step{'s' if k > 1 else ''} per dispatch, eager" in caplog.text
        out[k] = _checkpoint(base / "exp" / f"k{k}")
    for key in PARAMS:
        np.testing.assert_allclose(out[4][key], out[1][key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    assert int(out[4]["step"]) == int(out[1]["step"]) == 8
    assert np.abs(out[4]["params/points"] - out[1]["params/points"]).max() < 1e-5


def test_cli_window_matches_the_jax_scan_window(dataset):
    """(b) The port's CLI and dss_tpu's at --steps-per-dispatch 4 on the
    reference backend: the first window's logged loss parts (its last
    step's) and the parameters after it, at SAME_STATE."""
    base, _ = dataset
    cfg = _cli_config(base, "ref4", backend="reference")
    common = ["--config", cfg, "--max-iters", "4", "--steps-per-dispatch",
              "4", "--seed", "0"]
    jax_main(common + ["--name", "jax4", "--platform", "cpu"])
    torch_main(common + ["--name", "torch4", "--device", DEV])
    ja, to = base / "exp" / "jax4", base / "exp" / "torch4"
    rj, rt = _first_row(ja), _first_row(to)
    assert rj["step"] == rt["step"] == 4
    for k in ("loss", "loss_dr_rgb", "loss_dr_silhouette", "loss_dr_proj",
              "loss_dr_repel"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=SAME_STATE[0],
                                   err_msg=k)
    assert rt["params_finite"] == rj["params_finite"] == 1.0
    assert rt["bin_overflow"] == rj["bin_overflow"]
    cj, ct = _checkpoint(ja), _checkpoint(to)
    for k in PARAMS:
        np.testing.assert_allclose(ct[k], cj[k], atol=SAME_STATE[1], err_msg=k)
    for k in cj:
        if k.endswith("/count") or k == "step":
            np.testing.assert_array_equal(ct[k], cj[k], err_msg=k)


def _jax_k(argv, caplog):
    """The k dss_tpu's CLI picks (it logs k > 1 only), or its error."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="train_mvr"):
        try:
            jax_main(argv + ["--platform", "cpu"])
        except ValueError as e:
            return str(e)
    for rec in caplog.records:
        if rec.getMessage().startswith("dispatching "):
            return int(rec.getMessage().split()[1])
    return 1


@pytest.mark.parametrize("batch,print_every,k", [
    (1, 1, -1), (1, 3, -1), (1, 100, -1), (2, 1, -1), (1, 4, 2), (1, 4, 3),
    (2, 4, 4)])
def test_k_rule_matches_the_jax_cli(dataset, caplog, batch, print_every, k):
    """(e) The auto k and the divisibility error of both CLIs, for 4 and 2
    steps per epoch; `--epochs 0` stops both before any step."""
    base, _ = dataset
    cfg = _cli_config(base, f"rule_{batch}_{print_every}_{k}",
                      batch_size=batch, print_every=print_every)
    argv = ["--config", cfg, "--epochs", "0", "--steps-per-dispatch", str(k)]
    want = _jax_k(argv, caplog)
    steps = 4 // batch
    if isinstance(want, str):
        with pytest.raises(ValueError) as err:
            torch_main(argv + ["--device", DEV])
        assert str(err.value) == want
        with pytest.raises(ValueError, match="must divide"):
            steps_per_dispatch(k, steps, print_every)
    else:
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="train_mvr"):
            torch_main(argv + ["--device", DEV])
        assert f"{want} train step" in caplog.text
        assert steps_per_dispatch(k, steps, print_every) == want


def test_k_rule_pairs():
    """The auto rule on more (steps_per_epoch, print_every) pairs."""
    assert [steps_per_dispatch(-1, s, p) for s, p in
            ((12, 10), (12, 5), (7, 10), (7, 6), (1, 10), (16, 0))] == [
        6, 4, 7, 1, 1, 1]
    assert steps_per_dispatch(3, 12, 1) == 3


# ---------------------------------------------------------------------------
# The grid kNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid_res,bucket,chunk", [
    (4, 128, 4096), (6, 8, 4096), (3, 16, 64)])
def test_grid_knn_matches_jax_and_brute_force(grid_res, bucket, chunk):
    """dss_tpu's grid_knn_points on a masked normal cloud, at a bucket that
    holds every cell (exact: equal to brute force) and at one that drops
    candidates; the query chunk does not change the result."""
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[7] = False
    mask[100:110] = False
    dj, ij = jax_grid_knn(jnp.asarray(pts), jnp.asarray(mask), k=5,
                          exclude_self=True, grid_res=grid_res,
                          bucket_size=bucket)
    dt, it = grid_knn_points(torch.tensor(pts), torch.tensor(mask), k=5,
                             exclude_self=True, grid_res=grid_res,
                             bucket_size=bucket, query_chunk=chunk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2e-6,
                               atol=2e-6)
    assert np.isinf(dt.numpy()[~mask]).all() and (it.numpy()[~mask] == -1).all()
    if bucket == 128:
        db, _ = knn_points(torch.tensor(pts), torch.tensor(pts),
                           torch.tensor(mask), torch.tensor(mask), k=5,
                           exclude_self=True)
        np.testing.assert_allclose(dt.numpy(), db.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("route", ["argument", "environment"])
def test_build_knn_grid_dispatch(route, monkeypatch):
    """build_knn's grid route (grid_threshold, or DSS_KNN_GRID_THRESHOLD)
    against dss_tpu's at the same threshold, and against the brute force
    at a benign density, as tests/test_geometry.py holds dss_tpu's."""
    from dss_tpu_torch.geometry.shapes import (ico_sphere,
                                               sample_points_from_mesh)

    verts, faces = ico_sphere(level=3, radius=0.5)
    pts, _ = sample_points_from_mesh(verts, faces, 2048,
                                     rng=np.random.default_rng(1))
    mask = np.ones(2048, bool)
    mask[7] = False
    tp, tm = torch.tensor(pts), torch.tensor(mask)
    if route == "argument":
        grid = build_knn(tp, tm, knn_k=8, grid_threshold=0)
    else:
        monkeypatch.setenv("DSS_KNN_GRID_THRESHOLD", "0")
        grid = build_knn(tp, tm, knn_k=8)
    want = jax_build_knn(jnp.asarray(pts), jnp.asarray(mask), knn_k=8,
                         grid_threshold=0)
    np.testing.assert_array_equal(grid.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(grid.dists.numpy(), np.asarray(want.dists),
                               rtol=2e-6, atol=2e-6)
    monkeypatch.delenv("DSS_KNN_GRID_THRESHOLD", raising=False)
    brute = build_knn(tp, tm, knn_k=8)
    np.testing.assert_allclose(grid.dists.numpy(), brute.dists.numpy(),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(grid.valid.numpy(), brute.valid.numpy())
