"""Coverage reseeding of dss_tpu_torch against dss_tpu on the same numpy
inputs: `FoVPerspectiveCameras.unproject_ndc_depth`, the deficit masks,
`reseed_coverage` (hull carving and the dense-depth placement), the
`--reseed-every` event of the train CLI, and the reseed_coverage app,
whose grown checkpoint resumes in either package's train_mvr.

Tolerances:

- `unproject_ndc_depth`: 1e-6 relative to JAX; unproject ∘
  transform_points_screen within 1e-5 of the identity;
- the deficit masks and `_pix_to_ndc`: bit-equal; the ray subset follows
  (numpy's RandomState on both sides);
- `reseed_coverage` proposals within 1e-5, `nearest_idx` equal, on
  32² masks of a sphere with a cap switched off (the renders that give
  `pred_alpha` and the depths come from the port and go to both sides);
- the event: P static, donor rows moved, their `exp_avg` and `exp_avg_sq`
  0 right after it, every other row and Adam's `step` unchanged.

The apps render through their own packages' routes: dss_tpu's `auto`
backend is its reference rasterizer on the CPU, the port's the
tile-binned ops, so the app test holds what is shared (shapes, key
layout, the resume in both packages), not the proposals."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dss_tpu.apps import reseed_coverage as j_app
from dss_tpu.apps.train_mvr import main as j_train
from dss_tpu.geometry import cameras as jcam
from dss_tpu.models import reseed as jrs
from dss_tpu_torch.apps import reseed_coverage as t_app
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as t_train
from dss_tpu_torch.apps.train_mvr import reseed_event
from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.geometry import cameras as tcam
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models import reseed as trs
from dss_tpu_torch.models.point_model import (
    PointModelParams,
    point_model_forward,
    render_model,
)
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.trainer import create_train_state, make_optimizer
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")
TWIN = dict(views=8, image_size=32, points=2000)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# The camera's inverse
# ---------------------------------------------------------------------------


def _cameras(n, seed):
    rng = np.random.default_rng(seed)
    r, t = tcam.look_at_view_transform(
        dist=torch.tensor(rng.uniform(1.5, 3.0, n), dtype=torch.float32),
        elev=torch.tensor(rng.uniform(-60, 60, n), dtype=torch.float32),
        azim=torch.tensor(rng.uniform(-180, 180, n), dtype=torch.float32))
    fov = rng.uniform(30.0, 75.0, n).astype(np.float32)
    aspect = rng.uniform(0.7, 1.4, n).astype(np.float32)
    kw = dict(fov=fov, znear=0.1, zfar=100.0, aspect_ratio=aspect)
    return (tcam.FoVPerspectiveCameras.create(r, t, device=DEV, **kw),
            jcam.FoVPerspectiveCameras.create(jnp.asarray(r.numpy()),
                                              jnp.asarray(t.numpy()), **kw))


def test_unproject_ndc_depth_matches_jax():
    tc, jc = _cameras(5, 0)
    rng = np.random.default_rng(1)
    ndc = rng.uniform(-1, 1, (5, 64, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (5, 64)).astype(np.float32)
    want = np.asarray(jc.unproject_ndc_depth(jnp.asarray(ndc), jnp.asarray(depth)))
    got = tc.unproject_ndc_depth(_t(ndc), _t(depth)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_unproject_inverts_transform_points_screen():
    tc, _ = _cameras(4, 2)
    x = _t(np.random.default_rng(3).uniform(-0.5, 0.5, (200, 3)))
    screen = tc.transform_points_screen(x)  # (V, P, 3): ndc xy, view z
    back = tc.unproject_ndc_depth(screen[..., :2], screen[..., 2])
    torch.testing.assert_close(back, x.expand(4, -1, -1), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Deficit masks and reseed_coverage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("erode", [0, 1, 2])
def test_coverage_deficit_masks_bit_equal(erode):
    rng = np.random.default_rng(erode)
    gt = (rng.random((3, 24, 24)) < 0.8).astype(np.float32)
    alpha = rng.random((3, 24, 24)).astype(np.float32)
    gt[:, 4:20, 4:20] = 1.0
    alpha[:, 6:18, 6:18] = 0.0  # a hole the erosion keeps
    want = jrs.coverage_deficit_masks(jnp.asarray(gt), jnp.asarray(alpha), erode)
    got = trs.coverage_deficit_masks(_t(gt), _t(alpha), erode)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    idx = np.arange(24, dtype=np.float32)
    np.testing.assert_array_equal(trs._pix_to_ndc(idx, 24), jrs._pix_to_ndc(idx, 24))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 32² twin (8 views of a radius-0.5 sphere) and a 400-point sphere
    whose cap x > 0.2 is switched off: the port renders its alpha (lean
    path) and its front depth (fragment path); both go to both sides."""
    ds_dir = str(tmp_path_factory.mktemp("reseed") / "data")
    make_tiny_dataset(ds_dir, device=DEV, **TWIN)
    ds = MVRDataset(ds_dir, load_dense_depth=True)
    pts = fibonacci_sphere(400, 0.5).astype(np.float32)
    act = pts[:, 0] <= 0.2
    params = PointModelParams.create(pts, pts / 0.5, device=DEV,
                                     requires_grad=False)
    filters = PointFilters(*(_t(act, torch.bool),) * 3)
    cams = ds.get_cameras(None, device=DEV)
    st = RasterSettings(image_size=32, points_per_pixel=5, Vrk_invariant=True,
                        Vrk_isotropic=False, tile_size=16)
    alpha = render_model(params, filters, cams, None, st)[..., 3].numpy()
    with torch.no_grad():
        out, _ = point_model_forward(params, filters, cams, None,
                                     st.replace(lean_fragments=False))
    a = out["mask_img_pred"]
    depth = torch.where(a > 0.5, out["depth_pred"], 100.0).numpy()
    return dict(ds=ds, ds_dir=ds_dir, pts=pts, act=act, cams=cams,
                alpha=alpha, depth=depth)


def _jax_cams(ds):
    return jcam.cameras_from_matrix(jnp.asarray(ds.camera_mat),
                                    **ds.cameras_params)


@pytest.mark.parametrize("mode", ["hull", "depth", "rays"])
def test_reseed_coverage_matches_jax(scene, mode):
    """hull: carving over the active cloud's depth range; depth: the dense
    depth placement (silhouette and occluded deficits); rays: the hull
    with max_rays below the deficit count, through numpy's RandomState."""
    ds = scene["ds"]
    kw = dict(n_new=64, seed=3)
    if mode == "depth":
        kw.update(gt_depths=ds.get_depths(), pred_depths=scene["depth"])
    if mode == "rays":
        kw.update(max_rays=40)
    want_p, want_i = jrs.reseed_coverage(
        jnp.asarray(scene["pts"]), jnp.asarray(scene["act"]), _jax_cams(ds),
        jnp.asarray(ds.masks), jnp.asarray(scene["alpha"]), **{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()})
    got_p, got_i = trs.reseed_coverage(
        _t(scene["pts"]), _t(scene["act"], torch.bool), scene["cams"],
        _t(ds.masks), scene["alpha"], **kw)
    assert got_p.dtype == np.float32 and got_i.dtype == np.int32
    assert 4 <= len(got_p) <= 64, len(got_p)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    # the nearest points are active ones, and the proposals lie off them
    assert scene["act"][got_i].all()
    gap = np.linalg.norm(got_p - scene["pts"][got_i], axis=-1)
    assert gap.min() > 0.02, gap.min()


def test_reseed_coverage_without_deficit(scene):
    ds = scene["ds"]
    p, i = trs.reseed_coverage(_t(scene["pts"]), torch.ones(400, dtype=torch.bool),
                               scene["cams"], _t(ds.masks),
                               np.ones_like(scene["alpha"]))
    assert p.shape == (0, 3) and i.shape == (0,)


# ---------------------------------------------------------------------------
# The --reseed-every event
# ---------------------------------------------------------------------------


def test_reseed_event_moves_donors_and_zeroes_their_moments(scene):
    """A state after two Adam updates, its cap relocated to a floater
    cluster: the event claims floaters (active, outside the silhouette)
    then inactive slots, writes them in place, and zeroes their moments."""
    ds, pts = scene["ds"], scene["pts"].copy()
    cap = pts[:, 0] > 0.2
    pts[cap] = 3.0
    inactive = np.zeros(400, bool)
    inactive[::50] = True
    inactive &= ~cap
    params = PointModelParams.create(pts, scene["pts"] / 0.5, device=DEV)
    state = create_train_state(params, make_optimizer(params))
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for t in params.tensors():
            t.grad = torch.randn(t.shape, generator=g)
        state.optimizer.step()
    state.filters = PointFilters(_t(~inactive, torch.bool),
                                 *(torch.ones(400, dtype=torch.bool),) * 2)
    tensors = params.tensors()
    before = [t.detach().clone() for t in tensors]
    moments = {k: [state.optimizer.state[t][k].clone() for t in tensors]
               for k in ("exp_avg", "exp_avg_sq")}
    steps = [state.optimizer.state[t]["step"].clone() for t in tensors]
    st = RasterSettings(image_size=32, points_per_pixel=5, Vrk_invariant=True,
                        Vrk_isotropic=False, tile_size=16)
    state, k_new = reseed_event(state, scene["cams"], _t(ds.masks), st,
                                reseed_max=int(cap.sum()) + 20, reseed_views=4)
    assert k_new >= 4
    pts_new = state.params.points.detach().numpy()
    assert state.params.points is tensors[0]  # the Adam state's key
    assert pts_new.shape == (400, 3)
    moved = np.any(pts_new != before[0].numpy(), axis=-1)
    assert moved.sum() == k_new
    # donors: floaters first (the cap), then the inactive slots
    assert moved[cap].sum() == min(k_new, cap.sum())
    assert not moved[~cap & ~inactive].any()
    assert np.all(np.linalg.norm(pts_new[moved], axis=-1) < 1.0)
    act = state.filters.activation.numpy()
    assert act[moved].all() and (act[~moved] == ~inactive[~moved]).all()
    for i, t in enumerate(tensors):
        s = state.optimizer.state[t]
        assert torch.equal(s["step"], steps[i])
        for k in ("exp_avg", "exp_avg_sq"):
            assert (s[k][_t(moved, torch.bool)] == 0).all()
            torch.testing.assert_close(s[k][_t(~moved, torch.bool)],
                                       moments[k][i][_t(~moved, torch.bool)],
                                       rtol=0, atol=0)
        if i > 0:  # normals and colours copied from active neighbours
            assert torch.equal(t.detach()[_t(~moved, torch.bool)],
                               before[i][_t(~moved, torch.bool)])


def _config(base, ds, name, n_points=120):
    """tests/test_data_config.py's reseed config at 16 px on the twin."""
    cfg = {
        "name": name,
        "data": {"data_dir": ds, "type": "MVR"},
        "model": {"type": "point", "model_kwargs": {
            "learn_colors": False, "learn_normals": True,
            "learn_points": True, "n_points_per_cloud": n_points}},
        "renderer": {"raster_params": {
            "image_size": 16, "points_per_pixel": 3, "cutoff_threshold": 1.0,
            "radii_backward_scaler": 10.0}},
        "training": {"batch_size": 2, "out_dir": str(base / "exp"),
                     "print_every": 100, "validate_every": -1,
                     "visualize_every": -1, "checkpoint_every": 100},
    }
    path = base / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def twin16(tmp_path_factory):
    base = tmp_path_factory.mktemp("reseed16")
    ds = str(base / "data")
    make_tiny_dataset(ds, device=DEV, views=4, image_size=16, points=400)
    return base, ds


def _sabotage(ck_path):
    """Relocate the cloud's cap x > −0.2 to a floater cluster at (3, 3, 3):
    donors and a coverage hole at once (most of the sphere: at 16 px a
    smaller hole is covered by its neighbours' splats)."""
    ck = dict(np.load(ck_path))
    pts = ck["params/points"].copy()
    cap = pts[:, 0] > -0.2
    assert cap.sum() >= 10
    pts[cap] = np.float32(3.0)
    ck["params/points"] = pts
    np.savez(ck_path, **ck)
    return cap


def test_train_mvr_reseed_every_respawns_points(twin16):
    base, ds = twin16
    cfg = _config(base, ds, "reseed_cli")
    common = ["--config", cfg, "--seed", "0", "--device", "cpu"]
    t_train(common + ["--max-iters", "2"])
    run = base / "exp" / "reseed_cli"
    cap = _sabotage(run / "model.npz")
    t_train(common + ["--max-iters", "6", "--reseed-every", "4",
                      "--reseed-views", "4", "--reseed-max", "16"])
    with np.load(run / "model.npz") as ck2:
        p2 = ck2["params/points"]
    assert p2.shape == (120, 3)
    moved = np.linalg.norm(p2[cap] - 3.0, axis=-1)
    assert (moved > 1.0).sum() >= 4, moved
    rows = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    n = [r["n_reseeded"] for r in rows if "n_reseeded" in r]
    assert len(n) == 1 and 4 <= n[0] <= 16, n


def _grow(app, ck_path, ds, device_flag):
    app.main(["--ckpt", str(ck_path), "--data", ds, "--out", str(ck_path),
              "--n-new", "16", "--views", "4", *device_flag])
    return dict(np.load(ck_path))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_reseed_coverage_grow_and_resume_across_packages(twin16, writer):
    """The port's train_mvr writes a 2-iteration checkpoint, its cap becomes
    floaters, `writer`'s reseed_coverage grows the cloud, and the other
    package's train_mvr resumes it to 4: the shapes follow the checkpoint,
    not the config's 120 points.  (One JAX compile per JAX CLI: its
    reseed_coverage on one side, its train_mvr on the other.)"""
    base, ds = twin16
    name = f"grow_{writer}"
    cfg = _config(base, ds, name)
    t_train(["--config", cfg, "--max-iters", "2", "--seed", "0",
             "--device", "cpu"])
    ck_path = base / "exp" / name / "model.npz"
    _sabotage(ck_path)
    app, flag = ((t_app, ["--device", "cpu"]) if writer == "torch"
                 else (j_app, ["--platform", "cpu"]))
    grown = _grow(app, ck_path, ds, flag)
    n_grown = grown["params/points"].shape[0]
    assert n_grown > 120, "reseed_coverage found no deficit to fill"
    for key, v in grown.items():
        assert not (v.ndim >= 1 and v.shape[0] == 120), f"{key} not grown"
    assert int(grown["__scalar__/it"]) == 2
    assert grown["filters/activation"][120:].all()
    resume = ["--config", cfg, "--max-iters", "4", "--seed", "0"]
    if writer == "torch":
        j_train(resume + ["--platform", "cpu"])
    else:
        t_train(resume + ["--device", "cpu"])
    with np.load(ck_path) as ck2:
        assert ck2["params/points"].shape == (n_grown, 3)
        assert int(ck2["__scalar__/it"]) == 4
        assert np.isfinite(ck2["params/points"]).all()


def test_extend_checkpoint_matches_jax():
    rng = np.random.default_rng(5)
    ck = {"params/points": rng.random((6, 3), dtype=np.float32),
          "opt_state/x/mu": rng.random((6, 3), dtype=np.float32),
          "filters/activation": rng.random(6) > 0.5,
          "step": np.int32(7), "__scalar__/it": np.asarray(3)}
    new = {"params/points": rng.random((2, 3), dtype=np.float32)}
    want = j_app.extend_checkpoint(ck, 6, new)
    got = t_app.extend_checkpoint(ck, 6, new)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_reseed_coverage_app_use_depth(twin16, tmp_path):
    """The port's --use-depth route (the fragment render's front depth):
    a sabotaged checkpoint grows, and every proposal lies inside the hull
    of all four views."""
    base, ds = twin16
    cfg = _config(base, ds, "depth_app")
    t_train(["--config", cfg, "--max-iters", "2", "--seed", "0",
             "--device", "cpu"])
    ck_path = base / "exp" / "depth_app" / "model.npz"
    _sabotage(ck_path)
    out = tmp_path / "grown.npz"
    new_pts, near = t_app.main(["--ckpt", str(ck_path), "--data", ds, "--out",
                                str(out), "--use-depth", "--views", "4",
                                "--device", "cpu"])
    assert len(new_pts) > 0 and len(near) == len(new_pts)
    with np.load(out) as grown:
        assert grown["params/points"].shape[0] == 120 + len(new_pts)
    # proposals sit at the GT depth, the twin's weighted depth at 16 px:
    # near the sphere of radius 0.5
    off = np.abs(np.linalg.norm(new_pts, axis=-1) - 0.5)
    assert np.median(off) < 0.02 and off.max() < 0.1, off
