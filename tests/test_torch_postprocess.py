"""The flagship post-process of dss_tpu_torch against dss_tpu on the same
numpy inputs: the point metrics, the cameras from matrices and at random,
`MVRDataset.get_depths`, the eval render, the three prunes, the
prune_floaters / refine_normals / evaluate_pcl apps on a 64² dataset twin
against the JAX apps on the same checkpoint, and `train_mvr
--prune-every`.

Tolerances: metrics rtol 1e-5; camera matrices bit-equal; keep-masks
equal; refined normals cos ≥ 1 − 1e-4; renders within 1e-5."""
import json
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.apps import evaluate_pcl as j_eval
from dss_tpu.apps import prune_floaters as j_prune
from dss_tpu.apps import refine_normals as j_refine
from dss_tpu.data.dataset import MVRDataset as JDataset
from dss_tpu.geometry import cameras as jcam
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models import point_model as jpm
from dss_tpu.render.ewa import RasterSettings as JSettings
from dss_tpu.training import metrics as jmet
from dss_tpu_torch.apps import evaluate_pcl as t_eval
from dss_tpu_torch.apps import prune_floaters as t_prune
from dss_tpu_torch.apps import refine_normals as t_refine
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as train_main
from dss_tpu_torch.apps.train_mvr import resize_masks_nearest
from dss_tpu_torch.data.dataset import MVRDataset
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.geometry import cameras as tcam
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models import point_model as tpm
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training import metrics as tmet
from dss_tpu_torch.utils import yaml_lite
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")
TWIN = dict(views=8, image_size=64, points=2000)
N_SURF, N_OUT, N_IN = 600, 16, 16


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    gt = fibonacci_sphere(500, 0.5)
    gt_n = gt / np.linalg.norm(gt, axis=-1, keepdims=True)
    pred = (fibonacci_sphere(400, 0.5)
            + rng.normal(0, 0.01, (400, 3))).astype(np.float32)
    pred[:5] *= 1.6  # outliers
    pm = rng.random(400) > 0.2
    gm = rng.random(500) > 0.1
    return pred, gt, gt_n, pm, gm


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_chamfer_hausdorff_matches_jax(clouds, masked):
    pred, gt, _, pm, gm = clouds
    m = (pm, gm) if masked else (None, None)
    want = jmet.chamfer_hausdorff(jnp.asarray(pred), jnp.asarray(gt),
                                  *[None if x is None else jnp.asarray(x) for x in m])
    got = tmet.chamfer_hausdorff(_t(pred), _t(gt),
                                 *[None if x is None else _t(x, torch.bool) for x in m])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("normals,masked", [(True, False), (False, False),
                                            (True, True)],
                         ids=["gt-normals", "pca-normals", "masked"])
def test_point_to_surface_matches_jax(clouds, normals, masked):
    pred, gt, gt_n, pm, gm = clouds
    kw_j = dict(gt_normals=jnp.asarray(gt_n) if normals else None)
    kw_t = dict(gt_normals=_t(gt_n) if normals else None)
    if masked:
        kw_j.update(pred_mask=jnp.asarray(pm), gt_mask=jnp.asarray(gm))
        kw_t.update(pred_mask=_t(pm, torch.bool), gt_mask=_t(gm, torch.bool))
    want = float(jmet.point_to_surface(jnp.asarray(pred), jnp.asarray(gt), **kw_j))
    got = tmet.point_to_surface(_t(pred), _t(gt), **kw_t).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 1e-3


def test_uniformity_nuc_matches_jax(clouds):
    """Without a mask against dss_tpu; with a mask against dss_tpu on the
    masked subset (dss_tpu's own masked value is NaN: the masked-out rows'
    infinite distances meet a zero weight, 0·inf)."""
    pred, _, _, pm, _ = clouds
    np.testing.assert_allclose(tmet.uniformity_nuc(_t(pred)).item(),
                               float(jmet.uniformity_nuc(jnp.asarray(pred))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        tmet.uniformity_nuc(_t(pred), _t(pm, torch.bool)).item(),
        float(jmet.uniformity_nuc(jnp.asarray(pred[pm]))), rtol=1e-5)
    assert np.isnan(float(jmet.uniformity_nuc(jnp.asarray(pred),
                                              jnp.asarray(pm))))


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------


def _cam_mats(c):
    return [np.asarray(x) for x in (c.R, c.T, c.world_to_view_matrix(),
                                    c.projection_matrix(),
                                    c.full_projection_matrix())]


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "one"])
def test_cameras_from_matrix_bit_equal_to_jax(batched):
    rng = np.random.default_rng(1)
    m = rng.standard_normal((5, 4, 4)).astype(np.float32)
    m[:, :3, 3] = 0
    m[:, 3, 3] = 1
    m = m if batched else m[2]
    kw = dict(fov=47.0, znear=0.2, zfar=50.0)
    want = _cam_mats(jcam.cameras_from_matrix(jnp.asarray(m), **kw))
    got = _cam_mats(tcam.cameras_from_matrix(m, **kw, device="cpu"))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] == (5 if batched else 1)


def test_sample_random_cameras_ranges_and_sort():
    """The random stream cannot match jax.random: ranges, the descending
    distances, and a seeded generator's reproducibility."""
    kw = dict(num_cams=64, min_dist=1.5, max_dist=3.0, at_jitter=0.05,
              fov=50.0, device="cpu")
    c = tcam.sample_random_cameras(**kw, generator=torch.Generator().manual_seed(3))
    again = tcam.sample_random_cameras(**kw, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c.R, again.R) and torch.equal(c.T, again.T)
    pos = c.camera_position()
    # the look-at point is within the jitter box; distance to it in range
    fwd = c.R[:, :, 2]  # camera z axis, toward the look-at point
    at_dist = torch.linalg.vector_norm(pos, dim=-1)
    assert float(at_dist.min()) >= 1.5 - 0.1 and float(at_dist.max()) <= 3.0 + 0.1
    # the distance along the view axis to the jittered target, descending
    dist = -torch.sum(pos * fwd, -1)
    assert bool(torch.all(dist[:-1] >= dist[1:] - 0.1))
    assert torch.allclose(c.fov, torch.full((64,), 50.0))
    unsorted = tcam.sample_random_cameras(
        **kw, sort_distances=False, generator=torch.Generator().manual_seed(3))
    assert not torch.equal(unsorted.T, c.T)
    # elevation spans both hemispheres, azimuth all quadrants
    assert float(pos[:, 1].min()) < 0 < float(pos[:, 1].max())
    assert len({(bool(x > 0), bool(z > 0)) for x, z in pos[:, [0, 2]].tolist()}) == 4


# ---------------------------------------------------------------------------
# The dataset twin, a checkpoint with floaters, and the prunes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """A 64² twin (8 views, 2000-point GT sphere of radius 0.5) and a
    checkpoint: 600 surface points, 16 floaters at radius 0.8, 16 inside at
    radius ≤ 0.3, noisy normals, a few points already inactive."""
    base = tmp_path_factory.mktemp("post")
    ds = str(base / "data")
    make_tiny_dataset(ds, device="cpu", **TWIN)
    rng = np.random.default_rng(2)
    surf = fibonacci_sphere(N_SURF, 0.5)
    d = rng.standard_normal((N_OUT + N_IN, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.concatenate([np.full(N_OUT, 0.8), rng.uniform(0.0, 0.3, N_IN)])
    pts = np.concatenate([surf, d * r[:, None]]).astype(np.float32)
    nrm = pts + 0.3 * rng.standard_normal(pts.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    act = np.ones(len(pts), bool)
    act[::97] = False
    ck = {"params/points": pts, "params/normals": nrm,
          "params/colors": np.ones_like(pts), "filters/activation": act,
          "filters/visibility": act.copy(), "filters/inmask": act.copy(),
          "step": np.asarray(10, np.int32)}
    return base, ds, ck


def _write_ckpt(base, tag, ck):
    d = base / tag
    d.mkdir(exist_ok=True)
    path = str(d / "model_best.npz")
    np.savez(path, **ck)
    return path


def _cams_both(ds_dir):
    jd = JDataset(ds_dir, load_dense_depth=True)
    td = MVRDataset(ds_dir, load_dense_depth=True)
    jc = jcam.cameras_from_matrix(jd.camera_mat, **jd.cameras_params)
    tc = tcam.cameras_from_matrix(td.camera_mat, **td.cameras_params, device="cpu")
    return jd, td, jc, tc


def test_get_depths_matches_jax(twin):
    _, ds, _ = twin
    jd, td, _, _ = _cams_both(ds)
    np.testing.assert_array_equal(td.get_depths(), jd.get_depths())
    np.testing.assert_array_equal(td.get_depths([3, 1]), jd.get_depths([3, 1]))
    assert td.get_depths().shape == (TWIN["views"], 64, 64)
    assert MVRDataset(ds).get_depths() is None


def test_prune_outside_silhouette_and_depth_match_jax(twin):
    _, ds, ck = twin
    jd, td, jc, tc = _cams_both(ds)
    pts = ck["params/points"]
    want = np.asarray(jpm.prune_outside_silhouette(
        jnp.asarray(pts), jc, jnp.asarray(jd.masks), outside_frac=0.09))
    got = tpm.prune_outside_silhouette(_t(pts), tc, _t(td.masks),
                                       outside_frac=0.09).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[N_SURF:N_SURF + N_OUT].any()  # the outer floaters go
    want_d = np.asarray(jpm.prune_depth_inconsistent(
        jnp.asarray(pts), jc, jnp.asarray(jd.get_depths()), tol=0.03,
        min_views=3))
    got_d = tpm.prune_depth_inconsistent(_t(pts), tc, _t(td.get_depths()),
                                         tol=0.03, min_views=3).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    assert not got_d[N_SURF:].any()  # every floater, inside ones included
    assert got_d[:N_SURF].any()


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_prune_dead_points_matches_jax(backend):
    """tests/test_losses_training.py's scene: 200 sphere points and 20
    strays far off to the side, 2 views at 24², an all-ones mask; the
    backend named on both sides (tile 8 for the tile-binned ops)."""
    pts = np.concatenate([fibonacci_sphere(200, 0.4),
                          np.tile([[5.0, 5.0, 0.0]], (20, 1))]).astype(np.float32)
    nrm = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9)
    r, t = tcam.look_at_view_transform(dist=torch.tensor([2.0, 2.0]),
                                       elev=torch.tensor([0.0, 30.0]),
                                       azim=torch.tensor([0.0, 120.0]))
    kw = dict(image_size=24, points_per_pixel=3, backend=backend, tile_size=8)
    want = np.asarray(jpm.prune_dead_points(
        jpm.PointModelParams.create(jnp.asarray(pts), jnp.asarray(nrm)),
        JFilters.ones(220), jcam.FoVPerspectiveCameras.create(
            jnp.asarray(r.numpy()), jnp.asarray(t.numpy()), fov=60.0),
        JSettings(**kw), jnp.ones((2, 24, 24))))
    got = tpm.prune_dead_points(
        tpm.PointModelParams.create(pts, nrm, device="cpu"),
        PointFilters.ones(220, device="cpu"),
        tcam.FoVPerspectiveCameras.create(r, t, fov=60.0, device="cpu"),
        RasterSettings(**kw), torch.ones((2, 24, 24))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:200].mean() > 0.45 and not got[200:].any()


def test_prune_dead_points_takes_jax_abs():
    """With the render itself as the mask, alpha − mask is 0 at every
    pixel: only d|x|/dx = 1 at 0 (the JAX convention, `jax_abs`) gives the
    points a gradient; torch.abs would call every point dead."""
    pts = fibonacci_sphere(100, 0.4)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = tcam.look_at_view_transform(dist=torch.tensor([2.0]),
                                       elev=torch.tensor([0.0]),
                                       azim=torch.tensor([0.0]))
    st = RasterSettings(image_size=24, points_per_pixel=3, tile_size=8)
    args = (tpm.PointModelParams.create(pts, nrm, device="cpu"),
            PointFilters.ones(100, device="cpu"),
            tcam.FoVPerspectiveCameras.create(r, t, fov=60.0, device="cpu"), st)
    with torch.no_grad():
        rgba = tpm.render_model(*args[:3], None, st)
    alive = tpm.prune_dead_points(*args, rgba[..., 3].clone())
    assert alive.sum() > 30


def test_render_model_matches_jax(twin):
    _, ds, ck = twin
    jd, td, jc, tc = _cams_both(ds)
    pts, nrm = ck["params/points"], ck["params/normals"]
    act = ck["filters/activation"]
    kw = dict(image_size=32, tile_size=16, backend="pallas")
    want = np.asarray(jpm.render_model(
        jpm.PointModelParams.create(jnp.asarray(pts), jnp.asarray(nrm)),
        JFilters(activation=jnp.asarray(act), visibility=jnp.asarray(act),
                 inmask=jnp.asarray(act)), jc, None, JSettings(**kw)))
    got = tpm.render_model(
        tpm.PointModelParams.create(pts, nrm, device="cpu"),
        PointFilters(_t(act, torch.bool), _t(act, torch.bool), _t(act, torch.bool)),
        tc, None, RasterSettings(**kw)).numpy()
    assert got.shape == (8, 32, 32, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert want[..., 3].mean() > 0.1


# ---------------------------------------------------------------------------
# The apps against the JAX apps on the same checkpoint
# ---------------------------------------------------------------------------


def test_prune_floaters_app_matches_jax(twin, capsys):
    base, ds, ck = twin
    argv = ["--data", ds, "--depth-tol", "0.03", "--depth-min-views", "3"]
    jpath, tpath = _write_ckpt(base, "jax", ck), _write_ckpt(base, "torch", ck)
    j_prune.main(["--ckpt", jpath, *argv, "--platform", "cpu"])
    jout = capsys.readouterr().out
    act = t_prune.main(["--ckpt", tpath, *argv, "--device", "cpu"])
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "depth-consistency drops" in out and "after : chamfer" in out
    want = dict(np.load(jpath.replace(".npz", "_pruned.npz")))
    got = dict(np.load(tpath.replace(".npz", "_pruned.npz")))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(act, want["filters/activation"])
    assert not act[N_SURF:].any() and act[:N_SURF].any()
    for sfx in ("_pruned.ply",):
        assert os.path.exists(tpath.replace(".npz", sfx))
    # the same lines, numbers within the printed digits' last place
    assert [ln.split()[0] for ln in tout.splitlines()] == \
        [ln.split()[0] for ln in jout.splitlines()]


def test_refine_normals_app_matches_jax(twin, capsys):
    base, ds, ck = twin
    argv = ["--data", ds, "--jet-passes", "3"]
    jpath = _write_ckpt(base, "jax_r", ck)
    tpath = _write_ckpt(base, "torch_r", ck)
    j_refine.main(["--ckpt", jpath, *argv, "--platform", "cpu"])
    jout = capsys.readouterr().out
    t_refine.main(["--ckpt", tpath, *argv, "--device", "cpu"])
    tout = capsys.readouterr().out
    want = dict(np.load(jpath.replace(".npz", "_jet.npz")))
    got = dict(np.load(tpath.replace(".npz", "_jet.npz")))
    assert sorted(got) == sorted(want)
    cos = np.sum(got["params/normals"] * want["params/normals"], -1)
    assert np.all(cos >= 1 - 1e-4), cos.min()
    for k in want:
        if k != "params/normals":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def cn(out):
        rows = [ln.split() for ln in out.splitlines() if "chamfer_normal" in ln]
        return [float(r[-1]) for r in rows]

    np.testing.assert_allclose(cn(tout), cn(jout), atol=2e-4)
    before, after = cn(tout)
    assert after < before
    assert os.path.exists(tpath.replace(".npz", "_jet.ply"))


def test_evaluate_pcl_app_matches_jax(twin, tmp_path):
    _, ds, ck = twin
    dd = np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True)
    gt = str(tmp_path / "gt.ply")
    save_ply(gt, dd["points"], normals=dd["normals"])
    preds = []
    for i, sl in enumerate((slice(0, N_SURF), slice(None))):
        preds.append(str(tmp_path / f"pred{i}.ply"))
        save_ply(preds[-1], ck["params/points"][sl])
    want = j_eval.main(["--pred", *preds, "--gt", gt, "--platform", "cpu"])
    got = t_eval.main(["--pred", *preds, "--gt", gt, "--device", "cpu",
                       "--csv", str(tmp_path / "m.csv")])
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        for k in ("chamfer", "hausdorff", "p2f", "nuc"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    lines = (tmp_path / "m.csv").read_text().splitlines()
    assert lines[0] == "name,chamfer,hausdorff,p2f,nuc" and len(lines) == 3


# ---------------------------------------------------------------------------
# train_mvr --prune-every
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 128, 64), (2, 64, 64), (2, 96, 64),
                                   (1, 100, 64)],
                         ids=["2x", "same", "1.5x", "odd"])
def test_prune_masks_resize_as_jax_nearest(shape):
    """The prune's mask downsample against jax.image.resize(..., "nearest"),
    bit for bit (torch's "nearest" takes the other pixel of each pair at
    2×)."""
    import jax.image

    b, s, out = shape
    m = (np.random.default_rng(s).random((b, s, s)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (b, out, out), "nearest"))
    got = resize_masks_nearest(torch.tensor(m), out).numpy()
    np.testing.assert_array_equal(got, want)


def test_train_mvr_prune_every_logs_and_resumes(twin, caplog):
    base, ds, _ = twin
    cfg = yaml_lite.load(os.path.join(ds, "config.yml"))
    cfg["training"].update(out_dir=str(base / "exp"), print_every=2,
                           validate_every=100, checkpoint_every=100)
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 400
    path = str(base / "prune.yml")
    yaml_lite.dump(cfg, path)
    argv = ["--config", path, "--prune-every", "2", "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="train_mvr"):
        train_main(argv + ["--max-iters", "4"])
        train_main(argv + ["--max-iters", "6"])
    pruned = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("pruned to ")]
    assert len(pruned) == 3, pruned  # it 2, 4; resumed: 6
    assert "resumed from model.npz at it=4" in caplog.text
    run = base / "exp" / cfg["name"]
    rows = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    counts = {r["step"]: r["n_active_points"] for r in rows
              if "n_active_points" in r}
    assert sorted(counts) == [2, 4, 6]
    for msg, (step, n) in zip(pruned, sorted(counts.items())):
        assert msg == f"pruned to {int(n)} active points"
    assert 0 < counts[6] <= counts[4] <= counts[2] <= 400
    with np.load(run / "model.npz") as f:
        assert int(f["filters/activation"].sum()) == counts[6]
    shutil.rmtree(run)
