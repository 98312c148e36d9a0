"""The report and depth-backfill apps (apps/make_result_report.py,
apps/gen_depth_for_dataset.py) against the JAX scripts they port
(scripts/make_result_report.py, scripts/gen_depth_for_dataset.py), on
datasets that the port's create_mvr_data writes at 32² (4 cameras) from an
ellipsoid mesh and from a faceless cloud of it.

gen_depth_for_dataset must write the same files, bit for bit, as
create_mvr_data wrote for the same cameras.  The JAX script writes only
the first image row of each map (it indexes the (S, S) depth with [0], as
if it had a view axis); the port's first row must match it within 1e-5
(its "auto" render is the reference rasterizer, the port's the
tile-binned ops).  The report's metrics against the JAX script's run from
the same checkpoint and config: the cloud metrics rtol 1e-5, PSNR and the
IoU loss rtol 1e-4 (the two render paths again)."""
import importlib.util
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from dss_tpu_torch import config as tconfig
from dss_tpu_torch.apps import (
    create_mvr_data,
    gen_depth_for_dataset,
    make_result_report,
)
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.training.checkpoint import CheckpointIO
from dss_tpu_torch.training.trainer import create_train_state

torch.set_num_threads(2)

DEV = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, CAMS, N_MODEL = 32, 4, 300


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_argv(monkeypatch, tmp_path):
    """Runs a JAX script's main() with argv, its compilation cache under
    tmp_path and the process's jax cache setting restored after."""
    monkeypatch.setenv("DSS_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    old = jax.config.jax_compilation_cache_dir

    def run(mod, argv):
        monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
        mod.main()

    yield run
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apps")
    verts, faces = ico_sphere(level=2, radius=1.0)
    verts = verts * np.asarray([1.0, 0.7, 0.5], np.float32)
    save_ply(str(tmp / "mesh.ply"), verts, faces=faces)
    pts, _ = sample_points_from_mesh(verts, faces, 2000,
                                     rng=np.random.default_rng(0))
    save_ply(str(tmp / "cloud.ply"), pts)
    out = {}
    for label in ("mesh", "cloud"):
        ds = str(tmp / label)
        create_mvr_data.main(["--mesh", str(tmp / f"{label}.ply"), "--out", ds,
                              "--num-cameras", str(CAMS), "--image-size",
                              str(S), "--n-points", "500", "--device", DEV])
        out[label] = (ds, str(tmp / f"{label}.ply"))
    return out


def _copy_without_depth(src, dst):
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "depth"))
    return dst


@pytest.mark.parametrize("label", ["mesh", "cloud"])
def test_gen_depth_rewrites_create_mvr_data_depth(datasets, label, tmp_path,
                                                 jax_argv):
    ds, ply = datasets[label]
    port = _copy_without_depth(ds, str(tmp_path / "port"))
    gen_depth_for_dataset.main(["--data", port, "--mesh", ply, "--device", DEV])
    names = sorted(os.listdir(os.path.join(ds, "depth")))
    assert names == [f"{i:06d}.npy" for i in range(CAMS)]
    assert sorted(os.listdir(os.path.join(port, "depth"))) == names
    jdir = _copy_without_depth(ds, str(tmp_path / "jax"))
    jax_argv(_jax_script("gen_depth_for_dataset"),
             ["--data", jdir, "--mesh", ply, "--platform", "cpu"])
    for n in names:
        want = np.load(os.path.join(ds, "depth", n))
        got = np.load(os.path.join(port, "depth", n))
        assert got.dtype == np.float32 and got.shape == (S, S)
        np.testing.assert_array_equal(got, want, err_msg=n)
        assert 0.05 < (got < 100.0).mean() < 0.95
        jrow = np.load(os.path.join(jdir, "depth", n))
        assert jrow.shape == (S,)
        np.testing.assert_allclose(got[0], jrow, atol=1e-5, err_msg=n)


def test_make_result_report_matches_jax(datasets, tmp_path, jax_argv,
                                        monkeypatch):
    ds, _ = datasets["mesh"]
    # a config at the dataset's size, flattened, where the JAX script
    # looks for it (configs/dss.yml under its working directory)
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "dss.yml"))
    cfg["renderer"]["raster_params"].update(image_size=S, tile_size=16)
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = N_MODEL
    cfg.pop("inherit_from", None)
    cfg_path = str(tmp_path / "configs" / "dss.yml")
    tconfig.save_config(cfg, cfg_path)
    # a checkpoint near the GT cloud, a tenth of it switched off
    rng = np.random.default_rng(1)
    with np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True) as dd:
        gt, gt_n = dd["points"], dd["normals"]
    sel = rng.choice(len(gt), N_MODEL, replace=False)
    params, learn = tconfig.create_model_params(cfg, device=DEV)
    state = create_train_state(params,
                               tconfig.create_optimizer(cfg, params, learn))
    with torch.no_grad():
        params.points.copy_(torch.tensor(
            gt[sel] + rng.normal(0, 0.01, (N_MODEL, 3)).astype(np.float32)))
        params.normals.copy_(torch.tensor(gt_n[sel]))
    state.filters.activation[: N_MODEL // 10] = False
    ckpt = CheckpointIO(str(tmp_path / "run")).save("model.npz", state, it=5)

    views = ["--views", "0", "1", "2", "3"]
    got = make_result_report.main(
        ["--data", ds, "--ckpt", ckpt, "--out", str(tmp_path / "port"),
         "--config", cfg_path, "--json-name", "m_metrics.json",
         "--device", DEV] + views)
    monkeypatch.chdir(tmp_path)
    jax_argv(_jax_script("make_result_report"),
             ["--data", ds, "--ckpt", ckpt, "--out", str(tmp_path / "jax"),
              "--json-name", "m_metrics.json", "--platform", "cpu"] + views)
    with open(tmp_path / "jax" / "m_metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "m_metrics.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) == {
        "iters", "chamfer", "hausdorff", "p2f", "chamfer_normal",
        "psnr_4views", "iou_loss_4views"}
    assert got["iters"] == want["iters"] == 5
    for k in ("chamfer", "hausdorff", "p2f", "chamfer_normal"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("psnr_4views", "iou_loss_4views"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(list(got.values())).all()
    grid = read_png(str(tmp_path / "port" / "m_gt_vs_pred.png"))
    assert grid.shape == (4 * S, 2 * S, 3)
