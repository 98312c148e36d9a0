"""The train CLI of dss_tpu_torch against dss_tpu's, both on the CPU on the
same tiny dataset (written by scripts/make_tiny_dataset.py: 4 views of a
colour-banded sphere at 32², 300 points), and the port's dataset twin
against that script.

The runs use `backend: reference` on both sides with `print_every: 1` (the
JAX CLI then dispatches one step per program), 2 views per step, depth L1,
the projection and repulsion losses, radii annealing every 3 steps and lr
milestones at steps 2 and 6, colours frozen as in the flagship.  Each
package trains 4 iterations from scratch; each checkpoint at 4 then
resumes in both packages to 8, evaluating at 4 and 8.

Tolerances, from what was measured on the CPU when this test was written:

- From the same state (iteration 1 from scratch, and the 4 iterations a
  checkpoint of either package resumes for in both): loss parts agreed
  within 5.1e-7 relative, evals within 1.3e-6, parameters within 3e-7.
  Held at loss parts rtol 1e-4, evals rtol 1e-3, parameters atol 1e-4.
- Each package's own 8 iterations from scratch: at iteration 2 the two
  packages, given the same JAX-written state, differ in the depth loss
  (0.0030948543 against 0.0030933577) while rgb and silhouette agree: one
  fragment sits at a depth-window tie that the last bit of its z decides,
  and XLA's and torch's float32 arithmetic round it apart.  From there the
  trajectories drift: loss parts up to 1.57e-2 relative (silhouette at
  iteration 6), evals 1.55e-3 (chamfer), points 5.1e-3.  Held at loss parts
  rtol 3e-2, evals rtol 5e-3, parameters atol 2e-2.
"""
import json
import logging
import os
import shutil
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from dss_tpu.apps.train_mvr import main as jax_main
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as torch_main
from dss_tpu_torch.data import png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(views=4, image_size=32, points=300)
LEARN_COLORS = False
LOSS_KEYS = ("loss", "loss_dr_rgb", "loss_dr_silhouette", "loss_dr_depth",
             "loss_dr_proj", "loss_dr_repel")
EVAL_KEYS = ("val/iou_loss", "val/psnr", "val/chamfer_point",
             "val/chamfer_normal")
PARAMS = ("params/points", "params/normals", "params/colors")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The JAX script's dataset, written in a subprocess."""
    base = tmp_path_factory.mktemp("cli")
    ds = str(base / "jax_ds")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "make_tiny_dataset.py"),
         "--out", ds, "--views", str(TINY["views"]), "--image-size",
         str(TINY["image_size"]), "--points", str(TINY["points"]),
         "--platform", "cpu"],
        cwd=ROOT, env=env, check=True, capture_output=True, timeout=600)
    return base, ds


def _config(base, ds, backend="reference", **training):
    cfg = {
        "name": "run",
        "data": {"data_dir": ds},
        "model": {"model_kwargs": {"n_points_per_cloud": 200,
                                   "learn_colors": LEARN_COLORS}},
        "renderer": {"raster_params": {
            "image_size": TINY["image_size"], "points_per_pixel": 5,
            "cutoff_threshold": 1.0, "Vrk_invariant": True,
            "Vrk_isotropic": False, "backface_culling": True,
            "radii_backward_scaler": 10.0, "clip_pts_grad": 0.05,
            "backend": backend}},
        "training": {
            "out_dir": str(base / "exp"), "batch_size": 2, "print_every": 1,
            "validate_every": 4, "checkpoint_every": 4,
            "visualize_every": -1, "lambda_dr_proj": 0.01,
            "lambda_dr_repel": 0.1, "lambda_dr_depth": 0.1,
            "steps_dss_backward_radii": 3, "scheduler_milestones": [1, 3],
            **training},
    }
    path = base / f"{backend}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(pkg, cfg, name, iters):
    common = ["--config", cfg, "--name", name, "--max-iters", str(iters),
              "--seed", "0"]
    if pkg == "jax":
        jax_main(common + ["--platform", "cpu"])
    else:
        torch_main(common + ["--device", "cpu"])


def _copy_run(base, src, dst):
    shutil.copytree(base / "exp" / src, base / "exp" / dst)


@pytest.fixture(scope="module")
def runs(work):
    """Each package trains 0 → 4; each checkpoint at 4 resumes in both
    packages to 8: `<writer>_<resumer>`."""
    base, ds = work
    cfg = _config(base, ds)
    for pkg in ("jax", "torch"):
        _run(pkg, cfg, pkg, 4)
        for other in ("jax", "torch"):
            _copy_run(base, pkg, f"{pkg}_{other}")
    for writer in ("jax", "torch"):
        for resumer in ("jax", "torch"):
            _run(resumer, cfg, f"{writer}_{resumer}", 8)
    return base / "exp"


def _metrics(run_dir):
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r for r in rows if "loss" in r}
    evals = {r["step"]: r for r in rows if "val/psnr" in r}
    return losses, evals


def _checkpoint(run_dir):
    with np.load(run_dir / "model.npz") as f:
        return {k: f[k] for k in f.files}


# (loss parts rtol, evals rtol, params atol): see the module docstring
SAME_STATE = (1e-4, 1e-3, 1e-4)
OWN_TRAJECTORIES = (3e-2, 5e-3, 2e-2)


def _agree(a_dir, b_dir, steps, tol, params=True):
    la, ea = _metrics(a_dir)
    lb, eb = _metrics(b_dir)
    for s in steps:
        for k in LOSS_KEYS:
            np.testing.assert_allclose(lb[s][k], la[s][k], rtol=tol[0],
                                       err_msg=f"it {s} {k}")
        assert la[s]["params_finite"] == lb[s]["params_finite"] == 1.0
        assert la[s]["bin_overflow"] == lb[s]["bin_overflow"] == 0.0
    for s in sorted(ea):
        if s in steps:
            for k in EVAL_KEYS:
                np.testing.assert_allclose(eb[s][k], ea[s][k], rtol=tol[1],
                                           err_msg=f"eval at {s} {k}")
    ca, cb = _checkpoint(a_dir), _checkpoint(b_dir)
    if params:
        for k in PARAMS:
            np.testing.assert_allclose(cb[k], ca[k], atol=tol[2], err_msg=k)
    return ca, cb


def test_cli_parity_on_the_reference_backend(runs):
    """Each package's own 8 iterations (4, then resumed to 8): the first
    from the same initial state, all of them within their drift."""
    _agree(runs / "jax", runs / "torch", [1], SAME_STATE, params=False)
    ca, cb = _agree(runs / "jax_jax", runs / "torch_torch", range(1, 9),
                    OWN_TRAJECTORIES)
    la, ea = _metrics(runs / "jax_jax")
    assert sorted(la) == list(range(1, 9)) and sorted(ea) == [4, 8]
    assert int(ca["step"]) == int(cb["step"]) == 8
    # the points moved: the comparison is not of two untouched clouds
    init = _checkpoint(runs / "jax")
    assert np.abs(ca["params/points"] - init["params/points"]).max() > 1e-3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_resumes_in_the_other_package(runs, writer):
    other = "torch" if writer == "jax" else "jax"
    ca, cb = _agree(runs / f"{writer}_{writer}", runs / f"{writer}_{other}",
                    range(5, 9), SAME_STATE)
    assert int(cb["__scalar__/it"]) == 8 and int(cb["step"]) == 8
    for k, v in ca.items():
        if "/count" in k or k.startswith("filters/"):
            np.testing.assert_array_equal(cb[k], v, err_msg=k)


def test_checkpoints_share_the_key_layout(runs):
    """Same keys, shapes and dtypes (milestones on: the schedule counts
    are written too)."""
    ja, to = _checkpoint(runs / "jax"), _checkpoint(runs / "torch")
    assert sorted(ja) == sorted(to)
    assert "opt_state/inner_states/points/inner_state/1/count" in to
    for k in ja:
        assert ja[k].shape == to[k].shape and ja[k].dtype == to[k].dtype, k
    assert int(to["opt_state/inner_states/points/inner_state/0/count"]) == 4


def test_default_backend_trains_writes_and_resumes(work, caplog):
    """The port's own tile-binned ops (their plain versions on the CPU):
    finite metrics and evals, every artifact, and a resume."""
    base, ds = work
    cfg = _config(base, ds, backend="auto", validate_every=2,
                  checkpoint_every=2, visualize_every=2, print_every=2)
    torch_main(["--config", cfg, "--name", "auto", "--max-iters", "4",
                "--device", "cpu"])
    with caplog.at_level("INFO", logger="train_mvr"):
        torch_main(["--config", cfg, "--name", "auto", "--max-iters", "6",
                    "--device", "cpu"])
    assert "resumed from model.npz at it=4" in caplog.text
    run = base / "exp" / "auto"
    for f in ("model.npz", "model_best.npz", "shape_pts.ply", "metrics.jsonl",
              "config.yaml", "vis/points_animation.html"):
        assert (run / f).exists(), f
    losses, evals = _metrics(run)
    assert sorted(losses) == [2, 4, 6] and sorted(evals) == [2, 4, 6]
    for r in [*losses.values(), *evals.values()]:
        assert all(np.isfinite(v) for v in r.values()), r
    assert all(r["params_finite"] == 1.0 for r in losses.values())
    assert int(_checkpoint(run)["step"]) == 6


@pytest.mark.parametrize("flag", ["--reseed-every"])
def test_unported_flags_raise(flag, work, caplog):
    """The CLI once raised NotImplementedError for the JAX CLI's flags it
    lacked; the last of them, --reseed-every, is ported: it runs its event
    and raises nothing."""
    base, ds = work
    with caplog.at_level(logging.INFO, logger="train_mvr"):
        state = torch_main(["--config", _config(base, ds), "--name",
                            "reseed_flag", flag, "2", "--max-iters", "2",
                            "--device", "cpu"])
    assert state.step == 2
    assert "reseed" in caplog.text


def test_no_card_and_no_device_raises(work, monkeypatch):
    base, ds = work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        torch_main(["--config", _config(base, ds)])


def test_twin_writes_the_jax_scripts_dataset(work):
    """The twin on the reference backend against the JAX script: images and
    masks within 1/255, depth at rtol 1e-5, the point cloud exactly, the
    colours and cameras within 1 ulp (torch's float32 sin and cos differ
    from XLA's by 1 ulp on some inputs), and the same config."""
    base, ds = work
    out = str(base / "twin")
    make_tiny_dataset(out, device="cpu", backend="reference", **TINY)
    for sub in ("image", "mask"):
        names = sorted(os.listdir(os.path.join(ds, sub)))
        assert names == sorted(os.listdir(os.path.join(out, sub)))
        for n in names:
            want = imageio.imread(os.path.join(ds, sub, n)).astype(int)
            got = png.read_png(os.path.join(out, sub, n)).astype(int)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1, (sub, n)
            if sub == "mask":
                assert 0 < (got > 127).mean() < 1
    for n in sorted(os.listdir(os.path.join(ds, "depth"))):
        np.testing.assert_allclose(np.load(os.path.join(out, "depth", n)),
                                   np.load(os.path.join(ds, "depth", n)),
                                   rtol=1e-5)
    want = np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True)
    got = np.load(os.path.join(out, "data_dict.npz"), allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for k in ("points", "normals"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("colors", "camera_mat"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2.4e-7,
                                   err_msg=k)
    assert got["cameras_params"].item() == want["cameras_params"].item()
    assert str(got["cameras_type"]) == str(want["cameras_type"])
    with open(os.path.join(ds, "config.yml")) as f:
        want_cfg = yaml.safe_load(f.read().replace(ds, out))
    with open(os.path.join(out, "config.yml")) as f:
        assert yaml.safe_load(f) == want_cfg
