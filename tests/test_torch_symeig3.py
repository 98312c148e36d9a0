"""The port's 3×3 eigensolver (ops/kernels.py `symeig3_plain`, the CPU path
of `symeig3` and of `mathutil.symeig3x3`) against dss_tpu's
`jnp.linalg.eigh` on the same numpy inputs, and what it carries: the
anisotropic Vrk (`compute_vrk`) and a train window with the anisotropic Vrk
and the PCA normal anchor, against dss_tpu's scan window.

Tolerances:

- Eigenvalues rtol 1e-5 with atol 1e-6 of the row's largest |λ|: both
  solvers are backward stable, ~eps·max|λ| each (measured here: Jacobi
  within 3e-7·max|λ| of a float64 solve, LAPACK within 9e-7).
- Eigenvectors up to sign, where the relative gap (the distance to the
  nearest other eigenvalue over the row's largest |λ|) is at least 1e-3:
  |Δ| ≤ 4e-6 / gap, the first-order bound for two such solvers (measured
  |Δ v vᵀ|·gap ≤ 1.1e-6).  Below that gap the eigenvector is
  ill-conditioned in both packages.
- Gradients (rows with a relative gap ≥ 0.05): rtol 1e-4 with atol 1e-5
  of the largest |g|, test_torch_aux.py's eigenvalue-gradient tolerance.
- Vrk = Σₖ λₖ tₖtₖᵀ over the tangents is sign-free: rtol 1e-4 with atol
  1e-6 of max |Vrk| on points whose normal eigenvalue is separated
  (test_torch_normals.py's frames rule).
- The train window: test_torch_train_cli.py's SAME_STATE (loss parts rtol
  1e-4, parameters atol 1e-4).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dss_tpu.apps.train_mvr import main as jax_main
from dss_tpu.render import ewa as jewa
from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
from dss_tpu_torch.apps.train_mvr import main as torch_main
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.utils import mathutil as tmu
from tests.test_torch_normals import noisy_sphere

torch.set_num_threads(2)

DEV = "cpu"
N = 2000
SAME_STATE = (1e-4, 1e-4)
PARAMS = ("params/points", "params/normals", "params/colors")


def _family(name):
    """(N, 3, 3) float32 symmetric matrices of one family, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    u = lambda lo, hi: rng.uniform(lo, hi, N)
    if name == "symmetric":
        a = rng.standard_normal((N, 3, 3))
        m = (a + np.swapaxes(a, 1, 2)) / 2
    elif name == "spd":
        a = rng.standard_normal((N, 3, 3))
        m = a @ np.swapaxes(a, 1, 2)
    elif name == "planar":  # λ₀ = 0 or ≪ the others: a plane's covariance
        w0 = np.where(rng.random(N) < 0.5, 0.0, 10.0 ** u(-9, -5))
        m = chip_smoke._rotated(rng, np.stack([w0, u(0.5, 2), u(0.5, 2)], -1)
                                * 1e-2)
    elif name == "line":  # two equal eigenvalues, below or above the third
        lo = rng.random(N) < 0.5
        a, b = u(0.1, 1), u(1.5, 2)
        w = np.where(lo[:, None], np.stack([a, a, b], -1),
                     np.stack([a, b, b], -1))
        m = chip_smoke._rotated(rng, w)
    elif name == "graded":  # eigenvalues over many decades
        m = chip_smoke._rotated(rng, np.stack(
            [10.0 ** u(-8, -4), 10.0 ** u(-4, -2), np.ones(N)], -1))
    else:  # the normals' own input: 8-NN covariances of a noisy sphere
        from dss_tpu_torch.geometry.normals import local_covariances

        pts, _, _, _ = noisy_sphere(N, 7)
        m = local_covariances(torch.tensor(pts), None, 8)[0].numpy()
    return np.ascontiguousarray(m, dtype=np.float32)


def _rel_gaps(w):
    return chip_smoke._rel_gaps(torch.tensor(np.asarray(w))).numpy()


def _hold_to_eigh(m, w, v):
    jw, jv = map(np.asarray, jnp.linalg.eigh(jnp.asarray(m)))
    rowmax = np.abs(jw).max(axis=1, keepdims=True)
    bad = np.abs(w - jw) > 1e-5 * np.abs(jw) + 1e-6 * rowmax
    assert not bad.any(), (np.abs(w - jw) / rowmax).max()
    gap = _rel_gaps(jw)
    ok = gap >= 1e-3
    sign = np.where(np.sum(v * jv, axis=1, keepdims=True) < 0, -1.0, 1.0)
    dv = np.abs(v * sign - jv).max(axis=1)
    assert np.all(dv[ok] <= 4e-6 / gap[ok]), (dv[ok] * gap[ok]).max()
    return ok


@pytest.mark.parametrize("family", ["symmetric", "spd", "planar", "line",
                                    "graded", "sphere-covariances"])
def test_plain_matches_jax_eigh(family):
    m = _family(family)
    w, v = kernels.symeig3_plain(torch.tensor(m))
    w, v = w.numpy(), v.numpy()
    ok = _hold_to_eigh(m, w, v)
    assert np.all(np.diff(w, axis=1) >= 0)  # ascending
    # eigenvectors orthonormal, and V diag(w) Vᵀ gives the matrix back
    np.testing.assert_allclose(np.swapaxes(v, 1, 2) @ v,
                               np.broadcast_to(np.eye(3), v.shape), atol=2e-6)
    rec = np.einsum("nij,nj,nkj->nik", v, w, v)
    scale = np.abs(w).max(axis=1)[:, None, None]
    assert np.all(np.abs(rec - m) <= 4e-6 * scale)
    # the eigenvectors held: all but the equal pairs of "line" and the
    # small eigenvalues of "graded" (gaps of 1e-8–1e-2 of the largest)
    assert ok.mean() > {"line": 0.33, "graded": 0.6}.get(family, 0.99)
    # symeig3 is the plain version on CPU tensors, and reads only the
    # lower triangle
    upper = m.copy()
    iu = np.triu_indices(3, 1)
    upper[:, iu[0], iu[1]] = 7.0
    w2, v2 = kernels.symeig3(torch.tensor(upper))
    np.testing.assert_array_equal(w2.numpy(), w)
    np.testing.assert_array_equal(v2.numpy(), v)


def test_zero_and_nan_rows():
    """A zero matrix (every masked-out point's covariance): λ = 0 and V = I,
    as jnp.linalg.eigh gives.  A NaN (or infinite) entry: NaN in all of the
    row's λ and V; jnp.linalg.eigh puts NaN in some of them (LAPACK's
    answer depends on where the NaN is), never all finite values."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 3, 3))
    m = (a @ np.swapaxes(a, 1, 2)).astype(np.float32)
    m[0] = 0.0
    m[1, 1, 0] = m[1, 0, 1] = np.nan
    m[2, 2, 2] = np.nan
    m[3] = np.diag([np.nan, 1.0, 2.0])
    m[4, 2, 1] = m[4, 1, 2] = np.inf
    w, v = kernels.symeig3_plain(torch.tensor(m))
    w, v = w.numpy(), v.numpy()
    jw, jv = map(np.asarray, jnp.linalg.eigh(jnp.asarray(m)))
    np.testing.assert_array_equal(w[0], jw[0])
    np.testing.assert_array_equal(v[0], np.eye(3))
    np.testing.assert_array_equal(jv[0], np.eye(3))
    for i in (1, 2, 3, 4):
        assert np.isnan(w[i]).all() and np.isnan(v[i]).all()
        assert np.isnan(jw[i]).any()
    _hold_to_eigh(m[5:], w[5:], v[5:])


@pytest.mark.parametrize("batch", [(N,), (40, 50)], ids=["flat", "batched"])
def test_symeig3x3_gradients_match_jax(batch):
    """The gradient of a sign-free loss on the eigenvectors' projectors
    v vᵀ and on the eigenvalues, against jax.grad of jnp.linalg.eigh's,
    on rows whose eigenvalues lie at least 0.05 apart (relative)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((*batch, 3, 3))
    m = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    w0 = np.linalg.eigh(m.reshape(-1, 3, 3).astype(np.float64))[0]
    keep = (_rel_gaps(w0) >= 0.05).all(axis=1).reshape(batch)
    cot_p = rng.standard_normal((*batch, 3, 3, 3)).astype(np.float32)
    cot_w = rng.standard_normal((*batch, 3)).astype(np.float32)
    wmask = keep[..., None, None].astype(np.float32)

    def loss_t(x):
        w, v = tmu.symeig3x3(x)
        p = v[..., :, None, :] * v[..., None, :, :]
        return (p * torch.tensor(cot_p * wmask[..., None])).sum() + (
            w * torch.tensor(cot_w * keep[..., None])).sum()

    def loss_j(x):
        w, v = jnp.linalg.eigh(x)
        p = v[..., :, None, :] * v[..., None, :, :]
        return (p * cot_p * wmask[..., None]).sum() + (
            w * cot_w * keep[..., None]).sum()

    x = torch.tensor(m, requires_grad=True)
    gt = torch.autograd.grad(loss_t(x), x)[0].numpy()
    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(m)))
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())
    # the gradient is symmetric, as the symmetrised input's is in JAX
    np.testing.assert_allclose(gt, np.swapaxes(gt, -1, -2), atol=1e-6)


def test_compute_vrk_anisotropic_matches_jax():
    pts, nrm, mask, _ = noisy_sphere(400, 3)
    st_t = tewa.RasterSettings(image_size=32, Vrk_invariant=False,
                               Vrk_isotropic=False)
    st_j = jewa.RasterSettings(image_size=32, Vrk_invariant=False,
                               Vrk_isotropic=False)
    vrk, sk = tewa.compute_vrk(torch.tensor(pts), torch.tensor(nrm),
                               torch.tensor(mask), st_t)
    jvrk, jsk = jewa.compute_vrk(jnp.asarray(pts), jnp.asarray(nrm),
                                 jnp.asarray(mask), st_j)
    vrk, jvrk = vrk.numpy(), np.asarray(jvrk)
    from dss_tpu.geometry.normals import estimate_local_coord_frames as jframes

    curv, _ = jframes(jnp.asarray(pts), jnp.asarray(mask), 8)
    ok = _rel_gaps(curv)[:, 0] >= 1e-3
    assert ok[mask].mean() > 0.9
    np.testing.assert_allclose(vrk[ok], jvrk[ok], rtol=1e-4,
                               atol=1e-6 * np.abs(jvrk).max())
    # Sk holds the tangents as rows: equal up to a sign per row there
    sk, jsk = sk.numpy(), np.asarray(jsk)
    cos = np.abs(np.sum(sk * jsk, axis=-1))
    gap1 = _rel_gaps(curv)[:, 1:]
    assert np.all(cos[gap1 >= 1e-3] >= 1 - 1e-5)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The port's twin: 3 views at 32² (one epoch is one window of 3
    steps), a 400-point sphere."""
    base = tmp_path_factory.mktemp("symeig3")
    make_tiny_dataset(str(base / "ds"), views=3, image_size=32, points=400,
                      n_train_points=200, device=DEV)
    return base


def _config(base):
    cfg = {
        "name": "aniso_pca",
        "data": {"data_dir": str(base / "ds"), "type": "MVR"},
        "model": {"type": "point", "model_kwargs": {
            "learn_colors": True, "learn_normals": True, "learn_points": True,
            "n_points_per_cloud": 200}},
        "renderer": {"raster_params": {
            "image_size": 32, "points_per_pixel": 3, "cutoff_threshold": 1.0,
            "radii_backward_scaler": 10.0, "backend": "reference",
            "Vrk_invariant": False, "Vrk_isotropic": False}},
        "training": {
            "batch_size": 1, "out_dir": str(base / "exp"), "print_every": 3,
            "validate_every": -1, "visualize_every": -1,
            "checkpoint_every": 100, "lambda_dr_repel": 0.01,
            "lambda_dr_proj": 0.01, "lambda_dr_normal": 0.1,
            "normal_anchor": "pca", "normal_anchor_k": 8},
    }
    path = base / "aniso_pca.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_anisotropic_pca_window_matches_the_jax_scan_window(dataset):
    """Both CLIs at --steps-per-dispatch 3 with the anisotropic Vrk and the
    PCA normal anchor on the reference backend (the port's window runs
    eagerly on the CPU): the window's logged loss parts (its last step's)
    and the parameters after it, at SAME_STATE."""
    base = dataset
    cfg = _config(base)
    common = ["--config", cfg, "--max-iters", "3", "--steps-per-dispatch",
              "3", "--seed", "0"]
    jax_main(common + ["--name", "jax3", "--platform", "cpu"])
    torch_main(common + ["--name", "torch3", "--device", DEV])
    rows = [json.loads((base / "exp" / n / "metrics.jsonl").read_text()
                       .splitlines()[0]) for n in ("jax3", "torch3")]
    rj, rt = rows
    assert rj["step"] == rt["step"] == 3
    for k in ("loss", "loss_dr_rgb", "loss_dr_silhouette", "loss_dr_proj",
              "loss_dr_repel", "loss_dr_normal"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=SAME_STATE[0],
                                   err_msg=k)
    assert rt["params_finite"] == rj["params_finite"] == 1.0
    with np.load(base / "exp" / "jax3" / "model.npz") as fj, \
            np.load(base / "exp" / "torch3" / "model.npz") as ft:
        for k in PARAMS:
            np.testing.assert_allclose(ft[k], fj[k], atol=SAME_STATE[1],
                                       err_msg=k)
        for k in fj.files:
            if k.endswith("/count") or k == "step":
                np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
