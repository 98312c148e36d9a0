"""Point-cloud denoising of dss_tpu_torch against dss_tpu on the same numpy
inputs: `geometry/denoise.py` function by function, the denoising recipe
of tests/test_denoise.py, and the denoise_pcl app against the JAX app.

Tolerances:

- every denoise function within 1e-5 of JAX (points and normals), outlier
  masks equal; the bilateral normal filter within 3e-5 (1.47e-5 measured
  on 3 of 1800 entries): its spatial weight exp(−d²·P/2) scales the kNN's
  float32 rounding of d² (the matmul expansion's, ~1e-7 absolute) by
  P/2 ≈ 300;
- `upsample` and `_insert_round` on the same input: the inserted points
  and masks equal, bit for bit (the kNN and the insertion sort break no
  tie on these inputs);
- `upsample_ear`: its LOP step within 1e-5 (the case n_target =
  n_current), and the full call's masks equal with its first n_current
  rows within 1e-5: the inserted points themselves follow the LOP's last
  float32 bits, which reorder near-equal sparsities;
- the app: output points within 1e-5, normals within cos 1 − 1e-5 of
  JAX's; with --upsample, the count and the rows before the insertions.

The inputs have no ties in their kNN distances or sparsities (a noisy
sphere and a noisy plane from seeded numpy draws); on ties the two
packages' order is not promised to agree (geometry/denoise.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.apps import denoise_pcl as j_app
from dss_tpu.data.io import read_ply as j_read_ply
from dss_tpu.geometry import denoise as jd
from dss_tpu_torch.apps import denoise_pcl as t_app
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.geometry import denoise as td
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.training.metrics import chamfer_hausdorff, point_to_surface
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")
N = 600


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=DEV)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def cloud():
    """A noisy unit sphere (σ 0.01), its radial normals perturbed, 1 point
    in 37 masked out."""
    rng = np.random.default_rng(0)
    gt = fibonacci_sphere(N, 1.0)
    pts = (gt + 0.01 * rng.standard_normal(gt.shape)).astype(np.float32)
    nrm = gt + 0.2 * rng.standard_normal(gt.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[::37] = False
    return pts, nrm, mask


def test_remove_outliers_matches_jax():
    """tests/test_denoise.py's plane with two floaters, plus noise."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(-1, 1, (300, 2))
    plane = np.concatenate([xy, 0.002 * rng.standard_normal((300, 1))], -1)
    pts = np.concatenate([plane, [[0.0, 0.0, 0.8], [0.5, 0.5, -0.9]]]
                         ).astype(np.float32)
    mask = np.ones(302, bool)
    mask[7] = False
    want = np.asarray(jd.remove_outliers(jnp.asarray(pts), jnp.asarray(mask), 12))
    got = td.remove_outliers(_t(pts), _t(mask, torch.bool), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[300:].any() and got[:300].mean() > 0.95


@pytest.mark.parametrize("k", [8, 16])
def test_denoise_normals_bilateral_matches_jax(cloud, k):
    pts, nrm, mask = cloud
    want = jd.denoise_normals_bilateral(jnp.asarray(pts), jnp.asarray(nrm),
                                        jnp.asarray(mask), 30.0, k)
    got = td.denoise_normals_bilateral(_t(pts), _t(nrm), _t(mask, torch.bool),
                                       30.0, k)
    _close(got, want, atol=3e-5)
    np.testing.assert_array_equal(got.numpy()[~mask], nrm[~mask])


@pytest.mark.parametrize("variant", ["pca", "normals", "reproject"])
def test_resample_uniformly_matches_jax(cloud, variant):
    pts, nrm, mask = cloud
    kw_j, kw_t = dict(iters=2), dict(iters=2)
    if variant != "pca":
        kw_j["normals"], kw_t["normals"] = jnp.asarray(nrm), _t(nrm)
    if variant == "reproject":
        kw_j["reproject"] = kw_t["reproject"] = True
    want = jd.resample_uniformly(jnp.asarray(pts), jnp.asarray(mask), **kw_j)
    got = td.resample_uniformly(_t(pts), _t(mask, torch.bool), **kw_t)
    _close(got, want)


@pytest.mark.parametrize("est", [1, 5])
def test_project_to_latent_surface_matches_jax(cloud, est):
    pts, nrm, mask = cloud
    kw = dict(neighborhood_size=15, max_proj_iters=3, max_est_iter=est)
    want = jd.project_to_latent_surface(jnp.asarray(pts), jnp.asarray(nrm),
                                        jnp.asarray(mask), **kw)
    got = td.project_to_latent_surface(_t(pts), _t(nrm), _t(mask, torch.bool),
                                       **kw)
    _close(got, want)
    assert np.abs(got.numpy() - pts).max() > 1e-3  # it moved


def _padded(pts, nrm, cap):
    n = pts.shape[0]
    pc = np.zeros((cap, 3), np.float32)
    nc = np.zeros((cap, 3), np.float32)
    pc[:n], nc[:n] = pts, nrm
    return pc, nc, np.arange(cap) < n


def test_insert_round_and_upsample_match_jax(cloud):
    pts, nrm, _ = cloud
    pc, _, mc = _padded(pts, nrm, 700)
    want = jd._insert_round(jnp.asarray(pc), jnp.asarray(mc), N, 60, 8)
    got = td._insert_round(_t(pc), _t(mc, torch.bool), N, 60, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jd.upsample(jnp.asarray(pc), jnp.asarray(mc), N, 700, 8)
    got = td.upsample(_t(pc), _t(mc, torch.bool), N, 700, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) == 700
    r = np.linalg.norm(got[0].numpy()[N:], axis=-1)
    assert np.abs(r - 1.0).max() < 0.25


def test_upsample_ear_matches_jax(cloud):
    pts, nrm, _ = cloud
    pc, nc, mc = _padded(pts, nrm, 700)
    args_j = (jnp.asarray(pc), jnp.asarray(nc), jnp.asarray(mc), N)
    args_t = (_t(pc), _t(nc), _t(mc, torch.bool), N)
    # the LOP step alone: no insertion when n_target == n_current
    want = jd.upsample_ear(*args_j, N, neighborhood_size=8)
    got = td.upsample_ear(*args_t, N, neighborhood_size=8)
    _close(got[0], want[0])
    want = jd.upsample_ear(*args_j, 700, neighborhood_size=8)
    got = td.upsample_ear(*args_t, 700, neighborhood_size=8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0][:N], want[0][:N])
    assert np.isfinite(got[0].numpy()).all()


def test_bbox_diag_matches_jax(cloud):
    pts, _, mask = cloud
    for m in (mask, np.zeros(N, bool)):
        want = float(jd._bbox_diag(jnp.asarray(pts), jnp.asarray(m)))
        got = float(td._bbox_diag(_t(pts), _t(m, torch.bool)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got)  # nothing masked in: NaN in both


def test_denoise_recipe_improves_both_metrics():
    """tests/test_denoise.py::TestDenoisePipeline through the port: PCA
    normals at k 32, bilateral, one RIMLS step; chamfer below 0.9× and
    point-to-surface below 0.8× the noisy cloud's."""
    rng = np.random.default_rng(42)
    gt_np = fibonacci_sphere(4000, 1.0)
    diag = float(np.linalg.norm(gt_np.max(0) - gt_np.min(0)))
    gt = _t(gt_np)
    noisy = _t(gt_np + rng.standard_normal(gt_np.shape).astype(np.float32)
               * 0.003 * diag)
    mask = torch.ones(4000, dtype=torch.bool)

    def metrics(p):
        return (float(chamfer_hausdorff(p, gt)["chamfer"]),
                float(point_to_surface(p, gt, gt)))

    cd0, p2f0 = metrics(noisy)
    normals = estimate_normals(noisy, mask, neighborhood_size=32)
    normals = td.denoise_normals_bilateral(noisy, normals, mask, 30.0, 32)
    den = td.project_to_latent_surface(noisy, normals, mask,
                                       neighborhood_size=15, max_proj_iters=1,
                                       max_est_iter=5)
    cd1, p2f1 = metrics(den)
    assert cd1 < 0.9 * cd0, (cd0, cd1)
    assert p2f1 < 0.8 * p2f0, (p2f0, p2f1)


@pytest.mark.parametrize("extra", [[], ["--iters", "2", "--repulsion-mu", "0.5"],
                                   ["--remove-outliers", "--upsample", "700"]],
                         ids=["defaults", "two-rounds", "upsample"])
def test_denoise_pcl_app_matches_jax(cloud, tmp_path, extra):
    """Both apps on one PLY with normals (so that no PCA sign decides the
    bilateral weights)."""
    pts, nrm, _ = cloud
    src = str(tmp_path / "noisy.ply")
    save_ply(src, pts, normals=nrm)
    j_out, t_out = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    j_app.main(["--input", src, "--out", j_out, *extra, "--platform", "cpu"])
    got_p, got_n = t_app.main(["--input", src, "--out", t_out, *extra,
                               "--device", "cpu"])
    want = j_read_ply(j_out)
    got = j_read_ply(t_out)
    np.testing.assert_array_equal(got.points, got_p)
    assert got.points.shape == want.points.shape
    n = N if "--upsample" not in extra else int(
        np.sum(td.remove_outliers(_t(pts), torch.ones(N, dtype=torch.bool)).numpy()))
    np.testing.assert_allclose(got.points[:n], want.points[:n], rtol=0, atol=1e-5)
    if "--upsample" in extra:
        assert got.points.shape[0] == 700
        return
    cos = np.sum(got.normals * want.normals, -1)
    assert cos.min() > 1 - 1e-5, cos.min()
