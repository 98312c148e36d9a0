"""geometry/normals.py and what waits on it, against dss_tpu on the same
numpy inputs: the PCA frames and normals, the jet refinement (with the
nanmedian rule, k > P and a single bilateral neighbour), the normal
consistency loss with both anchors, the anisotropic Vrk (the EWA golden
lives in test_torch_fragments.py) in a render, and a train step with the
normal term.

Tolerances: eigenvalues rtol 1e-4, atol 1e-9; frames up to sign,
|cos| ≥ 1 − 1e-5, skipping points whose relative eigen-gap is below 1e-3
(the eigenvector is ill-conditioned there in both packages); refined
normals cos ≥ 1 − 1e-4; loss values rtol 1e-5, their normal gradients
rtol 1e-4 with atol 1e-6·max."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dss_tpu.training.trainer as jt
from dss_tpu.geometry import normals as jn
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.render import ewa as jewa
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.render.renderer import render_views as j_render_views
from dss_tpu.training import losses as jl
from dss_tpu_torch import config as tconfig
from dss_tpu_torch import convert
from dss_tpu_torch.geometry import normals as tn
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import losses as tl
from dss_tpu_torch.training import trainer as tt
from tests.test_torch_train_step import LIGHTS, RASTER, SCHED, TRAIN, V, N, case  # noqa: F401

torch.set_num_threads(2)

DEV = torch.device("cpu")


def noisy_sphere(n, seed, noise=0.004, radius=0.5):
    """Points near a sphere (a few hundred, uneven spacing), their outward
    normals perturbed, and a mask with ~10% of the points off."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * radius + rng.normal(0, noise, (n, 3))).astype(np.float32)
    nrm = (d + 0.25 * rng.standard_normal((n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.1
    return pts, nrm, mask, d.astype(np.float32)


def _gap_ok(curv, col):
    """Points whose eigenvalue `col` is separated from its neighbours by a
    relative gap of at least 1e-3."""
    c = np.asarray(curv, np.float64)
    scale = np.maximum(c[:, 2], 1e-30)
    gaps = [np.abs(c[:, col] - c[:, j]) / scale for j in range(3) if j != col]
    return np.min(gaps, axis=0) >= 1e-3


@pytest.mark.parametrize("masked,disamb", [(False, False), (True, False),
                                           (True, True)],
                         ids=["all", "masked", "masked-disambiguated"])
def test_local_coord_frames_match_jax(masked, disamb):
    pts, _, mask, _ = noisy_sphere(300, 1)
    m = mask if masked else None
    cj, fj = jn.estimate_local_coord_frames(
        jnp.asarray(pts), None if m is None else jnp.asarray(m), 8,
        disambiguate_directions=disamb)
    ct, ft = tn.estimate_local_coord_frames(
        torch.tensor(pts), None if m is None else torch.tensor(m), 8,
        disambiguate_directions=disamb)
    cj, fj = np.asarray(cj), np.asarray(fj)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-9)
    for col in range(3):
        ok = _gap_ok(cj, col)  # masked-out points: a zero covariance
        assert ok[mask if masked else slice(None)].mean() > 0.9
        cos = np.sum(ft.numpy()[:, :, col] * fj[:, :, col], axis=-1)
        assert np.all(np.abs(cos[ok]) >= 1 - 1e-5), (col, np.abs(cos[ok]).min())
        if disamb and col == 0:  # the flip fixes the normal's sign
            assert np.all(cos[ok] >= 1 - 1e-5)


def test_estimate_normals_with_reference_normals_match_jax():
    pts, nrm, mask, _ = noisy_sphere(300, 2)
    want = np.asarray(jn.estimate_normals(jnp.asarray(pts), jnp.asarray(mask),
                                          8, reference_normals=jnp.asarray(nrm)))
    got = tn.estimate_normals(torch.tensor(pts), torch.tensor(mask), 8,
                              reference_normals=torch.tensor(nrm)).numpy()
    cj, _ = jn.estimate_local_coord_frames(jnp.asarray(pts), jnp.asarray(mask), 8)
    ok = _gap_ok(cj, 0)
    cos = np.sum(got * want, axis=-1)
    assert np.all(cos[ok] >= 1 - 1e-5)
    # the sign follows the reference field
    assert np.all(np.sum(got * nrm, -1)[ok] >= 0)


@pytest.mark.parametrize("shape", [
    (np.array([[1.0, 3.0, 2.0, 4.0]]), 2.5),
    (np.array([[1.0, np.nan, 2.0, 7.0, np.nan]]), 2.0),
    (np.array([[np.nan, np.nan]]), np.nan),
], ids=["even", "odd", "all-nan"])
def test_jax_nanmedian_rule(shape):
    x, want = shape
    got = tn.jax_nanmedian(torch.tensor(x, dtype=torch.float32))
    jv = jnp.nanmedian(jnp.asarray(x, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got.numpy(), np.float32(want))


def test_jax_nanmedian_bits_on_random_arrays():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 301):
        x = rng.uniform(0, 1, (n, 5)).astype(np.float32)
        x[rng.random(x.shape) < 0.3] = np.nan
        np.testing.assert_array_equal(
            tn.jax_nanmedian(torch.tensor(x)).numpy(),
            np.asarray(jnp.nanmedian(jnp.asarray(x))))


REFINE_CASES = {
    # an even number of active points, 15 off-self spacings each: an even
    # count of squared spacings, whose
    # middle pair jnp.nanmedian averages and torch.nanmedian does not
    "even-median": dict(n=300, kw=dict(neighborhood_size=24, jet_passes=2)),
    # k = min(neighborhood_size, P): 20 points, 48 asked
    "k-above-P": dict(n=20, kw=dict(neighborhood_size=48, jet_passes=3)),
    # a single bilateral neighbour turns the smoothing off
    "bilateral-k-1": dict(n=300, kw=dict(neighborhood_size=16, bilateral_k=1)),
}


@pytest.mark.parametrize("name", list(REFINE_CASES))
def test_refine_normals_matches_jax(name):
    c = REFINE_CASES[name]
    pts, nrm, mask, _ = noisy_sphere(c["n"], 4)
    if name == "even-median" and mask.sum() % 2:
        mask[np.argmin(mask)] = True  # an even number of active points
    want = np.asarray(jn.refine_normals(jnp.asarray(pts), jnp.asarray(nrm),
                                        jnp.asarray(mask), **c["kw"]))
    got = tn.refine_normals(torch.tensor(pts), torch.tensor(nrm),
                            torch.tensor(mask), **c["kw"]).numpy()
    cos = np.sum(got * want, axis=-1)
    assert np.all(cos >= 1 - 1e-4), cos.min()
    # masked-out points keep their (normalized) input normals
    n0 = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    np.testing.assert_allclose(got[~mask], n0[~mask], atol=1e-6)
    assert not np.allclose(got[mask], n0[mask], atol=1e-2)
    if name == "even-median":
        k = c["kw"]["neighborhood_size"]
        tm = torch.tensor(mask)
        d2, idx = tn.knn_points(torch.tensor(pts), torch.tensor(pts), tm, tm,
                                k=k)
        valid = (idx >= 0) & tm[:, None]
        off = torch.where(valid[:, 1:16], d2[:, 1:16], torch.nan)
        assert int((~torch.isnan(off)).sum()) % 2 == 0
        assert float(tn.jax_nanmedian(off)) != float(torch.nanmedian(off))


@pytest.mark.parametrize("anchor", ["pca", "jet"])
def test_normal_consistency_loss_matches_jax(anchor):
    pts, nrm, mask, _ = noisy_sphere(300, 5)
    jval, jgrad = jax.value_and_grad(
        lambda n: jl.normal_consistency_loss(jnp.asarray(pts), n,
                                             jnp.asarray(mask), 8, anchor)
    )(jnp.asarray(nrm))
    tnrm = torch.tensor(nrm, requires_grad=True)
    tpts = torch.tensor(pts, requires_grad=True)
    val = tl.normal_consistency_loss(tpts, tnrm, torch.tensor(mask), 8, anchor)
    g_n, g_p = torch.autograd.grad(val, (tnrm, tpts), allow_unused=True)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(g_n.numpy(), jg, rtol=1e-4,
                               atol=1e-6 * np.abs(jg).max())
    assert g_p is None  # the target is detached
    assert 0.0 < val.item() < 1.0


def test_config_reads_the_normal_anchor():
    cfg = tconfig.load_config("configs/exp_e21_jetanchor.yml")
    tc = tconfig.create_train_config(cfg)
    assert tc.lambda_normal > 0 and tc.normal_anchor == "jet"
    assert tc.normal_anchor_k == int(cfg["training"]["normal_anchor_k"])


# ---------------------------------------------------------------------------
# The anisotropic Vrk in a render, and a train step with the normal term
# ---------------------------------------------------------------------------

ANISO = dict(image_size=32, points_per_pixel=5, tile_size=16,
             Vrk_invariant=False, Vrk_isotropic=False, backface_culling=True)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_anisotropic_render_matches_jax(backend):
    """render_views with the anisotropic Vrk, the backend named on both
    sides: rgba within 1e-4, visibility equal, point gradients within
    rtol 1e-3, atol 1e-4·max."""
    pts, _, _, d = noisy_sphere(300, 6, noise=0.0)
    r, t = look_at_view_transform(dist=torch.full((3,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 100.0, 220.0]))
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0}
    cols = np.random.default_rng(7).uniform(0.2, 0.9, pts.shape).astype(np.float32)
    g = np.random.default_rng(8).standard_normal((3, 32, 32, 4)).astype(np.float32)
    jlights = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (3,) + x.shape), JLights.create(**LIGHTS))

    def jloss(p):
        rgba, _, vis = j_render_views(
            p, jnp.asarray(d), jnp.asarray(cols), jnp.ones((300,), bool),
            JCameras.create(cams["R"], cams["T"], fov=60.0), jlights,
            jewa.RasterSettings(backend=backend, **ANISO))
        return jnp.sum(rgba * g), (rgba, vis)

    (_, (jrgba, jvis)), jgp = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pts))
    tp = torch.tensor(pts, requires_grad=True)
    rgba, _, vis = render_views(
        tp, torch.tensor(d), torch.tensor(cols), torch.ones(300, dtype=torch.bool),
        convert.cameras_from_numpy(cams, device=DEV),
        convert.lights_from_numpy(LIGHTS, 3, device=DEV),
        tewa.RasterSettings(backend=backend, **ANISO))
    (gp,) = torch.autograd.grad((rgba * torch.tensor(g)).sum(), (tp,))
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(jrgba), atol=1e-4)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    jg = np.asarray(jgp)
    np.testing.assert_allclose(gp.numpy(), jg, rtol=1e-3, atol=1e-4 * np.abs(jg).max())
    assert float(np.asarray(jrgba)[..., 3].mean()) > 0.1


@pytest.mark.parametrize("anchor", ["pca", "jet"])
def test_train_step_with_the_normal_term_matches_jax(case, anchor):  # noqa: F811
    """test_torch_train_step's flagship step at 32² with λ_normal 0.1:
    every loss part (loss_dr_normal included) within rtol 1e-4, the
    gradients within rtol 1e-3, atol 1e-4·max."""
    c = case
    train = {**TRAIN, "lambda_normal": 0.1}
    jcfg = jt.TrainConfig(**train, normal_anchor=anchor, normal_anchor_k=8)
    loss_fn = jt.make_loss_fn(jewa.RasterSettings(backend="pallas", **RASTER),
                              jcfg, jt.AnnealSchedule(**SCHED))
    lights = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), JLights.create())
    (_, (jparts, _)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        JParams.create(**c["params"]), JFilters.ones(N),
        JCameras.create(c["cams"]["R"], c["cams"]["T"], fov=60.0), lights,
        jnp.asarray(c["img"]), jnp.asarray(c["mask"]), jnp.asarray(0),
        jnp.asarray(c["depth"]))

    tcfg = tt.TrainConfig(**train, normal_anchor=anchor, normal_anchor_k=8)
    loss_fn = tt.make_loss_fn(tewa.RasterSettings(**RASTER), tcfg,
                              tt.AnnealSchedule(**SCHED))
    params = convert.params_from_numpy(c["params"], device=DEV)
    total, (parts, _) = loss_fn(
        params, PointFilters.ones(N, device=DEV),
        convert.cameras_from_numpy(c["cams"], device=DEV),
        convert.lights_from_numpy(LIGHTS, V, device=DEV),
        torch.tensor(c["img"]), torch.tensor(c["mask"]), 0,
        torch.tensor(c["depth"]))
    grads = torch.autograd.grad(total, params.tensors())
    assert float(jparts["loss_dr_normal"]) > 0
    for k, v in jparts.items():
        if k.startswith("loss"):
            np.testing.assert_allclose(parts[k].item(), float(v), rtol=1e-4,
                                       err_msg=k)
    for name, got, want in zip(("points", "normals", "colors"), grads,
                               (jg.points, jg.normals, jg.colors)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)

