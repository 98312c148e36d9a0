"""The public-API remainder, the numpy plots and the gradient debugger
against dss_tpu on the same numpy inputs: mathutil.safe_sqrt / inv2x2 /
symeig3x3 (values and gradients, rtol 1e-5; eigenvectors up to sign),
losses.l2_loss / smape_loss (masked, weighted; rtol 1e-6), PointClouds,
ndc_to_pixel_np (bit-equal), the numpy plots (the PNG reads back at its
stated size with arrow colours at the projected tails), and
collect_gradient_fields at 32² on the tile-binned ops (their plain
versions here) against dss_tpu's on its Pallas kernels in interpret mode
(rtol 1e-3, atol 1e-4 · max, the train step's tolerance, for 'position';
rtol 1e-4, atol 1e-6 · max for the regularizers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dss_tpu.geometry import pointclouds as jpc
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.render.ewa import RasterSettings as JSettings
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.training import debug as jdebug
from dss_tpu.training import losses as jlosses
from dss_tpu.utils import mathutil as jmu
from dss_tpu.utils import visualize as jvis
from dss_tpu_torch import PointClouds, convert
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import debug, losses
from dss_tpu_torch.utils import mathutil as tmu
from dss_tpu_torch.utils import visualize as tvis

torch.set_num_threads(2)

DEV = "cpu"
RNG = lambda seed: np.random.default_rng(seed)


def _grads(fn_t, fn_j, *xs):
    """Values and input gradients of Σ fn(x)·cot in both packages."""
    tx = [torch.tensor(x, requires_grad=True) for x in xs]
    out_t = fn_t(*tx)
    cot = RNG(99).standard_normal(out_t.shape).astype(np.float32)
    g_t = torch.autograd.grad((out_t * torch.tensor(cot)).sum(), tx)
    out_j, vjp = jax.vjp(fn_j, *[jnp.asarray(x) for x in xs])
    g_j = vjp(jnp.asarray(cot))
    return (out_t.detach().numpy(), np.asarray(out_j),
            [g.numpy() for g in g_t], [np.asarray(g) for g in g_j])


def test_safe_sqrt_matches_jax():
    x = RNG(0).uniform(-1.0, 4.0, (200,)).astype(np.float32)
    x[:4] = [0.0, 1e-17, 1e-20, -0.0]  # the clamp, and a tie at eps
    got, want, gt, gj = _grads(tmu.safe_sqrt, jmu.safe_sqrt, x)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-5)


def test_inv2x2_matches_jax():
    m = RNG(1).standard_normal((300, 2, 2)).astype(np.float32)
    m[0] = [[1.0, 2.0], [2.0, 4.0]]  # singular: the eps-guarded determinant
    got, want, gt, gj = _grads(tmu.inv2x2, jmu.inv2x2, m)
    ok = np.ones(len(m), bool)
    ok[0] = False
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt[0][ok], gj[0][ok], rtol=1e-4, atol=1e-5)
    assert np.isfinite(got[0]).all() == np.isfinite(want[0]).all()


def test_symeig3x3_matches_jax():
    a = RNG(2).standard_normal((100, 3, 3)).astype(np.float32)
    m = (a + np.swapaxes(a, -1, -2)) / 2
    w, v = tmu.symeig3x3(torch.tensor(m))
    jw, jv = jmu.symeig3x3(jnp.asarray(m))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    v, jv = v.numpy(), np.asarray(jv)
    sign = np.sign(np.sum(v * jv, axis=-2, keepdims=True))
    np.testing.assert_allclose(v * sign, jv, atol=1e-4)
    # the eigenvalues' gradient (sign-free): dλᵢ/dM = vᵢvᵢᵀ
    got, want, gt, gj = _grads(lambda x: tmu.symeig3x3(x)[0],
                               lambda x: jmu.symeig3x3(x)[0], m)
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_l2_and_smape_losses_match_jax(masked, weighted):
    rng = RNG(3)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y[0, 0, 0] = x[0, 0, 0]  # a tie: d|x − y| is JAX's there
    mask = (rng.uniform(size=(4, 8, 8, 1)) > 0.4) if masked else None
    w = rng.uniform(0.5, 2.0, (4, 8, 8, 3)).astype(np.float32) if weighted else None
    tm = None if mask is None else torch.tensor(mask)
    tw = None if w is None else torch.tensor(w)
    for ft, fj in ((lambda a, b: losses.l2_loss(a, b, tm, tw),
                    lambda a, b: jlosses.l2_loss(a, b, mask, w)),
                   (lambda a, b: losses.smape_loss(a, b, tm),
                    lambda a, b: jlosses.smape_loss(a, b, mask))):
        got, want, gt, gj = _grads(ft, fj, x, y)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)


def test_pointclouds_match_jax():
    rng = RNG(4)
    p = rng.uniform(-2.0, 3.0, (50, 3)).astype(np.float32)
    n = rng.standard_normal((50, 3)).astype(np.float32)
    f = rng.uniform(size=(50, 3)).astype(np.float32)
    m = rng.uniform(size=50) > 0.3
    t = PointClouds.create(p, n, f, m, capacity=64, device=DEV)
    j = jpc.PointClouds.create(p, n, f, m, capacity=64)
    assert t.capacity == j.capacity == 64
    assert int(t.num_points()) == int(j.num_points()) == m.sum()
    np.testing.assert_array_equal(t.masked_points(-1.0).numpy(),
                                  np.asarray(j.masked_points(-1.0)))
    for name in ("normalize_to_sphere", "normalize_to_box"):
        (tc, tctr, tsc), (jc, jctr, jsc) = getattr(t, name)(), getattr(j, name)()
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tctr.numpy(), np.asarray(jctr), rtol=1e-6)
        np.testing.assert_allclose(float(tsc), float(jsc), rtol=1e-6)
    d = PointClouds.create(p, device=DEV)
    jd = jpc.PointClouds.create(p)
    np.testing.assert_array_equal(d.normals.numpy(), np.asarray(jd.normals))
    np.testing.assert_array_equal(d.features.numpy(), np.asarray(jd.features))
    sub = t.subsample_randomly(torch.Generator().manual_seed(0), 0.5)
    kept = sub.mask.numpy()
    assert not (kept & ~t.mask.numpy()).any()  # only valid points survive
    assert 0 < kept.sum() < m.sum()
    assert sub.capacity == 64 and torch.equal(sub.points, t.points)


def test_ndc_to_pixel_np_is_bit_equal():
    xy = RNG(5).uniform(-1.2, 1.2, (500, 2)).astype(np.float32)
    for s in (17, 64, 512):
        np.testing.assert_array_equal(tvis.ndc_to_pixel_np(xy, s),
                                      jvis.ndc_to_pixel_np(xy, s))


def _arrow_colours(n):
    return {tvis._TAB[c] for c in tvis._COLORS_2D[:n]}


def test_plots_write_pngs(tmp_path):
    rng = RNG(6)
    pts = rng.uniform(-0.8, 0.8, (60, 3)).astype(np.float32)
    grads = {k: rng.standard_normal((60, 2)).astype(np.float32) * 0.05
             for k in ("position", "proj")}
    mask = (rng.uniform(size=(48, 48)) > 0.5).astype(np.float32)
    img = read_png(tvis.plot_2d_quiver(pts, grads, mask,
                                       str(tmp_path / "q2.png"), 48))
    assert img.shape == (48, 48, 3)
    tails = np.rint(tvis.ndc_to_pixel_np(pts[:, :2], 48)).astype(int)
    inside = ((tails >= 0) & (tails < 48)).all(-1)
    colours = _arrow_colours(2)
    hit = [tuple(img[r, c]) in colours for c, r in tails[inside]]
    assert inside.sum() > 30 and all(hit)
    # the mask shows through in gray at 60%: 102 off it, 255 on it
    gray = (img[..., 0] == img[..., 1]) & (img[..., 1] == img[..., 2])
    assert {0, 102, 255} >= set(np.unique(img[gray][:, 0]).tolist()) >= {102, 255}

    img = read_png(tvis.plot_3d_quiver(
        pts, {"a": rng.standard_normal((60, 3))}, str(tmp_path / "q3.png")))
    assert img.shape == (tvis._CANVAS, tvis._CANVAS, 3)
    assert (img == np.asarray(tvis._TAB["red"], np.uint8)).all(-1).sum() > 100

    sphere = lambda q: torch.linalg.vector_norm(q, dim=-1) - 0.6
    img = read_png(tvis.plot_iso_surface(sphere, str(tmp_path / "iso.png"),
                                         resolution=10, device=DEV))
    assert img.shape == (tvis._CANVAS, tvis._CANVAS, 3)
    shaded = (img != 255).any(-1)
    assert 0.01 < shaded.mean() < 0.5
    assert shaded[tvis._CANVAS // 2, tvis._CANVAS // 2]

    img = read_png(tvis.plot_cuts(sphere, str(tmp_path / "cuts.png"),
                                  resolution=32, device=DEV))
    assert img.shape == (32, 3 * 32 + 8, 3)
    black = (img == 0).all(-1)
    assert black[:, :32].any() and black[:, 36:68].any()
    assert tuple(img[16, 16]) != (255, 255, 255)

    html = tvis.figures_to_html([str(tmp_path / "cuts.png"),
                                 np.zeros((4, 4, 3), np.float32)],
                                str(tmp_path / "figs.html"))
    assert open(html).read().count("data:image/png;base64,") == 2
    page = tvis.animate_mesh([np.eye(3), 2 * np.eye(3)], [[0, 1, 2]],
                             str(tmp_path / "mesh.html"))
    assert "mesh animation" in open(page).read()


# ---------------------------------------------------------------------------
# collect_gradient_fields
# ---------------------------------------------------------------------------

S, T, V, N = 32, 16, 2, 300
RASTER = {**chip_smoke.FLAGSHIP_RASTER, "image_size": S, "tile_size": T}
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}


@pytest.fixture(scope="module")
def field_case():
    rng = RNG(7)
    verts, faces = ico_sphere(3, 0.5)
    pts, nrm = sample_points_from_mesh(verts, faces, N, rng=rng)
    gt, gt_n = sample_points_from_mesh(verts, faces, 600, rng=rng)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([10.0, -20.0]),
                                  azim=torch.tensor([0.0, 140.0]))
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0}
    with torch.no_grad():
        rgba, _, _ = render_views(
            torch.tensor(gt * np.array([1.2, 0.9, 1.0], np.float32)),
            torch.tensor(gt_n), torch.full((600, 3), 0.6),
            torch.ones(600, dtype=torch.bool),
            convert.cameras_from_numpy(cams, device=DEV),
            convert.lights_from_numpy(LIGHTS, V, device=DEV),
            RasterSettings(**RASTER))
    vis = rng.uniform(size=N) > 0.1
    return dict(params={"points": pts, "normals": nrm,
                        "colors": np.ones_like(pts)},
                cams=cams, img=rgba[..., :3].numpy(),
                mask=rgba[..., 3].numpy(), vis=vis)


def test_collect_gradient_fields_matches_jax(field_case, tmp_path):
    c = field_case
    ones = np.ones(N, bool)
    params = convert.params_from_numpy(c["params"], device=DEV)
    filters = PointFilters(activation=torch.ones(N, dtype=torch.bool),
                           visibility=torch.tensor(c["vis"]),
                           inmask=torch.ones(N, dtype=torch.bool))
    cams = convert.cameras_from_numpy(c["cams"], device=DEV)
    got = debug.collect_gradient_fields(
        params, filters, cams, convert.lights_from_numpy(LIGHTS, V, device=DEV),
        RasterSettings(**RASTER), torch.tensor(c["img"]),
        torch.tensor(c["mask"]))
    jl = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), JLights.create(**{
            k: jnp.asarray(v) for k, v in LIGHTS.items()}))
    jcams = JCameras.create(c["cams"]["R"], c["cams"]["T"], fov=60.0)
    jsettings = JSettings(backend="pallas", **RASTER)
    want = jax.jit(lambda *a: jdebug.collect_gradient_fields(
        *a[:4], jsettings, *a[4:]))(
        JParams.create(**c["params"]),
        JFilters(activation=jnp.asarray(ones), visibility=jnp.asarray(c["vis"]),
                 inmask=jnp.asarray(ones)),
        jcams, jl, jnp.asarray(c["img"]), jnp.asarray(c["mask"]))
    assert set(got) == set(want) == {"position", "proj", "repel"}
    for k, (rtol, atol) in {"position": (1e-3, 1e-4), "proj": (1e-4, 1e-6),
                            "repel": (1e-4, 1e-6)}.items():
        w = np.asarray(want[k])
        assert got[k].shape == (N, 3) and np.abs(w).max() > 0
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                   atol=atol * np.abs(w).max(), err_msg=k)
    # the render's filters are discarded, the model is not touched
    assert params.points.grad is None
    debug.dump_debug_quivers(params, got, cams, torch.tensor(c["mask"]),
                             str(tmp_path), 7, image_size=S)
    for name in ("debug_2d_000007.png", "debug_3d_000007.png"):
        assert read_png(str(tmp_path / name)).ndim == 3
