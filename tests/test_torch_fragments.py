"""The full-fragment paths of the port against dss_tpu on the same numpy
inputs: K5's plain version (`fwd_frag_plain`) and the fragment op against
the Pallas fragment kernel in interpret mode, the reference spec
rasterizer against dss_tpu's, both against the reference CPU goldens, the
renderer's fragment and reference paths, and the fragment-zbuf train loss.

Both packages bin with 128-candidate chunks (the port's kernels are
compiled for them); K5's depth window does not depend on the chunk."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dss_tpu.training.trainer as jt
from dss_tpu import config as jconfig
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.ops import splat_pallas as jsp
from dss_tpu.render import ewa as jewa
from dss_tpu.render import rasterizer as jras
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.render.renderer import render_views as j_render_views
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render import rasterizer as tras
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import trainer as tt
from tests.test_reference_golden import GOLDEN_DIR, SCENES, _sort_frags
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N, K, CAP = 64, 16, 2, 400, 5, 512
DMT, RBS = 0.3, 3.0
CFG = splat.TileConfig(tile=T, cap=CAP, max_tiles=4)
JCFG = (T, CAP, 128, 4)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def splats():
    """Random screen-space splats (2 views, 64², 400 points, radii 4–8 px,
    depths 1–1.6: pixels hold K fragments and the truncation bites), with
    a few culled ones, plus cotangents for every output."""
    rng = np.random.default_rng(11)
    a = rng.uniform(15.0, 80.0, (V, N, 1))
    c = rng.uniform(15.0, 80.0, (V, N, 1))
    b = rng.uniform(-20.0, 20.0, (V, N, 1))
    den = 4 * a * c - b * b
    culled = rng.random((V, N)) < 0.05
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        pts=f32(np.concatenate([rng.uniform(-0.9, 0.9, (V, N, 2)),
                                rng.uniform(1.0, 1.6, (V, N, 1))], -1)),
        ell=f32(np.concatenate([a, b, c], -1)),
        cut=f32(np.where(culled, -np.inf, 1.0)),
        radii=f32(np.sqrt(np.concatenate([4 * c / den, 4 * a / den], -1))
                  * ~culled[..., None]),
        scaler=f32(rng.uniform(0.5, 1.5, (V, N))),
        feat=f32(rng.uniform(0.0, 1.0, (V, N, 3))),
        g_occ=f32(rng.standard_normal((V, S, S))),
        g_rgbw=f32(rng.standard_normal((V, S, S, 4))),
        g_z=f32(rng.standard_normal((V, S, S, K))),
        g_q=f32(rng.standard_normal((V, S, S, K))),
    )


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def _jax_frag_forward(sp, v, dmt=DMT):
    return jsp.rasterize_forward_pallas(
        jnp.asarray(sp["pts"][v]), jnp.asarray(sp["ell"][v]),
        jnp.asarray(sp["cut"][v]), jnp.asarray(sp["radii"][v]), dmt, S, K,
        tile_size=T, bin_capacity=CAP, chunk=128, max_tiles_xy=4,
        scaler=jnp.asarray(sp["scaler"][v]), with_extras=True,
        features=jnp.asarray(sp["feat"][v]),
    )


def test_fwd_frag_plain_matches_jax(splats):
    """K5's plain version, through the port's fragment forward (binning,
    untile, truncation, visibility), against rasterize_forward_pallas."""
    sp = splats
    (idx, zbuf, qv, occ, visible, rgbw, overflow,
     _b) = splat.rasterize_forward_fragments(
        S, K, CFG, _t(sp["pts"]), _t(sp["ell"]), _t(sp["cut"]),
        _t(sp["radii"]), DMT, _t(sp["scaler"]), _t(sp["feat"]))
    for v in range(V):
        (j_idx, j_z, j_q, j_occ, _fs, j_vis, j_rgbw,
         j_over) = map(np.asarray, _jax_frag_forward(sp, v))
        np.testing.assert_array_equal(idx[v].numpy(), j_idx)
        np.testing.assert_array_equal(occ[v].numpy(), j_occ)
        np.testing.assert_array_equal(visible[v].numpy(), j_vis)
        assert int(overflow[v]) == int(j_over) == 0
        np.testing.assert_array_equal(zbuf[v].numpy(), j_z)
        np.testing.assert_allclose(qv[v].numpy(), j_q, rtol=1e-6, atol=1e-6)
        _close(rgbw[v].numpy(), j_rgbw, 1e-5, 1e-6)
        # non-vacuous: pixels with K fragments kept
        assert (j_idx[..., K - 1] >= 0).sum() > 50
    # ... and with fragments cut by the depth-merge truncation
    untruncated = splat.rasterize_forward_fragments(
        S, K, CFG, _t(sp["pts"]), _t(sp["ell"]), _t(sp["cut"]),
        _t(sp["radii"]), 1e9, _t(sp["scaler"]), _t(sp["feat"]))[0]
    assert ((untruncated >= 0) & (idx < 0)).any(-1).sum() > 50
    assert not visible[sp["cut"] == -np.inf].any()


def _port_frag_op(sp, dev="cpu"):
    f = lambda x: _t(x).to(dev)
    ps = f(sp["pts"]).requires_grad_()
    fe = f(sp["feat"]).requires_grad_()
    idx, zbuf, qv, occ, vis, rgbw, over = splat.rasterize_views_fragments(
        S, K, CFG, ps, f(sp["ell"]), f(sp["cut"]), f(sp["radii"]), DMT, RBS,
        f(sp["scaler"]), fe)
    loss = ((occ * f(sp["g_occ"])).sum() + (rgbw * f(sp["g_rgbw"])).sum()
            + (zbuf * f(sp["g_z"])).sum() + (qv * f(sp["g_q"])).sum())
    gp, gf = torch.autograd.grad(loss, (ps, fe))
    return [x.detach().cpu().numpy() for x in
            (idx, zbuf, qv, occ, vis, rgbw, over, gp, gf)]


def test_fragment_op_forward_and_grads_match_jax(splats):
    """rasterize_views_fragments against rasterize_points_pallas: forward
    outputs, and the gradients to pts (x, y from K2, z from the zbuf
    scatter) and features (K3); the qvalue cotangent is dropped by both."""
    sp = splats
    got = _port_frag_op(sp)
    for v in range(V):
        def jloss(ps, fe):
            out = jsp.rasterize_points_pallas(
                S, K, JCFG, ps, jnp.asarray(sp["ell"][v]),
                jnp.asarray(sp["cut"][v]), jnp.asarray(sp["radii"][v]), DMT,
                RBS, jnp.asarray(sp["scaler"][v]), fe)
            idx, zbuf, qv, occ, _fs, vis, rgbw, over = out
            loss = (jnp.sum(occ * sp["g_occ"][v]) + jnp.sum(rgbw * sp["g_rgbw"][v])
                    + jnp.sum(zbuf * sp["g_z"][v]) + jnp.sum(qv * sp["g_q"][v]))
            return loss, (idx, zbuf, qv, occ, vis, rgbw, over)

        (_, want), (gp, gf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                 has_aux=True)(
            jnp.asarray(sp["pts"][v]), jnp.asarray(sp["feat"][v]))
        for i in (0, 1, 3, 4, 6):  # idx, zbuf, occ, visible, overflow
            np.testing.assert_array_equal(got[i][v], np.asarray(want[i]))
        np.testing.assert_allclose(got[2][v], np.asarray(want[2]), rtol=1e-6,
                                   atol=1e-6)
        _close(got[5][v], want[5], 1e-5, 1e-6)
        _close(got[7][v], gp, 1e-4, 1e-5)
        _close(got[8][v], gf, 1e-4, 1e-5)
        gp = np.asarray(gp)
        assert np.abs(gp[:, :2]).max() > 1e-2 and np.abs(gp[:, 2]).max() > 1e-2


def test_fragment_op_skips_unused_cotangents(splats):
    """Without a zbuf or rgbw term the op launches neither the scatter of
    the zbuf cotangent nor K3, and returns no feature gradient."""
    sp = splats
    ps = _t(sp["pts"]).requires_grad_()
    fe = _t(sp["feat"]).requires_grad_()
    out = splat.rasterize_views_fragments(
        S, K, CFG, ps, _t(sp["ell"]), _t(sp["cut"]), _t(sp["radii"]), DMT,
        RBS, _t(sp["scaler"]), fe)
    gp, gf = torch.autograd.grad((out[3] * _t(sp["g_occ"])).sum(), (ps, fe),
                                 allow_unused=True)
    assert gf is None and not gp[..., 2].any() and gp[..., :2].abs().max() > 0


def test_reference_rasterizer_matches_jax(splats):
    """The port's spec rasterizer (forward, and the VJP to x/y through the
    occupancy field at a finite support radius and to z through the zbuf
    scatter) against dss_tpu's rasterize_points."""
    sp = splats
    ps = _t(sp["pts"]).requires_grad_()
    idx, zbuf, qv, occ = tras.rasterize_points(
        S, K, 8, ps, _t(sp["ell"]), _t(sp["cut"]), _t(sp["radii"]), DMT, RBS)
    loss = (occ * _t(sp["g_occ"])).sum() + (zbuf * _t(sp["g_z"])).sum()
    (gp,) = torch.autograd.grad(loss, (ps,))
    for v in range(V):
        def jloss(p):
            out = jras.rasterize_points(
                S, K, 8, p, jnp.asarray(sp["ell"][v]), jnp.asarray(sp["cut"][v]),
                jnp.asarray(sp["radii"][v]), DMT, RBS)
            return (jnp.sum(out[3] * sp["g_occ"][v])
                    + jnp.sum(out[1] * sp["g_z"][v])), out

        (_, want), jgp = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(sp["pts"][v]))
        np.testing.assert_array_equal(idx[v].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(zbuf[v].detach().numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(qv[v].detach().numpy(), np.asarray(want[2]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(occ[v].detach().numpy(), np.asarray(want[3]))
        _close(gp[v].numpy(), jgp, 1e-4, 1e-5)
        assert np.abs(np.asarray(jgp)[:, :2]).max() > 1e-2


# ---------------------------------------------------------------------------
# The window rules of K5 and K3
# ---------------------------------------------------------------------------


def test_window_rules_of_k5_and_k3_match_jax():
    """A tile where a quantized-depth tie puts the deeper of two splats
    first: a far live splat (z = 1e8) stretches the depth range until one
    quantum (range/2^26 at 16 tiles) exceeds the z gap of 0.2 > dmt.  K5's
    window (z₀ = the rank-0 fragment, the deeper splat) lets both win;
    K1's and K3's chunk-minimum window (z₀ = the nearer splat) drops the
    deeper one.  The port follows dss_tpu on both: K5's rgbw and vis in
    the forward, K3's feature gradients in the backward."""
    dmt = 0.05
    f32 = lambda x: np.asarray(x, np.float32)
    # 0: deeper splat, 1: nearer splat at the same place, 2: far splat
    sp = dict(
        pts=f32([[[0.5, 0.5, 1.2], [0.5, 0.5, 1.0], [-0.5, -0.5, 1e8]]]),
        ell=f32([[[100.0, 0.0, 100.0]] * 3]),
        cut=f32([[1.0, 1.0, 1.0]]),
        radii=f32([[[0.1, 0.1]] * 3]),
        scaler=f32([[1.0, 1.0, 1.0]]),
        feat=f32([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]]),
    )
    g_rgbw = np.random.default_rng(3).standard_normal((1, S, S, 4)).astype(np.float32)
    ps = _t(sp["pts"]).requires_grad_()
    fe = _t(sp["feat"]).requires_grad_()
    idx, zbuf, _q, _o, visible, rgbw, over = splat.rasterize_views_fragments(
        S, K, CFG, ps, _t(sp["ell"]), _t(sp["cut"]), _t(sp["radii"]), dmt,
        RBS, _t(sp["scaler"]), fe)
    (gf,) = torch.autograd.grad((rgbw * _t(g_rgbw)).sum(), (fe,))

    def jloss(fe_j):
        out = jsp.rasterize_points_pallas(
            S, K, JCFG, jnp.asarray(sp["pts"][0]), jnp.asarray(sp["ell"][0]),
            jnp.asarray(sp["cut"][0]), jnp.asarray(sp["radii"][0]), dmt, RBS,
            jnp.asarray(sp["scaler"][0]), fe_j)
        return jnp.sum(out[6] * g_rgbw[0]), out

    (_, want), jgf = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(sp["feat"][0]))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(visible[0].numpy(), np.asarray(want[5]))
    _close(rgbw[0].detach().numpy(), want[6], 1e-5, 1e-6)
    _close(gf[0].numpy(), jgf, 1e-4, 1e-5)
    assert int(over[0]) == 0
    # the deeper splat sorts first (slot 0) and wins K5's window: its red
    # reaches the composite and it is visible ...
    covered = np.asarray(want[0])[..., 0] == 0
    assert covered.sum() > 10 and (np.asarray(want[0])[covered, 1] == 1).all()
    assert bool(visible[0, 0]) and float(rgbw[0, ..., 0].detach().max()) > 0.1
    # ... while K3's window drops it: no colour gradient reaches it
    assert not gf[0, 0].any() and gf[0, 1].abs().max() > 1e-3


# ---------------------------------------------------------------------------
# Reference CPU goldens (the tolerances of tests/test_reference_golden.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SCENES)
def golden(request):
    return dict(np.load(os.path.join(GOLDEN_DIR, request.param + ".npz")))


def _golden_tile(g):
    return 16 if int(g["image_size"]) <= 128 else 32


@pytest.fixture(scope="module")
def golden_frags(golden):
    """The fragments of both port paths on the golden's EWA inputs."""
    g = golden
    s, k = int(g["image_size"]), int(g["points_per_pixel"])
    p = g["pts_screen"].shape[0]
    dmt = float(g["depth_merging_threshold"])
    args = [_t(g[n])[None] for n in ("pts_screen", "ellipse_params", "cutoff",
                                      "radii")]
    ref = tras.rasterize_points(s, k, 32, *args, dmt, 1.0)
    cfg = splat.TileConfig(tile=_golden_tile(g), cap=-(-p // 128) * 128,
                           max_tiles=16)
    frag = splat.rasterize_forward_fragments(
        s, k, cfg, *args, dmt, torch.ones((1, p)), torch.ones((1, p, 3)))
    assert int(frag[6][0]) == 0
    return {"reference": [x[0].numpy() for x in ref[:4]],
            "fragments": [x[0].numpy() for x in frag[:4]]}


PATHS = ["reference", "fragments"]


@pytest.mark.parametrize("path", PATHS)
def test_golden_fragments(golden, golden_frags, path):
    idx, zbuf, qvalue, occ = golden_frags[path]
    g = golden
    np.testing.assert_array_equal(occ, g["occupancy"])
    gi, gz, gq = _sort_frags(g["idx"], g["zbuf"], g["qvalue"])
    oi, oz, oq = _sort_frags(idx, zbuf, qvalue)
    np.testing.assert_array_equal(oi, gi)
    np.testing.assert_allclose(oz, gz, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(oq, gq, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("path", PATHS)
def test_golden_composite_rmse(golden, golden_frags, path):
    idx, _z, qvalue, _o = golden_frags[path]
    p = golden["pts_screen"].shape[0]
    colors = np.random.default_rng(7).random((p + 1, 3)).astype(np.float32)
    colors[-1] = 0.0  # idx −1 slot

    def composite(idx, qvalue):
        w = np.where(idx >= 0, np.exp(-0.5 * np.maximum(qvalue, 0.0)), 0.0)
        num = (w[..., None] * colors[idx]).sum(-2)
        return num / np.maximum(w.sum(-1)[..., None], 1e-10)

    rmse = float(np.sqrt(np.mean(
        (composite(idx, qvalue) - composite(golden["idx"], golden["qvalue"])) ** 2)))
    assert rmse <= 1e-3, f"pixel RMSE vs reference render: {rmse}"


@pytest.mark.parametrize("path", PATHS)
def test_golden_zbuf_backward(golden, path):
    p = golden["pts_screen"].shape[0]
    fn = tras._zbuf_backward if path == "reference" else splat.zbuf_backward
    grad_z = fn(_t(golden["idx"], torch.int32)[None],
                _t(golden["grad_zbuf"])[None], p)[0].numpy()
    np.testing.assert_allclose(grad_z, golden["grad_pts_z"], atol=1e-5,
                               rtol=1e-5)


def _port_occ_backward(g, path, g_occ, scaler):
    """(P, 2) occupancy gradient of the port on the golden's points, all
    visible: the spec's `_occ_backward`, or the CPU path of K2 + K4
    (`bin_for_occ_backward` → `occ_bwd_plain` → `segment_sum_plain`)."""
    pts, radii = _t(g["pts_screen"])[None], _t(g["radii"])[None]
    s = int(g["image_size"])
    p = pts.shape[1]
    visible = torch.ones((1, p), dtype=torch.bool)
    g_occ = _t(g_occ)[None]
    if path == "reference":
        grad_xy = tras._occ_backward(pts, radii, visible, g_occ, scaler, s, 32)
    else:
        t = _golden_tile(g)
        nt = s // t
        bb, r2 = splat.bin_for_occ_backward(
            pts, radii, visible, scaler, s, t, -(-p // 128) * 128, nt,
            pair_cap=p * nt * nt)
        assert int(bb.overflow[0]) == 0
        gx, gy = kernels.occ_bwd_plain(
            bb.tile_counts, bb.tile_data, splat._tile(g_occ[..., None], t)[..., 0],
            r2, s, t)
        grad_xy = kernels.segment_sum_plain(
            torch.stack([gx.reshape(1, -1), gy.reshape(1, -1)], 1),
            splat._seg(bb.tile_ids, p), p)
    return grad_xy[0].numpy()


@pytest.mark.parametrize("path", PATHS)
def test_golden_occ_field_wide(golden, path):
    """The whole-image support field (see test_reference_golden.py), with
    its exclusion of the points next to an active pixel centre."""
    g = golden
    s = int(g["image_size"])
    scaler = 4.0 / float(np.median(g["radii"]))
    grad_xy = _port_occ_backward(g, path, g["grad_occ"], scaler)
    want = g["grad_pts_xy_wide"]
    ys, xs = np.nonzero(g["grad_occ"] != 0.0)
    xf = 1.0 - (2.0 * xs + 1.0) / s
    yf = 1.0 - (2.0 * ys + 1.0) / s
    pn = g["pts_screen"]
    d2 = (xf[None, :] - pn[:, 0:1]) ** 2 + (yf[None, :] - pn[:, 1:2]) ** 2
    keep = d2.min(axis=1) >= 1e-7
    assert (~keep).sum() <= 10
    denom = np.maximum(np.abs(want[keep]), 1.0)
    np.testing.assert_allclose(grad_xy[keep] / denom, want[keep] / denom,
                               atol=6e-3)


@pytest.mark.parametrize("path", PATHS)
def test_golden_occ_field_finite(golden, path):
    """The finite support (the golden's mid-anneal scaler), the field
    training uses, against the reference CPU's own output, with the JAX
    package's test (test_reference_golden.py::TestOccBackward::
    test_finite_radius_matches_reference): the reference CPU skips a pixel
    iff |dx| > rx·s AND |dy| > ry·s (a per-point cross), both packages use
    the disc ‖d‖ ≤ median(radii)·s, so the golden is corrected by the
    analytic delta Σ(disc-only) − Σ(cross-only).  Points within 3e-4 NDC of
    an active pixel centre are left out (the field is singular there), the
    agreed region must dominate the correction for most points, and the
    pixels compared must not be empty.  atol 6e-3 of max(|want|, 1)."""
    g = golden
    pts = np.asarray(g["pts_screen"])
    radii = np.asarray(g["radii"])
    s = int(g["image_size"])
    scaler = float(g["radii_backward_scaler_finite"])
    g_img = g["grad_occ_finite"]
    p = pts.shape[0]
    grad_xy = _port_occ_backward(g, path, g_img, scaler)

    ys, xs = np.nonzero(g_img != 0.0)
    assert len(ys) > 0
    gv = g_img[ys, xs].astype(np.float64)
    xf = 1.0 - (2.0 * xs + 1.0) / s
    yf = 1.0 - (2.0 * ys + 1.0) / s
    cur_r = float(np.median(radii)) * scaler
    pt_ok = ((pts[:, 2] >= 0.0) & (np.abs(pts[:, 0]) <= 1.0)
             & (np.abs(pts[:, 1]) <= 1.0))
    corr = np.zeros((p, 2), np.float64)
    inter_mag = np.zeros((p,), np.float64)
    d2min = np.full((p,), np.inf)
    for i in range(0, p, 2048):
        sl = slice(i, min(i + 2048, p))
        dx = xf[None, :] - pts[sl, 0:1]
        dy = yf[None, :] - pts[sl, 1:2]
        dist2 = dx * dx + dy * dy
        d2min[sl] = dist2.min(axis=1)
        outside_splat = ((np.abs(dx) > radii[sl, 0:1])
                         | (np.abs(dy) > radii[sl, 1:2]))
        gate = pt_ok[sl, None] & ~((gv[None, :] > 0.0) & outside_splat)
        in_cross = ~((np.abs(dx) > radii[sl, 0:1] * scaler)
                     & (np.abs(dy) > radii[sl, 1:2] * scaler))
        in_disc = dist2 <= cur_r * cur_r
        delta = gate & (in_cross != in_disc)
        w = gv[None, :] / np.maximum(dist2, 1e-8)
        signed = np.where(delta, np.where(in_disc, w, -w), 0.0)
        corr[sl, 0] = (signed * dx).sum(axis=1)
        corr[sl, 1] = (signed * dy).sum(axis=1)
        w_agree = np.where(gate & in_disc & in_cross, w, 0.0)
        inter_mag[sl] = (np.abs(w_agree * dx).sum(axis=1)
                         + np.abs(w_agree * dy).sum(axis=1))
    want = g["grad_pts_xy_finite"].astype(np.float64) + corr

    keep = d2min >= 1e-7
    assert (~keep).sum() <= 10
    ok = keep & pt_ok
    assert ok.sum() > 0
    dominated = float((np.abs(corr[ok]).sum(axis=1) < inter_mag[ok]).mean())
    assert dominated > 0.5, f"agreed-region-dominant fraction {dominated}"
    assert (inter_mag[ok] > 0).any()
    denom = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(grad_xy[keep] / denom[keep],
                               want[keep] / denom[keep], atol=6e-3)


@pytest.fixture(scope="module")
def ewa_golden():
    return np.load(os.path.join(GOLDEN_DIR, "reference_ewa_teapot.npz"))


def _ewa_cams(g):
    return convert.cameras_from_numpy(
        {k: g[k] for k in ("R", "T", "fov", "znear", "zfar")}, device=DEV)


def test_ewa_golden_projection_matrix(ewa_golden):
    np.testing.assert_array_equal(
        _ewa_cams(ewa_golden).full_projection_matrix().numpy(),
        ewa_golden["m44"])


@pytest.mark.parametrize("mode", ["invariant", "isotropic", "anisotropic"])
def test_prepare_splats_matches_reference_ewa_golden(ewa_golden, mode):
    """The port's EWA setup against the reference's own
    `_get_per_point_info` (tolerances of tests/test_ewa_golden.py; the
    anisotropic scaler at rtol 6e-3, as there: the reference's SVD and
    eigh disagree at float level on near-degenerate 8-NN
    neighbourhoods)."""
    g = ewa_golden
    st = tewa.RasterSettings(
        image_size=int(g["image_size"]),
        cutoff_threshold=float(g["cutoff_threshold"]),
        antialiasing_sigma=float(g["antialiasing_sigma"]),
        Vrk_invariant=(mode == "invariant"), Vrk_isotropic=(mode == "isotropic"),
        backface_culling=False)
    p = g["points"].shape[0]
    sp = tewa.prepare_splats(_t(g["points"]), _t(g["normals"]),
                             torch.ones(p, dtype=torch.bool), _ewa_cams(g), st)
    assert bool(sp.mask.all())
    ref_ell = g[f"{mode}_ellipse_params"]
    scale = np.maximum(np.abs(ref_ell[:, 0]), np.abs(ref_ell[:, 2]))[:, None]
    diff = np.abs(sp.ellipse_params[0].numpy() - ref_ell)
    assert np.all(diff < 5e-4 * scale + 1e-6)
    np.testing.assert_allclose(sp.radii[0].numpy(), g[f"{mode}_radii"],
                               rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(sp.scaler[0].numpy(), g[f"{mode}_scaler"],
                               rtol=6e-3 if mode == "anisotropic" else 2e-3,
                               atol=1e-5)
    np.testing.assert_array_equal(sp.cutoff[0].numpy(),
                                  g[f"{mode}_cutoff_threshold"])


# ---------------------------------------------------------------------------
# The renderer's fragment and reference paths
# ---------------------------------------------------------------------------

RS, RT, RV, RN = 32, 16, 3, 300
RKW = dict(image_size=RS, points_per_pixel=K, backface_culling=True,
           tile_size=RT, Vrk_invariant=True, Vrk_isotropic=False,
           clip_pts_grad=0.05, depth_channel=True)
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}


@pytest.mark.parametrize("path", [dict(backend="pallas", lean_fragments=False),
                                  dict(backend="reference")],
                         ids=["fragments", "reference"])
def test_render_views_matches_jax(path):
    pts = fibonacci_sphere(RN, 0.5)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((RV,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 80.0, 200.0]))
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0}
    rng = np.random.default_rng(2)
    cols = rng.uniform(0.2, 0.9, (RN, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (RV, RS, RS, 4)).astype(np.float32)
    g_z = rng.standard_normal((RV, RS, RS)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (RV,) + x.shape),
                                JLights.create(**LIGHTS))

    def jloss(p, c):
        rgba, fr, vis = j_render_views(
            p, jnp.asarray(nrm), c, jnp.ones((RN,), bool),
            JCameras.create(cams["R"], cams["T"], fov=60.0), jl,
            jewa.RasterSettings(**path, **RKW))
        loss = (jnp.mean((rgba - target) ** 2) + jnp.mean(jnp.abs(fr.wdepth - 2.0))
                + jnp.mean(fr.zbuf[..., 0] * g_z))
        return loss, (rgba, vis, fr.idx, fr.zbuf, fr.wdepth)

    (jval, want), (jgp, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(pts), jnp.asarray(cols))

    tp = torch.tensor(pts, requires_grad=True)
    tc = torch.tensor(cols, requires_grad=True)
    rgba, fr, vis = render_views(
        tp, torch.tensor(nrm), tc, torch.ones(RN, dtype=torch.bool),
        convert.cameras_from_numpy(cams, device=DEV), convert.lights_from_numpy(LIGHTS, RV, device=DEV),
        tewa.RasterSettings(**path, **RKW))
    loss = (torch.mean((rgba - torch.tensor(target)) ** 2)
            + torch.mean(torch.abs(fr.wdepth - 2.0))
            + torch.mean(fr.zbuf[..., 0] * torch.tensor(g_z)))
    gp, gc = torch.autograd.grad(loss, (tp, tc))

    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(fr.idx.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(fr.zbuf.detach().numpy(), np.asarray(want[3]),
                               atol=1e-6)
    np.testing.assert_allclose(fr.wdepth.detach().numpy(), np.asarray(want[4]),
                               atol=1e-5)
    # the same sums in another order, through clip and shading
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-3, atol=1e-4)
    assert int(fr.overflow.sum()) == 0 and np.abs(np.asarray(jgp)).max() > 1e-3


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        render_views(torch.zeros((4, 3)), torch.zeros((4, 3)), torch.zeros((4, 3)),
                     torch.ones(4, dtype=torch.bool),
                     convert.cameras_from_numpy({"R": np.eye(3)[None],
                                                 "T": np.zeros((1, 3))},
                                                device=DEV),
                     None, tewa.RasterSettings(backend="cuda"))


# ---------------------------------------------------------------------------
# The fragment-zbuf train loss
# ---------------------------------------------------------------------------

FRAG_RASTER = {**chip_smoke.FLAGSHIP_FRAG_RASTER, "image_size": RS,
               "tile_size": RT}
PART_KEYS = ("loss_dr_rgb", "loss_dr_silhouette", "loss_dr_depth",
             "loss_dr_proj", "loss_dr_repel")


@pytest.fixture(scope="module")
def frag_case():
    """Model cloud, cameras and targets rendered by the port's fragment
    path from an ellipsoid; the depth target is the nearest fragment's z,
    the background at zfar (as create_mvr_data makes it)."""
    rng = np.random.default_rng(0)
    verts, faces = ico_sphere(3, 0.5)
    pts, nrm = sample_points_from_mesh(verts, faces, RN, rng=rng)
    gt, gt_n = sample_points_from_mesh(verts, faces, 800, rng=rng)
    r, t = look_at_view_transform(dist=torch.full((RV,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 120.0, 240.0]))
    cams = {"R": r.numpy(), "T": t.numpy(), "fov": 60.0}
    with torch.no_grad():
        rgba, fr, _ = render_views(
            torch.tensor(gt * np.array([1.2, 0.9, 1.0], np.float32)),
            torch.tensor(gt_n), torch.full((800, 3), 0.6),
            torch.ones(800, dtype=torch.bool), convert.cameras_from_numpy(cams, device=DEV),
            convert.lights_from_numpy(LIGHTS, RV, device=DEV), tewa.RasterSettings(**FRAG_RASTER))
    mask = rgba[..., 3].numpy()
    return dict(
        params={"points": pts, "normals": nrm, "colors": np.ones_like(pts)},
        cams=cams, img=rgba[..., :3].numpy(), mask=mask,
        depth=np.where(mask > 0.5, fr.zbuf[..., 0].numpy(), 100.0).astype(np.float32),
    )


def test_fragment_zbuf_loss_and_grads_match_jax(frag_case):
    """make_loss_fn with lean_fragments=False, depth_channel off and depth
    L1 on zbuf[..., 0], against dss_tpu's on the pallas fragment path
    (the tolerances of tests/test_torch_train_step.py)."""
    c = frag_case
    train = tt.TrainConfig(**chip_smoke.FLAGSHIP_TRAIN)
    sched = tt.AnnealSchedule(**chip_smoke.FLAGSHIP_SCHEDULE)
    loss_fn = jt.make_loss_fn(jewa.RasterSettings(backend="pallas", **FRAG_RASTER),
                              jt.TrainConfig(**chip_smoke.FLAGSHIP_TRAIN),
                              jt.AnnealSchedule(**chip_smoke.FLAGSHIP_SCHEDULE))
    jl = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (RV,) + x.shape),
                                JLights.create(**LIGHTS))
    (_, (jparts, jnf)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        JParams.create(**c["params"]), JFilters.ones(RN),
        JCameras.create(c["cams"]["R"], c["cams"]["T"], fov=60.0), jl,
        jnp.asarray(c["img"]), jnp.asarray(c["mask"]), jnp.asarray(0),
        jnp.asarray(c["depth"]))

    params = convert.params_from_numpy(c["params"], device=DEV)
    total, (parts, nf) = tt.make_loss_fn(
        tewa.RasterSettings(**FRAG_RASTER), train, sched)(
        params, PointFilters.ones(RN, device=DEV), convert.cameras_from_numpy(c["cams"], device=DEV),
        convert.lights_from_numpy(LIGHTS, RV, device=DEV), torch.tensor(c["img"]),
        torch.tensor(c["mask"]), 0, torch.tensor(c["depth"]))
    grads = torch.autograd.grad(total, params.tensors())
    for k in PART_KEYS:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-4,
                                   err_msg=k)
    assert int(parts["bin_overflow"]) == 0 == int(jparts["bin_overflow"])
    for name, got, want in zip(("points", "normals", "colors"), grads,
                               (jg.points, jg.normals, jg.colors)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(nf.visibility.numpy(), np.asarray(jnf.visibility))
    np.testing.assert_array_equal(nf.inmask.numpy(), np.asarray(jnf.inmask))
    assert parts["loss_dr_depth"].detach().item() > 0 and np.abs(np.asarray(jg.points)).max() > 1e-3


@pytest.mark.parametrize("kw, ok", [
    (dict(depth_channel=False, lean_fragments=True), False),
    (dict(depth_channel=True, lean_fragments=True), True),
    (dict(depth_channel=False, lean_fragments=False), True),
    (dict(depth_channel=False, backend="reference"), True),
])
def test_depth_loss_needs_a_depth_carrying_path(kw, ok):
    """dss_tpu's _validate_loss_inputs rule: depth needs the depth channel,
    the fragment buffers, or the reference backend, and a depth batch."""
    st = tewa.RasterSettings(**kw)
    cfg = tt.TrainConfig(lambda_depth=0.1)
    depth = torch.zeros((1, 8, 8))
    if ok:
        tt._validate_loss_inputs(st, cfg, depth)
    else:
        with pytest.raises(ValueError, match="depth-carrying"):
            tt._validate_loss_inputs(st, cfg, depth)
    with pytest.raises(ValueError, match="depth batch"):
        tt._validate_loss_inputs(st, cfg, None)
    tt._validate_loss_inputs(st, tt.TrainConfig(lambda_depth=0.0), None)


def test_fragment_flagship_values_match_the_yaml():
    """chip_smoke's fragment-path literals equal what dss_tpu.config builds
    from configs/dss_depth.yml with lean_fragments: false (train_mvr then
    leaves the depth channel off and reads the zbuf)."""
    cfg = jconfig.load_config("configs/dss_depth.yml")
    cfg["renderer"]["raster_params"]["lean_fragments"] = False
    rs = jconfig.create_raster_settings(cfg)
    for k, v in chip_smoke.FLAGSHIP_FRAG_RASTER.items():
        assert getattr(rs, k) == v, k
    assert not rs.depth_channel and not rs.lean_fragments
