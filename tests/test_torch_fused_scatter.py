"""The fused scatters of K1, K2, K3 and K5 (their per-candidate results
summed into points in the kernel's epilogue, where dss_tpu runs K4 after
each kernel) and the standalone K4 on the zbuf scatter, pinned to dss_tpu
on the CPU.

Each kernel's per-point plain version (`kernels.<name>_points_plain`, the
CPU path of the port and the reference its CUDA kernel is held to on the
card) runs on dss_tpu's own binned tables and is held to dss_tpu's
per-point results, on both of dss_tpu's scatter routes: the one-hot MXU
matmul (`segment_sum_views_matmul`, K4's Pallas kernel, in interpret mode)
and `sorted_segment_sum`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.ops import splat_pallas as jsp
from dss_tpu.render.rasterizer import _zbuf_backward
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.render.ewa import RasterSettings, prepare_splats
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N, K, DMT, CAP, CAP_BWD = 32, 16, 3, 300, 5, 0.05, 384, 2048
ROUTES = ["matmul", "sorted"]


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _tiled(img):
    """(V, S, S[, ch]) numpy → the kernels' tile order (V, nt, tt[, ch])."""
    x = _t(img)
    ch = x.shape[3:]
    x = x.reshape(V, S // T, T, S // T, T, *ch).permute(
        0, 1, 3, 2, 4, *range(5, 5 + len(ch)))
    return x.reshape(V, -1, T * T, *ch).contiguous()


@pytest.fixture(scope="module")
def splats():
    """Screen-space splats of a 300-point sphere in 3 views (32², tile 16),
    with random colours."""
    pts = fibonacci_sphere(N, 0.5)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 80.0, 200.0]))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=DEV)
    st = RasterSettings(image_size=S, points_per_pixel=K, backface_culling=True,
                        Vrk_invariant=True, Vrk_isotropic=False)
    sp = prepare_splats(torch.tensor(pts), torch.tensor(nrm),
                        torch.ones(N, dtype=torch.bool), cams, st)
    arr = {k: jnp.asarray(getattr(sp, k).detach().numpy()) for k in
           ("pts_screen", "ellipse_params", "cutoff", "radii", "scaler")}
    arr["features"] = jnp.asarray(
        np.random.default_rng(7).uniform(0, 1, (V, N, 3)), jnp.float32)
    return arr


@pytest.fixture(scope="module", params=ROUTES)
def lean(request, splats):
    """dss_tpu's lean forward on one scatter route: its per-point
    visibility and its binned tables."""
    arr = splats
    _occ, visible, _rgbw, overflow, binned = jsp.rasterize_forward_views_lean(
        arr["pts_screen"], arr["ellipse_params"], arr["cutoff"], arr["radii"],
        DMT, S, K, tile_size=T, bin_capacity=CAP, scaler=arr["scaler"],
        features=arr["features"], matmul_scatter=request.param == "matmul",
        with_depth=True,
    )
    assert int(jnp.sum(overflow)) == 0
    return dict(route=request.param, visible=np.asarray(visible),
                binned=binned)


def test_fwd_lean_points_plain_matches_jax(lean):
    b = lean["binned"]
    _cnt, vis, _rgbw = kernels.fwd_lean_points_plain(
        _t(b.tile_counts), _t(b.tile_data), N, DMT, S, T, K, with_depth=True)
    # exact: the same flags, and "any flag" is the sum's > 0 on both routes
    assert set(np.unique(vis.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(vis.numpy() > 0, lean["visible"])
    assert lean["visible"].sum() > 100


def test_occ_bwd_points_plain_matches_jax(splats, lean):
    arr = splats
    bb, cur_r2 = jax.vmap(lambda p, r, v: jsp.bin_for_occ_backward(
        p, r, v, jnp.float32(5.0), S, T, CAP_BWD, 4))(
        arr["pts_screen"], arr["radii"], jnp.asarray(lean["visible"]))
    g = np.random.default_rng(8).standard_normal((V, S, S)).astype(
        np.float32) * 3e-4
    want = jsp.occ_backward_views_from_binned(
        bb, cur_r2, jnp.asarray(g), N, S, T, CAP_BWD,
        matmul_scatter=lean["route"] == "matmul")
    got = kernels.occ_bwd_points_plain(
        _t(bb.tile_counts), _t(bb.tile_data), _t(bb.tile_ids), _tiled(g),
        _t(cur_r2), N, S, T)
    # per-candidate sums over the tile's pixels in another order, then
    # over the point's tiles (the MXU route exact to ~2⁻²⁴ per term)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-3


def test_feat_bwd_points_plain_matches_jax(lean):
    b = lean["binned"]
    g = np.random.default_rng(9).standard_normal((V, S, S, 4)).astype(
        np.float32) * 3e-4
    want = jsp.feat_backward_views(b, jnp.asarray(g), DMT, N, S, K, T, CAP,
                                   matmul_scatter=lean["route"] == "matmul",
                                   with_depth=True)
    got = kernels.feat_bwd_points_plain(_t(b.tile_counts), _t(b.tile_data),
                                        _tiled(g), N, DMT, S, T, K)
    # sums of w·g over pixels, then slots, in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-4


@pytest.fixture(scope="module")
def frag(splats):
    """dss_tpu's fragment forward (rasterize_forward_pallas, one view at a
    time): fragment ids, per-point visibility (its sorted_segment_sum
    route) and the binned tables, stacked over the views."""
    arr = splats
    outs = [jsp.rasterize_forward_pallas(
        *(arr[k][v] for k in ("pts_screen", "ellipse_params", "cutoff",
                              "radii")),
        DMT, S, K, tile_size=T, bin_capacity=CAP, max_tiles_xy=4,
        scaler=arr["scaler"][v], with_extras=True, features=arr["features"][v],
        with_binned=True) for v in range(V)]
    assert all(int(o[7]) == 0 for o in outs)
    binned = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[o[8] for o in outs])
    return dict(idx=np.stack([np.asarray(o[0]) for o in outs]),
                visible=np.stack([np.asarray(o[5]) for o in outs]),
                binned=binned)


@pytest.mark.parametrize("route", ROUTES)
def test_fwd_frag_points_plain_matches_jax(frag, route):
    """rasterize_forward_pallas scatters K5's flags by sorted_segment_sum
    only; the MXU route is segment_sum_views_matmul over K5's
    per-candidate flags (fwd_frag_plain's, bit-equal to the Pallas
    kernel's: test_torch_fragments.py) and dss_tpu's id map."""
    b = frag["binned"]
    counts, table = _t(b.tile_counts), _t(b.tile_data)
    *_frags, vis, _rgbw = kernels.fwd_frag_points_plain(counts, table, N, DMT,
                                                        S, T, K)
    if route == "sorted":
        want = frag["visible"]
    else:
        vis_t = kernels.fwd_frag_plain(counts, table, DMT, S, T, K)[4]
        ids = np.asarray(b.tile_ids).reshape(V, -1)
        want = np.asarray(jsp.segment_sum_views_matmul(
            jnp.asarray(vis_t.reshape(V, 1, -1).numpy()),
            jnp.asarray(np.where(ids >= 0, ids, N)), N))[..., 0] > 0
    np.testing.assert_array_equal(vis.numpy() > 0, want)
    assert want.sum() > 100


def test_zbuf_scatter_matches_jax(frag):
    """K4's plain version on the zbuf scatter, through the fragment op's
    zbuf_backward, against dss_tpu's _zbuf_backward on the fragment ids
    of rasterize_forward_pallas (−1 where a pixel has fewer than K)."""
    idx = frag["idx"]
    assert (idx < 0).any() and (idx >= 0).sum() > 500
    g = np.random.default_rng(10).standard_normal(idx.shape).astype(np.float32)
    got = splat.zbuf_backward(_t(idx), _t(g), N).numpy()
    want = np.stack([np.asarray(_zbuf_backward(jnp.asarray(idx[v]),
                                               jnp.asarray(g[v]), N))
                     for v in range(V)])
    # sums of a point's cotangents in another order
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("name", ["fwd_lean", "occ_bwd", "feat_bwd",
                                  "fwd_frag"])
def test_cpu_wrappers_take_the_per_point_plain_versions(frag, name):
    """Given CPU tensors, each fused kernel's wrapper returns its per-point
    plain version's outputs and counts no launch."""
    b = frag["binned"]
    counts, table = _t(b.tile_counts), _t(b.tile_data)
    rng = np.random.default_rng(11)
    grad = _t(rng.standard_normal((V, counts.shape[1], T * T, 4)), torch.float32)
    args = {"fwd_lean": (counts, table, N, DMT, S, T, K, True),
            "feat_bwd": (counts, table, grad, N, DMT, S, T, K),
            "fwd_frag": (counts, table, N, DMT, S, T, K)}
    if name == "occ_bwd":
        ids = _t(b.tile_ids)
        table5 = table[:, :, [kernels.CH_PX, kernels.CH_PY, kernels.CH_PZ,
                              kernels.CH_RX, kernels.CH_RY]].contiguous()
        args[name] = (counts, table5, ids, grad[..., 0].contiguous(),
                      torch.full((V,), 0.01), N, S, T)
    before = getattr(kernels, name).launches
    got = getattr(kernels, name)(*args[name])
    want = getattr(kernels, name + "_points_plain")(*args[name])
    for a, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, w)
    assert getattr(kernels, name).launches == before
    per_point = got[-2] if name.startswith("fwd") else got
    assert per_point.shape[:2] == (V, N) and per_point.abs().max() > 0
