"""The port's tile binning against dss_tpu's on the same screen-space
splats: the candidate tables are gathers and the counts integer, so every
field must match exactly (tie order inside a tile decides which fragments
win)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.ops import splat_pallas as jsp
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import splat as tsp
from dss_tpu_torch.render.ewa import RasterSettings, prepare_splats
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

# The entry points build on the card unless told otherwise.
DEV = torch.device("cpu")
S, T, V, N = 64, 16, 3, 400


@pytest.fixture(scope="module")
def splats():
    """Screen-space splats of a sphere in 3 views, as numpy arrays."""
    pts = fibonacci_sphere(N, 0.5)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    r, t = look_at_view_transform(dist=torch.full((V,), 2.0),
                                  elev=torch.tensor([0.0, 25.0, -20.0]),
                                  azim=torch.tensor([0.0, 80.0, 200.0]))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=DEV)
    st = RasterSettings(image_size=S, points_per_pixel=5, backface_culling=True)
    sp = prepare_splats(torch.tensor(pts), torch.tensor(nrm),
                        torch.ones(N, dtype=torch.bool), cams, st)
    rng = np.random.default_rng(5)
    out = {k: getattr(sp, k).detach().numpy() for k in
           ("pts_screen", "ellipse_params", "cutoff", "radii", "scaler")}
    out["features"] = rng.uniform(0, 1, (V, N, 3)).astype(np.float32)
    out["visible"] = rng.random((V, N)) < 0.8
    return out


def _jax_binned(sp, case):
    pts, ell, cut, rad = (sp["pts_screen"], sp["ellipse_params"],
                          sp["cutoff"], sp["radii"])
    outs = []
    for v in range(V):
        if case == "fwd":
            b = jsp.bin_splats(pts[v], ell[v], cut[v], rad[v], S, T, 512,
                               scaler=sp["scaler"][v],
                               features=sp["features"][v])
        elif case == "bwd":
            b, r2 = jsp.bin_for_occ_backward(
                jnp.asarray(pts[v]), jnp.asarray(rad[v]),
                jnp.asarray(sp["visible"][v]), jnp.float32(5.0), S, T, 2048, 4)
            b = b._replace(overflow=(b.overflow, r2))
        elif case == "span_trunc":
            b = jsp.bin_splats(pts[v], ell[v], cut[v], rad[v] * 3.0, S, T, 512,
                               max_tiles_x=2, max_tiles_y=2, pair_cap=256,
                               scaler=sp["scaler"][v],
                               features=sp["features"][v])
        outs.append(jax.tree_util.tree_map(np.asarray, b))
    return outs


def _torch_binned(sp, case):
    f = lambda k: torch.tensor(sp[k])
    if case == "fwd":
        return tsp.bin_splats(f("pts_screen"), f("ellipse_params"),
                              f("cutoff"), f("radii"), S, T, 512,
                              scaler=f("scaler"), features=f("features"))
    if case == "bwd":
        return tsp.bin_for_occ_backward(f("pts_screen"), f("radii"),
                                        f("visible"), 5.0, S, T, 2048, 4)
    return tsp.bin_splats(f("pts_screen"), f("ellipse_params"), f("cutoff"),
                          f("radii") * 3.0, S, T, 512, max_tiles_x=2,
                          max_tiles_y=2, pair_cap=256, scaler=f("scaler"),
                          features=f("features"))


@pytest.mark.parametrize("case", ["fwd", "bwd", "span_trunc"])
def test_bin_splats_matches_jax(splats, case):
    want = _jax_binned(splats, case)
    got = _torch_binned(splats, case)
    if case == "bwd":
        got, cur_r2 = got
        np.testing.assert_array_equal(cur_r2.numpy(),
                                      [w.overflow[1] for w in want])
        want = [w._replace(overflow=w.overflow[0]) for w in want]
    for field in ("tile_ids", "tile_counts", "overflow", "tile_data"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(),
            np.stack([getattr(w, field) for w in want]), err_msg=field)
    if case == "span_trunc":
        assert int(got.overflow.min()) > 0
    else:
        assert int(got.overflow.max()) == 0


def test_capacity_overflow_matches_jax():
    """20 candidates in one tile at capacity 4: 16 dropped in both."""
    pts = np.zeros((20, 3), np.float32)
    pts[:, 2] = np.linspace(1.0, 2.0, 20)
    radii = np.full((20, 2), 0.01, np.float32)
    ones = np.ones((20, 3), np.float32)
    want = jsp.bin_splats(pts, ones, ones[:, 0], radii, image_size=64,
                          tile_size=32, bin_capacity=4)
    got = tsp.bin_splats(torch.tensor(pts)[None], torch.tensor(ones)[None],
                         torch.tensor(ones[:, 0])[None],
                         torch.tensor(radii)[None], 64, 32, 4)
    assert int(want.overflow) == 16
    np.testing.assert_array_equal(got.overflow.numpy(), [16])
    np.testing.assert_array_equal(got.tile_ids[0].numpy(), want.tile_ids)
    np.testing.assert_array_equal(got.tile_data[0].numpy(), want.tile_data)


def test_masked_median_matches_jax():
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((4, 101)).astype(np.float32)
    mask = rng.random((4, 101)) < np.array([[0.5], [0.3], [1.0], [0.0]])
    got = tsp.masked_median(torch.tensor(vals), torch.tensor(mask)).numpy()
    want = [float(jsp.masked_median(jnp.asarray(v), jnp.asarray(m)))
            for v, m in zip(vals, mask)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_ndc_to_pixel_roundtrip():
    c = torch.arange(S, dtype=torch.float32)
    ndc = 1.0 - (2.0 * c + 1.0) / S
    np.testing.assert_allclose(tsp.ndc_to_pixel(ndc, S).numpy(), c.numpy(),
                               atol=1e-4)
