"""Meshing of dss_tpu_torch against dss_tpu on the same numpy inputs:
`geometry/meshing.py` (the MLS field and its grid, marching tetrahedra,
the Poisson indicator and both meshers) and `models/generator.py`
(`generate_mesh` both ways, `generate_pointclouds`, `generate_images`).

Tolerances:

- `mls_signed_distance` and `sample_sdf_grid`: within 1e-5, on the
  port's grid nodes and on dss_tpu's, which lie within an ulp of them
  (torch.linspace and jnp.linspace round some nodes apart); the grid
  leaves out the nodes whose 8th and 9th nearest squared distances tie
  in float32 (a gap below 1e-6: 1 node of 8000, gap 7.8e-9, 2.1e-4 apart
  in the field), where either package may take either neighbour;
- `marching_tetrahedra` on the same numpy grid: bit-equal;
- the Poisson indicator grid (float64; the port's splat and FFT are
  torch's, dss_tpu's numpy's): within 1e-9 relative to its largest
  value, and the iso level within 1e-9 relative;
- whole meshes: face counts within 0.5%, and the symmetric distance
  between the two vertex sets below 1e-3 of a voxel (the weld keys of
  vertices that land on a rounding edge can differ by an ulp of the grid);
- `generate_images`: PNGs within 1 level of dss_tpu's (both render with
  `backend="reference"`, named on both sides);
- `generate_pointclouds`: the PLY's points, normals and colours equal.
"""
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dss_tpu.data.io import read_ply as j_read_ply
from dss_tpu.geometry import cameras as jcam
from dss_tpu.geometry import meshing as jm
from dss_tpu.geometry.pointclouds import PointFilters as JFilters
from dss_tpu.models import point_model as jpm
from dss_tpu.models.generator import Generator as JGenerator
from dss_tpu.render.ewa import RasterSettings as JSettings
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry import cameras as tcam
from dss_tpu_torch.geometry import meshing as tm
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.generator import Generator
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.ewa import RasterSettings
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=DEV)


@pytest.fixture(scope="module")
def cloud():
    """A noisy ellipsoid (1500 points, σ 0.005) with outward normals, 1
    point in 29 masked out."""
    rng = np.random.default_rng(0)
    u = fibonacci_sphere(1500, 1.0)
    axes = np.array([0.6, 0.45, 0.5])
    pts = (u * axes + 0.005 * rng.standard_normal(u.shape)).astype(np.float32)
    nrm = u / axes
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[::29] = False
    return pts, nrm, mask


def test_mls_signed_distance_matches_jax(cloud):
    pts, nrm, mask = cloud
    q = np.random.default_rng(1).uniform(-0.8, 0.8, (300, 3)).astype(np.float32)
    for m in (None, mask):
        want = jm.mls_signed_distance(jnp.asarray(q), jnp.asarray(pts),
                                      jnp.asarray(nrm),
                                      None if m is None else jnp.asarray(m))
        got = tm.mls_signed_distance(_t(q), _t(pts), _t(nrm),
                                     None if m is None else _t(m, torch.bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert (got.numpy() < 0).any() and (got.numpy() > 0).any()


def test_sample_sdf_grid_matches_jax(cloud):
    """The grid's nodes within an ulp of the box's extent of
    jnp.linspace's (the two linspaces
    round some nodes apart, and a node an ulp away can swap a kNN-distance
    near-tie); the field on the port's nodes against JAX's MLS on the same
    nodes, and the chunked grid against one unchunked call."""
    pts, nrm, mask = cloud
    lo = np.array([-0.7, -0.55, -0.6], np.float32)
    hi = np.array([0.7, 0.55, 0.6], np.float32)
    grid = tm.sdf_grid_points(_t(lo), _t(hi), 20, DEV)
    axes = [np.asarray(jnp.linspace(jnp.asarray(lo)[i], jnp.asarray(hi)[i], 20))
            for i in range(3)]
    want_grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_allclose(grid.numpy(), want_grid, rtol=0,
                               atol=np.spacing(np.float32(0.7)))
    # a chunk that does not divide the 8000 grid points
    got = tm.sample_sdf_grid(_t(pts), _t(nrm), _t(mask, torch.bool), _t(lo),
                             _t(hi), resolution=20, chunk=3000)
    assert got.shape == (20, 20, 20)
    one = tm.mls_signed_distance(grid, _t(pts), _t(nrm), _t(mask, torch.bool))
    np.testing.assert_array_equal(got.numpy().reshape(-1), one.numpy())
    # nodes whose 8th and 9th nearest squared distances tie in float32
    # (a gap below 1e-6, in float64) take either neighbour in either package
    d = cKDTree(pts[mask].astype(np.float64)).query(
        grid.numpy().astype(np.float64), k=9)[0] ** 2
    apart = d[:, 8] - d[:, 7] > 1e-6
    assert apart.mean() > 0.999
    want = np.asarray(jm.mls_signed_distance(
        jnp.asarray(grid.numpy()), jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy().reshape(-1)[apart], want[apart],
                               rtol=0, atol=1e-5)
    # and dss_tpu's own grid
    jgrid = np.asarray(jm.sample_sdf_grid(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask), jnp.asarray(lo),
        jnp.asarray(hi), resolution=20)).reshape(-1)
    np.testing.assert_allclose(got.numpy().reshape(-1)[apart], jgrid[apart],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("level", [0.0, 0.13])
def test_marching_tetrahedra_bit_equal(level):
    """tests/test_meshing.py's analytic sphere grid at 32³."""
    lin = np.linspace(-1.2, 1.2, 32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    sdf = np.linalg.norm(g, axis=-1) - 0.8
    lo, hi = np.full(3, -1.2), np.full(3, 1.2)
    want = jm.marching_tetrahedra(sdf, lo, hi, level)
    got = tm.marching_tetrahedra(sdf, lo, hi, level)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)
        assert g_.dtype == w.dtype
    assert len(got[1]) > 1000
    assert tm.marching_tetrahedra(sdf + 5.0, lo, hi)[1].shape == (0, 3)


def test_poisson_indicator_grid_matches_jax(cloud):
    pts, nrm, _ = cloud
    lo, hi = np.full(3, -0.75, np.float32), np.full(3, 0.75, np.float32)
    want = jm.poisson_indicator_grid(pts, nrm, lo, hi, resolution=32)
    got = tm.poisson_indicator_grid(_t(pts), _t(nrm), _t(lo), _t(hi),
                                    resolution=32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def _iso_level(pkg, pts, nrm, r):
    """poisson_mesh_from_points' iso level, as each package computes it."""
    lo = pts.min(0) - 0.15 * (pts.max(0) - pts.min(0)).max()
    hi = pts.max(0) + 0.15 * (pts.max(0) - pts.min(0)).max()
    size, center = (hi - lo).max(), (hi + lo) / 2
    lo, hi = center - size / 2, center + size / 2
    if pkg == "jax":
        chi = jm.poisson_indicator_grid(pts, nrm, lo, hi, resolution=r)
    else:
        chi = tm.poisson_indicator_grid(_t(pts), _t(nrm), lo, hi,
                                        resolution=r).numpy()
    p = (pts - lo) / ((hi - lo) / (r - 1))
    i = np.clip(np.round(p).astype(int), 0, r - 1)
    return float(np.median(chi[i[:, 0], i[:, 1], i[:, 2]]))


def _hold_meshes(got, want, voxel):
    (gv, gf), (wv, wf) = got, want
    assert abs(len(gf) - len(wf)) <= 0.005 * len(wf), (len(gf), len(wf))
    d = max(cKDTree(wv).query(gv)[0].max(), cKDTree(gv).query(wv)[0].max())
    assert d < 1e-3 * voxel, (d, voxel)
    assert gf.min() >= 0 and gf.max() < len(gv)


def test_poisson_mesh_matches_jax(cloud):
    pts, nrm, mask = cloud
    r = 32
    iso_t, iso_j = _iso_level("torch", pts, nrm, r), _iso_level("jax", pts, nrm, r)
    np.testing.assert_allclose(iso_t, iso_j, rtol=1e-9)
    want = jm.poisson_mesh_from_points(pts, nrm, mask, resolution=r)
    got = tm.poisson_mesh_from_points(_t(pts), _t(nrm), _t(mask, torch.bool),
                                      resolution=r)
    span = (pts.max(0) - pts.min(0)).max() * 1.3
    _hold_meshes(got, want, span / (r - 1))
    assert len(got[1]) > 1000


def test_mls_mesh_matches_jax(cloud):
    pts, nrm, mask = cloud
    want = jm.generate_mesh_from_points(pts, nrm, mask, resolution=24)
    got = tm.generate_mesh_from_points(_t(pts), _t(nrm), _t(mask, torch.bool),
                                       resolution=24)
    span = (pts.max(0) - pts.min(0)).max() + 0.2
    _hold_meshes(got, want, span / 23)
    assert len(got[1]) > 500


@pytest.fixture(scope="module")
def model(cloud):
    pts, nrm, mask = cloud
    col = np.random.default_rng(2).uniform(0.2, 0.9, pts.shape).astype(np.float32)
    t_params = PointModelParams.create(pts, nrm * 3.0, col, device=DEV)
    j_params = jpm.PointModelParams.create(jnp.asarray(pts),
                                           jnp.asarray(nrm * 3.0),
                                           jnp.asarray(col))
    m = _t(mask, torch.bool)
    return (t_params, PointFilters(m, m, m), j_params,
            JFilters(*(jnp.asarray(mask),) * 3))


@pytest.mark.parametrize("method,res", [("poisson", 32), ("mls", 24)])
def test_generator_generate_mesh_matches_jax(model, method, res):
    """Poisson runs at max(resolution, 96) in both packages."""
    tp, tf, jp, jf = model
    want = JGenerator(JSettings(image_size=16), mesh_resolution=res,
                      mesh_method=method).generate_mesh(jp, jf)
    got = Generator(RasterSettings(image_size=16), mesh_resolution=res,
                    mesh_method=method).generate_mesh(tp, tf)
    r = 96 if method == "poisson" else res
    span = 1.3 * 1.2 if method == "poisson" else 1.4
    _hold_meshes(got, want, span / (r - 1))


@pytest.mark.parametrize("colormap", [None, "height"])
def test_generate_pointclouds_matches_jax(model, tmp_path, colormap):
    tp, tf, jp, jf = model
    st = RasterSettings(image_size=16)
    JGenerator(JSettings(image_size=16)).generate_pointclouds(
        jp, jf, str(tmp_path / "j.ply"), colormap_by=colormap)
    path = Generator(st).generate_pointclouds(tp, tf, str(tmp_path / "t.ply"),
                                              colormap_by=colormap)
    got, want = j_read_ply(path), j_read_ply(str(tmp_path / "j.ply"))
    for k in ("points", "normals", "colors"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def test_generate_images_matches_jax(model, tmp_path):
    tp, tf, jp, jf = model
    r, t = tcam.look_at_view_transform(dist=torch.full((3,), 2.0),
                                       elev=torch.tensor([0.0, 20.0, -30.0]),
                                       azim=torch.tensor([0.0, 120.0, 240.0]))
    kw = dict(image_size=24, points_per_pixel=5, backend="reference")
    want = JGenerator(JSettings(**kw)).generate_images(
        jp, jf, jcam.FoVPerspectiveCameras.create(jnp.asarray(r.numpy()),
                                                  jnp.asarray(t.numpy())),
        None, str(tmp_path / "j"))
    got = Generator(RasterSettings(**kw)).generate_images(
        tp, tf, tcam.FoVPerspectiveCameras.create(r, t, device=DEV), None,
        str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        gi, wi = read_png(g), imageio.imread(w)
        assert gi.shape == wi.shape == (24, 24, 3)
        assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1
        assert (gi < 250).any()  # the object is drawn over the white
