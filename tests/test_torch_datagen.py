"""Data generation in the port against dss_tpu on the same numpy inputs:
the mesh z-buffer (`render/mesh_raster.py`), the light rigs, and the
create_mvr_data CLI on a mesh and on a faceless point cloud."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.apps import create_mvr_data as jgen
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.render import lighting as jlighting
from dss_tpu.render import mesh_raster as jmesh
from dss_tpu_torch import convert
from dss_tpu_torch.apps import create_mvr_data as tgen
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.render import mesh_raster as tmesh

torch.set_num_threads(2)

DEV = torch.device("cpu")
AXES = np.array([1.0, 0.7, 0.5], np.float32)
TRI_RIG = {"ambient_color": [0.2] * 3,
           "diffuse_color": [[0.0, 0.0, 0.8], [0.0, 0.8, 0.0], [0.8, 0.0, 0.0]],
           "specular_color": [[0.0] * 3] * 3,
           "direction": [[0.5, 0.6, -0.6], [-0.7, 0.3, 0.6], [0.1, -0.9, 0.4]]}


def _mesh(level):
    verts, faces = ico_sphere(level, 0.6)
    return verts * AXES, faces


def _jax_lights(rig):
    """One view's dss_tpu lights from (L, 3) rig arrays."""
    cols = [np.asarray(rig[k], np.float32) for k in
            ("ambient_color", "diffuse_color", "specular_color")]
    if "location" in rig:
        return jlighting.PointLights(*cols, np.asarray(rig["location"],
                                                       np.float32))
    return jlighting.DirectionalLights(*cols, np.asarray(rig["direction"],
                                                         np.float32))


@pytest.mark.parametrize("level,size", [(1, 32), (2, 48)])
def test_mesh_raster_matches_jax(level, size):
    """fid equal except at depth ties (where the two nearest faces lie
    within 1e-6), zbuf at atol 1e-6, bary at atol 1e-5 and the flat-shaded
    rgba at atol 1e-5 where the faces agree."""
    verts, faces = _mesh(level)
    r, t = look_at_view_transform(dist=torch.tensor([1.6, 2.2]),
                                  elev=torch.tensor([20.0, -35.0]),
                                  azim=torch.tensor([30.0, 200.0]))
    lights = convert.lights_from_numpy(TRI_RIG, 1, device=DEV)
    n_hit = 0
    for v in range(2):
        tcam = convert.cameras_from_numpy(
            {"R": r[v:v + 1].numpy(), "T": t[v:v + 1].numpy()}, device=DEV)
        jcam = JCameras.create(r[v:v + 1].numpy(), t[v:v + 1].numpy())
        fid, zbuf, bary = tmesh.rasterize_mesh(
            torch.tensor(verts), torch.tensor(faces), tcam, size)
        jfid, jzbuf, jbary = (np.asarray(x) for x in jmesh.rasterize_mesh(
            jnp.asarray(verts), jnp.asarray(faces), jcam, size))
        fid, zbuf, bary = fid.numpy(), zbuf.numpy(), bary.numpy()
        assert fid.dtype == np.int32 and fid.shape == (size, size)
        np.testing.assert_allclose(zbuf, jzbuf, atol=1e-6)
        same = fid == jfid
        assert np.all(np.abs(zbuf - jzbuf)[~same] <= 1e-6)
        assert np.all((fid >= 0) == (jfid >= 0))
        np.testing.assert_allclose(bary[same], jbary[same], atol=1e-5)
        assert np.all(bary[fid < 0] == 0) and np.all(zbuf[fid < 0] == -1)

        rgba = tmesh.render_mesh_flat(torch.tensor(verts), torch.tensor(faces),
                                      tcam, lights, size).numpy()
        jrgba = np.asarray(jmesh.render_mesh_flat(
            jnp.asarray(verts), jnp.asarray(faces), jcam,
            _jax_lights(TRI_RIG), size))
        np.testing.assert_allclose(rgba[same], jrgba[same], atol=1e-5)
        n_hit += int((fid >= 0).sum())
    assert n_hit > 0


@pytest.mark.parametrize("point_lights", [True, False])
def test_light_rigs_match_jax(point_lights):
    """Both rigs, drawn three times each from the same numpy stream."""
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    cam_pos = np.array([0.3, 1.2, -1.1])
    m44 = np.eye(4, dtype=np.float32)
    m44[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    for _ in range(3):
        for kind, arg in (("tri_color_light_rig", cam_pos),
                          ("random_light_rig", m44)):
            got = getattr(tgen, kind)(arg, trng, point_lights, True)
            want = getattr(jgen, kind)(arg, jrng, point_lights, True)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


ARGS = ["--num-cameras", "4", "--image-size", "32", "--n-points", "300",
        "--seed", "3"]


def _generate(tmp_path, ply, extra=()):
    """Both CLIs on the same PLY; returns (port dir, dss_tpu dir)."""
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    tgen.main(["--mesh", ply, "--out", out_t, *ARGS, *extra,
               "--device", "cpu"])
    jgen.main(["--mesh", ply, "--out", out_j, *ARGS, *extra,
               "--platform", "cpu"])
    return out_t, out_j


def _same_layout(out_t, out_j):
    """The same files, npz keys, dtypes and shapes; the GT cloud bit for
    bit (every numpy draw after the cameras is the same)."""
    for sub in ("image", "mask", "depth"):
        assert (sorted(os.listdir(os.path.join(out_t, sub)))
                == sorted(os.listdir(os.path.join(out_j, sub))))
    for name in ("data_dict.npz", "cameras.npz"):
        with np.load(os.path.join(out_t, name), allow_pickle=True) as t, \
                np.load(os.path.join(out_j, name), allow_pickle=True) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                assert (t[k].dtype, t[k].shape) == (j[k].dtype, j[k].shape), k
                if t[k].dtype == object:
                    a, b = t[k].item(), j[k].item()
                    assert a.keys() == b.keys()
                    if k.startswith("lights_"):
                        assert all(a[x].shape == b[x].shape for x in a)
                    else:
                        assert a == b
            if name == "data_dict.npz":
                for k in ("points", "normals", "colors"):
                    np.testing.assert_array_equal(t[k], j[k])
                for k in ("cameras_type", "lights_type"):
                    assert t[k] == j[k]
    for i in range(4):
        for sub in ("image", "mask"):
            a = read_png(os.path.join(out_t, sub, "%06d.png" % i))
            b = read_png(os.path.join(out_j, sub, "%06d.png" % i))
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


def _depth_checks(out, zfar=100.0):
    for i in range(4):
        depth = np.load(os.path.join(out, "depth", "%06d.npy" % i))
        mask = read_png(os.path.join(out, "mask", "%06d.png" % i)) > 0
        assert depth.dtype == np.float32 and depth.shape == (32, 32)
        assert mask.any() and (~mask).any()
        assert np.all(depth[~mask] == zfar)
        assert np.all((depth[mask] > 0) & (depth[mask] < zfar))


def test_create_mvr_data_mesh_matches_jax(tmp_path):
    """On a mesh with tri-colour lights: dss_tpu's layout, and images and
    depth equal to dss_tpu's render_mesh_flat given the port's cameras and
    lights (images within one level of 255)."""
    verts, faces = _mesh(2)
    ply = str(tmp_path / "mesh.ply")
    save_ply(ply, verts, faces=faces)
    out_t, out_j = _generate(tmp_path, ply, ["--tri-color-lights"])
    _same_layout(out_t, out_j)
    _depth_checks(out_t)

    with np.load(os.path.join(out_t, "data_dict.npz"), allow_pickle=True) as f:
        m44 = f["camera_mat"]
        rigs = [f["lights_%d" % i].item() for i in range(4)]
    v = verts.astype(np.float64)
    v = v - (v.max(0) + v.min(0)) / 2.0
    v = (v / np.linalg.norm(v, axis=-1).max()).astype(np.float32)
    for i in range(4):
        jcam = JCameras.create(m44[i:i + 1, :3, :3], m44[i:i + 1, 3, :3],
                               fov=60.0, znear=0.1, zfar=100.0)
        rgba, zbuf = jmesh.render_mesh_flat(
            jnp.asarray(v), jnp.asarray(faces), jcam,
            _jax_lights({k: x[0] for k, x in rigs[i].items()}), 32,
            return_zbuf=True)
        rgba, zbuf = np.asarray(rgba), np.asarray(zbuf)
        img = read_png(os.path.join(out_t, "image", "%06d.png" % i))
        want = (np.clip(rgba[..., :3], 0, 1) * 255).astype(np.uint8)
        assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
        mask = read_png(os.path.join(out_t, "mask", "%06d.png" % i))
        np.testing.assert_array_equal(mask, (rgba[..., 3] * 255).astype(np.uint8))
        depth = np.load(os.path.join(out_t, "depth", "%06d.npy" % i))
        np.testing.assert_allclose(depth, np.where(zbuf > 0, zbuf, 100.0),
                                   atol=1e-5)


def test_create_mvr_data_cloud_matches_jax(tmp_path):
    """On a faceless PLY (splat-rendered through the fragment path): the
    layout and GT cloud of dss_tpu's CLI, zfar on the background and a
    positive depth inside the mask."""
    verts, faces = _mesh(3)
    pts, normals = sample_points_from_mesh(verts, faces, 500,
                                           rng=np.random.default_rng(1))
    ply = str(tmp_path / "cloud.ply")
    save_ply(ply, pts, normals=normals)
    out_t, out_j = _generate(tmp_path, ply)
    _same_layout(out_t, out_j)
    _depth_checks(out_t)
