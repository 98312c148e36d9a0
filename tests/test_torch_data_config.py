"""Configs, PNGs and datasets of dss_tpu_torch against dss_tpu and the
libraries dss_tpu uses (PyYAML, imageio), on the CPU at small sizes: 16²
images, 4 views, a few hundred points."""
import glob
import os
import struct
import zlib

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dss_tpu.config as jconfig
import dss_tpu.training.trainer as jtrainer
from dss_tpu.data import dataset as jdataset
from dss_tpu_torch import config as tconfig
from dss_tpu_torch.data import dataset as tdataset
from dss_tpu_torch.data import png
from dss_tpu_torch.utils import yaml_lite

torch.set_num_threads(2)

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "configs", "*.y*ml")))


# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_lite_reads_each_config_as_pyyaml_does(path):
    with open(os.path.join(ROOT, path)) as f:
        want = yaml.safe_load(f)
    assert yaml_lite.load(os.path.join(ROOT, path)) == want


def test_yaml_lite_resolves_scalars_as_pyyaml_does():
    """YAML 1.1's implicit types: a float needs a dot (1e-3 is a string),
    leading zeros are octal, `yes`/`on` are booleans, `:` is base 60."""
    for s in ["1e-3", "1.0e-3", "1.e3", "+1", "-0x1F", "0b101", "010",
              "1:30", "1_000", ".5", "-.inf", "~", "Yes", "OFF", "on",
              "1:30.5", "3.", "foo bar", "'q'", '"a\\nb"', "-1", "0",
              "[a, [b, 1], {d: 2.5}]", "{}", "[]", "/abs/path.yml",
              "a#b", "x # comment", "'it''s'", "null", "Null", "'null'"]:
        text = f"k: {s}\n"
        got, want = yaml_lite.loads(text)["k"], yaml.safe_load(text)["k"]
        assert got == want and type(got) is type(want), (s, got, want)
    assert np.isnan(yaml_lite.loads("k: .nan")["k"])


def test_yaml_lite_writer_round_trips_through_pyyaml():
    """Every string that would read back as another type is quoted; floats
    keep a dot; nested dicts, empty dicts and lists survive."""
    data = {
        "a": {"b": [1, 2.5, "x y", None, True], "c": {}, "d": []},
        "strings": ["a, b", "it's", "x]", "{"],
        "e": "1e-3", "f": "yes", "g": "0755", "h": "/tmp/a b", "i": 1e-5,
        "j": float("inf"), "k": "it's", "l": "a: b", "m": "#x", "n": "",
        "o": "12:30", "p": "x #y", "q": "tab\there", "s": -0.0,
        "t": "null", "u": "-", "v": "- a", "w": 2**70, "y": "[x]",
        "z": "true ", "2001-01-01": "k", "nested": [[1, 2], {"z": [3, 4]}],
    }
    text = yaml_lite.dumps(data)
    assert yaml.safe_load(text) == data
    assert yaml_lite.loads(text) == data
    # and PyYAML's own block style reads back through yaml_lite
    flat = {k: v for k, v in data.items() if k != "nested"}
    assert yaml_lite.loads(yaml.safe_dump(flat)) == flat


@pytest.mark.parametrize("text", ["k: &a 1\n", "k: !!str 1\n", "k: |\n  x\n",
                                  "k: 2001-12-14\n", "---\nk: 1\n",
                                  "k: a\n  b\n"])
def test_yaml_lite_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="yaml_lite"):
        yaml_lite.loads(text)


# ---------------------------------------------------------------------------
# Configs and factories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_dss_tpu(path):
    full = os.path.join(ROOT, path)
    assert tconfig.load_config(full) == jconfig.load_config(full)


def test_save_config_round_trips(tmp_path):
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "dss_depth.yml"))
    del cfg["inherit_from"]  # relative to configs/
    tconfig.save_config(cfg, str(tmp_path / "c.yaml"))
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == cfg
    assert tconfig.load_config(str(tmp_path / "c.yaml")) == cfg


@pytest.mark.parametrize("path", CONFIGS)
def test_factories_match_dss_tpu(path, monkeypatch):
    """Raster settings, train config, schedule and optimizer groups, field
    for field, as the factories build them from each config (every one
    trains in the port: the invariant, isotropic and anisotropic Vrk, with
    and without the normal loss)."""
    full = os.path.join(ROOT, path)
    cfg = jconfig.load_config(full)
    js, ts = jconfig.create_raster_settings(cfg), tconfig.create_raster_settings(cfg)
    for f in ts.__dataclass_fields__:
        assert getattr(ts, f) == getattr(js, f), f
    jt, tt = jconfig.create_train_config(cfg), tconfig.create_train_config(cfg)
    assert set(tt._fields) == set(jt._fields)
    for f in tt._fields:
        assert getattr(tt, f) == getattr(jt, f), f
    jsch, tsch = (jconfig.create_anneal_schedule(cfg),
                  tconfig.create_anneal_schedule(cfg))
    for f in tsch.__dataclass_fields__:
        assert getattr(tsch, f) == getattr(jsch, f), f

    got = {}
    monkeypatch.setattr(jtrainer, "make_optimizer",
                        lambda **kw: got.update(kw))
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 50
    params, learn = tconfig.create_model_params(cfg, device=DEV)
    jconfig.create_optimizer(cfg, learn, steps_per_epoch=7)
    opt = tconfig.create_optimizer(cfg, params, learn, steps_per_epoch=7)
    assert [g["name"] for g in opt.param_groups] == list(params.names())
    for group in opt.param_groups:
        # the JAX package's optimizer has no neural-texture groups
        want = (float(cfg["training"]["lr_texture"])
                if group["name"].startswith("texture.")
                else got["lr_" + group["name"]])
        assert group["lr"] == group["base_lr"] == want
        assert group["milestones"] == got["milestones"]
        assert group["gamma"] == got["gamma"]


def test_factory_defaults_are_the_factories_not_the_classes():
    """A config that omits them gets config.py's defaults: no backface
    culling, isotropic Vrk."""
    cfg = tconfig.load_config(None)
    del cfg["renderer"]["raster_params"]["backface_culling"]
    del cfg["renderer"]["raster_params"]["Vrk_isotropic"]
    st = tconfig.create_raster_settings(cfg)
    assert st.backface_culling is False and st.Vrk_isotropic is True


def test_model_params_match_dss_tpu():
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "dss.yml"))
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 300
    jp, jl = jconfig.create_model_params(cfg, np.random.default_rng(3))
    tp, tl = tconfig.create_model_params(cfg, np.random.default_rng(3), device=DEV)
    assert jl == tl
    for k in ("points", "normals", "colors"):
        np.testing.assert_array_equal(getattr(tp, k).detach().numpy(),
                                      np.asarray(getattr(jp, k)))


def test_tiled_io_is_refused():
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "dss.yml"))
    cfg["renderer"]["raster_params"]["tiled_io"] = True
    with pytest.raises(ValueError, match="tiled_io"):
        tconfig.create_raster_settings(cfg)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _image(shape, kind, seed=0):
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    base = 128 + 100 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
    c = shape[2] if len(shape) == 3 else 1
    img = base[..., None] + 25 * np.arange(c)
    return np.clip(img, 0, 255).astype(np.uint8).reshape(shape)


SHAPES = {"gray": (16, 16), "rgb": (16, 16, 3), "rgba": (16, 16, 4),
          "rgb 23x37": (23, 37, 3)}


def _filters(path):
    with open(path, "rb") as f:
        return set(png._parse(f.read())[3][:, 0].tolist())


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("mode", list(SHAPES))
def test_png_decodes_imageio_files_exactly(mode, kind, tmp_path):
    img = _image(SHAPES[mode], kind)
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    got = png.read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)


def test_imageio_files_use_the_sub_and_paeth_filters(tmp_path):
    """The files above exercise filters 1 (Sub) and 4 (Paeth): imageio's
    writer picks filters per row."""
    seen = set()
    for i, (mode, kind) in enumerate((m, k) for m in SHAPES
                                     for k in ("random", "smooth")):
        path = str(tmp_path / f"{i}.png")
        imageio.imwrite(path, _image(SHAPES[mode], kind))
        seen |= _filters(path)
    assert {1, 4} <= seen, seen


def _write_average_png(path, img):
    """A PNG whose every row uses filter 3 (Average), filtered here by the
    specification's per-byte rule."""
    h, w, c = img.shape
    x = img.astype(np.int64)
    rows = []
    for y in range(h):
        out = [3]
        for i in range(w * c):
            left = x[y].reshape(-1)[i - c] if i >= c else 0
            up = x[y - 1].reshape(-1)[i] if y > 0 else 0
            out.append((int(x[y].reshape(-1)[i]) - (left + up) // 2) % 256)
        rows.append(bytes(out))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_the_average_filter(channels, tmp_path):
    img = _image((16, 16, channels), "random", seed=channels)
    path = str(tmp_path / "avg.png")
    _write_average_png(path, img)
    assert _filters(path) == {3}
    want = imageio.imread(path)
    np.testing.assert_array_equal(want.reshape(img.shape), img)
    np.testing.assert_array_equal(png.read_png(path), want)


@pytest.mark.parametrize("mode", list(SHAPES))
def test_png_written_files_decode_identically_with_imageio(mode, tmp_path):
    img = _image(SHAPES[mode], "random", seed=7)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    assert _filters(path) == {0}
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_batches_mixed_sizes_and_refuses_16_bit(tmp_path):
    paths = []
    for i, mode in enumerate(["rgb", "gray", "rgb 23x37", "rgb"]):
        paths.append(str(tmp_path / f"{i}.png"))
        imageio.imwrite(paths[-1], _image(SHAPES[mode], "random", seed=i))
    for got, p in zip(png.read_pngs(paths), paths):
        np.testing.assert_array_equal(got, imageio.imread(p))
    deep = str(tmp_path / "deep.png")
    imageio.imwrite(deep, (np.arange(256, dtype=np.uint16) * 257).reshape(16, 16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(deep)


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

V, S = 4, 16


def _write_dataset(root, lights):
    """A dataset written with numpy and imageio: random images, masks from
    thresholded noise, dense depth, per-view lights, cameras and a GT
    cloud."""
    rng = np.random.default_rng(5)
    for sub in ("image", "mask", "depth"):
        os.makedirs(os.path.join(root, sub))
    for i in range(V):
        imageio.imwrite(os.path.join(root, "image", f"{i:03d}.png"),
                        rng.integers(0, 256, (S, S, 3), np.uint8))
        imageio.imwrite(os.path.join(root, "mask", f"{i:03d}.png"),
                        rng.integers(0, 256, (S, S), np.uint8))
        np.save(os.path.join(root, "depth", f"{i:03d}.npy"),
                rng.uniform(1.0, 3.0, (S, S)).astype(np.float32))
    # orthonormal R from QR, T in front of the camera
    q = np.linalg.qr(rng.standard_normal((V, 3, 3)))[0].astype(np.float32)
    m44 = np.zeros((V, 4, 4), np.float32)
    m44[:, :3, :3] = q
    m44[:, 3, :3] = rng.uniform(-0.2, 0.2, (V, 3))
    m44[:, 3, 2] = 2.5
    m44[:, 3, 3] = 1.0
    geo = "direction" if lights == "DirectionalLights" else "location"
    np.savez(
        os.path.join(root, "data_dict.npz"),
        camera_mat=m44,
        points=rng.standard_normal((300, 3)).astype(np.float32),
        normals=rng.standard_normal((300, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (300, 3)).astype(np.float32),
        cameras_type="FoVPerspectiveCameras",
        cameras_params={"fov": 50.0, "znear": 0.5, "zfar": 20.0},
        lights_type=lights,
        **{f"lights_{i}": {
            "ambient_color": rng.uniform(0, 1, (1, 2, 3)).astype(np.float32),
            "diffuse_color": rng.uniform(0, 1, (1, 2, 3)).astype(np.float32),
            "specular_color": rng.uniform(0, 1, (1, 2, 3)).astype(np.float32),
            geo: rng.standard_normal((1, 2, 3)).astype(np.float32)}
           for i in range(V)},
    )
    # DTU's cameras: camera_mat = scale.T @ world.T
    scale = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
    np.savez(os.path.join(root, "cameras.npz"),
             **{f"world_mat_{i}": m44[i].T for i in range(V)},
             **{f"scale_mat_{i}": scale for i in range(V)})


@pytest.mark.parametrize("kind", ["MVR", "DTU"])
@pytest.mark.parametrize("lights", ["DirectionalLights", "PointLights"])
def test_dataset_matches_dss_tpu(kind, lights, tmp_path):
    root = str(tmp_path / "ds")
    _write_dataset(root, lights)
    cls = "MVRDataset" if kind == "MVR" else "DTUDataset"
    # imageio path: the port has no counterpart of the native loader
    jds = getattr(jdataset, cls)(root, load_dense_depth=True,
                                 use_native_loader=False)
    tds = getattr(tdataset, cls)(root, load_dense_depth=True)
    assert len(tds) == len(jds) == V and tds.resolution == jds.resolution
    for name in ("images", "masks", "depths", "camera_mat", "points",
                 "normals", "colors"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name),
                                      err_msg=name)
    assert 0 < tds.masks.mean() < 1
    idx = [3, 1]
    jb, tb = jds.get_batch(idx), tds.get_batch(idx, device=DEV)
    np.testing.assert_array_equal(tb[0], jb[0])
    np.testing.assert_array_equal(tb[1], jb[1])
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tb[2].transform_points_screen(torch.tensor(pts)).numpy(),
        np.asarray(jb[2].transform_points_screen(jnp.asarray(pts))), atol=1e-5)
    for f in ("fov", "znear", "zfar", "aspect_ratio"):
        np.testing.assert_array_equal(getattr(tb[2], f).numpy(),
                                      np.asarray(getattr(jb[2], f)))
    assert type(tb[3]).__name__ == type(jb[3]).__name__ == lights
    for f in tb[3].__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tb[3], f).numpy(),
                                      np.asarray(getattr(jb[3], f)), err_msg=f)


def test_dataset_refuses_formats_without_a_codec(tmp_path):
    with pytest.raises(ValueError, match="no jpg decoder"):
        tdataset.MVRDataset(str(tmp_path), img_extension="jpg")


@pytest.mark.parametrize("views,batch,weighted", [
    (10, 4, False), (10, 2, True), (3, 8, False), (3, 8, True)])
def test_view_sampler_gives_dss_tpu_batches(views, batch, weighted):
    """The same seed gives the same epochs: uniform permutations, weighted
    draws with replacement, and the one with-replacement batch of the
    degenerate views < batch case."""
    w = np.arange(1.0, views + 1) if weighted else None
    js = jdataset.ViewSampler(views, batch, seed=11, weights=w)
    ts = tdataset.ViewSampler(views, batch, seed=11, weights=w)
    for _ in range(3):
        np.testing.assert_array_equal(ts.epoch_batches(), js.epoch_batches())
