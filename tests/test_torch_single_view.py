"""The port's single-view entry point, its bench harness and its turntable
against dss_tpu on the same numpy inputs: `render_single_view` on the lean
and fragment tile-binned paths (dss_tpu's Pallas kernels in interpret mode)
and on the reference rasterizer, the harness's loss and gradients against
the same composition in dss_tpu, and the turntable's first frame against
dss_tpu's reference render."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.render import ewa as jewa
from dss_tpu.render.lighting import DirectionalLights as JLights
from dss_tpu.render.renderer import render_single_view as j_render_single_view
from dss_tpu.render.renderer import render_views as j_render_views
from dss_tpu_torch import convert
from dss_tpu_torch.apps import bench, render_turntable
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render import render_single_view, render_views
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = torch.device("cpu")
S, T, N = 32, 16, 300
KW = dict(image_size=S, points_per_pixel=5, backface_culling=True,
          tile_size=T, Vrk_invariant=True, Vrk_isotropic=False,
          depth_channel=True)
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}
# path → (JAX backend, lean_fragments)
PATHS = {"lean": ("pallas", True), "fragment": ("pallas", False),
         "reference": ("reference", True)}


@pytest.fixture(scope="module")
def inputs():
    pts = fibonacci_sphere(N, 0.5)
    r, t = look_at_view_transform(dist=2.0, elev=25.0, azim=80.0)
    rng = np.random.default_rng(3)
    return dict(pts=pts,
                nrm=pts / np.linalg.norm(pts, axis=-1, keepdims=True),
                cols=rng.uniform(0.2, 0.9, (N, 3)).astype(np.float32),
                cams={"R": r.numpy(), "T": t.numpy(), "fov": 60.0})


def _port_settings(path):
    backend, lean = PATHS[path]
    return tewa.RasterSettings(backend=backend, lean_fragments=lean, **KW)


def _port_render(d, path):
    return render_single_view(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.tensor(d["cols"]),
        torch.ones(N, dtype=torch.bool),
        convert.cameras_from_numpy(d["cams"], device=DEV),
        convert.lights_from_numpy(LIGHTS, 1, device=DEV), _port_settings(path))


@pytest.mark.parametrize("path", list(PATHS))
def test_render_single_view_matches_jax(inputs, path):
    d = inputs
    backend, lean = PATHS[path]
    jst = jewa.RasterSettings(backend=backend, lean_fragments=lean, **KW)
    jcam = JCameras.create(d["cams"]["R"], d["cams"]["T"], fov=60.0)
    jrgba, jfr, jvis = j_render_single_view(
        jnp.asarray(d["pts"]), jnp.asarray(d["nrm"]), jnp.asarray(d["cols"]),
        jnp.ones((N,), bool), jcam, JLights.create(**LIGHTS), jst)
    rgba, fr, vis = _port_render(d, path)

    assert rgba.shape == (S, S, 4) and vis.shape == (N,)
    np.testing.assert_allclose(rgba.numpy(), np.asarray(jrgba), atol=1e-5)
    np.testing.assert_allclose(fr.wdepth.numpy(), np.asarray(jfr.wdepth),
                               atol=1e-5)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    if path != "lean":
        np.testing.assert_array_equal(fr.idx.numpy(), np.asarray(jfr.idx))
        np.testing.assert_allclose(fr.zbuf.numpy(), np.asarray(jfr.zbuf),
                                   atol=1e-5)
    assert int(fr.overflow) == 0 and int(vis.sum()) > 0


@pytest.mark.parametrize("path", ["lean", "fragment"])
def test_single_view_is_the_first_of_render_views(inputs, path):
    d = inputs
    rgba, fr, vis = _port_render(d, path)
    want = render_views(
        torch.tensor(d["pts"]), torch.tensor(d["nrm"]), torch.tensor(d["cols"]),
        torch.ones(N, dtype=torch.bool),
        convert.cameras_from_numpy(d["cams"], device=DEV),
        convert.lights_from_numpy(LIGHTS, 1, device=DEV), _port_settings(path))
    assert torch.equal(rgba, want[0][0]) and torch.equal(vis, want[2][0])
    assert torch.equal(fr.idx, want[1].idx[0])
    assert torch.equal(fr.wdepth, want[1].wdepth[0])


def test_texture_fn_raises(inputs):
    """A texture gives (V, P, 3) colours for all views at once; one that
    gives dss_tpu's per-view (P, 3) is refused."""
    d = inputs
    with pytest.raises(ValueError, match=r"\(V, P, 3\)"):
        render_single_view(
            torch.tensor(d["pts"]), torch.tensor(d["nrm"]),
            torch.tensor(d["cols"]), torch.ones(N, dtype=torch.bool),
            convert.cameras_from_numpy(d["cams"], device=DEV), None,
            _port_settings("lean"), texture_fn=lambda p, n, c: p)


BENCH_SHAPE = dict(n_points=200, n_views=2, image_size=32)


def test_bench_prints_one_json_line(capsys):
    bench.main(["--points", "200", "--views", "2", "--image-size", "32",
                "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "msplats_per_sec_fwd_bwd_512"
    assert rec["unit"] == "Msplats/s" and np.isfinite(rec["value"])
    assert rec["value"] > 0 and rec["vs_baseline"] == rec["value"]


def test_bench_loss_and_grads_match_jax():
    """The harness's forward + backward against dss_tpu's render_views and
    the same L1 against zero targets (bench.py's loss), on the harness's
    own inputs, with vrk_h from compute_vrk_h_global in the loss."""
    inp = bench.build_inputs(device=DEV, **BENCH_SHAPE)
    loss, grads = bench.grad_step(inp, inp["points"], inp["normals"],
                                  inp["colors"])

    st = jewa.RasterSettings(
        image_size=32, points_per_pixel=5, cutoff_threshold=1.0,
        Vrk_invariant=True, Vrk_isotropic=False, backface_culling=True,
        backend="pallas")
    cams = inp["cameras"]
    jcams = JCameras.create(cams.R.numpy(), cams.T.numpy(), fov=60.0)
    mask = jnp.ones((200,), bool)

    def jloss(p, n, c):
        vrk_h = jewa.compute_vrk_h_global(p, mask)
        rgba, _, _ = j_render_views(p, n, c, mask, jcams, None, st,
                                    vrk_h=vrk_h)
        return jnp.mean(jnp.abs(rgba[..., :3])) + jnp.mean(
            jnp.abs(rgba[..., 3]))

    args = [jnp.asarray(inp[k].numpy()) for k in ("points", "normals",
                                                  "colors")]
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, g, w in zip(("points", "normals", "colors"), grads, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
    assert np.abs(np.asarray(jg[0])).max() > 0


def test_turntable_writes_frames_matching_jax(inputs, tmp_path):
    """N frames at 32²; frame 0 equals dss_tpu's reference render of the
    same centred cloud, camera and light within one level of 255."""
    d = inputs
    pts = d["pts"] * np.float32(0.8) + np.float32(0.1)
    ply = str(tmp_path / "cloud.ply")
    save_ply(ply, pts, normals=d["nrm"])
    out = str(tmp_path / "turn")
    render_turntable.main(["--points", ply, "--out", out, "--num-frames", "3",
                           "--image-size", "32", "--device", "cpu"])
    frames = sorted(os.listdir(out))
    assert frames == ["frame_000.png", "frame_001.png", "frame_002.png"]
    got = read_png(os.path.join(out, frames[0]))
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8

    jp = jnp.asarray(pts)
    jp = jp - (jp.max(0) + jp.min(0)) / 2.0
    jp = jp / jnp.linalg.norm(jp, axis=-1).max()
    r, t = look_at_view_transform(dist=2.0, elev=15.0, azim=0.0)
    rgba, _, _ = j_render_single_view(
        jp, jnp.asarray(d["nrm"]), jnp.full_like(jp, 0.75),
        jnp.ones((N,), bool), JCameras.create(r.numpy(), t.numpy(), fov=60.0),
        JLights.create(direction=(0.3, 1.0, -0.5)),
        jewa.RasterSettings(image_size=32, points_per_pixel=5,
                            Vrk_isotropic=True, backface_culling=True,
                            backend="reference"))
    rgba = np.asarray(rgba)
    alpha = rgba[..., 3:4]
    want = (255 * (np.clip(rgba[..., :3], 0, 1) * alpha + (1 - alpha))
            ).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[alpha[..., 0] == 0] == 255).all() and (alpha == 0).any()
