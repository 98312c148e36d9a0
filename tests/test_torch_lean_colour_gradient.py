"""The lean path's colour gradient against the port's own
`backend="reference"` at 64² (the flagship's raster, tile 16, the weighted
depth channel, 300 points, 4 views), and what made them part on the
benchmark's data.

On the benchmark's tiny cell the two backends give bit-equal losses and
point gradients, but colour gradients apart by up to 8.5e-5 against a
largest entry of 2.2e-3.  dss_tpu's `pallas` and `reference` backends,
fed the same numpy inputs, part in the same way (8.7e-5).  Neither K3 nor
its window is at fault: the targets are 8-bit images, and in a channel that
no light reaches, a flat-shaded point renders exactly the target's
153/255 = 0.6 (three ambient terms of 0.2).  The two backends round the
weighted mean of such a pixel one ulp apart, so img − pred is +0 on one
side and −6e-8 on the other, and the L1's derivative (the sign) flips: the
loss moves by nothing, the colour gradient by a whole pixel's weight.  Each
backend's colour gradient is the gradient of the forward it computed.

So the tests hold the lean path to the reference backend where no target
sits on a prediction (targets rendered by the port from another cloud, and
checked to be apart), and, on the benchmark's quantised data, under one
shared cotangent, which takes the L1's sign out of the comparison.  The
tolerance is the point gradients': they lie within 1e-7 of their largest
entry here (float32 sums in another order); every gradient is held at
2e-6 of its leaf's largest entry.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import generate
from dss_tpu_torch import convert
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
from dss_tpu_torch.models.point_model import (PointModelParams,
                                               point_model_forward)
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.lighting import PointLights, shade_points
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training import trainer as tt
from dss_tpu_torch.utils.mathutil import normalize

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")
S, T, V, N = 64, 16, 4, 300
RASTER = {**chip_smoke.FLAGSHIP_RASTER, "image_size": S, "tile_size": T}
TRAIN = tt.TrainConfig(**chip_smoke.FLAGSHIP_TRAIN)
SCHED = tt.AnnealSchedule(**chip_smoke.FLAGSHIP_SCHEDULE)
TOL = 2e-6
LIGHTS = {"ambient_color": [0.5] * 3, "diffuse_color": [0.3] * 3,
          "specular_color": [0.2] * 3, "direction": [0.0, 1.0, 0.0]}
NAMES = ("points", "normals", "colors")


def _close(got, want, what):
    scale = float(want.abs().max())
    assert scale > 0, what
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=TOL * scale, err_msg=what)


def _loss_grads(backend, params_np, cams, lights, img, mask, depth, it):
    settings = RasterSettings(**RASTER, backend=backend)
    params = convert.params_from_numpy(params_np, device=DEV)
    total, (parts, _) = tt.make_loss_fn(settings, TRAIN, SCHED)(
        params, PointFilters.ones(params.points.shape[0], device=DEV), cams,
        lights, img, mask, it, depth)
    return total, parts, torch.autograd.grad(total, params.tensors())


@pytest.fixture(scope="module")
def rendered():
    """A model cloud of colour 1 against targets the port renders from an
    ellipsoid of colour 0.6 (no 8-bit steps)."""
    rng = np.random.default_rng(4)
    verts, faces = ico_sphere(3, 0.5)
    pts, nrm = sample_points_from_mesh(verts, faces, N, rng=rng)
    gt, gt_n = sample_points_from_mesh(verts, faces, 1200, rng=rng)
    r, t = look_at_view_transform(
        dist=torch.full((V,), 2.0),
        elev=torch.tensor([0.0, 25.0, -20.0, 40.0]),
        azim=torch.tensor([0.0, 90.0, 200.0, 300.0]))
    cams = convert.cameras_from_numpy({"R": r.numpy(), "T": t.numpy(),
                                       "fov": 60.0}, device=DEV)
    lights = convert.lights_from_numpy(LIGHTS, V, device=DEV)
    with torch.no_grad():
        rgba, fr, _ = render_views(
            torch.tensor(gt * np.array([1.2, 0.9, 1.0], np.float32)),
            torch.tensor(gt_n), torch.full((1200, 3), 0.6),
            torch.ones(1200, dtype=torch.bool), cams, lights,
            RasterSettings(**RASTER))
    mask = rgba[..., 3]
    depth = torch.where(mask > 0.5, fr.wdepth, 100.0)
    params = {"points": pts, "normals": nrm, "colors": np.ones_like(pts)}
    return params, cams, lights, rgba[..., :3].contiguous(), mask, depth


def test_lean_colour_gradient_matches_the_reference_backend(rendered):
    params, cams, lights, img, mask, depth = rendered
    lean = _loss_grads("auto", params, cams, lights, img, mask, depth, 0)
    ref = _loss_grads("reference", params, cams, lights, img, mask, depth, 0)
    # no target sits on a prediction: the L1's sign is decided by more
    # than round-off on both sides
    with torch.no_grad():
        settings = RasterSettings(**RASTER)
        pred, _ = point_model_forward(
            convert.params_from_numpy(params, device=DEV),
            PointFilters.ones(N, device=DEV), cams, lights,
            settings.replace(radii_backward_scaler=torch.tensor(5.0)))
        inter = (mask > 0.5) & (pred["mask_img_pred"] > 0.5)
        assert int(inter.sum()) > 1000
        assert float((img - pred["img_pred"]).abs()[inter].min()) > 1e-5
    np.testing.assert_allclose(float(lean[0].detach()),
                               float(ref[0].detach()), rtol=1e-6)
    for name, got, want in zip(NAMES, lean[2], ref[2]):
        _close(got, want, name)


def _benchmark_data():
    """The benchmark's tiny cell's data: 8-bit targets of a seeded
    ellipsoid under three coloured point lights, the start sphere."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "dss_depth.json")
                     .read_text())
    cfg["renderer"]["raster_params"].update(image_size=S, tile_size=T)
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = N
    ds = json.loads((ROOT / "benchmark" / "datasets" / "mvr128.json")
                    .read_text())
    return generate.make(cfg, {**ds, "n_views": 16}, 2 ** 31 + 12345, DEV, 1)


def test_quantised_targets_part_the_backends_only_through_the_l1_sign():
    """On 8-bit targets the colour gradients of the two backends part where
    a target equals a flat-shaded prediction to the last bits; under one
    cotangent (the lean loss's gradient of the rendered image, pushed
    through each backend's render to the shaded colours) they agree."""
    d = _benchmark_data()
    v = torch.arange(4)
    lv = d["leaves"]
    cams = convert.cameras_from_numpy(
        {"R": d["R"][v].numpy(), "T": d["T"][v].numpy(), "fov": d["fov"],
         "znear": d["znear"], "zfar": d["zfar"]}, device=DEV)
    lights = PointLights.create(n_views=4, device=DEV,
                                **{k: x[v] for k, x in d["lights"].items()})
    img, mask = d["img"][v], d["mask"][v]

    def render(backend, colors_leaf):
        settings = RasterSettings(**RASTER, backend=backend).replace(
            radii_backward_scaler=torch.tensor(1.0))
        params = PointModelParams.create(lv["points"], lv["normals"],
                                         lv["colors"], device=DEV)
        out, _ = point_model_forward(
            params, PointFilters.ones(N, device=DEV), cams, lights, settings,
            texture_fn=lambda p, n, c: colors_leaf)
        return out["img_pred"]

    with torch.no_grad():
        base = shade_points(lv["points"], normalize(lv["normals"]),
                            lv["colors"], lights, cams.camera_position(),
                            64.0)
    leaf = {b: base.clone().requires_grad_(True) for b in ("auto", "reference")}
    pred = {b: render(b, leaf[b]) for b in leaf}
    inter = (mask > 0.5)[..., None]
    # the predictions agree to round-off
    np.testing.assert_allclose(pred["auto"].detach().numpy(),
                               pred["reference"].detach().numpy(), atol=1e-6)
    # the L1's own gradients part, at targets the predictions meet exactly
    g_l1 = {b: torch.autograd.grad(
        torch.sum(torch.abs(img - pred[b]) * inter), leaf[b],
        retain_graph=True)[0] for b in leaf}
    sign = {b: torch.where(img - pred[b] >= 0, 1.0, -1.0) for b in pred}
    flips = (sign["auto"] != sign["reference"]) & inter
    assert int(flips.sum()) > 0
    assert float(img[flips.expand_as(img)].sub(0.6).abs().max()) < 1e-6
    assert not torch.allclose(g_l1["auto"], g_l1["reference"], atol=1e-7)
    # one shared cotangent: the same gradient of the shaded colours
    cot = -sign["auto"] * inter
    vjp = {b: torch.autograd.grad(pred[b], leaf[b], cot)[0] for b in leaf}
    _close(vjp["auto"], vjp["reference"], "shaded colours")
