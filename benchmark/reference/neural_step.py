"""The plain reference of one train step of DSS with its neural texture, in
float32 PyTorch.

Upstream DSS switches its shading from `LightingTexture` to `NeuralTexture`
with `renderer.is_neural_texture` (DSS config.py:154-170,
DSS/core/texture.py:130-162): each point's colour in each view is a decoder
MLP over (normal, point, encoded unit view direction).  The decoder is
IDR's rendering network (DSS/models/common.py:315-368; Yariv et al.,
"Multiview Neural Surface Reconstruction by Disentangling Geometry and
Appearance", NeurIPS 2020, confs/dtu_fixed_cameras.conf,
`rendering_network`): weight-normed linear layers, ReLU between them, tanh
on the last, scaled to [0, 1].  Its input is the normal (3), the point (3)
and the NeRF encoding of the view direction: the direction, then per
frequency 2^0 .. 2^(n-1) the sine and the cosine of each component (27 at
4 frequencies); 33 in all.

Everything else of the step (the EWA set-up, the banded brute-force
rasterizer with the hand-defined DSS backward, the losses, the annealed
support, Adam in optax's order) is `dss_step.py`'s, loaded by path from
beside this file and reused, not copied: only the render's shading and the
trainer's leaves change.  The decoder's weights are leaves beside points,
normals and colours, in the order v, g, bias of each layer, first to last,
trained by the same Adam at their own learning rate.

Departures from upstream, besides dss_step.py's own:
- the weight norm is written out per output unit, w = v / max(|v|, 1e-12)
  * g, where torch's weight_norm divides by |v| without a floor;
- the view direction is the point less the camera's position over
  max(its norm, 1e-12), as torch's F.normalize takes it;
- the decoder's weights are given (the benchmark draws them from the
  seed), not IDR's initialisation;
- colours are computed for every (view, point) pair at once, not for the
  packed points of each view, which gives the same values.

TF32 is off unless the caller turns it on (the benchmark's control does).
It imports nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path

import torch


def _load(path: Path):
    """A module of a file, kept in sys.modules under a name made from its
    path (a dataclass needs its module there), once per process."""
    path = Path(path).resolve()
    name = (f"benchmark_{path.stem.replace('.', '_')}_"
            f"{hashlib.sha1(str(path).encode()).hexdigest()[:12]}")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


D = _load(Path(__file__).resolve().parent / "dss_step.py")

# What the benchmark's work counts and adapters read of a reference module.
Raster, Recipe, Cameras, PointLights = D.Raster, D.Recipe, D.Cameras, D.PointLights
normalize, prepare_splats, rasterize_rows = (D.normalize, D.prepare_splats,
                                             D.rasterize_rows)
visible_points, support_radius2 = D.visible_points, D.support_radius2
backward_scaler = D.backward_scaler
vrk_h_global, vrk_h_isotropic = D.vrk_h_global, D.vrk_h_isotropic

# The leaves of one weight-normed layer, in order.
LAYER_LEAVES = ("v", "g", "bias")


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF's Embedder: x, then per frequency 2^i, sin of each component,
    then cos of each component."""
    out = [x]
    for i in range(n_freqs):
        out += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(out, dim=-1)


def texture_features(points, normals, cams: Cameras, view_dependent: bool,
                     view_freqs: int) -> torch.Tensor:
    """(V, P, F) decoder input: normal, point [, encoded unit view
    direction from the view's camera to the point]."""
    v = cams.R.shape[0]
    shape = (v,) + points.shape
    feats = [torch.broadcast_to(normals, shape), torch.broadcast_to(points, shape)]
    if view_dependent:
        d = points[None] - cams.position()[:, None, :]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                            min=1e-12)
        feats.append(encode(d, view_freqs))
    return torch.cat(feats, dim=-1)


def decode(x: torch.Tensor, layers) -> torch.Tensor:
    """IDR's rendering network over rows x (..., F): `layers` a list of
    (v (out, in), g (out,), bias (out,)); ReLU after each but the last,
    tanh after the last, scaled to [0, 1]."""
    h = x
    for i, (v, g, b) in enumerate(layers):
        w = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                            min=1e-12) * g[:, None]
        h = h @ w.T + b
        h = torch.relu(h) if i < len(layers) - 1 else torch.tanh(h)
    return h / 2.0 + 0.5


def render(points, normals, shaded, mask, cams: Cameras, raster: Raster,
           vrk_h, scaler):
    """dss_step.render with the shading given: shaded (V, P, 3) colours
    of the points in each view.  Returns (rgba (V, S, S, 4), depth
    (V, S, S), visible (V, P))."""
    spl = D.prepare_splats(points, normals, mask, cams, raster, vrk_h)
    pts_screen = spl.pts_screen
    if raster.clip_pts_grad > 0:
        pts_screen = D._ClipGradNorm.apply(pts_screen, raster.clip_pts_grad)
    s, k = raster.image_size, raster.points_per_pixel
    idx, zbuf, qvalue, occ = D._Rasterize.apply(
        pts_screen, spl.ellipse, spl.cutoff, spl.radii, s, k,
        raster.depth_merging_threshold, scaler)
    w = torch.where(idx >= 0, torch.exp(-0.5 * qvalue)
                    * D._frag_scaler(spl.scaler, idx), 0.0)
    v = idx.shape[0]
    safe = torch.clamp(idx, min=0).to(torch.int64)
    feat = shaded[torch.arange(v, device=idx.device)[:, None, None, None], safe]
    total = torch.sum(w, dim=-1, keepdim=True)
    rgb = (torch.einsum("...k,...kc->...c", w, feat)
           / torch.clamp(total, min=1e-10))
    rgba = torch.cat([rgb, occ[..., None]], dim=-1)
    if raster.depth_from_fragments:
        depth = zbuf[..., 0]
    else:
        wsum = torch.sum(w, dim=-1)
        depth = torch.where(wsum > 0.0,
                            torch.sum(w * zbuf, dim=-1)
                            / torch.clamp(wsum, min=1e-10), -1.0)
    return rgba, depth, visible_points(idx, points.shape[0])


class NeuralTrainer(D.ReferenceTrainer):
    """dss_step's trainer with the decoder's leaves after points, normals
    and colours (`decoder`: a flat list of v, g, bias per layer), the
    texture in place of the lights' shading, and the recipe's `lr` one per
    leaf.  Colours are a leaf the render does not read."""

    def __init__(self, raster: Raster, recipe: Recipe, points, normals,
                 colors, decoder, activation, step: int, moments=None,
                 count: int = 0, view_dependent: bool = True,
                 view_freqs: int = 4):
        super().__init__(raster, recipe, points, normals, colors, activation,
                         step, None, count)
        self.params += [t.detach().clone() for t in decoder]
        if len(self.params) % 3 or len(recipe.lr) != len(self.params):
            raise ValueError("the decoder's leaves come as v, g, bias per "
                             "layer, and the recipe gives one lr per leaf")
        if moments is None:
            moments = [(torch.zeros_like(t), torch.zeros_like(t))
                       for t in self.params]
        self.mu = [m.clone() for m, _ in moments]
        self.nu = [v.clone() for _, v in moments]
        self.view_dependent = view_dependent
        self.view_freqs = view_freqs

    def loss(self, params, cams: Cameras, lights: PointLights, img, mask_img,
             depth_img):
        """(total, parts) of the step's loss, and the new filters; as
        dss_step's, with the decoder's colours."""
        raster, rc = self.raster, self.recipe
        points, normals_raw = params[0], params[1]
        layers = [tuple(params[i:i + 3]) for i in range(3, len(params), 3)]
        normals = D.normalize(normals_raw)
        active = self.activation
        vrk_h = None
        if raster.Vrk_invariant:
            vrk_h = D.vrk_h_global(points.detach(), active)
        elif raster.Vrk_isotropic:
            vrk_h = D.vrk_h_isotropic(points.detach(), active)
        scaler = D.backward_scaler(rc, self.step, points.device)
        shaded = decode(texture_features(points, normals, cams,
                                         self.view_dependent,
                                         self.view_freqs), layers)
        rgba, depth, visible = render(points, normals, shaded, active, cams,
                                      raster, vrk_h, scaler)
        visibility = torch.any(visible, dim=0) & active
        with torch.no_grad():
            inmask = torch.any(
                D.sample_at_points(cams, points, mask_img) > 0.5,
                dim=0) & visibility
        l_rgb, l_sil = D.dr_loss(img, rgba[..., :3], mask_img, rgba[..., 3],
                                 rc.lambda_rgb, rc.lambda_silhouette)
        parts = {"loss_dr_rgb": l_rgb, "loss_dr_silhouette": l_sil}
        total = l_rgb + l_sil
        if rc.lambda_depth > 0:
            parts["loss_dr_depth"] = (D.depth_l1(depth_img, depth, mask_img)
                                      * rc.lambda_depth)
            total = total + parts["loss_dr_depth"]
        if rc.lambda_proj > 0 or rc.lambda_repel > 0:
            reliable = visibility & inmask
            knn = D.build_knn(points.detach(), active, rc.knn_k)
            if rc.lambda_proj > 0:
                parts["loss_dr_proj"] = D.projection_loss(
                    points, normals, active, visibility, reliable, knn,
                    rc.sharpness_sigma) * rc.lambda_proj
                total = total + parts["loss_dr_proj"]
            if rc.lambda_repel > 0:
                parts["loss_dr_repel"] = D.repulsion_loss(
                    points, normals, active, reliable, knn, rc.filter_scale,
                    rc.sharpness_sigma) * rc.lambda_repel
                total = total + parts["loss_dr_repel"]
        return total, parts, visibility, inmask
