"""The plain reference of one train step over S independent scenes of the
point model, in float32 PyTorch: the step that the program's stacked
multi-scene loss (`make_stacked_loss_fn`: one folded render of the S·V
views, each scene's loss terms as a single scene's, their mean) takes.

It holds S trainers of `dss_step.py` (loaded by path from beside this file
through the harness's loader, reused and not copied), one per scene, and
steps them as one:

- each scene's loss is its single-scene loss on its own views, scaled by
  1/S before its gradient is taken, as the mean over the scenes gives; the
  reported loss and each part are the means over the scenes;
- one guard: a non-finite gradient in any scene skips every scene's
  update, as the program's one guard over the stacked leaves does;
- Adam is elementwise, so each scene's own Adam on its slice is one Adam
  over the stacked leaves; the trainer shows the params, the first step's
  gradients and Adam's state stacked (S, P, 3), in leaf order.

TF32 is off unless the caller turns it on (the benchmark's control does).
It imports nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import torch

from benchmark.harness import load_module

D = load_module(Path(__file__).resolve().parent / "dss_step.py")

# What the benchmark's work counts and adapters read of a reference module.
Raster, Recipe, Cameras, PointLights = D.Raster, D.Recipe, D.Cameras, D.PointLights
normalize, prepare_splats, rasterize_rows = (D.normalize, D.prepare_splats,
                                             D.rasterize_rows)
visible_points, support_radius2 = D.visible_points, D.support_radius2
backward_scaler = D.backward_scaler
vrk_h_global, vrk_h_isotropic = D.vrk_h_global, D.vrk_h_isotropic


class Scenes(list):
    """S per-scene batches of cameras or lights, scene s at index s."""

    def take(self, idx) -> "Scenes":
        """The views `idx` of every scene's batch."""
        return Scenes(b.take(idx) for b in self)


class MultiSceneTrainer:
    """S single-scene trainers (`dss_step.ReferenceTrainer`), one per
    scene, trained one step at a time on the same view slots: scene s on
    its own cameras, lights and images of those slots."""

    def __init__(self, trainers):
        self.scenes = list(trainers)

    def _stacked(self, name: str):
        per = [getattr(sc, name) for sc in self.scenes]
        if per[0] is None:
            return None
        return [torch.stack(ts) for ts in zip(*per)]

    @property
    def params(self):
        return self._stacked("params")

    @property
    def grads(self):
        """The last step's gradients, of the loss over all scenes."""
        return self._stacked("grads")

    @property
    def mu(self):
        return self._stacked("mu")

    @property
    def nu(self):
        return self._stacked("nu")

    @property
    def betas(self) -> tuple:
        return self.scenes[0].betas

    @property
    def lr(self) -> tuple:
        return self.scenes[0].lr

    def train_step(self, cams, lights, img, mask_img, depth_img=None):
        """One step on these view slots: `cams` and `lights` S batches
        (`Scenes`), the images (S, V, ...).  Returns (loss, parts) as
        floats, the means over the scenes."""
        n = len(self.scenes)
        done = []
        for s, sc in enumerate(self.scenes):
            params = [t.clone().requires_grad_(True) for t in sc.params]
            total, parts, visibility, inmask = sc.loss(
                params, cams[s], lights[s], img[s], mask_img[s],
                None if depth_img is None else depth_img[s])
            grads = torch.autograd.grad(total / n, params, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(params, grads)]
            done.append((total.detach(), {k: v.detach()
                                          for k, v in parts.items()},
                         grads, visibility, inmask))
        finite = all(bool(torch.isfinite(g).all())
                     for d in done for g in d[2])
        for sc, (_, _, grads, visibility, inmask) in zip(self.scenes, done):
            sc.grads = grads
            if finite:
                sc._adam(grads)
            sc.visibility, sc.inmask = visibility, inmask
            sc.step += 1
        mean = lambda xs: float(torch.mean(torch.stack(xs)))
        return (mean([d[0] for d in done]),
                {k: mean([d[1][k] for d in done]) for k in done[0][1]})
