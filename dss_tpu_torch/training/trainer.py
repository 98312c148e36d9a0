"""Training step, annealing schedule, optimizer and chamfer evaluation
(counterpart of dss_tpu/training/trainer.py).

The step runs eagerly: model forward, losses, autograd, and a NaN-guarded
Adam update that skips both the parameters and the optimizer state when a
gradient is not finite.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import (
    PointModelParams,
    point_model_forward,
    point_model_forward_stacked,
)
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.losses import (
    build_knn,
    depth_l1_loss,
    dr_loss,
    normal_consistency_loss,
    projection_loss,
    repulsion_loss,
)
from dss_tpu_torch.utils.mathutil import eps_denom, normalize


@dataclasses.dataclass(frozen=True)
class AnnealSchedule:
    """Iteration-driven annealing: every `steps_backward_radii` iterations
    the occupancy-gradient support shrinks by gamma, floored at the limit;
    λ_proj grows by gamma_proj, capped at limit_proj.  Values are float32,
    computed in the JAX package's order."""

    init_backward_radii: float = 10.0
    steps_backward_radii: int = 200
    gamma_backward_radii: float = 0.9
    limit_backward_radii: float = 2.0
    steps_proj: int = -1
    gamma_proj: float = 5.0
    limit_proj: float = 1.0

    def backward_radii(self, it: int) -> torch.Tensor:
        if self.steps_backward_radii <= 0:
            return torch.tensor(self.init_backward_radii, dtype=torch.float32)
        i = torch.tensor(float(it // self.steps_backward_radii))
        return torch.clamp(
            self.init_backward_radii
            * torch.pow(torch.tensor(self.gamma_backward_radii), i),
            min=self.limit_backward_radii,
        )

    def proj_scale(self, it: int) -> torch.Tensor:
        if self.steps_proj <= 0:
            return torch.tensor(1.0)
        i = torch.tensor(float(it // self.steps_proj))
        return torch.clamp(torch.pow(torch.tensor(self.gamma_proj), i),
                           max=self.limit_proj)


class TrainConfig(NamedTuple):
    """Loss weights and loss hyper-parameters."""

    lambda_rgb: float = 1.0
    lambda_silhouette: float = 1.0
    lambda_proj: float = 0.0
    lambda_repel: float = 0.0
    lambda_depth: float = 0.0
    # Anchors the learned normals to a geometric estimate of the current
    # cloud (losses.normal_consistency_loss): "pca" or "jet".
    lambda_normal: float = 0.0
    normal_anchor: str = "pca"
    normal_anchor_k: int = 8
    knn_k: int = 12
    filter_scale: float = 2.0
    sharpness_sigma: float = 0.75


@dataclasses.dataclass
class TrainState:
    params: PointModelParams
    optimizer: torch.optim.Adam
    filters: PointFilters
    step: int = 0


def make_optimizer(params: PointModelParams, lr_points: float = 0.01,
                   lr_normals: float = 0.01, lr_colors: float = 1.0,
                   betas: Tuple[float, float] = (0.5, 0.9),
                   milestones: Sequence[int] = (),
                   gamma: float = 0.5) -> torch.optim.Adam:
    """Adam with one parameter group each for points, normals and colors
    (eps 1e-8, optax's default) and a MultiStepLR schedule counted in
    applied updates: a group's lr is base·gamma^(milestones reached).
    Frozen groups get lr 0."""
    groups = [
        {"params": [t], "lr": lr, "name": name, "base_lr": lr,
         "milestones": tuple(int(m) for m in milestones), "gamma": gamma}
        for name, t, lr in zip(("points", "normals", "colors"),
                               params.tensors(),
                               (lr_points, lr_normals, lr_colors))
    ]
    return torch.optim.Adam(groups, betas=betas, eps=1e-8)


def create_train_state(params: PointModelParams,
                       optimizer: torch.optim.Adam) -> TrainState:
    return TrainState(
        params=params,
        optimizer=optimizer,
        filters=PointFilters.ones(params.points.shape[0],
                                  device=params.points.device),
    )


def make_loss_fn(settings: RasterSettings, cfg: TrainConfig,
                 schedule: AnnealSchedule) -> Callable:
    """The train loss: (params, filters, cameras, lights, img, mask_img, it
    [, depth_img]) → (total, (parts, new_filters))."""
    def loss_fn(params, filters, cameras, lights, img, mask_img, it,
                depth_img=None):
        _validate_loss_inputs(settings, cfg, depth_img)
        sett = settings.replace(
            radii_backward_scaler=schedule.backward_radii(it).to(img.device)
        )
        out, new_filters = point_model_forward(
            params, filters, cameras, lights, sett, mask_img=mask_img
        )
        total, parts = _post_render_loss(
            params, filters, new_filters, out, img, mask_img, it, depth_img,
            cfg, schedule,
        )
        parts = {**parts, "bin_overflow": out["bin_overflow"]}
        return total, (parts, new_filters)

    return loss_fn


def make_stacked_loss_fn(settings: RasterSettings, cfg: TrainConfig,
                         schedule: AnnealSchedule) -> Callable:
    """The multi-scene train loss over stacked parameters ((S, P, 3)
    leaves), filters ((S, P) leaves), S camera batches of V views and
    (S, V, ...) images: one folded render of all S·V views
    (`point_model_forward_stacked`), then each scene's loss terms as in
    `make_loss_fn`.  The total and each part are the means over scenes, so
    each scene's gradient is 1/S of its single-scene value;
    `bin_overflow` is the sum over all views, not a mean.
    Returns (total, (parts, new_filters))."""
    def loss_fn(params, filters, cameras, lights, img, mask_img, it,
                depth_img=None):
        _validate_loss_inputs(settings, cfg, depth_img)
        sett = settings.replace(
            radii_backward_scaler=schedule.backward_radii(it).to(img.device)
        )
        out, new_filters = point_model_forward_stacked(
            params, filters, cameras, lights, sett, mask_img=mask_img
        )
        totals, parts = [], []
        for s in range(params.points.shape[0]):
            scene = lambda f: PointFilters(f.activation[s], f.visibility[s],
                                           f.inmask[s])
            total, part = _post_render_loss(
                PointModelParams(params.points[s], params.normals[s],
                                 params.colors[s]),
                scene(filters), scene(new_filters),
                {k: v[s] for k, v in out.items() if k != "bin_overflow"},
                img[s], mask_img[s], it,
                None if depth_img is None else depth_img[s], cfg, schedule,
            )
            totals.append(total)
            parts.append(part)
        parts = {k: torch.mean(torch.stack([p[k] for p in parts]))
                 for k in parts[0]}
        parts["bin_overflow"] = out["bin_overflow"]
        return torch.mean(torch.stack(totals)), (parts, new_filters)

    return loss_fn


def _validate_loss_inputs(settings: RasterSettings, cfg: TrainConfig,
                         depth_img) -> None:
    """A depth loss needs a depth batch and a render path that carries
    depth: the weighted-depth channel, the fragment buffers
    (lean_fragments=False), or the reference backend."""
    if cfg.lambda_depth > 0:
        carries_depth = (settings.depth_channel
                         or not settings.lean_fragments
                         or settings.backend == "reference")
        if depth_img is None or not carries_depth:
            raise ValueError(
                "lambda_depth > 0 needs a depth batch and a depth-carrying "
                "render path (settings.depth_channel=True for the lean "
                "path, or settings.lean_fragments=False for the fragment "
                "zbuf)"
            )


def _post_render_loss(params, filters, new_filters, out, img, mask_img, it,
                      depth_img, cfg, schedule):
    """Loss terms from a completed model forward."""
    total, parts = dr_loss(img, out["img_pred"], mask_img,
                           out["mask_img_pred"], cfg.lambda_rgb,
                           cfg.lambda_silhouette)
    if cfg.lambda_depth > 0:
        ld = depth_l1_loss(depth_img, out["depth_pred"], mask_img) * cfg.lambda_depth
        total = total + ld
        parts = {**parts, "loss_dr_depth": ld}
    if cfg.lambda_proj > 0 or cfg.lambda_repel > 0:
        normals = normalize(params.normals)
        active = filters.activation
        reliable = new_filters.visibility & new_filters.inmask
        knn = build_knn(params.points.detach(), active, cfg.knn_k)
        if cfg.lambda_proj > 0:
            lp = (projection_loss(params.points, normals, active,
                                  visibility=new_filters.visibility,
                                  reliable=reliable, knn=knn,
                                  filter_scale=cfg.filter_scale,
                                  sharpness_sigma=cfg.sharpness_sigma)
                  * cfg.lambda_proj
                  * schedule.proj_scale(it).to(img.device))
            total = total + lp
            parts = {**parts, "loss_dr_proj": lp}
        if cfg.lambda_repel > 0:
            lr_ = (repulsion_loss(params.points, normals, active,
                                  reliable=reliable, knn=knn,
                                  filter_scale=cfg.filter_scale,
                                  sharpness_sigma=cfg.sharpness_sigma)
                   * cfg.lambda_repel)
            total = total + lr_
            parts = {**parts, "loss_dr_repel": lr_}
    if cfg.lambda_normal > 0:
        ln = (normal_consistency_loss(params.points, params.normals,
                                      filters.activation,
                                      neighborhood_size=cfg.normal_anchor_k,
                                      anchor=cfg.normal_anchor)
              * cfg.lambda_normal)
        total = total + ln
        parts = {**parts, "loss_dr_normal": ln}
    return total, parts


def _milestone_lrs(optimizer: torch.optim.Adam) -> None:
    """Set each group's lr for the update about to be applied."""
    for group in optimizer.param_groups:
        st = optimizer.state.get(group["params"][0], {})
        count = int(st["step"]) if "step" in st else 0
        n = sum(count >= m for m in group["milestones"])
        group["lr"] = group["base_lr"] * group["gamma"] ** n


def apply_update(state: TrainState, grads, total, parts, new_filters):
    """NaN-guarded optimizer update: a non-finite gradient skips the whole
    update — parameters and Adam state alike (`step()` is not called).
    `grads` are the (points, normals, colors) gradients.  Returns
    (state, metrics); the state is updated in place."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    applied = bool(finite)
    if applied:
        for t, g in zip(state.params.tensors(), grads):
            t.grad = g
        _milestone_lrs(state.optimizer)
        state.optimizer.step()
    for t in state.params.tensors():
        t.grad = None
    state.filters = PointFilters(
        activation=new_filters.activation,
        visibility=new_filters.visibility.detach(),
        inmask=new_filters.inmask.detach(),
    )
    state.step += 1
    metrics = {"loss": total.detach(), "params_finite": finite,
               **{k: v.detach() for k, v in parts.items()}}
    return state, metrics


def make_train_step(settings: RasterSettings, cfg: TrainConfig,
                    schedule: AnnealSchedule) -> Callable:
    """The train step: (state, cameras, lights, img, mask_img[, depth_img])
    → (state, metrics)."""
    loss_fn = make_loss_fn(settings, cfg, schedule)

    def train_step(state: TrainState, cameras, lights, img, mask_img,
                   depth_img=None):
        total, (parts, new_filters) = loss_fn(
            state.params, state.filters, cameras, lights, img, mask_img,
            state.step, depth_img,
        )
        grads = torch.autograd.grad(total, state.params.tensors(),
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(state.params.tensors(), grads)]
        return apply_update(state, grads, total, parts, new_filters)

    return train_step


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


@torch.no_grad()
def chamfer_distance(x, y, x_normals=None, y_normals=None, x_mask=None,
                     y_mask=None):
    """Symmetric squared chamfer distance and the normal term 1 − |cos|
    (pytorch3d chamfer_distance semantics).  Returns (cd, cn or None)."""

    def directed(a, b, a_mask, b_mask, an, bn):
        d, idx = knn_points(a, b, a_mask, b_mask, k=1)
        d = torch.where(torch.isfinite(d[:, 0]), d[:, 0], 0.0)
        am = (torch.ones(a.shape[:1], device=a.device) if a_mask is None
              else a_mask.to(a.dtype))
        cd = torch.sum(d * am) / eps_denom(torch.sum(am))
        cn = None
        if an is not None and bn is not None:
            nb = masked_gather(bn, idx)[:, 0, :]
            cos = torch.abs(torch.sum(normalize(an) * normalize(nb), dim=-1))
            cn = torch.sum((1.0 - cos) * am) / eps_denom(torch.sum(am))
        return cd, cn

    cd_xy, cn_xy = directed(x, y, x_mask, y_mask, x_normals, y_normals)
    cd_yx, cn_yx = directed(y, x, y_mask, x_mask, y_normals, x_normals)
    return cd_xy + cd_yx, (None if cn_xy is None else cn_xy + cn_yx)


def psnr(img_pred: torch.Tensor, img_gt: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB of [0, 1] images."""
    mse = torch.mean((img_pred - img_gt) ** 2)
    return -10.0 * torch.log10(eps_denom(mse))
