"""Training step, train window, annealing schedule, optimizer and chamfer
evaluation (counterpart of dss_tpu/training/trainer.py and of the JAX
CLI's `train_steps_device`).

`make_train_step` runs one step eagerly: model forward, losses,
autograd, and a NaN-guarded Adam update that skips both the parameters
and the optimizer state when a gradient is not finite.  `make_train_window`
runs k steps per call over a device-resident dataset; on a CUDA card each
step is a replay of one captured CUDA graph.  Both run the same step body
(`_grads`) and the same update (`_guarded_update`): the guard, the anneal
and the milestone lrs stay on the device and nothing is read on the host.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from dss_tpu_torch.geometry.knn import knn_points, masked_gather
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import (
    PointModelParams,
    point_model_forward,
    point_model_forward_stacked,
    refuse_texture,
)
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.losses import (
    build_knn,
    depth_l1_loss,
    dr_loss,
    normal_consistency_terms,
    projection_loss,
    repulsion_loss,
)
from dss_tpu_torch.utils import spans
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

    def backward_radii(self, it) -> torch.Tensor:
        """The support scale at step `it`: a host int, or a 0-d integer
        tensor (the train window's device step), whose device the result
        takes."""
        if self.steps_backward_radii <= 0:
            return torch.full((), self.init_backward_radii, device=_device(it))
        i = _period(it, self.steps_backward_radii)
        return torch.clamp(
            self.init_backward_radii
            * torch.pow(torch.full((), self.gamma_backward_radii,
                                   device=i.device), i),
            min=self.limit_backward_radii,
        )

    def proj_scale(self, it) -> torch.Tensor:
        if self.steps_proj <= 0:
            return torch.full((), 1.0, device=_device(it))
        i = _period(it, self.steps_proj)
        return torch.clamp(
            torch.pow(torch.full((), self.gamma_proj, device=i.device), i),
            max=self.limit_proj)


def _device(it) -> torch.device:
    return it.device if isinstance(it, torch.Tensor) else torch.device("cpu")


def _period(it, steps: int) -> torch.Tensor:
    """float32 it // steps.  A tensor step stays on its device and is
    never read on the host, so that a CUDA graph replays the anneal."""
    if isinstance(it, torch.Tensor):
        return torch.div(it, steps, rounding_mode="floor").to(torch.float32)
    return torch.tensor(float(it // steps))


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
                   gamma: float = 0.5,
                   lr_texture: float = 1e-4) -> torch.optim.Adam:
    """Adam with one parameter group per leaf of the params (eps 1e-8,
    optax's default), named as `params.names()`: points, normals, colors,
    and each parameter of a neural texture at `lr_texture`; a
    MultiStepLR schedule counted in applied updates: a group's lr is
    base·gamma^(milestones reached).  Frozen groups get lr 0.  The port
    never calls its `step()`: it holds the groups and Adam's state,
    `guarded_adam_` updates them, and a group's "lr" stays its base lr."""
    lrs = {"points": lr_points, "normals": lr_normals, "colors": lr_colors}
    groups = [
        {"params": [t], "lr": lrs.get(name, lr_texture), "name": name,
         "base_lr": lrs.get(name, lr_texture),
         "milestones": tuple(int(m) for m in milestones), "gamma": gamma}
        for name, t in zip(params.names(), params.tensors())
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


# The metrics that count events (binning overflows; with the normal
# anchor, active points whose target is not finite): summed over the
# scenes of a stacked loss and over the steps of a window, not averaged
# or taken from the last step (train_mvr sums them on over the windows
# between two log lines).
COUNTS = ("bin_overflow", "anchor_nonfinite")


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
    `bin_overflow` is the sum over all views, the other COUNTS the sums
    over the scenes.
    Returns (total, (parts, new_filters))."""
    def loss_fn(params, filters, cameras, lights, img, mask_img, it,
                depth_img=None):
        refuse_texture(params, "the stacked multi-scene loss")
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
        parts = {k: (torch.sum if k in COUNTS else torch.mean)(
                     torch.stack([p[k] for p in parts])) for k in parts[0]}
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
    """Loss terms from a completed model forward: the image losses
    (`loss.image`), then the surface regularizers (`loss.reg`), added to
    the total in that order.  With the normal term the parts also hold
    `anchor_nonfinite`, the count of its non-finite targets."""
    with spans.span("loss.image"):
        img_pred, mask_pred, depth_pred = spans.inputs(
            "loss.image", out["img_pred"], out["mask_img_pred"],
            out.get("depth_pred"))
        total, parts = dr_loss(img, img_pred, mask_img, mask_pred,
                               cfg.lambda_rgb, cfg.lambda_silhouette)
        if cfg.lambda_depth > 0:
            ld = depth_l1_loss(depth_img, depth_pred, mask_img) * cfg.lambda_depth
            total = total + ld
            parts = {**parts, "loss_dr_depth": ld}
        (total,) = spans.outputs("loss.image", total)
    surface = cfg.lambda_proj > 0 or cfg.lambda_repel > 0
    if not surface and cfg.lambda_normal <= 0:
        return total, parts
    with spans.span("loss.reg"):
        points, raw_normals = spans.inputs("loss.reg", params.points,
                                           params.normals)
        terms = {}
        if surface:
            normals = normalize(raw_normals)
            active = filters.activation
            reliable = new_filters.visibility & new_filters.inmask
            knn = build_knn(points.detach(), active, cfg.knn_k)
            if cfg.lambda_proj > 0:
                terms["loss_dr_proj"] = (
                    projection_loss(points, normals, active,
                                    visibility=new_filters.visibility,
                                    reliable=reliable, knn=knn,
                                    filter_scale=cfg.filter_scale,
                                    sharpness_sigma=cfg.sharpness_sigma)
                    * cfg.lambda_proj
                    * schedule.proj_scale(it).to(img.device))
            if cfg.lambda_repel > 0:
                terms["loss_dr_repel"] = (
                    repulsion_loss(points, normals, active,
                                   reliable=reliable, knn=knn,
                                   filter_scale=cfg.filter_scale,
                                   sharpness_sigma=cfg.sharpness_sigma)
                    * cfg.lambda_repel)
        if cfg.lambda_normal > 0:
            term, nonfinite = normal_consistency_terms(
                points, raw_normals, filters.activation,
                neighborhood_size=cfg.normal_anchor_k,
                anchor=cfg.normal_anchor)
            terms["loss_dr_normal"] = term * cfg.lambda_normal
            parts = {**parts, "anchor_nonfinite": nonfinite}
        # one boundary for all terms: one backward span
        for name, term in zip(terms, spans.outputs("loss.reg",
                                                   *terms.values())):
            total = total + term
            parts = {**parts, name: term}
    return total, parts


def _grads(params: PointModelParams, loss: Callable):
    """`loss()`, then autograd in the `backward` span (zeros for leaves the
    loss does not reach).  Returns (grads, total, parts, new_filters).  The
    loss comes as a thunk so that the batch it gathers is freed before the
    backward, as after a direct call."""
    total, (parts, new_filters) = loss()
    with spans.span("backward"):
        grads = torch.autograd.grad(total, params.tensors(),
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params.tensors(), grads)]
    return grads, total, parts, new_filters


def _guarded_update(optimizer: torch.optim.Adam, grads) -> torch.Tensor:
    """`kernels.all_finite`, then `guarded_adam_` by its module attribute.
    Returns the guard, a 0-d bool on the device."""
    finite = kernels.all_finite(grads)
    guarded_adam_(optimizer, grads, finite)
    return finite


def apply_update(state: TrainState, grads, total, parts, new_filters):
    """NaN-guarded optimizer update (`_guarded_update`): a non-finite
    gradient skips the whole update — parameters and Adam state alike.
    `grads` are the gradients of `state.params.tensors()`, in order.
    Nothing is read on the host.  Returns (state, metrics); the state is
    updated in place."""
    finite = _guarded_update(state.optimizer, grads)
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
        with spans.step(state.params.points.device):
            grads, total, parts, new_filters = _grads(
                state.params, lambda: loss_fn(
                    state.params, state.filters, cameras, lights, img,
                    mask_img, state.step, depth_img))
            with spans.span("update"):
                return apply_update(state, grads, total, parts, new_filters)

    return train_step


def take_views(batch, idx):
    """The views `idx` of a camera or light batch (fields with a leading
    view axis), gathered on their device: by the batch's own `take` where
    it has one (a camera batch gathers its projection matrices with it)."""
    if batch is None:
        return None
    if hasattr(batch, "take"):
        return batch.take(idx)
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[idx] for f in dataclasses.fields(batch)})


# ---------------------------------------------------------------------------
# The train window: k steps per dispatch
# ---------------------------------------------------------------------------

# Eager steps run on a side stream before the capture (builds, library
# loads, cuBLAS handles and sort workspaces); the state is restored after.
GRAPH_WARMUP_STEPS = 2


def adam_state(optimizer: torch.optim.Adam, t: torch.Tensor) -> dict:
    """Adam's state of parameter `t`, created where missing: `exp_avg`,
    `exp_avg_sq` and `step` (the applied-update count, float32 as torch
    keeps it) on t's device, so that a graph can update them in place."""
    st = optimizer.state[t]
    if "step" not in st:
        st["step"] = torch.zeros((), device=t.device)
        st["exp_avg"] = torch.zeros_like(t, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(t, memory_format=torch.preserve_format)
    elif st["step"].device != t.device:
        st["step"] = st["step"].to(device=t.device, dtype=torch.float32)
    return st


def group_lr(group: dict, count: torch.Tensor) -> torch.Tensor:
    """A group's lr after `count` applied updates (a float32 0-d tensor,
    on its device): base·gamma per milestone ≤ count, in float32 as optax's
    piecewise-constant schedule computes it."""
    lr = torch.full((), group["base_lr"], device=count.device)
    for m in sorted(set(group["milestones"])):
        lr = torch.where(count < m, lr, group["gamma"] * lr)
    return lr


def guarded_adam_plain(optimizer: torch.optim.Adam, grads,
                       finite: torch.Tensor) -> None:
    """One Adam update in optax's order (the JAX package's optimizer),
    applied only where the 0-d bool `finite` holds: otherwise the
    parameters and all of Adam's state, its count included, keep their
    values.  Each group's lr is `group_lr` of its applied-update count.
    Updates the parameters and `adam_state` in place and reads nothing on
    the host.  `grads` are one per parameter group, in group order.  A
    chain of stock-torch ops per group, on any device: the CPU's update
    and the plain version of the card's kernel (`guarded_adam_`)."""
    with torch.no_grad():
        for group, g in zip(optimizer.param_groups, grads):
            (t,) = group["params"]
            st = adam_state(optimizer, t)
            b1, b2 = group["betas"]
            count = st["step"]
            count_inc = count + 1.0
            mu = (1.0 - b1) * g + b1 * st["exp_avg"]
            nu = (1.0 - b2) * (g * g) + b2 * st["exp_avg_sq"]
            mu_hat = mu / (1.0 - torch.pow(b1, count_inc))
            nu_hat = nu / (1.0 - torch.pow(b2, count_inc))
            lr = group_lr(group, count)
            new = t + mu_hat / (torch.sqrt(nu_hat) + group["eps"]) * -lr
            t.copy_(torch.where(finite, new, t))
            st["exp_avg"].copy_(torch.where(finite, mu, st["exp_avg"]))
            st["exp_avg_sq"].copy_(torch.where(finite, nu, st["exp_avg_sq"]))
            count.copy_(torch.where(finite, count_inc, count))


# The update kernel's tickets, one set per optimizer (kernels.guarded_adam:
# zeros that every launch leaves zero; two updates of one optimizer never
# run at once).
_TICKETS = weakref.WeakKeyDictionary()


def guarded_adam_(optimizer: torch.optim.Adam, grads, finite: torch.Tensor) -> None:
    """The guarded update of `guarded_adam_plain`, dispatched by device:
    CPU tensors take that composite; CUDA tensors take
    `kernels.guarded_adam`, one launch over every group (at most
    kernels.ADAM_MAX_TENSORS a launch), equal to it bit for bit.  Every
    train path calls it by this module attribute (`_guarded_update`)."""
    if finite.device.type == "cpu":
        guarded_adam_plain(optimizer, grads, finite)
        return
    params, states, hypers = [], [], []
    for group in optimizer.param_groups:
        (t,) = group["params"]
        params.append(t.detach())
        states.append(adam_state(optimizer, t))
        hypers.append(kernels.AdamHyper(
            *group["betas"], group["eps"], group["base_lr"], group["gamma"],
            tuple(group["milestones"])))
    tickets = _TICKETS.get(optimizer)
    if tickets is None:
        tickets = torch.zeros(kernels.ADAM_MAX_TENSORS, dtype=torch.int32,
                              device=finite.device)
        _TICKETS[optimizer] = tickets
    kernels.guarded_adam(params, grads, [st["exp_avg"] for st in states],
                         [st["exp_avg_sq"] for st in states],
                         [st["step"] for st in states], hypers, finite,
                         tickets)


class TrainWindow:
    """k train steps per call, the counterpart of the JAX CLI's
    `train_steps_device` (one `lax.scan` program).  Step i of a window
    trains on the views `epoch_idx[step % len(epoch_idx)]`, picked on the
    device; the update is `guarded_adam_`, the anneal and the milestone lrs
    follow the device step.  A call returns the last step's metrics, with
    `params_finite` ANDed and the COUNTS summed over the window.

    On a CUDA device the step is captured once as a CUDA graph and each
    step of a window is one replay: the host launches nothing else and
    reads nothing.  Before the capture, GRAPH_WARMUP_STEPS eager steps run
    on a side stream and the state is restored after them.  A capture or a
    replay that fails raises.  On the CPU (or with `graph=False`) the same
    step runs eagerly.

    The graph reads and writes fixed storage: the parameter tensors, Adam's
    state (`adam_state`), the filters and the step, all updated in place.
    At each call the window copies into that storage whatever the caller
    replaced since the last one (new filters after a prune or a reseed, an
    optimizer state from a checkpoint); `state.filters` and the optimizer's
    state then hold the window's tensors.  `TrainState.step` stays a host
    int, advanced by k per call.  Parameters whose storage changed (a
    checkpoint loaded after the window was made) raise: make a new window.

    The kernels' launch counters count replays: what the wrappers counted
    during the capture is taken back (`per_replay`), and a call of k
    replays adds k times it.

    With utils/spans on, the step records its spans (`step` at the root)
    and the graph holds their marks: the switch is read once per call, and
    a graph captured with the other setting is captured anew.  The call
    then puts `window.bind`, `window.capture` and each `window.replay` in
    host ranges, and adds the host time inside `CUDAGraph.replay()` to
    `replay_host_ns`, the replays it covers to `replays`.  With spans off
    the graph holds no mark and the replay loop times nothing."""

    def __init__(self, settings: RasterSettings, cfg: TrainConfig,
                 schedule: AnnealSchedule, state: TrainState, all_cams,
                 all_lights, all_img, all_mask, all_depth=None, graph=None):
        dev = state.params.points.device
        if graph is None:
            graph = dev.type == "cuda"
        if graph and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        opt = state.optimizer
        groups = opt.param_groups
        if (len(groups) != len(state.params.tensors()) or any(
                len(g["params"]) != 1 or g["params"][0] is not t
                or "base_lr" not in g or g["weight_decay"] or g["amsgrad"]
                or g["maximize"]
                for g, t in zip(groups, state.params.tensors()))):
            raise ValueError("the train window updates the optimizer of "
                             "make_optimizer: plain Adam, one parameter "
                             "group per tensor of the params")
        self.graph = graph
        self.loss_fn = make_loss_fn(settings, cfg, schedule)
        self.data = (all_cams, all_lights, all_img, all_mask, all_depth)
        self.params, self.optimizer = state.params, opt
        self._storage = [t.data_ptr() for t in state.params.tensors()]
        self._opt = [adam_state(opt, t) for t in state.params.tensors()]
        self._opt_bufs = [{k: st[k] for k in ("step", "exp_avg", "exp_avg_sq")}
                          for st in self._opt]
        f = state.filters
        self.filters = PointFilters(f.activation.clone(), f.visibility.clone(),
                                    f.inmask.clone())
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self._epoch = None
        self._out = None
        self._graph = None
        self.per_replay = {}
        self.capture_s = None
        self.pool_bytes = None
        self._traced = False  # whether the graph holds span marks
        self.replay_host_ns = 0
        self.replays = 0

    def _bind(self, state: TrainState, epoch_idx: torch.Tensor) -> None:
        """Copy what the caller replaced into the window's storage."""
        mine = self.params.tensors()
        if (any(t is not m for t, m in zip(state.params.tensors(), mine))
                or [t.data_ptr() for t in mine] != self._storage):
            raise ValueError("the parameters are not the storage this window "
                             "was made for (a checkpoint loaded after "
                             "make_train_window?): make a new window")
        for st, bufs in zip(self._opt, self._opt_bufs):
            for key, buf in bufs.items():
                if st.get(key) is not buf:
                    buf.copy_(st[key])
                    st[key] = buf
        for name in ("activation", "visibility", "inmask"):
            cur, buf = getattr(state.filters, name), getattr(self.filters, name)
            if cur is not buf:
                buf.copy_(cur)
        state.filters = self.filters
        if self._epoch is None:
            self._epoch = torch.empty_like(epoch_idx)
        elif epoch_idx.shape != self._epoch.shape:
            raise ValueError(f"epoch_idx {tuple(epoch_idx.shape)}, the window "
                             f"holds {tuple(self._epoch.shape)}")
        self._epoch.copy_(epoch_idx)
        self.step.fill_(state.step)
        if self._out is not None:
            self._reset_metrics()

    def _reset_metrics(self) -> None:
        """The window's AND and sums start anew."""
        self._out["params_finite"].fill_(True)
        for k in COUNTS:
            if k in self._out:
                self._out[k].zero_()

    def _body(self) -> None:
        """One train step on the window's storage."""
        with spans.step(self.step.device):
            cams, lights, img, mask, depth = self.data
            row = torch.remainder(self.step, self._epoch.shape[0]).reshape(1)
            idx = self._epoch.index_select(0, row).reshape(-1)
            grads, total, parts, new_filters = _grads(
                self.params, lambda: self.loss_fn(
                    self.params, self.filters, take_views(cams, idx),
                    take_views(lights, idx), img[idx], mask[idx], self.step,
                    None if depth is None else depth[idx]))
            with spans.span("update"):
                self._update(grads, total, parts, new_filters)

    def _update(self, grads, total, parts, new_filters) -> None:
        """The guarded update, the filters and the window's metrics."""
        finite = _guarded_update(self.optimizer, grads)
        metrics = {"loss": total, "params_finite": finite, **parts}
        with torch.no_grad():
            # the activation is the filters' own tensor: the forward
            # passes it through
            self.filters.visibility.copy_(new_filters.visibility)
            self.filters.inmask.copy_(new_filters.inmask)
            if self._out is None:
                self._out = {k: torch.empty_like(v) for k, v in metrics.items()}
                self._reset_metrics()
            for k, v in metrics.items():
                if k == "params_finite":
                    self._out[k].logical_and_(v)
                elif k in COUNTS:
                    self._out[k].add_(v)
                else:
                    self._out[k].copy_(v)
            self.step.add_(1)

    def _buffers(self):
        return [*(t.detach() for t in self.params.tensors()),
                *(b for bufs in self._opt_bufs for b in bufs.values()),
                self.filters.activation, self.filters.visibility,
                self.filters.inmask, self.step]

    def _capture(self) -> None:
        saved = [b.clone() for b in self._buffers()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                self._body()
        torch.cuda.current_stream().wait_stream(side)
        for b, s in zip(self._buffers(), saved):
            b.copy_(s)
        self._reset_metrics()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        after = kernels.launch_counts()
        self.per_replay = {k: n - before[k] for k, n in after.items()
                           if n != before[k]}
        kernels.add_launches(self.per_replay, -1)
        self._graph = graph

    def __call__(self, state: TrainState, epoch_idx: torch.Tensor, k: int):
        if k < 1:
            raise ValueError(f"k = {k}: a window takes at least one step")
        traced = spans.enabled()
        with spans.host("window.bind"):
            self._bind(state, epoch_idx)
        if self.graph and (self._graph is None or self._traced != traced):
            with spans.host("window.capture"):
                self._capture()
            self._traced = traced
        if not self.graph:
            for _ in range(k):
                self._body()
        elif traced:
            for _ in range(k):
                with spans.host("window.replay"):
                    t0 = time.perf_counter_ns()
                    self._graph.replay()
                    self.replay_host_ns += time.perf_counter_ns() - t0
            self.replays += k
        else:
            for _ in range(k):
                self._graph.replay()
        if self.graph:
            kernels.add_launches(self.per_replay, k)
        state.step += k
        return state, {k_: v.clone() for k_, v in self._out.items()}


def make_train_window(settings: RasterSettings, cfg: TrainConfig,
                      schedule: AnnealSchedule, state: TrainState, all_cams,
                      all_lights, all_img, all_mask, all_depth=None,
                      graph=None) -> TrainWindow:
    """The train window over a device-resident dataset (all views' cameras,
    lights, images, masks and depth maps): `window(state, epoch_idx, k)` →
    (state, metrics).  See TrainWindow."""
    return TrainWindow(settings, cfg, schedule, state, all_cams, all_lights,
                       all_img, all_mask, all_depth, graph)


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
