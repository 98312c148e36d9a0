"""View-parallel training over torch.distributed (counterpart of
dss_tpu/parallel/mesh.py).

The workload — V camera views of one shared point cloud — is data
parallel over views: each rank renders its contiguous slice of the view
batch and computes the loss over it; the point parameters (5000 × 3 floats
at the flagship) are replicated.  The gradients and the loss are
all-reduced to their mean, so every rank applies the same update.  The
per-point kNN regularizers run on every rank over the whole cloud, so no
halo exchange is needed.  `render_view_row_sharded` splits one view's
image rows over the ranks instead.

The caller starts the processes and calls `torch.distributed
.init_process_group` (`parallel/dryrun.py` does both for a run on one
host).  Every collective here runs on tensors of the ranks' own device:
gloo accepts CUDA tensors for all_reduce, broadcast and all_gather alike
(torch 2.11 on the H100, `chip_smoke.py`'s `parallel` phase), so nothing
is staged through the host; NCCL needs one card per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from dss_tpu_torch.models.point_model import refuse_texture
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.training.trainer import (
    AnnealSchedule,
    TrainConfig,
    TrainState,
    apply_update,
    make_loss_fn,
)


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """A 1-D mesh of `size` ranks along `axis`: the process group of the
    first `size` ranks of the job and this process's index in it (−1 when
    this rank is not in the mesh)."""

    group: dist.ProcessGroup
    size: int
    index: int
    axis: str = "views"

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)


def make_mesh(n_devices: Optional[int] = None, axis: str = "views") -> ViewMesh:
    """A mesh over the first n_devices ranks of the initialized process
    group (all of them by default).  Every rank must call it.  Raises if
    fewer than n_devices ranks exist: a silently shrunk mesh would make a
    multi-rank run pass on one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group to have run on every rank")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if world < n:
        raise ValueError(f"make_mesh: requested {n} ranks but only {world} "
                         f"exist ({dist.get_backend()} backend)")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return ViewMesh(group=group, size=n, index=rank if rank < n else -1,
                    axis=axis)


def _tree_map(fn: Callable, tree):
    """fn on every tensor of a tree of dataclasses, dicts, lists and
    tuples; other leaves (None, numbers) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _member(mesh: ViewMesh) -> int:
    if mesh.index < 0:
        raise ValueError("this rank is not in the mesh")
    return mesh.index


def _slab(x: torch.Tensor, mesh: ViewMesh) -> torch.Tensor:
    """This rank's contiguous slice of x's leading axis."""
    k = x.shape[0] // mesh.size
    i = _member(mesh)
    return x[i * k:(i + 1) * k]


def shard_views(tree, mesh: ViewMesh):
    """This rank's slice of every tensor whose leading dimension the mesh
    size divides; every other leaf is kept whole (replicated)."""
    return _tree_map(
        lambda x: (_slab(x, mesh) if x.ndim >= 1 and x.shape[0] % mesh.size == 0
                   else x), tree)


def shard_by_view_count(tree, mesh: ViewMesh, n_views: int):
    """The train step's rule: this rank's slice of every tensor whose
    leading dimension IS the view count (not merely divisible by the mesh
    size: a replicated (n, ...) table stays whole); every other leaf is
    kept whole."""
    return _tree_map(
        lambda x: (_slab(x, mesh) if x.ndim >= 1 and x.shape[0] == n_views
                   else x), tree)


def replicate(tree, mesh: ViewMesh):
    """Copies of every tensor, broadcast from the mesh's first rank, so
    that all ranks hold the same bits (a tensor that required grad still
    does)."""
    _member(mesh)
    src = mesh.global_rank(0)

    def bcast(x):
        y = x.detach().clone()
        dist.broadcast(y, src, group=mesh.group)
        return y.requires_grad_(x.requires_grad)

    return _tree_map(bcast, tree)


def _all_reduce(x: torch.Tensor, mesh: ViewMesh, op=dist.ReduceOp.SUM):
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def make_shardmap_grad_fn(settings: RasterSettings, cfg: TrainConfig,
                          schedule: AnnealSchedule, mesh: ViewMesh) -> Callable:
    """The distributed loss and gradients: (params, filters, cameras,
    lights, img, mask_img, it[, depth_img]) → (grads, total, parts,
    new_filters), reduced over the mesh as dss_tpu's shard_map body
    reduces them:

    - the gradients and the total: the mean over ranks, each rank's loss
      taken over its own views (a plain mean over views stays the whole
      batch's; a masked mean weighs every rank alike, whatever its mask
      count, as dss_tpu's pmean does);
    - every part the mean, except `bin_overflow`, the sum;
    - boolean filters OR-ed (visibility and inmask are ANY over views),
      float filters averaged.

    A rank takes its slice of the images, masks and depths, and of every
    camera and light leaf whose leading dimension is the view count; other
    leaves are replicated."""
    return _grad_fn(settings, cfg, schedule, mesh, by_view_count=True)


def _grad_fn(settings: RasterSettings, cfg: TrainConfig,
             schedule: AnnealSchedule, mesh: ViewMesh,
             by_view_count: bool) -> Callable:
    """make_shardmap_grad_fn's body; with by_view_count False the cameras
    and lights are placed by `shard_views` instead (every leaf whose
    leading dimension the mesh size divides is split)."""
    loss_fn = make_loss_fn(settings, cfg, schedule)
    n = mesh.size

    def place(tree, n_views):
        return (shard_by_view_count(tree, mesh, n_views) if by_view_count
                else shard_views(tree, mesh))

    def grad_fn(params, filters, cameras, lights, img, mask_img, it,
                depth_img=None):
        refuse_texture(params, "view-parallel training")
        n_views = img.shape[0]
        if n_views % n:
            raise ValueError(f"{n_views} views do not split over {n} ranks")
        cameras, lights = place(cameras, n_views), place(lights, n_views)
        img, mask_img = _slab(img, mesh), _slab(mask_img, mesh)
        if depth_img is not None:
            depth_img = _slab(depth_img, mesh)
        total, (parts, new_filters) = loss_fn(
            params, filters, cameras, lights, img, mask_img, it, depth_img)
        tensors = params.tensors()
        grads = torch.autograd.grad(total, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(tensors, grads)]

        # One all-reduce for the gradients, the total and the mean parts.
        names = [k for k in parts if k != "bin_overflow"]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [total.detach().reshape(1)]
                         + [parts[k].detach().float().reshape(1)
                            for k in names])
        flat = _all_reduce(flat, mesh) / n
        sizes = [g.numel() for g in grads]
        out = list(torch.split(flat, sizes + [1] * (1 + len(names))))
        grads = [o.reshape(g.shape) for o, g in zip(out, grads)]
        total = out[len(grads)].reshape(())
        reduced = {k: v.reshape(()) for k, v in zip(names, out[len(grads) + 1:])}
        if "bin_overflow" in parts:
            reduced["bin_overflow"] = _all_reduce(
                parts["bin_overflow"].detach().to(torch.int64).clone(), mesh)

        fields = [f.name for f in dataclasses.fields(new_filters)]
        vals = {k: getattr(new_filters, k) for k in fields}
        bools = [k for k in fields if vals[k].dtype == torch.bool]
        if bools:
            anyv = _all_reduce(torch.stack([vals[k] for k in bools]).to(
                torch.int32), mesh, dist.ReduceOp.MAX) > 0
            vals.update(zip(bools, anyv))
        for k in fields:
            if k not in bools:
                vals[k] = _all_reduce(vals[k].detach().clone(), mesh) / n
        return grads, total, reduced, type(new_filters)(**vals)

    return grad_fn


def make_shardmap_train_step(settings: RasterSettings, cfg: TrainConfig,
                             schedule: AnnealSchedule,
                             mesh: ViewMesh) -> Callable:
    """The distributed train step: (state, cameras, lights, img, mask_img
    [, depth_img]) → (state, metrics), with the whole view batch given to
    every rank.  Each rank runs the port's loss on its views
    (`make_shardmap_grad_fn`), then `apply_update` on the reduced gradients,
    with no host read: every rank sees the same gradients, so the guard
    decides alike everywhere and the parameters and Adam state stay
    bitwise identical across ranks.  The state is updated in place."""
    return _step_from(make_shardmap_grad_fn(settings, cfg, schedule, mesh))


def make_sharded_train_step(settings: RasterSettings, cfg: TrainConfig,
                            schedule: AnnealSchedule,
                            mesh: ViewMesh) -> Callable:
    """The train step with the camera and light batches placed by
    `shard_views` (every leaf whose leading dimension the mesh size
    divides is split), then reduced as `make_shardmap_train_step` reduces
    it.  dss_tpu's takes a jitted single-device step and lets GSPMD
    partition it; torch has no such partitioner, so this one is built on
    the same explicit all-reduce."""
    return _step_from(_grad_fn(settings, cfg, schedule, mesh,
                               by_view_count=False))


def _step_from(grad_fn: Callable) -> Callable:
    def step(state: TrainState, cameras, lights, img, mask_img,
             depth_img=None):
        grads, total, parts, new_filters = grad_fn(
            state.params, state.filters, cameras, lights, img, mask_img,
            state.step, depth_img)
        return apply_update(state, grads, total, parts, new_filters)

    return step


def render_view_row_sharded(points, normals, colors, mask, camera, lights,
                            settings: RasterSettings, mesh: ViewMesh):
    """One view with its image rows split over the mesh: each rank renders
    its slab of S / n rows through the reference backend, then the slabs
    are all-gathered and `visible` is OR-ed.  Points are replicated.
    Returns (rgba (S, S, 4), visible (P,)) on every rank.  Forward only:
    the occupancy gradient of a slab is not defined (render/rasterizer.py)."""
    from dss_tpu_torch.render.renderer import render_single_view

    n = mesh.size
    s = settings.image_size
    if s % n:
        raise ValueError(f"{s} rows do not split over {n} ranks")
    rows = s // n
    r0 = _member(mesh) * rows
    rgba, _, visible = render_single_view(
        points, normals, colors, mask, camera, lights,
        settings.replace(backend="reference"), row_chunk=rows,
        row_window=(r0, r0 + rows))
    slabs = [torch.empty_like(rgba) for _ in range(n)]
    dist.all_gather(slabs, rgba.detach().contiguous(), group=mesh.group)
    seen = _all_reduce(visible.to(torch.int32), mesh, dist.ReduceOp.MAX) > 0
    return torch.cat(slabs), seen
