"""View-parallel training on one host: spawn n processes, join them in a
torch.distributed group and run the sharded train step on a case
(`run_case`); the dry run (counterpart of
__graft_entry__.py::dryrun_multichip) does so on tiny shapes:

    python3 -c "from dss_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

The processes rendezvous through a file in a temporary directory (no TCP
port), use gloo on the CPU unless told otherwise, and are joined with a
timeout: a hung rendezvous or collective fails the run instead of waiting.
The workers live in this module, so a spawned child imports torch and
dss_tpu_torch only.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dss_tpu_torch.utils.device import resolve_device

# The tiny case: views (a multiple of the ranks), image size, points.
CASE = dict(n_views=4, image_size=16, n_points=256)
RASTER = dict(points_per_pixel=3, backend="pallas", tile_size=8)
TRAIN = dict(lambda_proj=0.01, lambda_repel=0.01)


def _rank_main(rank: int, n: int, backend: str, device: str,
               init_file: str, timeout: float, fn: Callable,
               args: tuple) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method="file://" + init_file, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args: tuple = (), backend: str = "gloo",
              device=None, timeout: float = 300.0,
              store_dir: Optional[str] = None) -> None:
    """Run fn(rank, n, *args) in n spawned processes joined in one process
    group (`backend`; each process's current CUDA device is `device` when
    it is one: cuda:0 by default, device="cpu" for the CPU), rendezvous
    through a file in a new temporary directory under `store_dir`.  fn
    must be importable by name.  Raises the first worker's exception, or
    TimeoutError (after killing the workers) if they are not all done
    within `timeout` seconds."""
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ctx = mp.spawn(_rank_main,
                       args=(n, backend, device,
                             os.path.join(tmp, "rendezvous"), timeout, fn,
                             args),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{n} {backend} ranks not done after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)


def dryrun_case(n_views: int, image_size: int, n_points: int,
                seed: int = 0) -> dict:
    """The dry run's inputs as numpy: a cloud sampled from a sphere of
    radius 0.5 (points, normals, colours 0.5), n_views look-at cameras at
    distance 2 (R, T; fov 60), targets of colour 0.3 and a centred square
    mask."""
    from dss_tpu_torch.geometry.cameras import look_at_view_transform
    from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh

    verts, faces = ico_sphere(level=3, radius=0.5)
    pts, normals = sample_points_from_mesh(verts, faces, n_points,
                                           rng=np.random.default_rng(seed))
    r, t = look_at_view_transform(
        dist=torch.full((n_views,), 2.0),
        elev=torch.linspace(-30.0, 30.0, n_views),
        azim=torch.linspace(0.0, 315.0, n_views))
    s = image_size
    mask = np.zeros((n_views, s, s), np.float32)
    mask[:, s // 4:3 * s // 4, s // 4:3 * s // 4] = 1.0
    return dict(points=pts, normals=normals,
                colors=np.full_like(pts, 0.5), R=r.numpy(), T=t.numpy(),
                img=np.full((n_views, s, s, 3), 0.3, np.float32), mask=mask)


def _flat_state(state) -> torch.Tensor:
    """The parameters and Adam moments of a TrainState in one vector."""
    parts = [t.detach().reshape(-1) for t in state.params.tensors()]
    for t in state.params.tensors():
        st = state.optimizer.state.get(t, {})
        parts += [st[k].reshape(-1) for k in ("exp_avg", "exp_avg_sq")
                  if k in st]
    return torch.cat(parts)


def _same_on_all_ranks(x: torch.Tensor, n: int) -> bool:
    got = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(got, x.contiguous())
    return all(torch.equal(g, got[0]) for g in got)


def _case_worker(rank: int, n: int, device: str, case_path: str,
                 out_dir: str, raster: dict, train: dict, schedule: dict,
                 opt: dict, steps: int) -> None:
    """One rank of `run_case`."""
    from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.parallel.mesh import (
        make_mesh,
        make_shardmap_grad_fn,
        make_shardmap_train_step,
        make_sharded_train_step,
        render_view_row_sharded,
        replicate,
    )
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.render.lighting import DirectionalLights
    from dss_tpu_torch.training.trainer import (
        AnnealSchedule,
        TrainConfig,
        create_train_state,
        make_optimizer,
    )

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with np.load(case_path) as f:
        c = {k: torch.as_tensor(f[k], device=dev) for k in f.files}
    group = lambda pre: {k[len(pre):]: v for k, v in c.items()
                         if k.startswith(pre)}
    cams = FoVPerspectiveCameras(**group("cam/"))
    lights = DirectionalLights(**group("lights/")) if group("lights/") else None
    img, mask, depth = c["img"], c["mask"], c.get("depth")
    n_points = c["points"].shape[0]
    kernels.reset_launch_counts()

    mesh = make_mesh(n)
    if mesh.shape["views"] != n:
        raise AssertionError(f"mesh of {mesh.shape['views']} ranks, not {n}")
    try:
        make_mesh(n + 1)
    except ValueError:
        pass
    else:
        raise AssertionError(f"make_mesh({n + 1}) did not refuse {n} ranks")
    settings = RasterSettings(**raster)
    cfg, sched = TrainConfig(**train), AnnealSchedule(**schedule)

    def fresh():
        return replicate(PointModelParams.create(
            c["points"], c["normals"], c["colors"], device=dev), mesh)

    params = fresh()
    p0 = params.points.detach().clone()
    grads, total, parts, nf = make_shardmap_grad_fn(settings, cfg, sched, mesh)(
        params, PointFilters.ones(n_points, device=dev), cams, lights, img,
        mask, 0, depth)

    # Adam through the step, timed, then a step whose last view (on the
    # last rank) has a NaN mask, which every rank must skip.
    state = create_train_state(params, make_optimizer(params, **opt))
    step = make_shardmap_train_step(settings, cfg, sched, mesh)
    times, losses = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, cams, lights, img, mask, depth)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    after = _flat_state(state).clone()
    bad = mask.clone()
    bad[-1] = float("nan")
    state, m_nan = step(state, cams, lights, img, bad, depth)
    skipped = bool(not m_nan["params_finite"]) and torch.equal(
        _flat_state(state), after)
    same = _same_on_all_ranks(after, n) and _same_on_all_ranks(
        torch.cat([g.reshape(-1) for g in grads]), n)

    gp = fresh()
    gs = create_train_state(gp, make_optimizer(gp, **opt))
    _, mg = make_sharded_train_step(settings, cfg, sched, mesh)(
        gs, cams, lights, img, mask, depth)
    cam0 = FoVPerspectiveCameras(**{k: v[:1] for k, v in group("cam/").items()})
    lights0 = (None if lights is None else
               DirectionalLights(**{k: v[:1] for k, v in group("lights/").items()}))
    with torch.no_grad():
        rgba, visible = render_view_row_sharded(
            p0, c["normals"], c["colors"],
            torch.ones(n_points, dtype=torch.bool, device=dev), cam0, lights0,
            settings, mesh)
    launches = kernels.launch_counts()

    loss = losses[0]
    moved = float((after[:p0.numel()] - p0.reshape(-1)).abs().max()) > 0
    agree = lambda a: abs(a - loss) <= 1e-6 * max(abs(loss), 1.0)
    if not (np.isfinite(losses).all() and agree(float(total))
            and agree(float(mg["loss"])) and skipped and same and moved):
        raise AssertionError(
            f"rank {rank}: losses {losses} (grad fn {float(total)}, sharded "
            f"step {float(mg['loss'])}), parameters moved {moved}, NaN step "
            f"skipped {skipped}, ranks identical {same}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             grads=np.stack([g.cpu().numpy() for g in grads]),
             total=total.cpu().numpy(),
             bin_overflow=parts["bin_overflow"].cpu().numpy(),
             visibility=nf.visibility.cpu().numpy(),
             inmask=nf.inmask.cpu().numpy(),
             state=after.cpu().numpy(), rgba=rgba.cpu().numpy(),
             visible=visible.cpu().numpy(), step_ms=np.asarray(times),
             losses=np.asarray(losses),
             launches=np.asarray([launches[k] for k in sorted(launches)]),
             launch_names=np.asarray(sorted(launches)),
             backend=np.asarray(dist.get_backend()))


def run_case(case: dict, n: int, out_dir: str, device=None,
             backend: str = "gloo", raster: Optional[dict] = None,
             train: Optional[dict] = None, schedule: Optional[dict] = None,
             opt: Optional[dict] = None, steps: int = 1,
             timeout: float = 300.0) -> list:
    """Run the view-sharded train step on `case` over n spawned ranks.

    `case` holds numpy arrays: points, normals, colors (P, 3), img
    (V, S, S, 3), mask (V, S, S), optionally depth (V, S, S), the cameras'
    fields as cam/<field> and a DirectionalLights' as lights/<field>, each
    with its leading view axis; the ranks run on `device` (cuda:0 by
    default, device="cpu" for the CPU); raster, train, schedule and opt
    are the RasterSettings, TrainConfig, AnnealSchedule and make_optimizer
    keyword arguments.  Each rank computes the distributed gradients
    (`make_shardmap_grad_fn`), takes `steps` timed Adam steps of
    `make_shardmap_train_step`, then a step with a NaN in the last view's
    mask (on the last rank), which every rank must skip, takes one step of
    `make_sharded_train_step` from the same start (the same loss), and
    renders view 0 with `render_view_row_sharded`.  A rank raises unless
    the losses are finite, the parameters moved, the NaN step left the
    parameters and Adam state untouched, and the parameters, Adam state
    and gradients are bitwise equal across ranks; it writes its results
    (gradients, loss, filters, the state after the timed steps, the row
    render, step times, the kernel launches of the whole run) to
    out_dir/rank<r>.npz.  Returns the ranks' results as dicts."""
    device = str(resolve_device(device))
    path = os.path.join(out_dir, "case.npz")
    np.savez(path, **case)
    run_ranks(_case_worker, n,
              (device, path, out_dir, raster or {}, train or {},
               schedule or {}, opt or {}, steps),
              backend=backend, device=device, timeout=timeout,
              store_dir=out_dir)
    out = []
    for r in range(n):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def dryrun_multichip(n_devices: int = 2, device: str = "cpu",
                     backend: str = "gloo", out_dir: Optional[str] = None,
                     timeout: float = 300.0) -> list:
    """Spawn n_devices ranks and run `run_case` on the tiny case (CASE: 4
    views of 16², 256 points; the lean tile-binned path, λ_proj = λ_repel
    = 0.01; fov 60).  The ranks' results go to `out_dir` (a temporary
    directory by default) and are returned."""
    c = dryrun_case(**CASE)
    from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras

    cams = FoVPerspectiveCameras.create(c["R"], c["T"], fov=60.0, device="cpu")
    case = {k: c[k] for k in ("points", "normals", "colors", "img", "mask")}
    case.update({f"cam/{f.name}": getattr(cams, f.name).numpy()
                 for f in dataclasses.fields(cams)})
    raster = dict(image_size=CASE["image_size"], **RASTER)
    with tempfile.TemporaryDirectory() as tmp:
        res = run_case(case, n_devices, out_dir or tmp, device=device,
                       backend=backend, raster=raster, train=TRAIN,
                       timeout=timeout)
    print(f"dryrun_multichip: {n_devices} ranks ({backend}, {device}): loss "
          f"{float(res[0]['losses'][0]):.6f}, NaN step skipped on every "
          f"rank, parameters, Adam state and gradients bitwise equal across "
          f"ranks")
    return res
