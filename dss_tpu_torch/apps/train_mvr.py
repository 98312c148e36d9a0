"""Multi-view inverse-rendering training CLI (counterpart of
dss_tpu/apps/train_mvr.py).

Config load, dataset, icosphere initial cloud, per-group Adam with
milestones, checkpoint and resume, an epoch loop over view mini-batches,
periodic evaluation (mask IoU, PSNR, chamfer to the ground-truth cloud)
with a best-model checkpoint, dead-point pruning (`--prune-every`),
coverage reseeding (`--reseed-every`: floaters and inactive slots respawn
at silhouette-coverage deficits, `reseed_event`), and `--exit-after`
time-limited runs.

    python3 -m dss_tpu_torch.apps.train_mvr --config configs/dss_depth.yml \\
        --data-dir <dataset>

It trains on the CUDA card by default (`--device cpu` runs on the CPU).
Where it differs from the JAX CLI:

- the whole dataset is uploaded to the device once and each batch is
  gathered there, `epoch_idx[state.step % steps_per_epoch]` of a
  ViewSampler re-seeded at start, as the JAX loop picks it, so a resumed
  run takes the same batches in both packages;
- `--steps-per-dispatch` k (the JAX CLI's default and rule): on a CUDA
  card each dispatch replays a captured CUDA graph of the train step k
  times (`trainer.make_train_window`), where the JAX CLI runs one
  `lax.scan` program; on the CPU the same window runs eagerly;
- `--device` replaces `--platform`; `--profile-dir` writes a
  torch.profiler trace of the dispatches from iteration 10 to 15
  (`trace.json`) and turns utils/spans on for the whole run: the train
  step's device spans of the traced iterations go to `spans.json` beside
  it, and each log line carries `span_<name>_ms`, the mean ms per step of
  each span over the steps since the last line;
- the point animation is written as HTML only (no GIF).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from dss_tpu_torch import config as config_mod
from dss_tpu_torch.data.dataset import ViewSampler
from dss_tpu_torch.data.io import save_ply
from dss_tpu_torch.models.point_model import (
    point_model_forward,
    prune_dead_points,
    prune_outside_silhouette,
    render_model,
)
from dss_tpu_torch.models.reseed import reseed_coverage
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.training.checkpoint import CheckpointIO
from dss_tpu_torch.training.losses import iou_loss
from dss_tpu_torch.training.trainer import (
    COUNTS,
    chamfer_distance,
    create_train_state,
    make_train_window,
    psnr,
    steps_per_dispatch,
    take_views,
)
from dss_tpu_torch.utils import spans
from dss_tpu_torch.utils.spans import span_ms
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.logging import MetricsLogger, get_logger

logger = get_logger("train_mvr")


def resize_masks_nearest(masks: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W) masks resized to (B, size, size) as jax.image.resize's
    "nearest" does: half-pixel centres, src = floor((i + 0.5)·in/out),
    which is interpolate's "nearest-exact" ("nearest" takes floor(i·in/out)
    and picks the other pixel of each pair at a 2× downsample)."""
    return torch.nn.functional.interpolate(
        masks[:, None], size=(size, size), mode="nearest-exact")[:, 0]


def reseed_event(state, cameras, masks, settings, reseed_max: int = 64,
                 reseed_views: int = 16):
    """One `--reseed-every` event: respawn donor points at
    silhouette-coverage deficits.  The donors are the floaters (active
    points outside the silhouette in > 9% of the views) first, then the
    inactive slots; `reseed_views` evenly spaced views of `cameras` and
    `masks` (all of the dataset's, on the state's device) are rendered with
    the floaters off, and up to `reseed_max` donors move to the proposals of
    `reseed_coverage`, with the normal and colour of their nearest active
    point, and become active.  P stays the same.

    The rows are written into the parameter tensors in place: the Adam
    state is keyed by those tensors, and a new tensor would orphan it.
    `exp_avg` and `exp_avg_sq` of the moved rows are set to 0 and `step`
    is left alone, as the JAX CLI zeroes optax's mu and nu rows and keeps
    its count.  Returns (state, number reseeded)."""
    dev = state.params.points.device
    points = state.params.points.detach()
    keep = prune_outside_silhouette(points, cameras, masks).cpu().numpy()
    act = state.filters.activation.cpu().numpy().copy()
    donors = np.concatenate([np.nonzero(act & ~keep)[0], np.nonzero(~act)[0]])
    if donors.size == 0:
        logger.info("reseed: no donors (no floaters/inactive)")
        return state, 0
    n_views = masks.shape[0]
    vsel = torch.as_tensor(np.unique(np.linspace(
        0, n_views - 1, min(reseed_views, n_views)).round().astype(int)),
        device=dev)
    cams_v = take_views(cameras, vsel)
    render_act = torch.as_tensor(act & keep, device=dev)
    alpha = render_model(
        state.params, dataclasses.replace(state.filters, activation=render_act),
        cams_v, None, settings)[..., 3]
    proposals, near = reseed_coverage(
        points, render_act, cams_v, masks[vsel], alpha,
        n_new=min(reseed_max, donors.size))
    k_new = proposals.shape[0]
    if k_new == 0:
        logger.info("reseed: no coverage deficit found")
        return state, 0
    rows = torch.as_tensor(donors[:k_new], device=dev)
    near = torch.as_tensor(near.astype(np.int64), device=dev)
    with torch.no_grad():
        pts, nrm, col = point_leaves = state.params.tensors()[:3]
        pts[rows] = torch.as_tensor(proposals, device=dev)
        nrm[rows] = nrm[near]
        col[rows] = col[near]
        for t in point_leaves:
            st = state.optimizer.state.get(t, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key][rows] = 0.0
    act[donors[:k_new]] = True
    state.filters = dataclasses.replace(
        state.filters, activation=torch.as_tensor(act, device=dev))
    logger.info("reseeded %d points into coverage deficits (%d donor "
                "floaters/inactive available)", k_new, donors.size)
    return state, k_new


def main(argv=None):
    try:
        return _main(argv)
    finally:
        spans.disable()


def _main(argv):
    parser = argparse.ArgumentParser(
        description="Train dss_tpu_torch multi-view inverse rendering")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--exit-after", type=int, default=-1,
                        help="checkpoint and exit(3) after this many seconds")
    parser.add_argument("--max-iters", type=int, default=-1)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations "
                             "10-15 into this directory (trace.json), with "
                             "the train step's device spans (spans.json); "
                             "spans are on for the whole run and logged as "
                             "span_<name>_ms")
    parser.add_argument("--view-weights", type=str, default=None,
                        help=".npy of per-view sampling weights (len = "
                             "#views); default uniform")
    parser.add_argument("--prune-every", type=int, default=-1,
                        help="drop dead points (exactly zero silhouette "
                             "gradient) every N iterations")
    parser.add_argument("--reseed-every", type=int, default=-1,
                        help="every N iterations respawn floater and "
                             "inactive points at silhouette-coverage "
                             "deficits (GT-free hull carving, "
                             "models.reseed)")
    parser.add_argument("--reseed-max", type=int, default=64,
                        help="max points respawned per reseed event")
    parser.add_argument("--reseed-views", type=int, default=16,
                        help="views rendered at each reseed event")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="override cfg data.data_dir")
    parser.add_argument("--name", type=str, default=None,
                        help="override cfg name (output subdirectory)")
    parser.add_argument("--steps-per-dispatch", type=int, default=-1,
                        help="run N train steps per dispatch (on a CUDA "
                             "card, N replays of one captured CUDA graph). "
                             "-1 = auto (largest divisor of steps_per_epoch "
                             "<= print_every); 1 = one step per dispatch")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    t_start = time.time()
    cfg = config_mod.load_config(args.config)
    if args.data_dir is not None:
        cfg["data"]["data_dir"] = args.data_dir
    if args.name is not None:
        cfg["name"] = args.name
    out_dir = os.path.join(cfg["training"]["out_dir"], cfg["name"])
    os.makedirs(out_dir, exist_ok=True)
    config_mod.save_config(cfg, os.path.join(out_dir, "config.yaml"))
    mlog = MetricsLogger(out_dir)

    # Data ------------------------------------------------------------------
    # Depth supervision needs the dense depth maps and a depth-carrying
    # render path, both wired from lambda_dr_depth: the lean weighted-depth
    # channel by default, the fragment zbuf when the config sets
    # lean_fragments: false.
    use_depth = float(cfg["training"].get("lambda_dr_depth", 0.0)) > 0
    if use_depth:
        cfg["data"]["load_dense_depth"] = True
        rp = cfg["renderer"]["raster_params"]
        if rp.get("lean_fragments", True):
            rp.setdefault("depth_channel", True)
    dataset = config_mod.create_dataset(cfg)
    logger.info("dataset: %d views at %s", len(dataset), dataset.resolution)

    # Model -----------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    params, learn = config_mod.create_model_params(cfg, rng, device=device)
    settings = config_mod.create_raster_settings(cfg)
    tcfg = config_mod.create_train_config(cfg)
    schedule = config_mod.create_anneal_schedule(cfg)
    batch_size = int(cfg["training"]["batch_size"])
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    optimizer = config_mod.create_optimizer(
        cfg, params, learn, steps_per_epoch=steps_per_epoch
    )
    state = create_train_state(params, optimizer)

    # Resume ----------------------------------------------------------------
    ckpt = CheckpointIO(out_dir)
    resume_name = cfg["training"].get("resume_from", "model.npz")
    epoch_it, it = 0, 0
    metric_best = float("inf")
    try:
        state, scalars = ckpt.load(resume_name, state)
        epoch_it = int(scalars.get("epoch_it", 0))
        it = int(scalars.get("it", 0))
        metric_best = float(scalars.get("loss_val_best", float("inf")))
        logger.info("resumed from %s at it=%d", resume_name, it)
    except FileNotFoundError:
        pass

    # The whole dataset lives on the device; each step gathers its batch
    # there from the epoch's index table.
    all_img = torch.as_tensor(dataset.images, device=device)
    all_mask = torch.as_tensor(dataset.masks, device=device)
    all_depth = (torch.as_tensor(dataset.depths, device=device)
                 if use_depth else None)
    all_cams = dataset.get_cameras(None, device=device)
    all_lights = dataset.get_lights(None, device=device)

    # Per-view sampling weights: optional .npy with one weight per view.
    view_weights = None
    if args.view_weights:
        view_weights = np.load(args.view_weights)
        if view_weights.shape != (len(dataset),):
            raise ValueError(
                f"--view-weights must have shape ({len(dataset)},), "
                f"got {view_weights.shape}"
            )
    sampler = ViewSampler(
        len(dataset), batch_size, seed=args.seed, weights=view_weights
    )
    print_every = int(cfg["training"].get("print_every", 10))
    ckpt_every = int(cfg["training"].get("checkpoint_every", 500))
    validate_every = int(cfg["training"].get("validate_every", 500))
    visualize_every = int(cfg["training"].get("visualize_every", -1))
    k_disp = steps_per_dispatch(args.steps_per_dispatch, steps_per_epoch,
                                print_every)
    if args.profile_dir:
        spans.enable()  # before the window captures its graph
    window = make_train_window(settings, tcfg, schedule, state, all_cams,
                               all_lights, all_img, all_mask, all_depth,
                               graph=device.type == "cuda")
    logger.info("%d train step%s per dispatch, %s", k_disp,
                "s" if k_disp > 1 else "",
                "each a CUDA graph replay" if window.graph else "eager")
    prof, prof_done = None, False
    span_next = span_prof = 0  # the spans' step indices: logged, traced
    last_print_it = it
    # the COUNTS of the dispatches since the last log read, summed on the
    # device (a window call returns its own dispatch's only)
    counts = {}
    vis_frames, vis_names = [], []  # cloud snapshots → vis/points_animation

    gt_points, gt_normals, _ = dataset.get_pointclouds()
    gt_points_dev = (None if gt_points is None
                     else torch.as_tensor(gt_points, device=device))
    gt_normals_dev = (None if gt_normals is None
                      else torch.as_tensor(gt_normals, device=device))

    # A fixed validation batch (the first views) for the image-space eval.
    val_idx = np.arange(min(batch_size, len(dataset)))
    val_img, val_mask, val_cams, val_lights = dataset.get_batch(val_idx, device)
    val_img = torch.as_tensor(val_img, device=device)
    val_mask = torch.as_tensor(val_mask, device=device)
    # The dataset's background colour (per channel, over the pixels outside
    # the GT mask): the PSNR composites the prediction over it, so that it
    # measures the object, not the background convention; 0 for a black
    # background.
    _out = 1.0 - val_mask[..., None]
    val_bg = torch.sum(val_img * _out, dim=(0, 1, 2)) / torch.clamp(
        torch.sum(_out, dim=(0, 1, 2)), min=1.0
    )

    @torch.no_grad()
    def evaluate(state):
        out = {}
        pred, _ = point_model_forward(
            state.params, state.filters, val_cams, val_lights, settings
        )
        rgb_pred, mask_pred = pred["img_pred"], pred["mask_img_pred"]
        out["iou_loss"] = float(iou_loss(mask_pred, val_mask))
        rgb_comp = rgb_pred + (1.0 - mask_pred[..., None]) * val_bg
        out["psnr"] = float(psnr(rgb_comp, val_img))
        if gt_points is None:
            return out
        cd, cn = chamfer_distance(
            gt_points_dev,
            state.params.points.detach(),
            gt_normals_dev,
            state.params.normals.detach(),
            y_mask=state.filters.activation,
        )
        out["chamfer_point"] = float(cd)
        if cn is not None:
            out["chamfer_normal"] = float(cn)
        return out

    # Train loop -------------------------------------------------------------
    # --max-iters is the authoritative stop; widen the epoch range so the
    # --epochs cap cannot end a resumed run short of it.
    if args.max_iters > 0:
        needed = epoch_it + -(-max(args.max_iters - it, 0) // steps_per_epoch) + 1
        args.epochs = max(args.epochs, needed)
    t_iter = time.time()
    stop = False
    epoch = epoch_it
    for epoch in range(epoch_it, args.epochs):
        if stop:
            break
        epoch_np = sampler.epoch_batches()
        # the batch is epoch_idx[state.step % steps]: that phase matches the
        # loop only while epochs have this constant length
        assert epoch_np.shape[0] == steps_per_epoch, (
            f"sampler epoch length {epoch_np.shape[0]} != steps_per_epoch "
            f"{steps_per_epoch} used for the LR schedule"
        )
        epoch_idx = torch.as_tensor(epoch_np, device=device)  # one upload
        for _ in range(steps_per_epoch // k_disp):
            if args.profile_dir and prof is None and not prof_done and it >= 10:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                span_prof = spans.begun(device)
                prof.start()
            state, metrics = window(state, epoch_idx, k_disp)
            for k in COUNTS:
                if k in metrics:
                    counts[k] = (counts[k] + metrics[k] if k in counts
                                 else metrics[k].clone())
            prev_it = it
            it += k_disp
            # state.step is the host mirror of the window's device step
            # (k per dispatch, skipped steps included): the last batch of
            # the dispatch, for the prune
            batch_idx = epoch_np[(state.step - 1) % steps_per_epoch]
            if prof is not None and it >= 15:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                path = os.path.join(args.profile_dir, "trace.json")
                prof.export_chrome_trace(path)
                record = spans.read(first=span_prof, device=device)
                record["steps"] = [{"index": st["index"], "spans": [
                    s._asdict() for s in st["spans"]]}
                    for st in record["steps"]]
                with open(os.path.join(args.profile_dir, "spans.json"),
                          "w") as f:
                    json.dump(record, f)
                prof, prof_done = None, True
                logger.info("profiler trace written to %s, the steps' spans "
                            "beside it", path)

            def crossed(period):
                return period > 0 and (it // period) > (prev_it // period)

            if crossed(print_every):
                n_new = it - last_print_it
                dt = (time.time() - t_iter) / n_new
                last_print_it = it
                t_iter = time.time()
                with spans.host("train.log_read"):
                    scalars = {k: float(v) for k, v in
                               {**metrics, **counts}.items() if v.ndim == 0}
                    counts = {}
                    # the binning's tiles that outgrew shared memory since
                    # the last line (the kernels' own counter)
                    scalars["bin_long_tiles"] = float(
                        kernels.read_bin_long_tiles(device))
                    if spans.enabled():
                        # the steps of this line's iterations (the ring
                        # also holds the capture's eager warm-up steps)
                        record = spans.read(first=span_next, device=device)
                        span_next = record["next"]
                        scalars.update(span_ms(record["steps"][-n_new:]))
                mlog.log(it, {**scalars, "sec_per_iter": dt})
                logger.info(
                    "epoch %d it %d loss %.5f (%.3fs/it)",
                    epoch, it, scalars.get("loss", float("nan")), dt,
                )
                # nonzero: the static binning budgets (bin_capacity /
                # max_tiles_per_splat / pair caps) dropped candidates in the
                # steps since the last line, and with them fragments or
                # silhouette gradients
                if scalars.get("bin_overflow", 0.0) > 0:
                    logger.warning(
                        "bin_overflow=%d in the %d steps to it %d: binning "
                        "budgets dropped candidates — raise bin_capacity/"
                        "max_tiles_per_splat/pair_cap or gradients will "
                        "silently degrade",
                        int(scalars["bin_overflow"]), n_new, it,
                    )
                # nonzero: some tiles of the binning held more candidates
                # than shared memory sorts, and took the kernels' slower
                # device-memory path (the tables are the same)
                if scalars["bin_long_tiles"] > 0:
                    logger.info(
                        "bin_long_tiles=%d since the last line: concentrated "
                        "tiles took the binning's device-memory sort",
                        int(scalars["bin_long_tiles"]))
                # nonzero: in the steps since the last line the normal
                # anchor's target was not finite at that many active points
                # (a singular jet system), and the NaN guard skipped those
                # steps' updates
                if scalars.get("anchor_nonfinite", 0.0) > 0:
                    logger.warning(
                        "anchor_nonfinite=%d in the %d steps to it %d: the "
                        "normal anchor's target was not finite and the NaN "
                        "guard skipped their updates",
                        int(scalars["anchor_nonfinite"]), n_new, it,
                    )

            if crossed(args.prune_every):
                # checkpoint first, as the JAX CLI does
                ckpt.save(resume_name, state, epoch_it=epoch, it=it,
                          loss_val_best=metric_best)
                # the zero-gradient test at half resolution, on the batch
                # just trained
                prune_settings = settings.replace(
                    image_size=max(64, settings.image_size // 2))
                idx = torch.as_tensor(batch_idx, device=device)
                small = resize_masks_nearest(all_mask[idx],
                                             prune_settings.image_size)
                active = prune_dead_points(
                    state.params, state.filters, take_views(all_cams, idx),
                    prune_settings, small) & state.filters.activation
                n_active = int(active.sum())
                state.filters = dataclasses.replace(state.filters,
                                                    activation=active)
                logger.info("pruned to %d active points", n_active)
                mlog.log(it, {"n_active_points": float(n_active)})

            if crossed(args.reseed_every):
                # checkpoint first, as the JAX CLI does
                ckpt.save(resume_name, state, epoch_it=epoch, it=it,
                          loss_val_best=metric_best)
                state, k_new = reseed_event(state, all_cams, all_mask,
                                            settings, args.reseed_max,
                                            args.reseed_views)
                if k_new:
                    mlog.log(it, {"n_reseeded": float(k_new)})

            if crossed(visualize_every):
                act = state.filters.activation.cpu().numpy()
                vis_frames.append(
                    state.params.points.detach().cpu().numpy()[act])
                vis_names.append(f"it {it}")

            if crossed(validate_every):
                with spans.host("train.eval"):
                    eval_dict = evaluate(state)
                if eval_dict:
                    mlog.log(it, {("val/" + k): v for k, v in eval_dict.items()})
                    logger.info("eval %s", eval_dict)
                    metric = eval_dict.get("chamfer_point", float("inf"))
                    if metric < metric_best:
                        metric_best = metric
                        ckpt.save("model_best.npz", state, epoch_it=epoch, it=it,
                                  loss_val_best=metric_best)

            if crossed(ckpt_every):
                with spans.host("train.checkpoint"):
                    ckpt.save(resume_name, state, epoch_it=epoch, it=it,
                              loss_val_best=metric_best)

            if args.exit_after > 0 and time.time() - t_start > args.exit_after:
                logger.info("exit-after reached; checkpointing and exiting(3)")
                ckpt.save(resume_name, state, epoch_it=epoch, it=it,
                          loss_val_best=metric_best)
                raise SystemExit(3)

            if args.max_iters > 0 and it >= args.max_iters:
                stop = True
                break

    # Final artifacts ---------------------------------------------------------
    ckpt.save(resume_name, state, epoch_it=epoch, it=it,
              loss_val_best=metric_best)
    active = state.filters.activation.cpu().numpy()
    points = state.params.points.detach().cpu().numpy()
    save_ply(
        os.path.join(out_dir, cfg["training"].get("point_file", "shape_pts.ply")),
        points[active],
        normals=state.params.normals.detach().cpu().numpy()[active],
    )
    if vis_frames:
        from dss_tpu_torch.utils.visualize import animate_points

        vis_frames.append(points[active])
        vis_names.append(f"it {it} (final)")
        animate_points(
            vis_frames,
            names=vis_names,
            save_html=os.path.join(out_dir, "vis", "points_animation.html"),
            title=cfg.get("name", "dss_tpu_torch training"),
        )
        logger.info("wrote %s", os.path.join(out_dir, "vis"))
    mlog.close()
    logger.info("done: %d iters, best chamfer %.6f", it, metric_best)
    return state


if __name__ == "__main__":
    main()
