"""Smoke run of dss_tpu_torch on one CUDA card: build the splat kernels
and the 3×3 eigensolver, hold each against its plain PyTorch version at
the flagship shapes (with its time, its least possible time from this
run's bytes and (pixel, candidate) pairs, and its library counterpart
where there is one): K1, K2, K3 and K5 with the scatter to points fused
into their epilogues, K4 on the fragment path's zbuf scatter, symeig3 on
the flagship cloud's 8-NN covariances, 10⁶ random SPD matrices and
hand-made planar, line-like, zero and NaN rows (also against
torch.linalg.eigh), the fused exact kNN at the benchmark cells' four
shapes (distances bit-equal, with its time and bound), and the train
window's guard and update on the neural cell's 18 leaves and the
flagship's 3 (bit-equal to the composite, with their times and bounds),
and the render's set-up kernels at the flagship's shapes with three point
lights a view (bit-equal to their plain versions, with their times,
bounds and the composite's time per step).  Hold K2 on a table of pixels exactly on the disc's
and the box's edges, K1, K3 and K5 on the edge tables of their shared
sub-tile cull, and K4 on the edge cases of its warp merge; check the
camera on the
card against the CPU, then drive the flagship train step
(configs/dss_depth.yml: 512² images, 5000 points, 8 views per step, K=5,
Vrk_invariant) through `make_train_step` on both of its paths, 1 warm-up
step and 5 timed steps each:

- the lean path (K1–K3; no K4), with depth L1 on the weighted-depth
  channel;
- the fragment path (`lean_fragments: false`; K5, K2, K3, and K4 once per
  step for the zbuf scatter), with depth L1 on the nearest fragment's z
  (zbuf[..., 0]).

Then the same recipe through the train window (`window`, on both paths):
`make_train_window` captures the step as a CUDA graph and replays it once
per step, held against the window run eagerly and against
make_train_step (losses, states, a NaN batch skipped, launches per
replay, ms per step; on the lean path also with the grid kNN), and then
on the two recipes that run the eigensolver every step: the anisotropic
Vrk and the PCA normal anchor (λ_normal 0.1, k 8).

Then the train CLI from a config file (`train_cli`): the dataset twin
renders 16 views of a 20,000-point sphere at 512² on the card and writes
them (PNG, npz, YAML), and `dss_tpu_torch.apps.train_mvr` trains on them
from a config that inherits configs/dss_depth.yml: 12 iterations (auto
--steps-per-dispatch, 2), a resume to 16, 12 iterations at
--steps-per-dispatch 1, and 4 iterations with `lean_fragments: false`,
with evals and checkpoints every 4 iterations.

Then the render entry points and multi-scene training: `bench` (the
port's bench harness at bench.py's shape, K1–K3 once per iteration),
`single_view` (`render_single_view` on the lean and fragment paths against
view 0 of `render_views`, and the turntable CLI: 8 frames at 512²),
`multiscene` (train_multiscene at 4 scenes × 25,000 points × 8 views ×
512²: folded, one K1, K2 and K3 per step; then the per-scene loop, four of
each per step, from the same first loss) and `data_gen` (create_mvr_data on
an ellipsoid mesh and on a faceless 20,000-point cloud of it, K5 once per
view, then train_mvr on the mesh dataset, whose chamfer to the mesh's GT
cloud must fall).  Last, in data_gen's directory, `geometry`:
reseed_coverage on its trained model with a cap switched off (16 views at
512², lean and --use-depth), train_mvr --reseed-every on the grown
checkpoint with injected floaters, denoise_pcl on 20,000 noisy samples of
the ellipsoid (then --upsample), the Poisson and MLS meshers at 96³, and
generate_images.  Then `neural`: a RenderingNetwork neural texture trained
with the points through K1–K3 at the flagship shape (and held, tile-binned
against the reference rasterizer, at 64²), the SDF decoder sphere-traced
at 512², the image filters and the full-width pix2pix generator on the
texture's renders, and image_filter_flow end to end (l0 with and without
its regularisers, pix2pix from the saved .pth, guided, superpixel).
Then `aux`, on data_gen's dataset and model: the per-source gradient
fields (K1–K3 once) and their quiver PNGs, make_result_report (K1 once),
gen_depth_for_dataset on the mesh and the cloud datasets (K5 once per
view) against create_mvr_data's depth maps, and render_sdf's weight
gradient under grad.  Last, `parallel`: the flagship lean train step
sharded over views across ranks spawned on the card (NCCL × 1, gloo × 2)
against the single-process gradients, with the NaN guard and the ranks'
bitwise agreement checked, and a row-sharded render.

    python3 chip_smoke.py

Every phase passes or raises; nothing is caught.  Without a CUDA card it
exits non-zero before printing any result.  The last two lines of standard
output are the per-kernel JSON summary and the device JSON line.
"""
import contextlib
import ctypes.util
import dataclasses
import importlib.util
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

# Flagship values, as the dss_tpu.config factories build them from
# configs/dss_depth.yml with train_mvr's depth wiring (depth_channel on);
# tests/test_torch_train_step.py holds these literals against the YAML.
FLAGSHIP_RASTER = dict(
    image_size=512,
    points_per_pixel=5,
    cutoff_threshold=1.0,
    depth_merging_threshold=0.05,
    antialiasing_sigma=1.0,
    radii_backward_scaler=5.0,
    Vrk_invariant=True,
    Vrk_isotropic=False,
    backface_culling=False,
    clip_pts_grad=0.05,
    tile_size=64,
    bin_capacity=512,
    max_tiles_per_splat=-1,
    depth_channel=True,
)
# The same recipe with `lean_fragments: false`: train_mvr then leaves the
# depth channel off, and the depth loss reads the nearest fragment's z
# (zbuf[..., 0]) from K5's fragment buffers.
FLAGSHIP_FRAG_RASTER = {**FLAGSHIP_RASTER, "lean_fragments": False,
                        "depth_channel": False}
FLAGSHIP_TRAIN = dict(
    lambda_rgb=1.0,
    lambda_silhouette=1.0,
    lambda_proj=0.01,
    lambda_repel=0.1,
    lambda_depth=0.1,
    lambda_normal=0.0,
    knn_k=12,
    filter_scale=2.0,
    sharpness_sigma=0.75,
)
FLAGSHIP_SCHEDULE = dict(
    init_backward_radii=5.0,
    steps_backward_radii=200,
    gamma_backward_radii=0.9,
    limit_backward_radii=1.0,
    steps_proj=-1,
    gamma_proj=5.0,
    limit_proj=1.0,
)
# lr per group; learn_colors is false, so colors get lr 0.  Milestones are
# epochs × steps per epoch (one 8-view batch per epoch here).
FLAGSHIP_OPT = dict(lr_points=0.01, lr_normals=0.01, lr_colors=0.0,
                    milestones=(500, 800), gamma=0.5)
N_POINTS = 5000
N_VIEWS = 8
N_GT_POINTS = 20000
GT_AXES = (0.6, 0.45, 0.5)
ZFAR = 100.0
SEED = 0
TIMED_STEPS = 5
# The window phase: steps per dispatch and timed dispatches.
WINDOW_K, WINDOW_DISPATCHES = 5, 4
# How train states are compared (the window phase's docstring): the
# quantile of |Δ| over all their elements, and its floor.
WINDOW_QUANTILE, WINDOW_ATOL = 0.99, 1e-6
# The graphed step's losses against an eager window's, relative.
WINDOW_LOSS_RTOL = 1e-3
DEV = "cuda"

# What each CUDA kernel replaces in dss_tpu: a Pallas kernel of
# dss_tpu/ops/splat_pallas.py, or (symeig3) XLA's eigh.
KERNEL_TABLE = {
    "fwd_lean": ("dss_tpu_torch/ops/csrc/fwd_lean.cu",
                 "dss_tpu/ops/splat_pallas.py:719"),
    "occ_bwd": ("dss_tpu_torch/ops/csrc/occ_bwd.cu",
                "dss_tpu/ops/splat_pallas.py:1373"),
    "feat_bwd": ("dss_tpu_torch/ops/csrc/feat_bwd.cu",
                 "dss_tpu/ops/splat_pallas.py:1134"),
    "segment_sum": ("dss_tpu_torch/ops/csrc/segment_sum.cu",
                    "dss_tpu/ops/splat_pallas.py:120"),
    "fwd_frag": ("dss_tpu_torch/ops/csrc/fwd_frag.cu",
                 "dss_tpu/ops/splat_pallas.py:584"),
    "symeig3": ("dss_tpu_torch/ops/csrc/symeig3.cu",
                "dss_tpu/geometry/normals.py:46 (jnp.linalg.eigh, XLA; no "
                "Pallas kernel)"),
    "knn_topk": ("dss_tpu_torch/ops/csrc/knn_topk.cu",
                 "dss_tpu/geometry/knn.py:knn_points (a matmul and "
                 "lax.top_k, XLA; no Pallas kernel)"),
    "all_finite": ("dss_tpu_torch/ops/csrc/guarded_adam.cu",
                   "dss_tpu/training/trainer.py:350 (apply_update's "
                   "isfinite guard, XLA; no Pallas kernel)"),
    "guarded_adam": ("dss_tpu_torch/ops/csrc/guarded_adam.cu",
                     "dss_tpu/training/trainer.py:350 (apply_update: "
                     "optax.adam under the guard, XLA; no Pallas kernel)"),
    "prep_fwd": ("dss_tpu_torch/ops/csrc/prep_splats.cu",
                 "dss_tpu/render/ewa.py:prepare_splats and "
                 "render/lighting.py:shade_points (XLA; no Pallas kernel)"),
    "prep_bwd": ("dss_tpu_torch/ops/csrc/prep_splats.cu",
                 "the gradient of dss_tpu/render/ewa.py:prepare_splats' "
                 "projection and of render/lighting.py:shade_points (XLA; "
                 "no Pallas kernel)"),
    "bin_tiles": ("dss_tpu_torch/ops/csrc/bin_tiles.cu",
                  "dss_tpu/ops/splat_pallas.py:bin_splats and "
                  "bin_for_occ_backward (XLA's sort, cumsum and gathers; no "
                  "Pallas kernel)"),
    "median_select": ("dss_tpu_torch/ops/csrc/bin_tiles.cu",
                      "dss_tpu/ops/splat_pallas.py:masked_median (XLA's "
                      "sort; no Pallas kernel)"),
}
# Float operations per (pixel, candidate) pair, as each source's note
# counts them: K2 per pair inside the support disc, K1/K3/K5 per pair
# inside the candidate's box.  K4 is bound by bytes alone.
OPS_PER_PAIR = {"fwd_lean": 26, "occ_bwd": 16, "feat_bwd": 24, "fwd_frag": 24}
# The eigensolver: float operations per Jacobi rotation (symeig3.cu), the
# random SPD batch it is also timed at, and its tolerance against
# torch.linalg.eigh: 4e-6 (~32 float32 eps) of the row's largest |λ| for
# the eigenvalues, 4e-6 / relative gap for the projectors v vᵀ of the
# eigenvectors whose relative gap is at least SYMEIG3_GAP (first-order
# bounds for two backward-stable solvers).
SYMEIG3_ROT_OPS = 43
SYMEIG3_RANDOM = 1_000_000
SYMEIG3_LIB_TOL, SYMEIG3_GAP = 4e-6, 1e-3
# cuSOLVER refuses torch.linalg.eigh of 65,536 or 10⁶ 3×3 matrices in one
# batch (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size query, torch
# 2.11 on the H100; 23,000 pass): the library yardstick goes in batches of
# this many.
EIGH_BATCH = 16384
# The exact kNN: float operations per (query, ref) pair (knn_topk.cu: the
# dot's product and two multiply-adds, |q|² + |r|², the doubling, the
# difference), and the cells' four kNNs (Q = P, k, exclude_self): the
# flagship's Vrk h and build_knn at 5000 points, the default recipe's
# anisotropic frames and build_knn at 8000.
KNN_OPS_PER_PAIR = 8
KNN_SHAPES = ((5000, 7, False), (5000, 11, True), (8000, 8, False),
              (8000, 11, True))
# The exact kNN runs wherever a cloud's neighbours are needed: the Vrk's h
# of every render, the surface losses, the chamfer evals, the normals and
# the geometry apps.  The launch checks leave it out unless a phase names
# it: check_knn holds it to its plain version, and the train and window
# phases count it per step (the Vrk's h or the anisotropic frames, and
# build_knn; the PCA anchor's normals a third time).
KNN = "knn_topk"
KNN_PER_STEP = 2
# The train window's guard and update run once per step of every window
# (train_mvr's too); the launch checks leave them out unless a phase names
# them: check_adam holds them to the composite, the window phases count
# them per replay.
UPDATE = ("all_finite", "guarded_adam")
# The render's set-up runs once per render (its backward once per train
# step) on every path; the launch checks leave it out unless a phase
# names it: check_prep holds it to the composite and the closed form.
PREP = ("prep_fwd", "prep_bwd")
PREP_LIGHTS = 3
# The default cell's set-up in check_prep: (views, points), and its raster
# (the anisotropic Vrk, cutoff 0.5).
PREP_DEFAULT = (1, 8000)
# The binning (the forward and the support table, and the support radius's
# median) runs in every render on every path; the launch checks leave it
# out unless a phase names it: check_bin holds it to the plain versions,
# the window phases count it per replay (BIN_LAUNCHES kernels a table).
BIN = ("bin_tiles", "median_select")
ASIDE = (KNN,) + UPDATE + PREP + BIN
# The update's leaves: the neural cell's 18 (the points' three 5000 × 3,
# then IDR's decoder 33 → 512 × 4 → 3, each weight-normed layer's v, g and
# bias) and the flagship's 3; bytes per element of the update (p, g, m, v
# read, p, m, v written) and of the guard.
ADAM_NEURAL = ([(N_POINTS, 3)] * 3
               + [s for a, b in ((33, 512), (512, 512), (512, 512),
                                 (512, 512), (512, 3))
                  for s in ((b, a), (b,), (b,))])
ADAM_FLAGSHIP = [(N_POINTS, 3)] * 3
ADAM_BYTES, FINITE_BYTES = 28, 4
# H100 SXM peaks at the 700 W limit (NVIDIA's data sheet): FP32 outside
# the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# What each train phase must launch, and must not: the lean step scatters
# to points only in the epilogues of K1–K3, the fragment step launches K4
# once per step, for the zbuf cotangent.
LEAN_KERNELS = ("fwd_lean", "occ_bwd", "feat_bwd")
FRAG_KERNELS = ("fwd_frag", "occ_bwd", "feat_bwd", "segment_sum")
# The recipes whose step also runs the eigensolver once (the window
# phase): the anisotropic Vrk (the local PCA frames of the 8-NN) and the
# PCA normal anchor (λ_normal 0.1, k 8) on the flagship raster.
ANISO_RASTER = {**FLAGSHIP_RASTER, "Vrk_invariant": False,
                "Vrk_isotropic": False}
PREP_DEFAULT_RASTER = {**ANISO_RASTER, "cutoff_threshold": 0.5}
PCA_TRAIN = {**FLAGSHIP_TRAIN, "lambda_normal": 0.1, "normal_anchor": "pca",
             "normal_anchor_k": 8}
EIG_KERNELS = LEAN_KERNELS + ("symeig3",)
# The train CLI phase: the twin's dataset and the runs' iterations (the
# first run, the resume, the fragment run).
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_DATA = dict(views=16, image_size=512, points=20000, n_train_points=5000)
CLI_ITERS = (12, 16, 4)
# Config entries merged over the CLI's (empty: the flagship widths).
CLI_OVERRIDES = {}
# The post-process phase: the prune-every run's iterations and period, the
# anisotropic + normal-loss runs' iterations (jet anchor, then PCA), and
# the floaters injected before prune_floaters (outside at radius 0.8,
# inside at radius ≤ 0.3, about the twin's sphere of radius 0.5).
POST_ITERS, POST_PRUNE_EVERY, POST_NORMAL_ITERS = 8, 4, 4
N_FLOATERS_OUT, N_FLOATERS_IN = 64, 64
# The bench harness's arguments (empty: bench.py's flagship shape).
BENCH_ARGV = []
# The single-view phase: the turntable's frames and image size.
TURN_FRAMES, TURN_SIZE = 8, 512
# The multi-scene phase (BASELINE config 5 at full width): scenes, points
# per scene, views per scene, image size; the folded run's and the
# per-scene loop's iterations.
MS_SHAPE = dict(scenes=4, points=25000, views=8, image_size=512)
MS_ITERS, MS_LOOP_ITERS = 10, 3
# The data-generation phase: the ellipsoid's semi-axes, cameras, image
# size, the faceless cloud's points, and the train run's iterations with
# its eval (and loss print) period (CLI_OVERRIDES applies to that run
# too).  On this dataset the recipe's chamfer drops within 20 iterations,
# then drifts up until each anneal of the backward radii (every 200
# iterations), in dss_tpu as in the port (scripts/diag_convergence.py;
# PERF.md): a run of 200 iterations ends above its first eval, so the run
# is long enough for the anneals to carry it below.
DG_AXES = (1.0, 0.7, 0.5)
DG_CAMERAS, DG_SIZE, DG_CLOUD_POINTS = 16, 512, 20000
DG_ITERS, DG_EVAL_EVERY = 2000, 100
# The geometry phase, on data_gen's dataset and trained model: the share
# of the points in the cap switched off before reseed_coverage (largest x)
# and the views and proposals asked; the --reseed-every run (iterations,
# period; the same share at the smallest x turned into floaters around
# (3, 3, 3)); the denoised cloud's points, noise (of the bbox diagonal) and
# upsampling target; the meshes' resolution.
GEO_CAP, GEO_VIEWS, GEO_NEW = 0.15, 16, 256
GEO_TRAIN_ITERS, GEO_RESEED_EVERY = 8, 4
GEO_POINTS, GEO_NOISE, GEO_UPSAMPLE = 20000, 0.003, 24000
GEO_MESH_RES = 96
# The neural phase: the neural texture's decoder (the reference's
# RenderingNetwork width), its Adam steps and learning rates (points,
# decoder), and the size of its tiled-vs-reference check (image, tile,
# points); the SDF (the reference's width), the implicit render's size and
# steps, and the rays that fit its zero set; the points the other decoders
# run on; the image filters' radius; the image_filter_flow cloud's points
# and runs (filter, iterations, extra arguments).  The flow's defaults (λ_proj = λ_repel = 0.02) move the image
# term up over the first iterations, in dss_tpu as in the port (ROADMAP.md,
# reference behaviours): the run without the regularisers is the one whose
# loss must fall.
TEX_DECODER = dict(hidden_size=512, n_layers=4)
TEX_STEPS, TEX_LR = 20, (2e-3, 1e-3)
TEX_CHECK = dict(image_size=64, tile_size=16, points=1000)
SDF_NET = dict(hidden_size=512, n_layers=8, skip_in=(4,), num_frequencies=6)
SDF_SIZE, SDF_STEPS, SDF_RAYS = 512, 64, 4096
DECODER_POINTS = 65536
FILTER_R = 4
FLOW_POINTS = 5000
FLOW_ARGV = ["--num-views", "8", "--image-size", "512"]
FLOW_RUNS = (("l0", 40, ()),
             ("l0", 40, ("--lambda-proj", "0", "--lambda-repel", "0")),
             ("pix2pix", 10, ()), ("guided", 3, ()), ("superpixel", 3, ()))
# The aux phase, on data_gen's dataset and model: the report's views, and
# the size and trace steps of the SDF render under grad.
AUX_VIEWS = (0, 5, 11, 15)
AUX_SDF_SIZE, AUX_SDF_STEPS = 128, 16
REPORT_KEYS = {"iters", "chamfer", "hausdorff", "p2f", "chamfer_normal",
               f"psnr_{len(AUX_VIEWS)}views", f"iou_loss_{len(AUX_VIEWS)}views"}
# The parallel phase: (backend, ranks) runs on cuda:0 (NCCL takes one rank
# per card), and the timed Adam steps per rank (the first a warm-up).
PAR_RUNS = (("nccl", 1), ("gloo", 2))
PAR_STEPS = 4
DATA_DICT_KEYS = {"camera_mat", "points", "normals", "colors", "cameras_type",
                  "cameras_params", "lights_type"}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _time_ms(fn, reps):
    """Mean device time of fn over reps launches (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps):
    """Device time per call of fn: reps calls captured into one CUDA graph,
    replayed (no host work between the launches; fn must be
    capture-safe).  For a kernel whose launch costs more host time than
    its run."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _time_ms(graph.replay, 5) / reps
    del graph
    return ms


def _bound(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the FP32 rate."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _live(counts, m):
    return int(torch.clamp(counts, max=m).sum())


def _pairs(counts, table, image_size, tile, in_disc_r2=None):
    """(pixel, candidate) pairs of these tables: pixels inside the
    candidate's box with pz ≥ 0 (forward table), or, given cur_r² (V,),
    pixels of the tile inside the support disc of an on-screen candidate
    with pz ≥ 0 (occupancy-backward table).  Live slots only."""
    from dss_tpu_torch.ops import kernels

    v, n_tiles, _, m = table.shape
    xf, yf = kernels._pixel_centres(int(round(n_tiles ** 0.5)), tile,
                                    image_size, table.device)
    xf, yf = xf[..., None], yf[..., None]
    slot = torch.arange(m, device=table.device)
    total = 0
    for vi in range(v):
        for c0 in range(0, m, kernels.CHUNK):
            d = table[vi, :, :, c0:c0 + kernels.CHUNK]
            ch = lambda i: d[:, i, None, :]
            live = (slot[c0:c0 + kernels.CHUNK] < counts[vi, :, None])[:, None, :]
            dx, dy = xf - ch(0), yf - ch(1)
            if in_disc_r2 is None:
                hit = ((torch.abs(dx) <= ch(kernels.CH_RX))
                       & (torch.abs(dy) <= ch(kernels.CH_RY))
                       & (ch(kernels.CH_PZ) >= 0.0))
            else:
                hit = ((dx * dx + dy * dy <= in_disc_r2[vi])
                       & (ch(kernels.BCH_PZ) >= 0.0)
                       & (torch.abs(ch(0)) <= 1.0) & (torch.abs(ch(1)) <= 1.0))
            total += int((hit & live).sum())
    return total


def _close(name, got, want, rtol, atol_frac):
    """assert_close with atol = atol_frac · max|want|; returns max|got − want|."""
    atol = atol_frac * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


def _differs(got, want, rtol, atol_frac):
    """Whether _close at this tolerance would refuse got (no NaNs here)."""
    atol = atol_frac * float(want.abs().max())
    return bool(((got - want).abs() > atol + rtol * want.abs()).any())


def k2_edge_case(dev):
    """Support tables whose pixels sit exactly on the disc's edge
    (dist² = cur_r²) and on the splat box's edge (|dx| = rx, |dy| = ry),
    under occupancy gradients of both signs, zeros included: 3 views of a
    128² image in 64² tiles.  In each view three candidates share a pixel
    centre: their box edge at 2 pixels, a box that holds the whole disc,
    and a box whose corner is the pixel on the disc's edge; two more sit
    between pixel centres.  cur_r² is the dist² of the pixel 3 columns and
    4 rows away, computed as the kernels compute it.  The third view's
    centre is by a tile corner, so its candidates are in all four tiles.
    Returns (counts, table5, grad_occ, cur_r2, image_size, tile,
    cur_r2 one float lower, table5 with rx and ry one float lower)."""
    f = np.float32
    s, t, m = 128, 64, 128
    ntx = s // t
    pix = lambda i: f(1) - (f(2) * f(i) + f(1)) * f(1.0 / s)
    table = np.zeros((3, ntx * ntx, 5, m), f)
    table[:, :, 0:2], table[:, :, 2] = 2.0, -1.0  # sentinel rows
    counts = np.zeros((3, ntx * ntx), np.int32)
    r2 = np.zeros(3, f)
    for v, (cy, cx) in enumerate(((20, 20), (100, 70), (63, 63))):
        px, py = pix(cx), pix(cy)
        dx, dy = pix(cx + 3) - px, pix(cy + 4) - py
        r2[v] = dx * dx + dy * dy
        e2x, e2y = abs(pix(cx + 2) - px), abs(pix(cy + 2) - py)
        half = f(1.0 / s)  # half a pixel
        cands = [(px, py, e2x, e2y), (px, py, f(1e3), f(1e3)),
                 (px, py, abs(dx), abs(dy)),
                 (px + f(0.37) * half, py - f(1.21) * half, e2x, e2y),
                 (px - f(0.5) * half, py + f(0.5) * half, abs(dx), e2y)]
        tiles = range(ntx * ntx) if v == 2 else [(cy // t) * ntx + cx // t]
        for g in tiles:
            for j, (x, y, rx, ry) in enumerate(cands):
                table[v, g, :, j] = (x, y, 1.5, rx, ry)
            counts[v, g] = len(cands)
    rows, cols = np.divmod(np.arange(s * s), s)
    g_img = np.where((rows + 2 * cols) % 3 == 0, f(-1.0), f(1.5))
    g_img[(rows * 7 + cols) % 11 == 0] = 0.0
    g_occ = g_img.reshape(ntx, t, ntx, t).transpose(0, 2, 1, 3).reshape(
        1, ntx * ntx, t * t).repeat(3, axis=0)
    lower = table.copy()
    lower[:, :, 3:5] = np.nextafter(lower[:, :, 3:5], f(0))
    to = lambda x: torch.tensor(x, device=dev)
    return (to(counts), to(table), to(g_occ), to(r2), s, t,
            to(np.nextafter(r2, f(0))), to(lower))


def slot_ids(table):
    """A point of its own for every slot of a table, (V, nt, M) int32
    ids tile·M + slot (P = nt·M): the fused kernels' per-point sums are then
    the per-candidate ones."""
    v, nt, _, m = table.shape
    ids = torch.arange(nt * m, dtype=torch.int32, device=table.device)
    return ids.reshape(1, nt, m).expand(v, nt, m).contiguous()


def close_xy(label, got, want):
    """K2's per-point (V, P, 2) sums against the plain version's, gx and
    gy each at its own tolerance: mixed-sign sums over a tile's pixels and
    tiles in another order, rtol 1e-4 with atol 1e-6·max for entries that
    nearly cancel.  Returns max |got − want|."""
    return max(_close(f"{label} {c}", got[..., i], want[..., i], 1e-4, 1e-6)
               for i, c in enumerate(("gx", "gy")))


def check_k2_edges():
    """K2 against its plain version on k2_edge_case, each slot its own
    point: it must count exactly the pixels its plain version counts.  The
    check is shown to be able to see one pixel: nudging cur_r² or the box
    one float down drops the edge pixels and moves the plain version's sums
    beyond the tolerance."""
    from dss_tpu_torch.ops import kernels

    counts, tab, g, r2, s, t, r2_lo, tab_lo = k2_edge_case(DEV)
    ids = slot_ids(tab)
    p = ids[0].numel()
    want = kernels.occ_bwd_points_plain(counts, tab, ids, g, r2, p, s, t)
    for name, moved in (
            ("cur_r2", kernels.occ_bwd_points_plain(counts, tab, ids, g, r2_lo,
                                                    p, s, t)),
            ("box", kernels.occ_bwd_points_plain(counts, tab_lo, ids, g, r2,
                                                 p, s, t))):
        if not any(_differs(moved[..., i], want[..., i], 1e-4, 1e-6)
                   for i in (0, 1)):
            raise AssertionError(f"k2 edge case: moving the {name} edge by "
                                 f"one float is within the tolerance")
    err = close_xy("occ_bwd edge", kernels.occ_bwd(counts, tab, ids, g, r2, p,
                                                   s, t), want)
    print(f"occ_bwd edge case: matches the plain version (max |Δ| "
          f"{err:.3e} on sums up to {float(want.abs().max()):.4g}); one "
          f"float on cur_r² or the box would break the tolerance")


def k4_edge_cases(dev):
    """Tables for K4's warp merge, each (label, vals (V, C, N), seg (V, N)
    int32, P): every lane of every warp on one id; ids alternating from
    lane to lane; ids −1 and P mixed among the valid ones; P = 1.  Values
    are positive (sums without cancellation), with a third of them exactly
    0, which K4 skips; N = 2800 leaves the last block's threads past the
    end."""
    rng = np.random.default_rng(13)
    v, n = 2, 2800

    def vals(c):
        x = rng.uniform(0.5, 1.5, (v, c, n)).astype(np.float32)
        x[rng.random(x.shape) < 1 / 3] = 0.0
        return x

    lane = np.arange(n) // 4 % 32
    cases = [("one id", vals(1), np.full((v, n), 3), 5),
             ("alternating ids", vals(4), np.broadcast_to(lane % 2, (v, n)), 5),
             ("-1 and P mixed in", vals(2), rng.integers(-1, 41, (v, n)), 40),
             ("P = 1", vals(3), rng.integers(-1, 2, (v, n)), 1)]
    return [(label, torch.tensor(x, device=dev),
             torch.tensor(np.ascontiguousarray(sg), dtype=torch.int32,
                          device=dev), p)
            for label, x, sg, p in cases]


def check_k4_edges():
    """K4 against its plain version on k4_edge_cases.  Positive terms in
    another order: rtol 1e-4, atol 1e-6·max."""
    from dss_tpu_torch.ops import kernels

    for label, vals, seg, p in k4_edge_cases(DEV):
        err = _close(f"segment_sum, {label}", kernels.segment_sum(vals, seg, p),
                     kernels.segment_sum_plain(vals, seg, p), 1e-4, 1e-6)
        print(f"segment_sum edge case, {label} (C = {vals.shape[1]}, P = {p}):"
              f" matches the plain version, max |Δ| {err:.3e}")


def _fwd_table(cands, s, t, m):
    """A forward table (V = 1) from per-tile lists of (px, py, pz, rx, ry)
    with Q = 0 (a box-only accept) and random scalers and colours; the
    slots of each tile keep the list's order.  Returns numpy (counts,
    table)."""
    from dss_tpu_torch.ops import kernels

    rng = np.random.default_rng(11)
    nt = (s // t) ** 2
    table = np.zeros((1, nt, kernels.N_CHANNELS, m), np.float32)
    table[0, :, kernels.CH_PZ] = -1.0
    table[0, :, kernels.CH_CUT] = -np.inf
    counts = np.zeros((1, nt), np.int32)
    for gi, lst in cands.items():
        c = len(lst)
        a = np.asarray(lst, np.float32)
        table[0, gi, kernels.CH_PX, :c] = a[:, 0]
        table[0, gi, kernels.CH_PY, :c] = a[:, 1]
        table[0, gi, kernels.CH_PZ, :c] = a[:, 2]
        table[0, gi, kernels.CH_CUT, :c] = 1.0
        table[0, gi, kernels.CH_RX, :c] = a[:, 3]
        table[0, gi, kernels.CH_RY, :c] = a[:, 4]
        table[0, gi, kernels.CH_SC, :c] = rng.uniform(0.5, 1.5, c)
        table[0, gi, kernels.CH_R:kernels.CH_B2 + 1, :c] = rng.uniform(
            0, 1, (3, c))
        table[0, gi, kernels.CH_ID, :c] = np.arange(c)
        counts[0, gi] = c
    return counts, table


def _edge_case(dev, counts, table, s, t, k, dmt):
    """(counts, table, K3's cotangents, s, t, K, dmt) as tensors on dev."""
    g = np.random.default_rng(12).standard_normal(
        (1, counts.shape[1], t * t, 4)).astype(np.float32)
    to = lambda x: torch.tensor(x, device=dev)
    return to(counts), to(table), to(g), s, t, k, dmt


def cull_border_case(dev):
    """Boxes whose edge lies within a pixel of a 16×16 sub-tile border, on
    either side, down to a pixel centre exactly (64², tiles of 32, in two
    of the four tiles): the sub-tile cull must keep every candidate a pixel
    of the sub-tile accepts.  Returns _edge_case's tuple (K = 5,
    dmt = 0.05)."""
    s, t, m = 64, 32, 256
    f = np.float32
    pix = lambda i: f(1) - (f(2) * f(i) + f(1)) * f(1.0 / s)
    step = 2.0 / s
    rng = np.random.default_rng(5)
    lst = []
    # the box's edge by the last column (row) of a sub-tile, or by the
    # first of the next
    for border in (15, 16):
        for off in (0.0, 1e-7, -1e-7, 0.3 * step, -0.3 * step, 0.95 * step):
            for axis in (0, 1):
                r = f(rng.uniform(0.5, 3.0) * step)
                edge = pix(border) + f(off)
                c = [pix(rng.integers(0, t)), pix(rng.integers(0, t)),
                     f(rng.uniform(1.0, 2.0)), r, r]
                c[axis] = edge + r if border == 16 else edge - r
                lst.append(c)
    lst.sort(key=lambda c: c[2])
    counts, table = _fwd_table({0: lst, 3: lst}, s, t, m)
    return _edge_case(dev, counts, table, s, t, 5, 0.05)


def cull_empty_chunk_case(dev):
    """Two 128-candidate chunks of one 64² tile: the first only reaches one
    corner sub-tile, so the other sub-tiles skip it; the second covers the
    tile, and ranks and z₀ carry over from the first chunk.  Returns
    _edge_case's tuple (K = 8, dmt = 0.5)."""
    s, t, m = 64, 64, 256
    step = 2.0 / s
    rng = np.random.default_rng(6)
    first = [[1 - step * rng.uniform(1, 10), 1 - step * rng.uniform(1, 10),
              1.0 + 0.001 * i, 3 * step, 3 * step] for i in range(128)]
    second = [[1 - step * rng.uniform(0, 64), 1 - step * rng.uniform(0, 64),
               1.2 + 0.001 * i, 8 * step, 8 * step] for i in range(90)]
    counts, table = _fwd_table({0: first + second}, s, t, m)
    return _edge_case(dev, counts, table, s, t, 8, 0.5)


def kernel_pair(name, counts, table, s, t, k, dmt, grad=None, p=None):
    """(kernel call, per-point plain call) of K1 (with the depth channel),
    K3 (on the cotangents grad) or K5 on one forward table, for P = p
    points (default: the largest id of the table's live slots + 1)."""
    from dss_tpu_torch.ops import kernels

    if p is None:
        slot = torch.arange(table.shape[-1], device=table.device)
        p = int(table[:, :, kernels.CH_ID][slot < counts[..., None]].max()) + 1
    args = {"fwd_lean": (counts, table, p, dmt, s, t, k, True),
            "feat_bwd": (counts, table, grad, p, dmt, s, t, k),
            "fwd_frag": (counts, table, p, dmt, s, t, k)}[name]
    return (lambda: getattr(kernels, name)(*args),
            lambda: getattr(kernels, name + "_points_plain")(*args))


# The outputs of K1 and K5 that must be bit-equal to the plain version's
# (the same accept, rank and window arithmetic; vis per candidate in the
# per-candidate plain versions, per point in the kernels); rgbw comes last.
EXACT_OUTPUTS = {"fwd_lean": ("cnt", "vis"),
                 "fwd_frag": ("z", "q", "ids", "cnt", "vis")}


def hold_to_plain(name, got, want):
    """Raise unless K1's or K5's exact outputs are bit-equal to the plain
    version's and the sums (their rgbw, K3's output) are within tolerance;
    returns max |kernel − plain| of the sums."""
    if name == "feat_bwd":
        # per-point sums of w·g over pixels, sub-tiles and tiles, by float
        # atomics in an order that changes from run to run: rtol 1e-4 with
        # atol 1e-6·max for entries that nearly cancel
        return _close(name, got, want, 1e-4, 1e-6)
    for i, label in enumerate(EXACT_OUTPUTS[name]):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(
                f"{name}: {label} differs from the plain version in "
                f"{int((got[i] != want[i]).sum())} entries")
    # rgbw: sums of positive terms in another order, exp to ~2 ulp
    return _close(f"{name} rgbw", got[-1], want[-1], 1e-5, 1e-7)


def check_cull_edges():
    """K1, K3 and K5 against their plain versions on the edge tables of
    their shared sub-tile cull: boxes within a pixel of a sub-tile border
    (K5 also at K = 16, its second register instance), and a chunk that
    only one corner sub-tile keeps."""
    for case, make in (("sub-tile border", cull_border_case),
                       ("chunk without survivors", cull_empty_chunk_case)):
        counts, table, grad, s, t, k, dmt = make(DEV)
        runs = [("fwd_lean", k), ("feat_bwd", k), ("fwd_frag", k)]
        if make is cull_border_case:
            runs.append(("fwd_frag", 16))
        for name, kk in runs:
            run, plain = kernel_pair(name, counts, table, s, t, kk, dmt, grad)
            err = hold_to_plain(name, run(), plain())
            print(f"cull edge case, {case}: {name} (K = {kk}) matches the "
                  f"plain version, max |Δ| of the sums {err:.3e}")


def check_cameras():
    """The camera's projection on the card is bit-equal to the CPU's
    (tan_f32 is separate float ops, rounded alike on both)."""
    from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                                look_at_view_transform)

    r, t = look_at_view_transform(dist=2.0, elev=20.0, azim=40.0)
    for fov in (30.0, 45.0, 60.0, 90.0):
        m = [FoVPerspectiveCameras.create(r, t, fov=fov, aspect_ratio=1.5,
                                          device=d).projection_matrix().cpu()
             for d in (DEV, "cpu")]
        if not torch.equal(m[0], m[1]):
            raise AssertionError(f"projection matrix at fov {fov}: the card "
                                 f"differs from the CPU")
    print("cameras: projection matrices bit-equal on the card and the CPU "
          "at fov 30, 45, 60, 90")


def setup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); nothing was run")
    from dss_tpu_torch.ops import kernels

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    nvcc = kernels.find_nvcc()
    print(_run([nvcc, "--version"]).splitlines()[-1])
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    environment()
    t0 = time.perf_counter()
    lib_path = kernels.build_library()
    kernels.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    return smi


def environment():
    """Print whether this machine has what dss_tpu's config and data code
    need (PyYAML, imageio, and g++ with libpng for its native PNG loader);
    dss_tpu_torch uses none of them."""
    found = lambda x: "yes" if x else "no"
    png_h = any(os.path.exists(os.path.join(d, "png.h"))
                for d in ("/usr/include", "/usr/local/include"))
    print(f"environment: yaml {found(importlib.util.find_spec('yaml'))}, "
          f"imageio {found(importlib.util.find_spec('imageio'))}, "
          f"g++ {found(shutil.which('g++'))}, libpng "
          f"{found(ctypes.util.find_library('png'))} (png.h {found(png_h)}); "
          f"dss_tpu_torch reads configs with utils/yaml_lite.py and PNGs "
          f"with data/png.py")


def make_data(dev):
    """Ground truth (20k points on an ellipsoid), 8 look-at cameras, lights
    and the initial model cloud (ico_sphere(4), radius 0.5, 5000 points),
    all from SEED."""
    from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                                look_at_view_transform)
    from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
    from dss_tpu_torch.render.lighting import DirectionalLights

    rng = np.random.default_rng(SEED)
    verts, faces = ico_sphere(level=4, radius=1.0)
    axes = np.asarray(GT_AXES, np.float32)
    gt_pts, gt_nrm = sample_points_from_mesh(verts, faces, N_GT_POINTS, rng=rng)
    gt_pts = gt_pts * axes
    gt_nrm = gt_nrm / axes
    gt_nrm /= np.linalg.norm(gt_nrm, axis=-1, keepdims=True)

    r, t = look_at_view_transform(
        dist=torch.full((N_VIEWS,), 2.0),
        elev=torch.linspace(-30.0, 30.0, N_VIEWS),
        azim=torch.linspace(0.0, 315.0, N_VIEWS),
    )
    mverts, mfaces = ico_sphere(level=4, radius=0.5)
    pts, nrm = sample_points_from_mesh(mverts, mfaces, N_POINTS, rng=rng)
    return dict(
        gt_pts=torch.tensor(gt_pts, device=dev),
        gt_nrm=torch.tensor(gt_nrm, device=dev),
        cams=FoVPerspectiveCameras.create(r, t, fov=60.0, zfar=ZFAR, device=dev),
        lights=DirectionalLights.create(n_views=N_VIEWS, device=dev),
        init=(pts, nrm),
    )


def initial_params(data):
    """The model's starting point (colours frozen at 1)."""
    from dss_tpu_torch.models.point_model import PointModelParams

    pts, nrm = data["init"]
    return PointModelParams.create(pts, nrm, np.ones_like(pts),
                                   device=data["gt_pts"].device)


def render_targets(data, settings):
    """Targets rendered from the ground truth with `settings`: rgb, mask
    and depth.  The model's colours are frozen at 1 (learn_colors is
    false), so the targets use the same albedo: only the geometry differs.
    The depth is the weighted-depth channel where it is on, else the
    nearest fragment's z (as create_mvr_data makes it); zfar outside the
    mask."""
    from dss_tpu_torch.render.ewa import compute_vrk_h_global
    from dss_tpu_torch.render.renderer import render_views

    p = data["gt_pts"]
    with torch.no_grad():
        mask = torch.ones(N_GT_POINTS, dtype=torch.bool, device=p.device)
        rgba, frags, _ = render_views(
            p, data["gt_nrm"], torch.ones_like(p), mask, data["cams"],
            data["lights"], settings, vrk_h=compute_vrk_h_global(p, mask),
        )
    img = rgba[..., :3].contiguous()
    mask_img = rgba[..., 3].contiguous()
    depth = frags.wdepth if settings.depth_channel else frags.zbuf[..., 0]
    depth = torch.where(mask_img > 0.5, depth, ZFAR).contiguous()
    path = "lean" if settings.lean_fragments else "fragment"
    print(f"{path} targets: {tuple(img.shape)} rgb, mask coverage "
          f"{float(mask_img.mean()):.4f}, gt render overflow "
          f"{int(frags.overflow.sum())}, depth in mask "
          f"{float(depth[mask_img > 0.5].min()):.4f}–"
          f"{float(depth[mask_img > 0.5].max()):.4f}")
    if not (torch.isfinite(img).all() and torch.isfinite(depth).all()):
        raise AssertionError(f"{path} targets are not finite")
    return dict(img=img, mask_img=mask_img, depth=depth)


def flagship_tables(data):
    """The model's first flagship render (lean settings) up to its binning:
    returns (settings, tile config, screen-space points, splats, shaded
    colours, forward binning)."""
    from dss_tpu_torch.ops import splat
    from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
    from dss_tpu_torch.render.renderer import _prep_view, _tile_config
    from dss_tpu_torch.utils.mathutil import normalize

    st, prm = RasterSettings(**FLAGSHIP_RASTER), initial_params(data)
    cfg = _tile_config(N_POINTS, st)
    dev = data["gt_pts"].device
    with torch.no_grad():
        mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
        shaded, spl, pts_s = _prep_view(
            prm.points, normalize(prm.normals), prm.colors, mask, data["cams"],
            data["lights"], st, compute_vrk_h_global(prm.points, mask), 64.0)
        b = splat.bin_splats(
            pts_s, spl.ellipse_params, spl.cutoff, spl.radii, st.image_size,
            cfg.tile, cfg.cap, cfg.max_tiles, cfg.max_tiles, scaler=spl.scaler,
            features=shaded)
    return st, cfg, pts_s, spl, shaded, b


def zbuf_scatter_case(st, cfg, pts_s, spl, shaded, gen):
    """K4's work on the fragment step, at flagship_tables' render: (vals
    (V, 1, N), seg (V, N) int32), N = S²·K, the fragment ids of that render
    (−1 where empty) and the depth L1's cotangent on the nearest fragment's
    z (±λ/pixels on rank 0, zero on ranks 1..K−1)."""
    from dss_tpu_torch.ops import splat

    with torch.no_grad():
        idx = splat.rasterize_forward_fragments(
            st.image_size, st.points_per_pixel, cfg, pts_s, spl.ellipse_params,
            spl.cutoff, spl.radii, st.depth_merging_threshold, spl.scaler,
            shaded)[0]
    g_z = torch.zeros(idx.shape, device=idx.device)
    sign = torch.rand(idx.shape[:-1], generator=gen, device=idx.device) < 0.5
    g_z[..., 0] = torch.where(sign, -1.0, 1.0) * (
        FLAGSHIP_TRAIN["lambda_depth"] / idx[..., 0].numel())
    v = idx.shape[0]
    return g_z.reshape(v, 1, -1), idx.reshape(v, -1)


def check_kernels(data):
    """Each kernel against its plain version on the card, at the tables of
    the model's first flagship render: K1, K2, K3 and K5 with their fused
    scatter to points, held to their per-point plain versions; K4 on the
    zbuf cotangent of that render's fragments.  Returns per-kernel
    records."""
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.ops import splat

    st, cfg, pts_s, spl, shaded, b = flagship_tables(data)
    p = N_POINTS
    s, k, dmt = st.image_size, st.points_per_pixel, st.depth_merging_threshold
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    with torch.no_grad():
        counts, table, t = b.tile_counts, b.tile_data, cfg.tile
        print(f"forward table {tuple(table.shape)}, max count "
              f"{int(counts.max())}, overflow {int(b.overflow.sum())}")
        recs = {}
        pts_out = N_VIEWS * p  # per-point outputs, per channel

        k1, k1p = kernel_pair("fwd_lean", counts, table, s, t, k, dmt, p=p)
        got, want = k1(), k1p()
        err = hold_to_plain("fwd_lean", got, want)
        vis = got[1] > 0
        print(f"fwd_lean: cnt and the points' visibility bit-equal to the "
              f"plain version ({int(vis.sum())} visible); rgbw max |Δ| "
              f"{err:.3e} on values up to {float(want[2].abs().max()):.4g}")
        recs["fwd_lean"] = (err, _time_ms(k1, 20), _time_ms(k1p, 2))
        # bytes: counts, the live candidates' 14 channels (the id included),
        # cnt and Σw·[r, g, b, 1, z] per pixel, a flag per point
        v, n_tiles, _, m = table.shape
        live, px_all = _live(counts, m), v * n_tiles * t * t
        box_pairs = _pairs(counts, table, s, t)
        survivors = int(kernels.subtile_cull_plain(counts, table, s, t).sum())
        n_subs = v * n_tiles * (t // kernels.SUB) ** 2
        bounds = {"fwd_lean": _bound(
            counts.numel() * 4 + live * 14 * 4 + px_all * 6 * 4 + pts_out * 4,
            box_pairs * OPS_PER_PAIR["fwd_lean"])}

        bt, bcap, bmt, bpc = splat._bwd_tile_budget(cfg, p)
        bb, cur_r2 = splat.bin_for_occ_backward(
            pts_s, spl.radii, vis, st.radii_backward_scaler, s, bt, bcap,
            bmt, pair_cap=bpc)
        cur_r2 = cur_r2.contiguous()
        print(f"occupancy-backward table {tuple(bb.tile_data.shape)}, max "
              f"count {int(bb.tile_counts.max())}, overflow {int(bb.overflow.sum())}")
        n_tiles, tt = table.shape[1], t * t
        g_occ = torch.randn((N_VIEWS, n_tiles, tt), generator=gen,
                            device=DEV) * 1e-6
        k2_args = (bb.tile_counts, bb.tile_data, bb.tile_ids, g_occ, cur_r2,
                   p, s, bt)

        def k2():
            return kernels.occ_bwd(*k2_args)

        def k2p():
            return kernels.occ_bwd_points_plain(*k2_args)

        err = close_xy("occ_bwd", k2(), k2p())
        recs["occ_bwd"] = (err, _time_ms(k2, 20), _time_ms(k2p, 2))
        # bytes: counts, cur_r², the live candidates' 5 channels and ids,
        # grad_occ, gx and gy per point
        blive = _live(bb.tile_counts, bb.tile_data.shape[-1])
        disc_pairs = _pairs(bb.tile_counts, bb.tile_data, s, bt, cur_r2)
        bounds["occ_bwd"] = _bound(
            bb.tile_counts.numel() * 4 + cur_r2.numel() * 4 + blive * 6 * 4
            + px_all * 4 + pts_out * 2 * 4,
            disc_pairs * OPS_PER_PAIR["occ_bwd"])
        print(f"bound inputs: {box_pairs} (pixel, candidate) pairs inside a "
              f"forward box, {disc_pairs} inside a support disc; {live} and "
              f"{blive} live candidates")
        print(f"sub-tile cull of K1, K3 and K5: {survivors} (sub-tile, "
              f"candidate) survivors, {survivors / n_subs:.2f} per 16×16 "
              f"sub-tile against {live / (v * n_tiles):.2f} live candidates "
              f"per {t}² tile")

        g_rgbw = torch.randn((N_VIEWS, n_tiles, tt, 4), generator=gen,
                             device=DEV) * 1e-6

        k3, k3p = kernel_pair("feat_bwd", counts, table, s, t, k, dmt, g_rgbw,
                              p=p)
        err = hold_to_plain("feat_bwd", k3(), k3p())
        recs["feat_bwd"] = (err, _time_ms(k3, 20), _time_ms(k3p, 2))
        # bytes: counts, the live candidates' 14 channels, 16 B of
        # cotangents per pixel, 4 sums per point
        bounds["feat_bwd"] = _bound(
            counts.numel() * 4 + live * 14 * 4 + px_all * 16
            + pts_out * 4 * 4, box_pairs * OPS_PER_PAIR["feat_bwd"])

        k5, k5p = kernel_pair("fwd_frag", counts, table, s, t, k, dmt, p=p)
        want = k5p()
        err = hold_to_plain("fwd_frag", k5(), want)
        print(f"fwd_frag: z, q, ids, cnt and the points' visibility "
              f"bit-equal to the plain version ({int((want[2] >= 0).sum())} "
              f"fragments); rgbw max |Δ| {err:.3e} on values up to "
              f"{float(want[5].abs().max()):.4g}")
        recs["fwd_frag"] = (err, _time_ms(k5, 20), _time_ms(k5p, 2))
        # bytes: counts, the live candidates' 14 channels, z, q, ids (K per
        # pixel), cnt and Σw·[r, g, b, 1] per pixel, a flag per point
        bounds["fwd_frag"] = _bound(
            counts.numel() * 4 + live * 14 * 4 + px_all * (3 * k + 5) * 4
            + pts_out * 4, box_pairs * OPS_PER_PAIR["fwd_frag"])

        vals, seg = zbuf_scatter_case(st, cfg, pts_s, spl, shaded, gen)

        def k4():
            return kernels.segment_sum(vals, seg, p)

        def k4p():
            return kernels.segment_sum_plain(vals, seg, p)

        # ±c terms summed by atomics in another order: rtol 1e-4 with atol
        # 1e-6·max for the points whose terms nearly cancel
        err = _close("segment_sum", k4(), k4p(), 1e-4, 1e-6)
        recs["segment_sum"] = (err, _time_ms(k4, 50), _time_ms(k4p, 5))
        print(f"segment_sum on the zbuf cotangent: {seg.numel()} slots, "
              f"{int((seg >= 0).sum())} fragments, "
              f"{int(((seg >= 0) & (vals[:, 0] != 0)).sum())} non-zero; "
              f"matches the plain version, max |Δ| {err:.3e}")
        # bytes: an id and a value per slot, a sum per point
        bounds["segment_sum"] = _bound(seg.numel() * 8 + pts_out * 4, 0)
        # The library call computing the same function: scatter_add_ into a
        # (V, P + 1) buffer, the empty slots' index P made beforehand.
        lib_idx = torch.where(seg >= 0, seg, p).to(torch.int64)
        lib_vals = vals[:, 0].contiguous()
        buf = torch.zeros((N_VIEWS, p + 1), device=DEV)
        library = {"segment_sum": _time_ms(
            lambda: buf.scatter_add_(1, lib_idx, lib_vals), 50)}
    out = {}
    for name, (err, ms, pms) in recs.items():
        bms, by = bounds[name]
        lib = library.get(name)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=lib)
        print(f"kernel {name}: max|kernel − plain| {err:.3e}, {ms:.4f} ms vs "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), library "
              + ("none" if lib is None else f"{lib:.4f} ms"))
    out["symeig3"] = check_symeig3(data)
    out[KNN] = check_knn(data)
    out.update(check_adam())
    out.update(check_prep(data))
    out.update(check_bin(data))
    return out


def _adam_leaves(shapes, seed):
    """An optimizer of one Adam group per leaf as make_optimizer builds it
    for the flagship (betas 0.5, 0.9; milestones 500, 800; lr 1e-4 past the
    third leaf), its state at count 3200 with moments at a run's scale, and
    a gradient per leaf, all from `seed`."""
    gen = torch.Generator(DEV).manual_seed(seed)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=DEV)
    ts = [rnd(s).requires_grad_() for s in shapes]
    lrs = [FLAGSHIP_OPT["lr_points"], FLAGSHIP_OPT["lr_normals"],
           FLAGSHIP_OPT["lr_colors"]] + [1e-4] * (len(ts) - 3)
    opt = torch.optim.Adam(
        [{"params": [t], "lr": lr, "name": f"leaf{i}", "base_lr": lr,
          "milestones": FLAGSHIP_OPT["milestones"],
          "gamma": FLAGSHIP_OPT["gamma"]}
         for i, (t, lr) in enumerate(zip(ts, lrs))],
        betas=(0.5, 0.9), eps=1e-8)
    for t in ts:
        opt.state[t] = {"step": torch.tensor(3200.0, device=DEV),
                        "exp_avg": rnd(t.shape) * 1e-3,
                        "exp_avg_sq": (rnd(t.shape) * 1e-3) ** 2}
    return ts, opt, [rnd(t.shape) * 1e-3 for t in ts]


def check_adam():
    """The train window's guard and update (csrc/guarded_adam.cu) on the
    neural cell's 18 leaves and the flagship's 3: one step of the kernel
    against the composite (trainer.guarded_adam_plain) from the same state,
    parameters, moments and counts bit-equal; then each kernel timed per
    launch in a CUDA graph of 20 launches (`_graph_ms`), the composite per
    call likewise.  Bound: ADAM_BYTES (FINITE_BYTES) per element over the
    memory rate.  Returns the records of the neural leaves' update and
    guard."""
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.training import trainer

    recs = {}
    for label, shapes in (("neural 18 leaves", ADAM_NEURAL),
                          ("flagship 3 leaves", ADAM_FLAGSHIP)):
        runs = []
        for fn in (trainer.guarded_adam_plain, trainer.guarded_adam_):
            ts, opt, grads = _adam_leaves(shapes, SEED + 7)
            fn(opt, grads, kernels.all_finite(grads))
            runs.append([x for t in ts for x in (
                t.detach(), *(opt.state[t][k] for k in
                              ("exp_avg", "exp_avg_sq", "step")))])
        differ = sum(not torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip(*runs))
        if differ:
            raise AssertionError(f"guarded_adam {label}: {differ} of "
                                 f"{len(runs[0])} tensors differ from the "
                                 f"composite's bits")
        n = sum(t.numel() for t in ts)
        finite = kernels.all_finite(grads)
        ms = _graph_ms(lambda: trainer.guarded_adam_(opt, grads, finite), 20)
        fms = _graph_ms(lambda: kernels.all_finite(grads), 20)
        pms = _graph_ms(
            lambda: trainer.guarded_adam_plain(opt, grads, finite), 20)
        bms, by = _bound(n * ADAM_BYTES, 0)
        fbms, fby = _bound(n * FINITE_BYTES, 0)
        print(f"guarded_adam {label} ({n} elements): bit-equal to the "
              f"composite; update {ms:.4f} ms per launch, bound {bms:.5f} ms "
              f"({by}, {100 * bms / ms:.1f}%); guard {fms:.4f} ms with its "
              f"flag fill, bound {fbms:.5f} ms ({fby}); composite "
              f"{pms:.4f} ms (graph replays)")
        if label.startswith("neural"):
            recs["guarded_adam"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                        bound_ms=bms, bound_by=by,
                                        library_ms=None)
            recs["all_finite"] = dict(
                max_abs_err=0.0, ms=fms,
                plain_ms=_graph_ms(lambda: kernels.all_finite_plain(grads),
                                   20),
                bound_ms=fbms, bound_by=fby, library_ms=None)
    return recs


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bits_equal(got, want):
    """Bit for bit, shapes included; None equals None only."""
    if got is None or want is None:
        return got is None and want is None
    return torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))


def _prep_cases(data):
    """check_prep's cases, each cell's mode and shape: label → (points,
    normals, colours, mask, cameras, lights, settings, vrk_h, shade)."""
    from dss_tpu_torch.geometry.shapes import (ico_sphere,
                                               sample_points_from_mesh)
    from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
    from dss_tpu_torch.render.lighting import PointLights
    from dss_tpu_torch.utils.mathutil import normalize

    prm = initial_params(data)
    dev, cams = prm.points.device, data["cams"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)

    def lit(n_views):
        return PointLights(
            ambient_color=0.1 + 0.2 * u(n_views, PREP_LIGHTS, 3),
            diffuse_color=0.2 + 0.3 * u(n_views, PREP_LIGHTS, 3),
            specular_color=0.1 + 0.2 * u(n_views, PREP_LIGHTS, 3),
            location=4.0 * u(n_views, PREP_LIGHTS, 3) - 2.0)

    def cloud(points, normals):
        mask = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
        return points, normals, 0.2 + 0.6 * u(points.shape[0], 3), mask

    flag = cloud(prm.points.detach(), normalize(prm.normals.detach()))
    st = RasterSettings(**FLAGSHIP_RASTER)
    h = compute_vrk_h_global(flag[0], flag[3])
    rng = np.random.default_rng(SEED + 11)
    verts, faces = ico_sphere(level=4, radius=0.5)
    pts, nrm = sample_points_from_mesh(verts, faces, PREP_DEFAULT[1], rng=rng)
    default = cloud(*(torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in (pts, nrm)))
    view = cams.take(torch.arange(PREP_DEFAULT[0], device=dev))
    return {
        "flagship": (*flag, cams, lit(N_VIEWS), st, h, True),
        "default": (*default, view, lit(PREP_DEFAULT[0]),
                    RasterSettings(**PREP_DEFAULT_RASTER), None, True),
        "neural": (*flag, cams, lit(N_VIEWS), st, h, False),
        "raw colours": (*flag, cams, None, st, h, True),
    }


def check_prep(data):
    """The render's set-up kernels (csrc/prep_splats.cu) in each cell's
    mode and shape, as check_knn runs its four: the flagship (V 8, P 5000,
    PREP_LIGHTS point lights a view, Vrk_invariant, clip 0.05), the default
    cell (V 1, P 8000, the anisotropic Vrk and frame of compute_vrk,
    cutoff 0.5, lit), the neural texture (the flagship's, no shading in
    the kernel) and the raw colours (the flagship's, no lights).  In each,
    prep_fwd's outputs bit-equal to the composite's (prep.prep_composite,
    its plain version) and prep_bwd's gradients bit-equal to their closed
    form (prep.prep_bwd_plain) on the card: cuBLAS picks the composite's
    GEMM kernels, and so its orders of summation, by shape.  Then at the
    flagship's: each kernel and its plain version timed per launch in a
    CUDA graph of 20 launches, and the set-up's forward and backward under
    a loss of the two cotangents, through the kernels and through the
    composite under autograd, each in a graph.  Bound: the bytes read and
    written over the memory rate (~300 float operations per (view, point)
    need 100× less).  Returns the two kernels' records."""
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render import prep

    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    runs = {}
    for label, case in _prep_cases(data).items():
        points, normals, colors, mask, cams, lights, st, vrk_h, shade = case
        v, p = len(cams), points.shape[0]
        packed = prep.prep_inputs(points, normals, mask, cams, lights, st,
                                  vrk_h, shade=shade)
        g_screen = 0.04 * torch.randn((v, p, 3), generator=gen, device=DEV)
        g_shaded = (torch.randn((v, p, 3), generator=gen, device=DEV)
                    if shade else None)
        fwd_in = (points, normals, colors, mask, *packed)
        bwd_in = (points, normals, colors, *packed, g_shaded, g_screen)

        def composite(case=case):
            with torch.no_grad():
                shaded, spl, pts_s = prep.prep_composite(*case[:-1], 64.0,
                                                         shade=case[-1])
            return (shaded, pts_s, spl.ellipse_params, spl.cutoff,
                    spl.radii, spl.scaler, spl.mask)

        differ = [f"prep_fwd output {i}" for i, (g, w) in
                  enumerate(zip(kernels.prep_fwd(*fwd_in), composite()))
                  if not _bits_equal(g, w)]
        differ += [f"prep_bwd gradient {i}" for i, (g, w) in
                   enumerate(zip(kernels.prep_bwd(*bwd_in),
                                 prep.prep_bwd_plain(*bwd_in)))
                   if not _bits_equal(g, w)]
        if differ:
            raise AssertionError(f"prep {label}: {differ} differ from the "
                                 f"composite's or the closed form's bits")
        print(f"prep {label} (V {v}, P {p}, mode {packed[2].shade}, "
              f"{'h' if packed[2].h is not None else 'Vrk'}): prep_fwd "
              f"bit-equal to the composite, prep_bwd to its closed form")
        runs[label] = (case, fwd_in, bwd_in, composite)

    case, fwd_in, bwd_in, composite = runs["flagship"]
    recs = {}
    for name, kernel, plain, args in (
            ("prep_fwd", kernels.prep_fwd, lambda *a: composite(), fwd_in),
            ("prep_bwd", kernels.prep_bwd, prep.prep_bwd_plain, bwd_in)):
        got = kernel(*args)
        n_bytes = _bytes(*(a for a in args if isinstance(a, torch.Tensor)),
                         *got)
        ms = _graph_ms(lambda: kernel(*args), 20)
        pms = _graph_ms(lambda: plain(*args), 20)
        bms, by = _bound(n_bytes, 0)
        recs[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=bms,
                          bound_by=by, library_ms=None)
        print(f"{name} (V {N_VIEWS}, P {N_POINTS}, {PREP_LIGHTS} point "
              f"lights): {ms:.4f} ms per launch, bound {bms:.5f} ms ({by}, "
              f"{n_bytes} B, {100 * bms / ms:.1f}%); plain version "
              f"{pms:.4f} ms")

    points, normals, colors, mask, cams, lights, st, vrk_h, _ = case
    g_shaded, g_screen = bwd_in[-2:]

    def step(fn):
        leaves = [x.clone().requires_grad_(True)
                  for x in (points, normals, colors)]
        shaded, _, pts = fn(*leaves, mask, cams, lights, st, vrk_h, 64.0)
        loss = (pts * g_screen).sum() + (shaded * g_shaded).sum()
        return torch.autograd.grad(loss, leaves)

    per_step = {label: _graph_ms(lambda: step(fn), 10) for label, fn in
                (("kernels", prep.prep_splats),
                 ("composite", prep.prep_composite))}
    print(f"the set-up's forward and backward per step in a graph (with "
          f"the loss's two products and sums): kernels "
          f"{per_step['kernels']:.4f} ms, composite "
          f"{per_step['composite']:.4f} ms")
    return recs


def _hold_binned(label, got, want):
    """Raise unless the four fields of two BinnedSplats are equal bit for
    bit."""
    differ = [f"{f} ({int((getattr(got, f) != getattr(want, f)).sum())})"
              for f in got._fields
              if not _bits_equal(getattr(got, f), getattr(want, f))]
    if differ:
        raise AssertionError(f"bin {label}: {differ} differ from the plain "
                             f"version's")


def check_bin(data):
    """The binning kernels (csrc/bin_tiles.cu) at the flagship's tables
    (flagship_tables: V 8, P 5000, 64 tiles of 64², M 2048) and the default
    cell's (check_prep's default cloud: V 1, P 8000, M 3200, support M
    6016): the forward table (bin_splats) and the support table with cur_r²
    (bin_for_occ_backward on the visibility K1 reads off the forward table,
    the scaler as the train step passes it, a 0-d device tensor) bit-equal
    to the plain versions on the card, and the long-segment counter 0.
    Each table and the median timed as graph replays of 20 calls (the
    kernels and the wrapper's fill) against its plain version; the bound
    is the bytes read and written (the splats' channels, the table whole,
    its ids and counts) over the memory rate.  Returns the flagship's
    records."""
    from dss_tpu_torch.ops import kernels, splat
    from dss_tpu_torch.render.renderer import _prep_view, _tile_config

    st, cfg, pts_s, spl, shaded, _ = flagship_tables(data)
    cases = {"flagship": (st, cfg, pts_s, spl, shaded)}
    pts, nrm, col, mask, view, lights, dst, vrk_h, _ = _prep_cases(data)[
        "default"]
    with torch.no_grad():
        d_shaded, d_spl, d_pts = _prep_view(pts, nrm, col, mask, view, lights,
                                            dst, vrk_h, 64.0)
    cases["default"] = (dst, _tile_config(pts.shape[0], dst), d_pts, d_spl,
                        d_shaded)
    kernels.read_bin_long_tiles(DEV)
    recs = {}
    for label, (st, cfg, pts_s, spl, shaded) in cases.items():
        v, p = pts_s.shape[:2]
        s = st.image_size
        fwd_args = (pts_s, spl.ellipse_params, spl.cutoff, spl.radii, s,
                    cfg.tile, cfg.cap, cfg.max_tiles, cfg.max_tiles)
        fwd_kw = dict(scaler=spl.scaler, features=shaded)
        fwd = splat.bin_splats(*fwd_args, **fwd_kw)
        _hold_binned(f"{label} forward", fwd,
                     splat.bin_splats_plain(*fwd_args, **fwd_kw))
        vis = kernels.fwd_lean(fwd.tile_counts, fwd.tile_data, p,
                               st.depth_merging_threshold, s, cfg.tile,
                               st.points_per_pixel)[1] > 0
        bt, bcap, bmt, bpc = splat._bwd_tile_budget(cfg, p)
        rbs = torch.full((), float(st.radii_backward_scaler), device=DEV)
        bwd_args = (pts_s, spl.radii, vis, rbs, s, bt, bcap, bmt, bpc)
        (bwd, r2), (pbwd, pr2) = (splat.bin_for_occ_backward(*bwd_args),
                                  splat.bin_for_occ_backward_plain(*bwd_args))
        _hold_binned(f"{label} support", bwd, pbwd)
        if not _bits_equal(r2, pr2):
            raise AssertionError(f"bin {label}: cur_r² {r2.tolist()} against "
                                 f"the plain version's {pr2.tolist()}")
        long_tiles = kernels.read_bin_long_tiles(DEV)
        if long_tiles:
            raise AssertionError(f"bin {label}: {long_tiles} tiles took the "
                                 f"long-segment path")
        radii2 = spl.radii.reshape(v, -1)
        vis2 = vis[..., None].expand(v, p, 2).reshape(v, -1)
        runs = {
            "forward": (lambda: splat.bin_splats(*fwd_args, **fwd_kw),
                        lambda: splat.bin_splats_plain(*fwd_args, **fwd_kw),
                        _bytes(pts_s, spl.ellipse_params, spl.cutoff,
                               spl.radii, spl.scaler, shaded, *fwd)),
            "support": (lambda: splat.bin_for_occ_backward(*bwd_args),
                        lambda: splat.bin_for_occ_backward_plain(*bwd_args),
                        _bytes(pts_s, spl.radii, vis, *bwd, r2)),
            "median": (lambda: kernels.median_select(radii2, vis, scale=rbs),
                       lambda: splat.masked_median_plain(radii2, vis2) * rbs,
                       _bytes(radii2, vis) + 3 * v * 4),
        }
        for part, (fn, plain, n_bytes) in runs.items():
            ms, pms = _graph_ms(fn, 20), _graph_ms(plain, 20)
            bms, by = _bound(n_bytes, 0)
            print(f"bin {label} {part} (V {v}, P {p}): bit-equal to the plain "
                  f"version; {ms:.4f} ms per call, bound {bms:.5f} ms ({by}, "
                  f"{n_bytes} B, {100 * bms / ms:.1f}%); plain version "
                  f"{pms:.4f} ms")
            if label == "flagship" and part != "support":
                name = "bin_tiles" if part == "forward" else "median_select"
                recs[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, library_ms=None)
        print(f"bin {label}: forward {tuple(fwd.tile_data.shape)}, max count "
              f"{int(fwd.tile_counts.max())}, overflow "
              f"{int(fwd.overflow.sum())}; support "
              f"{tuple(bwd.tile_data.shape)}, max count "
              f"{int(bwd.tile_counts.max())}, overflow "
              f"{int(bwd.overflow.sum())}; long-segment tiles 0")
    return recs


def check_knn(data):
    """The exact kNN kernel against its plain version (the distance matmul
    and torch.topk) at the cells' four shapes (KNN_SHAPES) on start clouds
    (uniform on a sphere of radius 0.5): distances bit-equal, index sets
    equal but for ties at the last slot.  Times the kernel alone and with
    its wrapper (as graph replays: at these sizes a call from the host
    takes longer) and the plain version; the bound is operations over the
    FP32 rate (KNN_OPS_PER_PAIR per pair; the 16 B per point are
    negligible).  Returns the record of the flagship's build_knn shape."""
    from dss_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 5)
    rec = None
    for n, k, excl in KNN_SHAPES:
        v = rng.normal(size=(n, 3))
        p = torch.tensor((0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True))
                         .astype(np.float32), device=DEV)
        m = torch.ones(n, dtype=torch.bool, device=DEV)
        run = lambda: kernels.knn_topk(p, p, m, m, k=k, exclude_self=excl)
        plain = lambda: kernels.knn_topk_plain(p, p, m, m, k=k,
                                               exclude_self=excl)
        (d, i), (pd, pi) = run(), plain()
        last = torch.where(torch.isfinite(d), d, -float("inf")).amax(
            dim=1, keepdim=True)
        below = (d < last) & (i >= 0)
        sets = lambda x: torch.sort(torch.where(below, x, -2), dim=1).values
        ties = int(((d == last) & (i != pi)).any(dim=1).sum())
        if not (torch.equal(d, pd) and torch.equal(sets(i), sets(pi))):
            raise AssertionError(
                f"knn_topk {n}² k {k}: {int((d != pd).sum())} distances "
                f"differ from the plain version's; index sets equal "
                f"{torch.equal(sets(i), sets(pi))}")
        qq = torch.sum(p * p, dim=-1)
        ms = _graph_ms(lambda: kernels._call(
            "dss_knn_topk", p.data_ptr(), qq.data_ptr(), m.data_ptr(),
            p.data_ptr(), qq.data_ptr(), m.data_ptr(), d.data_ptr(),
            i.data_ptr(), n, n, k, int(excl)), 20)
        wms = _graph_ms(run, 20)
        pms = _graph_ms(plain, 5)
        bms, by = _bound(n * 16, n * n * KNN_OPS_PER_PAIR)
        print(f"knn_topk {n}² k {k}{' + self' if excl else ''}: distances "
              f"bit-equal to the plain version's, index sets equal ({ties} "
              f"rows tie at the last slot); kernel {ms:.4f} ms, with the "
              f"wrapper's |q|² {wms:.4f} ms (graph replays), plain "
              f"{pms:.4f} ms, bound {bms:.5f} ms ({by})")
        if rec is None or (n, k) == (5000, 11):
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=bms,
                       bound_by=by, library_ms=None)
    return rec


def _rotated(rng, w):
    """Symmetric matrices R diag(w) Rᵀ (float64 numpy) for eigenvalues w
    (n, 3) and random rotations R."""
    q, _ = np.linalg.qr(rng.standard_normal((len(w), 3, 3)))
    return np.einsum("nij,nj,nkj->nik", q, w, q)


def symeig3_cases(dev):
    """The eigensolver's hand-made rows, 1000 each: planar (λ₀ = 0 and
    λ₀ = 1e-7, the others in [0.5, 2]), line-like (two equal eigenvalues,
    below and above the third), zero, and a random SPD matrix with a NaN
    in its lower triangle (off the diagonal, then on it)."""
    rng = np.random.default_rng(SEED + 3)
    n = 1000
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    b = rng.standard_normal((2 * n, 3, 3))
    nan = b @ np.swapaxes(b, 1, 2)
    nan[:n, 2, 0] = np.nan
    nan[n:, 1, 1] = np.nan
    cases = {
        "planar λ0 = 0": _rotated(rng, np.stack([np.zeros(n), u(.5, 2), u(.5, 2)], -1)),
        "planar λ0 = 1e-7": _rotated(rng, np.stack([np.full(n, 1e-7), u(.5, 2), u(.5, 2)], -1)),
        "line λ0 = λ1": _rotated(rng, np.stack([np.full(n, .7), np.full(n, .7), u(1, 2)], -1)),
        "line λ1 = λ2": _rotated(rng, np.stack([u(0, 1), np.full(n, 2.), np.full(n, 2.)], -1)),
        "zero": np.zeros((n, 3, 3)),
        "NaN": nan,
    }
    return {k: torch.tensor(v.astype(np.float32), device=dev)
            for k, v in cases.items()}


def _rel_gaps(w):
    """Each eigenvalue's distance to the nearest other one over the row's
    largest |λ|, (N, 3) (float64)."""
    w = w.double()
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
    return torch.stack([torch.minimum((w[:, i] - w[:, (i + 1) % 3]).abs(),
                                      (w[:, i] - w[:, (i + 2) % 3]).abs())
                        for i in range(3)], dim=1) / scale


def _eigh(mats):
    """torch.linalg.eigh in batches of EIGH_BATCH matrices."""
    out = [torch.linalg.eigh(m) for m in torch.split(mats, EIGH_BATCH)]
    return torch.cat([w for w, _ in out]), torch.cat([v for _, v in out])


def _hold_symeig3(label, mats, with_library):
    """The kernel against its plain version on `mats` (eigenvalues rtol
    1e-5 with atol 1e-6 of the row's largest |λ|, eigenvectors up to sign
    to 1e-5 where the relative gap is at least SYMEIG3_GAP; NaN rows all
    NaN in both) and, with `with_library`, against torch.linalg.eigh in
    float32 (SYMEIG3_LIB_TOL) and float64 (printed).  Returns the largest
    |kernel − plain| and the kernel's output."""
    from dss_tpu_torch.ops import kernels

    w, v = kernels.symeig3(mats)
    pw, pv = kernels.symeig3_plain(mats)
    bad = ~torch.isfinite(mats).flatten(1).all(dim=1)
    if bad.any() and not (torch.isnan(w[bad]).all() and torch.isnan(v[bad]).all()
                          and torch.isnan(pw[bad]).all()
                          and torch.isnan(pv[bad]).all()):
        raise AssertionError(f"symeig3 {label}: a row with a NaN entry "
                             f"gives finite output")
    if torch.isnan(w[~bad]).any() or torch.isnan(v[~bad]).any():
        raise AssertionError(f"symeig3 {label}: NaN from a finite row")
    w, v, pw, pv = w[~bad], v[~bad], pw[~bad], pv[~bad]
    if not len(w):
        print(f"symeig3 {label}: {len(mats)} rows, each all NaN from the "
              f"kernel and the plain version")
        return 0.0, (w, v)
    rowmax = pw.abs().amax(dim=1, keepdim=True)
    dw = (w - pw).abs()
    if (dw > 1e-5 * pw.abs() + 1e-6 * rowmax).any():
        raise AssertionError(f"symeig3 {label}: eigenvalues off the plain "
                             f"version's by {float(dw.max()):.3e}")
    ok = _rel_gaps(pw) >= SYMEIG3_GAP
    sign = torch.where((v * pv).sum(dim=1, keepdim=True) < 0, -1.0, 1.0)
    dv = ((v * sign - pv).abs().amax(dim=1))[ok]
    if (dv > 1e-5).any():
        raise AssertionError(f"symeig3 {label}: eigenvectors off the plain "
                             f"version's by {float(dv.max()):.3e}")
    err = max(float(dw.max()), float((v - pv).abs().max()))
    same = torch.equal(w, pw) and torch.equal(v, pv)
    msg = (f"symeig3 {label}: {len(mats)} rows, kernel against plain max "
           f"|Δ| {err:.3e} ({'bit-equal' if same else 'not bit-equal'}); "
           f"{int(ok.sum())} eigenvectors with a relative gap ≥ {SYMEIG3_GAP:g}")
    if with_library:
        lw, lv = _eigh(mats[~bad])
        w64, _ = _eigh(mats[~bad].double())
        scale = w64.abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
        dl = (w - lw).abs()
        if (dl > SYMEIG3_LIB_TOL * scale).any():
            raise AssertionError(f"symeig3 {label}: eigenvalues off "
                                 f"torch.linalg.eigh's by {float(dl.max()):.3e}")
        proj = lambda x: x[:, :, None, :] * x[:, None, :, :]  # (N, 3, 3, j)
        gap = _rel_gaps(w64)
        dp = (proj(v.double()) - proj(lv.double())).abs().amax(dim=(1, 2))
        ok = gap >= SYMEIG3_GAP
        if (dp[ok] * gap[ok] > SYMEIG3_LIB_TOL).any():
            raise AssertionError(f"symeig3 {label}: projectors off "
                                 f"torch.linalg.eigh's by {float(dp[ok].max()):.3e}")
        msg += (f"; against torch.linalg.eigh max |Δλ| / max|λ| "
                f"{float((dl / scale).max()):.3e}, max |Δ v vᵀ|·gap "
                f"{float((dp[ok] * gap[ok]).max()) if ok.any() else 0.0:.3e}; "
                f"|λ − λ(float64)| / max|λ|: kernel "
                f"{float(((w - w64).abs() / scale).max()):.3e}, eigh "
                f"{float(((lw - w64).abs() / scale).max()):.3e}")
    print(msg)
    return err, (w, v)


def check_symeig3(data):
    """The eigensolver kernel against its plain version and torch.linalg.eigh
    on the card: the 8-NN covariances of the flagship cloud (the main
    path's N = P), SYMEIG3_RANDOM random SPD matrices and the hand-made
    rows (`symeig3_cases`; the library sees the finite ones).  Times the
    kernel (as graph replays: at N = P a call from the host takes longer
    than the kernel), the plain version and torch.linalg.eigh at both
    batch sizes;
    the bound is bytes over the memory rate (36 B in, 48 B out per matrix;
    the operations of 3·SWEEPS rotations per matrix take less).  Returns
    the record of the main path's shape."""
    from dss_tpu_torch.geometry.normals import local_covariances
    from dss_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    with torch.no_grad():
        cov, _ = local_covariances(initial_params(data).points.detach(),
                                   neighborhood_size=8)
        b = torch.randn((SYMEIG3_RANDOM, 3, 3), generator=gen, device=DEV)
        spd = (b @ b.transpose(1, 2)).contiguous()
        sets = {"flagship 8-NN covariances": cov.contiguous(),
                "random SPD": spd, **symeig3_cases(DEV)}
        held = {k: _hold_symeig3(k, m, with_library=True)
                for k, m in sets.items()}
        w, v = held["zero"][1]
        eye = torch.eye(3, device=DEV).expand_as(v)
        if not (torch.equal(w, torch.zeros_like(w)) and torch.equal(v, eye)):
            raise AssertionError("symeig3 zero: expected λ = 0 and v = I")
        rec = None
        for label, m in (("flagship", sets["flagship 8-NN covariances"]),
                         ("random SPD", spd)):
            n = len(m)
            ms = _graph_ms(lambda: kernels.symeig3(m), 20)
            eager_ms = _time_ms(lambda: kernels.symeig3(m), 50)
            pms = _time_ms(lambda: kernels.symeig3_plain(m), 3)
            lms = _time_ms(lambda: _eigh(m), 5)
            bms, by = _bound(n * (36 + 12 + 36),
                             n * 3 * kernels.SYMEIG3_SWEEPS * SYMEIG3_ROT_OPS)
            calls = -(-n // EIGH_BATCH)
            print(f"symeig3 {label} (N = {n}): kernel {ms:.4f} ms (graph "
                  f"replay; {eager_ms:.4f} ms a call from the host), plain "
                  f"{pms:.4f} ms, torch.linalg.eigh {lms:.4f} ms"
                  + (f" ({calls} calls of ≤ {EIGH_BATCH})" if calls > 1 else "")
                  + f", bound {bms:.6f} ms ({by})"
                  + ("; launch-bound at this N" if n < 10**5 else ""))
            if rec is None:
                rec = dict(max_abs_err=max(e for e, _ in held.values()),
                           ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                           library_ms=lms)
    return rec


def check_small_reference():
    """The splat op on the card against its plain version on the CPU, on
    one small input (64², 400 points, 3 views, tile 16): forward outputs
    and gradients."""
    from dss_tpu_torch.ops.splat import (TileConfig,
                                         rasterize_views_fragments,
                                         rasterize_views_lean)

    rng = np.random.default_rng(SEED + 1)
    v, p, s = 3, 400, 64
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (v, p, 2)),
                          rng.uniform(1.0, 3.0, (v, p, 1))], -1)
    a = rng.uniform(200.0, 900.0, (v, p, 1))
    c = rng.uniform(200.0, 900.0, (v, p, 1))
    b = rng.uniform(-100.0, 100.0, (v, p, 1))
    ell = np.concatenate([a, b, c], -1)
    cut = np.ones((v, p))
    den = 4 * a * c - b * b
    radii = np.sqrt(np.concatenate([4 * c / den, 4 * a / den], -1))
    scl = rng.uniform(0.5, 1.5, (v, p))
    feat = rng.uniform(0.0, 1.0, (v, p, 3))
    gocc = rng.standard_normal((v, s, s))
    grgb = rng.standard_normal((v, s, s, 5))
    cfg = TileConfig(tile=16, cap=512, max_tiles=4, depth_channel=1)

    def run(dev):
        f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
        ps, fe = f(pts).requires_grad_(), f(feat).requires_grad_()
        occ, vis, rgbw, over = rasterize_views_lean(
            s, 5, cfg, ps, f(ell), f(cut), f(radii), 0.05, 5.0, f(scl), fe)
        loss = (occ * f(gocc)).sum() + (rgbw * f(grgb)).sum()
        gp, gf = torch.autograd.grad(loss, (ps, fe))
        return [x.detach().cpu() for x in (occ, vis, rgbw, over, gp, gf)]

    got, want = run(DEV), run("cpu")
    for name, i in (("occ", 0), ("visible", 1), ("overflow", 3)):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"small reference: {name} differs")
    _close("small reference rgbw", got[2], want[2], 1e-5, 1e-6)
    _close("small reference grad pts", got[4], want[4], 1e-4, 1e-5)
    _close("small reference grad features", got[5], want[5], 1e-4, 1e-5)
    print(f"small reference (64², {p} points, {v} views): CUDA op matches "
          f"the CPU plain path; visible {int(got[1].sum())}, rgbw max "
          f"{float(got[2].abs().max()):.4f}")

    gz = rng.standard_normal((v, s, s, 5))
    fcfg = TileConfig(tile=16, cap=512, max_tiles=4)

    def run_frag(dev):
        f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
        ps, fe = f(pts).requires_grad_(), f(feat).requires_grad_()
        out = rasterize_views_fragments(
            s, 5, fcfg, ps, f(ell), f(cut), f(radii), 0.05, 5.0, f(scl), fe)
        idx, zbuf, _q, occ, _vis, rgbw, _over = out
        loss = ((occ * f(gocc)).sum() + (rgbw * f(grgb[..., :4])).sum()
                + (zbuf * f(gz)).sum())
        return [x.detach().cpu() for x in
                (*out, *torch.autograd.grad(loss, (ps, fe)))]

    got, want = run_frag(DEV), run_frag("cpu")
    for name, i in (("idx", 0), ("zbuf", 1), ("qvalue", 2), ("occ", 3),
                    ("visible", 4), ("overflow", 6)):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"small reference, fragment op: {name} differs")
    _close("small reference fragment rgbw", got[5], want[5], 1e-5, 1e-6)
    _close("small reference fragment grad pts", got[7], want[7], 1e-4, 1e-5)
    _close("small reference fragment grad features", got[8], want[8], 1e-4,
           1e-5)
    if not (got[7][..., 2].abs().max() > 0):
        raise AssertionError("small reference, fragment op: no z gradient")
    print(f"small reference, fragment op: CUDA op matches the CPU plain "
          f"path; {int((got[0] >= 0).sum())} fragments, max |dL/dz| "
          f"{float(got[7][..., 2].abs().max()):.4g}")


def check_launches(label, launches, must, once=(), n_once=0):
    """Raise unless every kernel in `must` launched, those in `once`
    exactly n_once times, and no other kernel at all (but the kNN and the
    window's guard and update, ASIDE)."""
    missing = [k for k in must if launches[k] == 0]
    stray = [k for k, n in launches.items()
             if k not in must and k not in ASIDE and n > 0]
    not_once = [k for k in once if launches[k] != n_once]
    if missing or stray or not_once:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"kernels launched off their path {stray}, "
                             f"kernels not launched {n_once} times {not_once}")


def check_counts(label, launches, want):
    """Raise unless each kernel launched exactly as often as `want` says
    (0 where it names none; the kNN, the guard and the update only where
    it names them)."""
    got = {k: n for k, n in launches.items()
           if n and (k not in ASIDE or k in want)}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def train(data, raster, targets, must, label, once=()):
    """1 warm-up step and TIMED_STEPS timed steps through make_train_step
    with the flagship recipe on `raster`.  Every kernel in `must` has to
    launch during the steps, those in `once` exactly once per step, and
    every other kernel must not.  Returns (launch counts of the run, step
    times in ms)."""
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                chamfer_distance,
                                                create_train_state,
                                                make_optimizer,
                                                make_train_step)

    params = initial_params(data)
    state = create_train_state(params, make_optimizer(params, **FLAGSHIP_OPT))
    step = make_train_step(RasterSettings(**raster), TrainConfig(**FLAGSHIP_TRAIN),
                           AnnealSchedule(**FLAGSHIP_SCHEDULE))
    cd0, _ = chamfer_distance(params.points.detach(), data["gt_pts"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steps = []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, data["cams"], data["lights"], targets["img"],
                        targets["mask_img"], targets["depth"])
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, m))
    times = [dt for dt, _ in steps[1:]]
    # the metrics are read after the run, not per step
    for i, (dt, m) in enumerate(steps):
        parts = {k: float(v) for k, v in m.items()}
        print(f"{label} step {i}{' (warm-up)' if i == 0 else ''}: {dt:.2f} ms  "
              + "  ".join(f"{k} {v:.6g}" for k, v in sorted(parts.items())))
        if not (all(np.isfinite(v) for v in parts.values())
                and bool(m["params_finite"])):
            raise AssertionError(f"{label} step {i}: non-finite loss or gradient")
    launches = kernels.launch_counts()
    check_launches(f"{label} steps", launches, must, once, 1 + TIMED_STEPS)
    if DEV == "cuda":  # CPU tensors launch nothing
        check_counts(f"{label} steps: the exact kNN", {KNN: launches[KNN]},
                     {KNN: KNN_PER_STEP * (1 + TIMED_STEPS)})
    cd1, _ = chamfer_distance(state.params.points.detach(), data["gt_pts"])
    print(f"{label} launches during the {1 + TIMED_STEPS} steps: {launches}")
    print(f"{label} median step {statistics.median(times):.3f} ms over "
          f"{TIMED_STEPS} steps (min {min(times):.3f}, max {max(times):.3f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{label} chamfer to ground truth: {float(cd0):.6f} before, "
          f"{float(cd1):.6f} after {1 + TIMED_STEPS} steps")
    return launches, times


def _fresh_state(data):
    from dss_tpu_torch.training.trainer import (create_train_state,
                                                make_optimizer)

    params = initial_params(data)
    return create_train_state(params, make_optimizer(params, **FLAGSHIP_OPT))


def _state_tensors(state):
    """Parameters, then each group's exp_avg, exp_avg_sq and count, as
    float32 tensors on the CPU."""
    out = [t.detach().float().cpu().clone() for t in state.params.tensors()]
    for t in state.params.tensors():
        st = state.optimizer.state[t]
        # clone: a CPU state's .cpu() is the tensor itself, which the
        # next update changes in place
        out += [st[k].detach().float().cpu().clone().reshape(-1)
                for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


class _Dist(NamedTuple):
    """|Δ| between two train states over every element of the parameters,
    Adam's moments and counts: the largest, the WINDOW_QUANTILE quantile,
    and how many elements differ by more than 1e-4."""

    max: float
    q: float
    far: int

    def __str__(self):
        return (f"max {self.max:.3e}, q{WINDOW_QUANTILE:g} {self.q:.3e}, "
                f"{self.far} > 1e-4")


def _state_dist(a, b):
    """_Dist between two train states, or two `_state_tensors` lists."""
    if not isinstance(a, list):
        a, b = _state_tensors(a), _state_tensors(b)
    d = torch.cat([(x - y).abs().reshape(-1) for x, y in zip(a, b)])
    return _Dist(float(d.max()), float(torch.quantile(d, WINDOW_QUANTILE)),
                 int((d > 1e-4).sum()))


def _window_steps(data, targets, raster, graph, k, train=FLAGSHIP_TRAIN):
    """A fresh window over the flagship batch, k dispatches of one step:
    (window, state, epoch_idx, the state after step 1 (`_state_tensors`),
    the k losses)."""
    win, st, rows = _window_for(data, targets, raster, graph=graph,
                                train=train)
    losses = []
    for i in range(k):
        st, m = win(st, rows, 1)
        losses.append(m["loss"])
        if i == 0:
            one = _state_tensors(st)
    return win, st, rows, one, [float(x) for x in losses]


def _rel(a, b):
    """Largest relative difference of two loss sequences."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _window_for(data, targets, raster, graph, nan_view=False,
                train=FLAGSHIP_TRAIN):
    """(window, state, epoch_idx) over the flagship batch with the train
    config `train`: one 8-view batch per step (epoch_idx [[0..7]]); with
    `nan_view`, a second batch of the same views with a NaN in the last
    view's mask, and the epoch [[0..7], [8..15], [0..7]]: the step in the
    middle is skipped."""
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                make_train_window)

    cams, lights = data["cams"], data["lights"]
    img, mask, depth = targets["img"], targets["mask_img"], targets["depth"]
    rows = [list(range(N_VIEWS))]
    if nan_view:
        cat = lambda b: type(b)(**{f.name: torch.cat([getattr(b, f.name)] * 2)
                                   for f in dataclasses.fields(b)})
        cams, lights = cat(cams), cat(lights)
        bad = mask.clone()
        bad[-1, 0, 0] = float("nan")
        img, mask, depth = (torch.cat([img, img]), torch.cat([mask, bad]),
                            torch.cat([depth, depth]))
        rows = [rows[0], list(range(N_VIEWS, 2 * N_VIEWS)), rows[0]]
    state = _fresh_state(data)
    window = make_train_window(
        RasterSettings(**raster), TrainConfig(**train),
        AnnealSchedule(**FLAGSHIP_SCHEDULE), state, cams, lights, img, mask,
        depth, graph=graph)
    return window, state, torch.tensor(rows, device=DEV)


def window(data, raster, targets, must, label, smi, grid_route=False,
           train=FLAGSHIP_TRAIN, knn=KNN_PER_STEP):
    """The flagship step (or the recipe of `raster` and `train`) through
    the train window (make_train_window, as train_mvr runs it): a CUDA
    graph of the step, captured at the first dispatch, replayed once per
    step, against the same window run eagerly (graph=False) and against
    make_train_step.

    Adam divides each moment by its root mean square, so an element whose
    gradient is at the level of K2's and K3's atomics noise moves by ±lr
    either way, and the elements it moves change the next gradients: two
    eager runs end a few elements apart by O(lr) after one step and more
    after each further step.  States are compared after one step, by the
    WINDOW_QUANTILE quantile of |Δ| over all their elements (`_state_dist`;
    the largest |Δ|, and the distances after WINDOW_K steps, are printed
    beside it), and the WINDOW_K steps by their losses.

    (i) the first replayed step's loss equals make_train_step's from the
    same state (rtol 1e-6); after one step the graphed state (parameters,
    Adam's moments and counts) lies no further from an eager window's than
    two eager windows lie from each other (at least WINDOW_ATOL: that
    distance is one random sample of the atomics' spread), and within 1e-5
    of make_train_step's (the same update, the atomics' noise apart); the
    losses of WINDOW_K steps within WINDOW_LOSS_RTOL of an eager window's;
    (ii) a NaN in the mask of the middle batch of a 3-step window is
    skipped (params_finite false, Adam's count 2, step 3) and the graphed
    state lies as close to the eager window's skip; (iii) the median ms
    per step over WINDOW_DISPATCHES dispatches of WINDOW_K replays, graphed,
    and make_train_step's; (iv) the graph launches each kernel of `must`
    exactly once per replay (per_replay), and the timed dispatches launch
    each exactly WINDOW_K × WINDOW_DISPATCHES times, as the guard, the
    update and the set-up's two kernels; the exact kNN `knn` times per
    replay (once fewer on the grid route), the binning's two tables and
    median (bin_per).  With `grid_route`, the same (i) with the surface
    losses' kNN on the grid (DSS_KNN_GRID_THRESHOLD=0).  Everything is printed before a failed
    check raises.  Returns (the launch counts of the phase, graphed ms per
    step, make_train_step ms per step)."""
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                make_train_step)

    bin_per = {"bin_tiles": 2 * kernels.BIN_LAUNCHES, "median_select": 1}
    k, n_disp = WINDOW_K, WINDOW_DISPATCHES
    total, faults = {}, []

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    kernels.reset_launch_counts()
    step = make_train_step(RasterSettings(**raster), TrainConfig(**train),
                           AnnealSchedule(**FLAGSHIP_SCHEDULE))
    batch = (data["cams"], data["lights"], targets["img"],
             targets["mask_img"], targets["depth"])
    eager = _fresh_state(data)
    eager_ms, eager_losses = [], []
    for i in range(k):
        t0 = time.perf_counter()
        eager, m = step(eager, *batch)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_losses.append(m["loss"])
        if i == 0:
            eager1 = _state_tensors(eager)
    eager_losses = [float(x) for x in eager_losses]

    # two eager windows: the spread of the atomics
    _, st_a, _, one_a, loss_a = _window_steps(data, targets, raster, False, k,
                                              train)
    _, st_b, _, one_b, loss_b = _window_steps(data, targets, raster, False, k,
                                              train)
    spread1, spread = _state_dist(one_a, one_b), _state_dist(st_a, st_b)
    bound = max(spread1.q, WINDOW_ATOL)
    add(kernels.launch_counts())

    # the graph: the first dispatch captures, then one replay per step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    graph = DEV == "cuda"
    win, st, rows, one_g, loss_g = _window_steps(data, targets, raster,
                                                 graph, k, train)
    d1, d1_step = _state_dist(one_g, one_a), _state_dist(one_g, eager1)
    d_eager, d_step = _state_dist(st, st_a), _state_dist(st, eager)
    if not abs(loss_g[0] - eager_losses[0]) <= 1e-6 * abs(eager_losses[0]):
        faults.append(f"first replayed loss {loss_g[0]!r}, make_train_step's "
                      f"{eager_losses[0]!r}")
    if not (d1.q <= bound and d1_step.q <= 1e-5):
        faults.append(f"after one step: {d1} from an eager window (two eager "
                      f"windows: {spread1}), {d1_step} from make_train_step")
    if not _rel(loss_g, loss_a) <= WINDOW_LOSS_RTOL:
        faults.append(f"losses {loss_g} against an eager window's {loss_a}")
    per = win.per_replay
    if graph and per != {**{name: 1 for name in must + UPDATE + PREP},
                         KNN: knn, **bin_per}:
        faults.append(f"launches per replay {per}")
    add(kernels.launch_counts())

    kernels.reset_launch_counts()
    graph_ms = []
    for _ in range(n_disp):
        t0 = time.perf_counter()
        st, m = win(st, rows, k)
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) * 1e3 / k)
    parts = {key: float(v) for key, v in m.items()}
    launches = kernels.launch_counts()
    check_launches(f"window {label} timed dispatches", launches, must, must,
                   k * n_disp)
    if graph and launches[KNN] != knn * k * n_disp:
        faults.append(f"timed dispatches: {launches[KNN]} kNN launches, "
                      f"expected {knn * k * n_disp}")
    if graph and any(launches[name] != k * n_disp * bin_per.get(name, 1)
                     for name in UPDATE + PREP + BIN):
        faults.append(f"timed dispatches: guard, update, set-up and binning "
                      f"launches "
                      f"{[launches[name] for name in UPDATE + PREP + BIN]}, "
                      f"expected {k * n_disp} each, times {bin_per} for the "
                      f"binning")
    if not (all(np.isfinite(v) for v in parts.values())
            and parts["params_finite"] == 1.0):
        faults.append(f"metrics {parts}")
    add(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # (ii) a NaN batch in the middle of a 3-step window
    kernels.reset_launch_counts()
    skipped = []
    for g in (False, graph):
        w, s0, r = _window_for(data, targets, raster, graph=g,
                               nan_view=True, train=train)
        s0, mm = w(s0, r, 3)
        counts = {int(s0.optimizer.state[t]["step"]) for t in
                  s0.params.tensors()}
        if bool(mm["params_finite"]) or counts != {2} or s0.step != 3:
            faults.append(f"NaN step: params_finite "
                          f"{bool(mm['params_finite'])}, Adam counts "
                          f"{counts}, step {s0.step}")
        skipped.append(s0)
    d_nan = _state_dist(*skipped)
    if d_nan.q > bound:
        faults.append(f"NaN step: graphed state {d_nan} from the eager "
                      f"skip's (two eager windows: {spread})")
    add(kernels.launch_counts())

    # the surface losses' kNN through the grid (build_knn's
    # DSS_KNN_GRID_THRESHOLD route), graphed against eager
    d_grid = None
    if grid_route:
        os.environ["DSS_KNN_GRID_THRESHOLD"] = "0"
        try:
            kernels.reset_launch_counts()
            grid = [_window_steps(data, targets, raster, g, k, train)
                    for g in (False, graph)]
            add(kernels.launch_counts())
        finally:
            del os.environ["DSS_KNN_GRID_THRESHOLD"]
        d_grid = _state_dist(grid[1][3], grid[0][3])
        d_grid_k = _state_dist(grid[1][1], grid[0][1])
        if (_rel(grid[1][4][:1], grid[0][4][:1]) > 1e-6 or d_grid.q > bound
                or _rel(grid[1][4], grid[0][4]) > WINDOW_LOSS_RTOL
                or (graph and grid[1][0].per_replay
                    != {**per, KNN: per[KNN] - 1})):
            faults.append(f"grid kNN route: losses {grid[1][4]} against the "
                          f"eager window's {grid[0][4]}; after one step "
                          f"{d_grid}; per replay {grid[1][0].per_replay}")

    print(f"window {label}: first replayed loss {loss_g[0]:.9g} "
          f"(make_train_step {eager_losses[0]:.9g}); losses graphed "
          + ", ".join(f"{x:.9g}" for x in loss_g) + ", eager window "
          + ", ".join(f"{x:.9g}" for x in loss_a) + f" (largest relative "
          f"difference {_rel(loss_g, loss_a):.3e}; two eager windows "
          f"{_rel(loss_b, loss_a):.3e}); |Δ| state after one step: from an "
          f"eager window {d1}, two eager windows {spread1}, from "
          f"make_train_step {d1_step}; after {k} steps: {d_eager}, "
          f"{spread}, {d_step}; the NaN batch skipped, {d_nan} from the "
          f"eager skip; per replay {per}"
          + ("" if d_grid is None else
             f"; the grid kNN route graphed: after one step {d_grid}, after "
             f"{k} {d_grid_k} from its eager window, losses' largest "
             f"relative difference {_rel(grid[1][4], grid[0][4]):.3e}"))
    print(f"window {label}: median ms per step graphed "
          f"{statistics.median(graph_ms):.3f} (k = {k}, {n_disp} dispatches: "
          + ", ".join(f"{x:.3f}" for x in graph_ms)
          + f"), make_train_step {statistics.median(eager_ms):.3f} ("
          + ", ".join(f"{x:.3f}" for x in eager_ms)
          + "); " + ("no capture on the CPU" if win.capture_s is None else
                     f"capture {win.capture_s:.3f} s, graph pool "
                     f"{win.pool_bytes / 2**20:.1f} MiB")
          + f", peak memory {peak:.2f} GiB; loss {parts['loss']:.6g}  [{smi}]")
    if faults:
        raise AssertionError(f"window {label}: " + "; ".join(faults))
    return total, graph_ms, eager_ms


class _LogLines(logging.Handler):
    """Keeps the messages of a logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _graph_warmup():
    """Eager steps a train window runs before it captures its graph (the
    CPU runs no graph)."""
    from dss_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

    return GRAPH_WARMUP_STEPS if DEV == "cuda" else 0


def _dispatch():
    """How train_mvr's log names a dispatch on this device."""
    return "each a CUDA graph replay" if DEV == "cuda" else "eager"


def _device_argv():
    """The CLIs' default is the card; a CPU rehearsal names its device."""
    return [] if DEV == "cuda" else ["--device", DEV]


def _cli_run(label, cfg_path, iters, name=None, extra=(), phase="train_cli"):
    """One in-process run of the train CLI to `iters` iterations, with the
    launch counts set to 0 just before it and read just after; returns
    (launches, log lines)."""
    from dss_tpu_torch.apps.train_mvr import main as train_main
    from dss_tpu_torch.ops import kernels

    argv = ["--config", cfg_path, "--max-iters", str(iters), "--seed", str(SEED),
            *extra, *_device_argv()]
    if name:
        argv += ["--name", name]
    log = _LogLines()
    logger = logging.getLogger("train_mvr")
    logger.addHandler(log)
    try:
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        train_main(argv)
        launches = kernels.launch_counts()
    finally:
        logger.removeHandler(log)
    print(f"{phase} {label}: {time.perf_counter() - t0:.2f} s, launches "
          f"{launches}")
    return launches, log.lines


def _metrics_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_cli_outputs(label, run_dir, first, last, phase="train_cli"):
    """The run's artifacts, and finite metrics for its iterations
    first..last: every logged loss part, params_finite, bin_overflow
    present, and the evals."""
    for f in ("model.npz", "model_best.npz", "shape_pts.ply", "metrics.jsonl",
              "config.yaml"):
        if not os.path.exists(os.path.join(run_dir, f)):
            raise AssertionError(f"{phase} {label}: {f} was not written")
    rows = [r for r in _metrics_rows(run_dir) if first <= r["step"] <= last]
    losses = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "val/psnr" in r]
    if not losses or not evals:
        raise AssertionError(f"{phase} {label}: no loss or eval rows logged")
    for r in losses:
        parts = {k: v for k, v in r.items() if k.startswith("loss")}
        if not (all(np.isfinite(v) for v in parts.values())
                and r["params_finite"] == 1.0 and "bin_overflow" in r):
            raise AssertionError(f"{phase} {label}: it {r['step']}: {r}")
        print(f"{phase} {label} it {r['step']}: "
              + "  ".join(f"{k} {v:.6g}" for k, v in sorted(parts.items()))
              + f"  bin_overflow {r['bin_overflow']:g}  sec_per_iter "
              f"{r['sec_per_iter']:.4f}")
    for r in evals:
        vals = {k: r[k] for k in ("val/iou_loss", "val/psnr",
                                  "val/chamfer_point")}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{phase} {label}: eval at {r['step']}: {r}")
        print(f"{phase} {label} eval at it {r['step']}: "
              + "  ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    return losses


def _cli_config(tmp, ds, name, raster=None, training=None):
    """A config inheriting configs/dss_depth.yml for the twin's dataset
    `ds` (evals and checkpoints every 4 iterations, losses printed every
    4), with `raster` and `training` entries, then CLI_OVERRIDES, merged
    over it; written to <tmp>/<name>.yml, whose path it returns."""
    from dss_tpu_torch.config import update_recursive
    from dss_tpu_torch.utils import yaml_lite

    cfg = {"inherit_from": os.path.join(REPO, "configs", "dss_depth.yml"),
           "data": {"data_dir": ds},
           "training": {"out_dir": os.path.join(tmp, "exp"),
                        "validate_every": 4, "checkpoint_every": 4,
                        "print_every": 4, **(training or {})}}
    if raster:
        cfg["renderer"] = {"raster_params": raster}
    update_recursive(cfg, CLI_OVERRIDES)
    path = os.path.join(tmp, name + ".yml")
    yaml_lite.dump(cfg, path)
    return path


def _make_twin(ds, phase):
    """The dataset twin (CLI_DATA) written to `ds` on the card."""
    from dss_tpu_torch.apps.make_tiny_dataset import make_tiny_dataset
    from dss_tpu_torch.data.dataset import MVRDataset

    t0 = time.perf_counter()
    make_tiny_dataset(ds, device=DEV, **CLI_DATA)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_views = len(MVRDataset(ds, load_dense_depth=True))
    t_decode = time.perf_counter() - t0
    print(f"{phase} dataset: {n_views} views at {CLI_DATA['image_size']}², "
          f"{CLI_DATA['points']}-point GT sphere; rendered and written in "
          f"{t_write:.3f} s, decoded (images, masks, depth) in {t_decode:.3f} s")


def train_cli(smi):
    """The train CLI on the card from a config file: the twin writes a
    dataset (16 views at 512², a 20,000-point GT sphere); the CLI trains
    5000 points on it from a config that inherits configs/dss_depth.yml
    (data_dir, out_dir, validate_every, checkpoint_every and print_every
    set; print_every 4 so that every run logs its losses), resumes, and
    runs the fragment path.  Returns the summed launch counts."""
    first, resumed, frag = CLI_ITERS
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "data")
        _make_twin(ds, "train_cli")

        config = lambda name, **raster: _cli_config(tmp, ds, name, raster)
        lean_cfg = config("lean")
        run_dir = os.path.join(tmp, "exp", "dss_depth")
        runs = []
        launches, lines = _cli_run("lean", lean_cfg, first)
        check_launches("train_cli lean run", launches, LEAN_KERNELS)
        k_auto = f"2 train steps per dispatch, {_dispatch()}"
        if k_auto not in lines:
            raise AssertionError(f"train_cli lean run: no {k_auto!r} (auto k "
                                 f"for 2 steps per epoch, print_every 4)")
        runs.append(("lean", launches, _check_cli_outputs("lean", run_dir, 1, first)))
        launches, lines = _cli_run("resume", lean_cfg, resumed)
        check_launches("train_cli resume", launches, LEAN_KERNELS)
        want = f"resumed from model.npz at it={first}"
        if want not in lines:
            raise AssertionError(f"train_cli resume: no {want!r} in {lines}")
        with np.load(os.path.join(run_dir, "model.npz")) as ck:
            counts = {int(ck["step"]), int(ck["__scalar__/it"]),
                      int(ck["opt_state/inner_states/points/inner_state/0/count"])}
        if counts != {resumed}:
            raise AssertionError(f"train_cli resume: step, it and Adam's count "
                                 f"{counts}, expected {resumed} (the saved "
                                 f"state continued)")
        print(f"train_cli resume: logged {want!r}; step, it and Adam's count "
              f"are {resumed}")
        runs.append(("resume", launches,
                     _check_cli_outputs("resume", run_dir, first + 1, resumed)))
        launches, lines = _cli_run("lean k = 1", lean_cfg, first,
                                   name="dss_depth_k1",
                                   extra=["--steps-per-dispatch", "1"])
        check_launches("train_cli k = 1", launches, LEAN_KERNELS,
                       ("occ_bwd", "feat_bwd"), first + _graph_warmup())
        if "1 train step per dispatch, " + _dispatch() not in lines:
            raise AssertionError(f"train_cli k = 1: {lines[:8]}")
        runs.append(("lean k = 1", launches, _check_cli_outputs(
            "lean k = 1", os.path.join(tmp, "exp", "dss_depth_k1"), 1,
            first)))
        frag_cfg = config("fragment", lean_fragments=False)
        launches, _ = _cli_run("fragment", frag_cfg, frag,
                               name="dss_depth_fragment")
        # K4 runs in the backward only: once per step, and once per
        # warm-up step before the graph's capture
        check_launches("train_cli fragment run", launches, FRAG_KERNELS,
                       ("segment_sum",), frag + _graph_warmup())
        runs.append(("fragment", launches, _check_cli_outputs(
            "fragment", os.path.join(tmp, "exp", "dss_depth_fragment"), 1,
            frag)))
    for label, launches, losses in runs:
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        print(f"train_cli {label}: sec_per_iter "
              + ", ".join(f"{r['sec_per_iter']:.4f} (it {r['step']})"
                          for r in losses) + f"  [{smi}]")
    return total


def _inject_floaters(ck, rng):
    """The checkpoint dict with N_FLOATERS_OUT points at radius 0.8 and
    N_FLOATERS_IN at radius ≤ 0.3 appended (active, radial normals); every
    other per-point array is padded with zeros (ones for the filters)."""
    p = ck["params/points"].shape[0]
    n = N_FLOATERS_OUT + N_FLOATERS_IN
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.concatenate([np.full(N_FLOATERS_OUT, 0.8),
                        0.3 * np.cbrt(rng.uniform(0.0, 1.0, N_FLOATERS_IN))])
    new = {"params/points": d * r[:, None], "params/normals": d,
           "params/colors": np.ones((n, 3))}
    out = dict(ck)
    for k, v in ck.items():
        if v.ndim and v.shape[0] == p:
            pad = new.get(k, np.ones((n,) + v.shape[1:]) if k.startswith("filters/")
                          else np.zeros((n,) + v.shape[1:]))
            out[k] = np.concatenate([v, pad.astype(v.dtype)])
    return out


def _prune_on_the_cpu(pts, ds, active, mask_threshold=0.5, tol=0.03,
                      min_views=3, outside_frac=0.09):
    """prune_floaters' keep-mask from the same functions on the CPU, and
    the points whose sampled mask or depth lies within 1e-5 of its
    threshold in some view (where the card's rounding may decide the
    other way)."""
    from dss_tpu_torch.data.dataset import MVRDataset
    from dss_tpu_torch.geometry.cameras import cameras_from_matrix
    from dss_tpu_torch.models.point_model import (_sample_views,
                                                  prune_depth_inconsistent,
                                                  prune_outside_silhouette)

    d = MVRDataset(ds, load_dense_depth=True)
    cams = cameras_from_matrix(d.camera_mat, **d.cameras_params, device="cpu")
    p = torch.as_tensor(pts)
    masks, depths = torch.as_tensor(d.masks), torch.as_tensor(d.get_depths())
    keep = (prune_outside_silhouette(p, cams, masks, outside_frac, mask_threshold)
            & prune_depth_inconsistent(p, cams, depths, tol, min_views))
    with torch.no_grad():
        sm = _sample_views(cams, p, masks)
        z = cams.transform_points_world_to_view(p)[..., 2]
        off = torch.abs(z - _sample_views(cams, p, depths))
    edge = (torch.any(torch.abs(sm - mask_threshold) < 1e-5, dim=0)
            | torch.any(torch.abs(off - tol) < 1e-5, dim=0))
    return (torch.as_tensor(active) & keep).numpy(), edge.numpy()


def _run_app(main_fn, argv):
    """An app's main in-process, its standard output captured and echoed;
    returns (result, output lines, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv + _device_argv())
    dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    return result, lines, dt


def post_process(smi):
    """The flagship recipe's other stages through the port's CLIs, on a
    twin (16 views at 512², a 20,000-point GT sphere; 5000 trained points):

    1. train_mvr --prune-every 4 for 8 lean iterations from a config that
       inherits configs/dss_depth.yml: two prunes, logged, with
       n_active_points in metrics.jsonl;
    2. the anisotropic Vrk with the normal loss (λ 0.1): 4 iterations with
       the jet anchor (k 48, as configs/exp_e21_jetanchor.yml), 4 with PCA,
       each window a CUDA graph; the eigensolver once per step for the
       Vrk's frames (and once more with PCA), warm-up steps included, and
       once per eval render;
    3. prune_floaters --depth-tol 0.03 --depth-min-views 3 on run 1's
       model.npz with 128 floaters injected: all of them dropped, the
       keep-mask equal to the CPU's away from the thresholds;
    4. refine_normals --jet-passes 3 on the pruned checkpoint with its
       normals perturbed (σ 0.3): chamfer_normal lower after;
    5. evaluate_pcl on the refined PLY against the twin's GT cloud.

    Returns the summed launch counts of the train runs."""
    from dss_tpu_torch.apps import evaluate_pcl, prune_floaters, refine_normals
    from dss_tpu_torch.data.io import save_ply
    from dss_tpu_torch.ops import kernels

    total, times = {}, []
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "data")
        _make_twin(ds, "post_process")

        # 1. --prune-every
        t0 = time.perf_counter()
        cfg = _cli_config(tmp, ds, "prune")
        run_dir = os.path.join(tmp, "exp", "dss_depth")
        launches, lines = _cli_run("prune-every", cfg, POST_ITERS,
                                   extra=["--prune-every", str(POST_PRUNE_EVERY)],
                                   phase="post_process")
        check_launches("post_process prune-every", launches, LEAN_KERNELS)
        _check_cli_outputs("prune-every", run_dir, 1, POST_ITERS,
                           phase="post_process")
        pruned = [ln for ln in lines if ln.startswith("pruned to ")]
        counts = [r["n_active_points"] for r in _metrics_rows(run_dir)
                  if "n_active_points" in r]
        want_n = POST_ITERS // POST_PRUNE_EVERY
        if len(pruned) != want_n or len(counts) != want_n:
            raise AssertionError(f"post_process prune-every: {pruned}, "
                                 f"n_active_points {counts}")
        n_pts = int(np.load(os.path.join(run_dir, "model.npz"))
                    ["params/points"].shape[0])
        print(f"post_process prune-every: {pruned}; n_active_points {counts};"
              f" {n_pts - int(counts[-1])} of {n_pts} points pruned")
        times.append(("prune-every", time.perf_counter() - t0))
        runs = [launches]

        # 2. the anisotropic Vrk with the normal loss, jet then PCA
        for anchor, k in (("jet", 48), ("pca", 8)):
            t0 = time.perf_counter()
            name = f"aniso_{anchor}"
            cfg = _cli_config(
                tmp, ds, name,
                raster={"Vrk_invariant": False, "Vrk_isotropic": False},
                training={"lambda_dr_normal": 0.1, "normal_anchor": anchor,
                          "normal_anchor_k": k, "print_every": 1})
            launches, lines = _cli_run(name, cfg, POST_NORMAL_ITERS,
                                       name=name, phase="post_process")
            check_launches(f"post_process {name}", launches, EIG_KERNELS)
            per_step = 2 if anchor == "pca" else 1
            n_eig = ((POST_NORMAL_ITERS + _graph_warmup()) * per_step
                     + POST_NORMAL_ITERS // 4)  # an eval every 4
            check_counts(f"post_process {name} eigensolver",
                         {"symeig3": launches["symeig3"]}, {"symeig3": n_eig})
            if f"1 train step per dispatch, {_dispatch()}" not in lines:
                raise AssertionError(f"post_process {name}: {lines[:8]}")
            losses = _check_cli_outputs(name, os.path.join(tmp, "exp", name), 1,
                                        POST_NORMAL_ITERS, phase="post_process")
            ln = [r.get("loss_dr_normal", float("nan")) for r in losses]
            if len(ln) != POST_NORMAL_ITERS or not all(
                    np.isfinite(v) and v > 0 for v in ln):
                raise AssertionError(f"post_process {name}: loss_dr_normal {ln}")
            times.append((name, time.perf_counter() - t0))
            runs.append(launches)

        # 3. prune_floaters on run 1's checkpoint with injected floaters
        t0 = time.perf_counter()
        with np.load(os.path.join(run_dir, "model.npz")) as f:
            ck = _inject_floaters({k: f[k] for k in f.files}, rng)
        ckpt = os.path.join(tmp, "post", "model_best.npz")
        os.makedirs(os.path.dirname(ckpt))
        np.savez(ckpt, **ck)
        kernels.reset_launch_counts()
        act, _, dt = _run_app(prune_floaters.main,
                              ["--ckpt", ckpt, "--data", ds, "--depth-tol",
                               "0.03", "--depth-min-views", "3"])
        runs.append(kernels.launch_counts())
        n_fl = N_FLOATERS_OUT + N_FLOATERS_IN
        before = ck["filters/activation"].astype(bool)
        if act[-n_fl:].any():
            raise AssertionError(f"post_process prune_floaters: "
                                 f"{int(act[-n_fl:].sum())} of {n_fl} "
                                 f"injected floaters kept")
        cpu, edge = _prune_on_the_cpu(ck["params/points"], ds, before)
        differ = act != cpu
        if (differ & ~edge).any():
            raise AssertionError(
                f"post_process prune_floaters: the card's keep-mask differs "
                f"from the CPU's at {int((differ & ~edge).sum())} points "
                f"away from the thresholds")
        print(f"post_process prune_floaters: all {n_fl} injected floaters "
              f"dropped; {int((before & ~act)[:-n_fl].sum())} of "
              f"{int(before[:-n_fl].sum())} active surface points dropped; "
              f"keep-mask equal to the CPU's except at {int(differ.sum())} "
              f"points, all within 1e-5 of a threshold "
              f"({int(edge.sum())} such points); app {dt:.2f} s")
        times.append(("prune_floaters", time.perf_counter() - t0))
        # the same tests on the twin's GT cloud, which lies on the surface
        # the depth maps were rendered from: what the prune drops there is
        # its own false-positive rate on this data
        with np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True) as f:
            gt_pts = f["points"]
        gt_keep, _ = _prune_on_the_cpu(gt_pts, ds, np.ones(len(gt_pts), bool))
        print(f"post_process prune_floaters: the same tests keep "
              f"{int(gt_keep.sum())} of the {len(gt_pts)} GT points")

        # 4. refine_normals on the pruned checkpoint, normals perturbed
        t0 = time.perf_counter()
        pruned_ckpt = os.path.join(tmp, "post", "model_best_pruned.npz")
        with np.load(pruned_ckpt) as f:
            ck = {k: f[k] for k in f.files}
        n = ck["params/normals"] + rng.normal(0.0, 0.3, ck["params/normals"].shape)
        ck["params/normals"] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                                ).astype(np.float32)
        np.savez(pruned_ckpt, **ck)
        kernels.reset_launch_counts()
        _, lines, dt = _run_app(refine_normals.main,
                                ["--ckpt", pruned_ckpt, "--data", ds,
                                 "--jet-passes", "3"])
        runs.append(kernels.launch_counts())
        cn = [float(ln.split()[-1]) for ln in lines if "chamfer_normal" in ln]
        if len(cn) != 2 or not cn[1] < cn[0]:
            raise AssertionError(f"post_process refine_normals: chamfer_normal "
                                 f"{cn}, expected lower after")
        print(f"post_process refine_normals: chamfer_normal {cn[0]:.4f} before, "
              f"{cn[1]:.4f} after; app {dt:.2f} s")
        times.append(("refine_normals", time.perf_counter() - t0))

        # 5. evaluate_pcl on the refined PLY against the twin's GT cloud
        t0 = time.perf_counter()
        with np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True) as f:
            gt_ply = os.path.join(tmp, "post", "gt.ply")
            save_ply(gt_ply, f["points"], normals=f["normals"])
        csv_path = os.path.join(tmp, "post", "metrics.csv")
        kernels.reset_launch_counts()
        rows, _, dt = _run_app(evaluate_pcl.main,
                               ["--pred", os.path.join(
                                   tmp, "post", "model_best_pruned_jet.ply"),
                                "--gt", gt_ply, "--csv", csv_path])
        runs.append(kernels.launch_counts())
        vals = {k: rows[0][k] for k in ("chamfer", "hausdorff", "p2f", "nuc")}
        if not (all(np.isfinite(v) for v in vals.values())
                and os.path.exists(csv_path)):
            raise AssertionError(f"post_process evaluate_pcl: {vals}")
        times.append(("evaluate_pcl", time.perf_counter() - t0))
    for launches in runs:
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    print("post_process times: " + ", ".join(f"{k} {v:.2f} s" for k, v in times)
          + f"  [{smi}]")
    print(f"post_process launches: {total}")
    return total


def bench_phase(smi):
    """The port's bench harness (dss_tpu_torch.apps.bench) in-process at
    bench.py's shape: its JSON line, and K1, K2 and K3 exactly once per
    forward + backward.  Returns the launch counts."""
    from dss_tpu_torch.apps import bench
    from dss_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = bench.main(BENCH_ARGV + _device_argv())
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n = result["iterations"]
    check_launches("bench", launches, LEAN_KERNELS, LEAN_KERNELS, n)
    if not (np.isfinite(result["value"]) and result["value"] > 0):
        raise AssertionError(f"bench: {result}")
    print(f"bench: {result['value']} Msplats/s over the best of 3 windows; "
          f"{n} iterations in {dt:.2f} s; launches {launches}  [{smi}]")
    return launches


def single_view(data, smi):
    """render_single_view on the card at 512² for the flagship cloud, lean
    (K1) and fragment (K5), against view 0 of render_views over all
    N_VIEWS cameras: visible and idx equal, rgba within 1e-6; K5's empty
    slots carry z = −1.  Then the turntable CLI writes TURN_FRAMES frames of
    the GT ellipsoid read from a PLY (K1 once per frame, nothing else):
    frame 0 equal to the same render here, white (255) where alpha is 0.
    Returns the launch counts of the renders and the CLI run."""
    from dss_tpu_torch.apps import render_turntable
    from dss_tpu_torch.training.trainer import take_views
    from dss_tpu_torch.data.io import save_ply
    from dss_tpu_torch.data.png import read_png
    from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                                look_at_view_transform)
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
    from dss_tpu_torch.render.lighting import DirectionalLights
    from dss_tpu_torch.render.renderer import render_single_view, render_views
    from dss_tpu_torch.utils.mathutil import normalize

    prm = initial_params(data)
    p = prm.points.detach()
    mask = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    args = (p, normalize(prm.normals.detach()), prm.colors.detach(), mask)
    vrk_h = compute_vrk_h_global(p, mask)
    cam0, light0 = (take_views(data["cams"], slice(0, 1)),
                    take_views(data["lights"], slice(0, 1)))
    total = {}
    for path, raster in (("lean", FLAGSHIP_RASTER),
                         ("fragment", FLAGSHIP_FRAG_RASTER)):
        st = RasterSettings(**raster)
        with torch.no_grad():
            kernels.reset_launch_counts()
            rgba, fr, vis = render_single_view(*args, cam0, light0, st,
                                               vrk_h=vrk_h)
            launches = kernels.launch_counts()
            want = render_views(*args, data["cams"], data["lights"], st,
                                vrk_h=vrk_h)
        kernel = "fwd_lean" if path == "lean" else "fwd_frag"
        check_launches(f"single_view {path}", launches, (kernel,), (kernel,), 1)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        if not (torch.equal(vis, want[2][0])
                and torch.equal(fr.idx, want[1].idx[0])):
            raise AssertionError(f"single_view {path}: visible or idx differs "
                                 f"from view 0 of render_views")
        err = float((rgba - want[0][0]).abs().max())
        if err > 1e-6:
            raise AssertionError(f"single_view {path}: rgba differs by {err}")
        note = ""
        if path == "fragment":
            empty = fr.idx < 0
            background = fr.occupancy == 0
            if not (background.any() and bool((fr.zbuf[empty] == -1).all())):
                raise AssertionError("single_view fragment: an empty slot's z "
                                     "is not −1, or no background pixel")
            note = (f"; {int(empty.sum())} empty slots, all z = −1, "
                    f"{int(background.sum())} background pixels")
        print(f"single_view {path}: {tuple(rgba.shape)}, {int(vis.sum())} "
              f"visible; equal to view 0 of render_views (rgba max |Δ| "
              f"{err:.3e}){note}")

    with tempfile.TemporaryDirectory() as tmp:
        ply, out = os.path.join(tmp, "gt.ply"), os.path.join(tmp, "turn")
        gt = data["gt_pts"].cpu().numpy()
        save_ply(ply, gt, normals=data["gt_nrm"].cpu().numpy())
        kernels.reset_launch_counts()
        _, _, dt = _run_app(render_turntable.main,
                            ["--points", ply, "--out", out, "--num-frames",
                             str(TURN_FRAMES), "--image-size", str(TURN_SIZE)])
        launches = kernels.launch_counts()
        check_launches("single_view turntable", launches, ("fwd_lean",),
                       ("fwd_lean",), TURN_FRAMES)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        frames = sorted(os.listdir(out))
        if len(frames) != TURN_FRAMES:
            raise AssertionError(f"single_view turntable: {frames}")
        f0 = read_png(os.path.join(out, frames[0]))
        # frame 0 here: the CLI's normalization, camera and light
        pts = torch.as_tensor(gt, device=DEV)
        pts = pts - (pts.amax(0) + pts.amin(0)) / 2.0
        pts = pts / torch.linalg.vector_norm(pts, dim=-1).max()
        r, t = look_at_view_transform(dist=2.0, elev=15.0, azim=0.0)
        with torch.no_grad():
            rgba, _, _ = render_single_view(
                pts, data["gt_nrm"], torch.full_like(pts, 0.75),
                torch.ones(len(gt), dtype=torch.bool, device=DEV),
                FoVPerspectiveCameras.create(r, t, fov=60.0, device=DEV),
                DirectionalLights.create(direction=(0.3, 1.0, -0.5),
                                         device=DEV),
                RasterSettings(image_size=TURN_SIZE, points_per_pixel=5,
                               Vrk_isotropic=True, backface_culling=True))
        rgba = rgba.cpu().numpy()
        alpha = rgba[..., 3:4]
        want = (255 * (np.clip(rgba[..., :3], 0, 1) * alpha + (1 - alpha))
                ).astype(np.uint8)
        bg = alpha[..., 0] == 0
        if not (f0.shape == (TURN_SIZE, TURN_SIZE, 3) and np.array_equal(f0, want)
                and bg.any() and (f0[bg] == 255).all()):
            raise AssertionError("single_view turntable: frame 0 differs from "
                                 "its render here, or its background is not "
                                 "white")
        print(f"single_view turntable: {len(frames)} frames of "
              f"{f0.shape}, frame 0 equal to its render here, background "
              f"255 on {int(bg.sum())} pixels; {dt:.2f} s  [{smi}]")
    return total


def _ms_run(dispatch, iters):
    """train_multiscene in-process at MS_SHAPE; returns (result, launches)."""
    from dss_tpu_torch.apps import train_multiscene
    from dss_tpu_torch.ops import kernels

    argv = [x for k, v in MS_SHAPE.items()
            for x in (f"--{k.replace('_', '-')}", str(v))]
    argv += ["--iters", str(iters), "--dispatch", dispatch, "--seed",
             str(SEED)]
    kernels.reset_launch_counts()
    result = train_multiscene.main(argv + _device_argv())
    return result, kernels.launch_counts()


def fold_vs_loop():
    """At MS_SHAPE on the card: make_stacked_loss_fn's loss and gradients
    against make_loss_fn per scene (mean of the totals), on train_multiscene's
    scenes and camera rings with random targets.  The folded call puts
    every scene's views in one launch of K1, K2 and K3, whose per-view
    buffers must keep the scenes apart: loss within rtol 1e-5, gradients
    within rtol 1e-4 and atol 1e-6·max (K2's and K3's float atomics sum in
    a run-dependent order)."""
    from dss_tpu_torch.apps.train_multiscene import build_scenes, camera_ring
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                make_loss_fn,
                                                make_stacked_loss_fn)

    n_s, p, v, s = (MS_SHAPE[k] for k in ("scenes", "points", "views",
                                          "image_size"))
    pts, nrm, cols = build_scenes(n_s, p, np.random.default_rng(SEED))
    cams = [camera_ring(SEED + i, v, DEV) for i in range(n_s)]
    st = RasterSettings(image_size=s, points_per_pixel=5, cutoff_threshold=1.0,
                        Vrk_invariant=True, Vrk_isotropic=False,
                        backface_culling=True, radii_backward_scaler=5.0)
    cfg = TrainConfig(lambda_repel=0.05)
    sched = AnnealSchedule(init_backward_radii=5.0, steps_backward_radii=50,
                           gamma_backward_radii=0.9, limit_backward_radii=1.0)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    img = torch.rand((n_s, v, s, s, 3), generator=gen, device=DEV)
    mask = (torch.rand((n_s, v, s, s), generator=gen, device=DEV) > 0.5
            ).to(torch.float32)
    params = PointModelParams.create(pts, nrm, cols, device=DEV)
    on = torch.ones((n_s, p), dtype=torch.bool, device=DEV)

    def grads(total):
        g = torch.autograd.grad(total, params.tensors(), allow_unused=True)
        return [torch.zeros_like(t) if x is None else x
                for t, x in zip(params.tensors(), g)]

    folded, _ = make_stacked_loss_fn(st, cfg, sched)(
        params, PointFilters(on, on.clone(), on.clone()), cams, None, img,
        mask, 0)
    g_fold = grads(folded)
    one = make_loss_fn(st, cfg, sched)
    loop = torch.mean(torch.stack([
        one(PointModelParams(params.points[i], params.normals[i],
                             params.colors[i]),
            PointFilters(on[i], on[i].clone(), on[i].clone()), cams[i], None,
            img[i], mask[i], 0)[0] for i in range(n_s)]))
    g_loop = grads(loop)
    _close("multiscene folded loss", folded.detach(), loop.detach(), 1e-5, 0.0)
    errs = [_close(f"multiscene folded grad {name}", a, b, 1e-4, 1e-6)
            for name, a, b in zip(("points", "normals", "colors"), g_fold,
                                  g_loop)]
    print(f"multiscene: folded loss {float(folded.detach()):.8f}, per-scene "
          f"loop {float(loop.detach()):.8f}; gradients max |Δ| "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f" (points up to {float(g_loop[0].abs().max()):.4g})")


def multiscene(smi):
    """train_multiscene at full width (MS_SHAPE), folded for MS_ITERS
    iterations and as a per-scene loop for MS_LOOP_ITERS: S GT renders (K1
    each), then per step one K1, K2 and K3 folded, S of each in the loop;
    finite losses and chamfers; the same first loss in both within rtol
    1e-4.  Returns the summed launch counts."""
    n_s = MS_SHAPE["scenes"]
    total, runs = {}, {}
    for dispatch, iters, per_step in (("folded", MS_ITERS, 1),
                                      ("vmap", MS_LOOP_ITERS, n_s)):
        t0 = time.perf_counter()
        res, launches = _ms_run(dispatch, iters)
        dt = time.perf_counter() - t0
        check_counts(f"multiscene {dispatch} ({n_s} GT renders, then "
                     f"{per_step} of K1, K2 and K3 per step)", launches,
                     {"fwd_lean": n_s + per_step * iters,
                      "occ_bwd": per_step * iters,
                      "feat_bwd": per_step * iters})
        if not (np.isfinite(res["loss0"]) and np.isfinite(res["final_loss"])
                and all(np.isfinite(c) for c in res["chamfer_per_scene"])):
            raise AssertionError(f"multiscene {dispatch}: {res}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        runs[dispatch] = res
        print(f"multiscene {dispatch}: sec_per_iter {res['sec_per_iter']} "
              f"(steps {', '.join(f'{x:.4f}' for x in res['step_times'])} s), "
              f"{res['msplats_per_s']} Msplats/s, loss0 {res['loss0']:.6f}, "
              f"final_loss {res['final_loss']}, bin_overflow "
              f"{res['bin_overflow']} (it 0, then every 10), chamfer "
              f"{res['chamfer_per_scene']}; launches {launches}; {dt:.2f} s  "
              f"[{smi}]")
    fold_vs_loop()
    l0f, l0v = runs["folded"]["loss0"], runs["vmap"]["loss0"]
    if abs(l0f - l0v) > 1e-4 * abs(l0v):
        raise AssertionError(f"multiscene: the folded first loss {l0f} is not "
                             f"the per-scene loop's {l0v} within rtol 1e-4")
    print(f"multiscene: first loss folded {l0f:.8f}, per-scene loop "
          f"{l0v:.8f} (|Δ| {abs(l0f - l0v):.3e})")
    return total


def _check_dataset(label, ds):
    """create_mvr_data's products: DG_CAMERAS PNGs in image/ and mask/,
    DG_CAMERAS depth maps (zfar on the background, positive depth inside
    the mask), data_dict.npz with the JAX CLI's keys."""
    from dss_tpu_torch.data.png import read_png

    names = {sub: sorted(os.listdir(os.path.join(ds, sub)))
             for sub in ("image", "mask", "depth")}
    want = [f"{i:06d}" for i in range(DG_CAMERAS)]
    if ([n[:-4] for n in names["image"]] != want
            or [n[:-4] for n in names["mask"]] != want
            or [n[:-4] for n in names["depth"]] != want):
        raise AssertionError(f"data_gen {label}: files {names}")
    covered = []
    for i in range(DG_CAMERAS):
        mask = read_png(os.path.join(ds, "mask", names["mask"][i])) > 0
        depth = np.load(os.path.join(ds, "depth", names["depth"][i]))
        if not (mask.any() and (~mask).any() and (depth[~mask] == ZFAR).all()
                and (depth[mask] > 0).all() and (depth[mask] < ZFAR).all()):
            raise AssertionError(f"data_gen {label}: view {i}: depth is not "
                                 f"zfar off the mask and positive on it")
        covered.append(float(mask.mean()))
    with np.load(os.path.join(ds, "data_dict.npz"), allow_pickle=True) as f:
        keys = set(f.files)
        n_gt = f["points"].shape[0]
    lights = {f"lights_{i}" for i in range(DG_CAMERAS)}
    if keys != DATA_DICT_KEYS | lights:
        raise AssertionError(f"data_gen {label}: data_dict keys {sorted(keys)}")
    print(f"data_gen {label}: {DG_CAMERAS} images, masks and depth maps; "
          f"mask coverage {min(covered):.3f}–{max(covered):.3f}; "
          f"data_dict.npz with the JAX CLI's keys, a {n_gt}-point GT cloud")


def data_gen(smi, tmp):
    """create_mvr_data on an ellipsoid mesh (ico_sphere(4) scaled by
    DG_AXES, written with its faces) and on a faceless cloud of
    DG_CLOUD_POINTS points sampled from it: DG_CAMERAS views at DG_SIZE²
    with tri-colour lights; the mesh launches no kernel, the cloud K5 once
    per view and the eigensolver once (its PCA normals), nothing else.  Then train_mvr on the mesh dataset from a
    config inheriting configs/dss_depth.yml for DG_ITERS iterations with an
    eval every DG_EVAL_EVERY: every loss finite, and the last eval's chamfer
    to the mesh's GT cloud below the first eval's.  Then the geometry phase
    in the same directory, on that dataset and model.  Everything goes to
    `tmp`.  Returns the summed launch counts of data_gen and of geometry,
    and the paths the aux phase reads: the two PLYs and datasets, the
    train config and the run directory."""
    from dss_tpu_torch.apps import create_mvr_data
    from dss_tpu_torch.data.io import save_ply
    from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
    from dss_tpu_torch.ops import kernels

    total = {}
    verts, faces = ico_sphere(level=4, radius=1.0)
    verts = verts * np.asarray(DG_AXES, np.float32)
    mesh = os.path.join(tmp, "ellipsoid.ply")
    save_ply(mesh, verts, faces=faces)
    pts, _ = sample_points_from_mesh(verts, faces, DG_CLOUD_POINTS,
                                     rng=np.random.default_rng(SEED))
    cloud = os.path.join(tmp, "ellipsoid_cloud.ply")
    save_ply(cloud, pts)
    for label, ply, want in (("mesh", mesh, {}),
                             ("cloud", cloud, {"fwd_frag": DG_CAMERAS,
                                               "symeig3": 1})):
        ds = os.path.join(tmp, label)
        kernels.reset_launch_counts()
        _, _, dt = _run_app(create_mvr_data.main,
                            ["--mesh", ply, "--out", ds, "--num-cameras",
                             str(DG_CAMERAS), "--image-size", str(DG_SIZE),
                             "--tri-color-lights", "--seed", str(SEED)])
        launches = kernels.launch_counts()
        check_counts(f"data_gen {label}", launches, want)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        print(f"data_gen {label}: create_mvr_data {dt:.2f} s, launches "
              f"{launches}  [{smi}]")
        _check_dataset(label, ds)

    t0 = time.perf_counter()
    cfg = _cli_config(os.path.join(tmp), os.path.join(tmp, "mesh"),
                      "data_gen",
                      training={"validate_every": DG_EVAL_EVERY,
                                "checkpoint_every": DG_ITERS,
                                "print_every": DG_EVAL_EVERY})
    launches, _ = _cli_run("mesh dataset", cfg, DG_ITERS, phase="data_gen")
    check_launches("data_gen train", launches, LEAN_KERNELS)
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    run_dir = os.path.join(tmp, "exp", "dss_depth")
    losses = _check_cli_outputs("mesh dataset", run_dir, 1, DG_ITERS,
                                phase="data_gen")
    evals = [(r["step"], r["val/chamfer_point"])
             for r in _metrics_rows(run_dir) if "val/chamfer_point" in r]
    if len(losses) < 2 or len(evals) < 2 or not evals[-1][1] < evals[0][1]:
        raise AssertionError(f"data_gen: chamfer to the mesh's GT cloud "
                             f"{evals}: the last eval is not below the "
                             f"first")
    print(f"data_gen train: chamfer to the mesh's GT cloud "
          + ", ".join(f"{c:.6f} (it {i})" for i, c in evals)
          + f"; {time.perf_counter() - t0:.2f} s  [{smi}]")
    geo = geometry(tmp, os.path.join(tmp, "mesh"), cfg, run_dir, verts,
                   faces, smi)
    return total, geo, dict(mesh=mesh, cloud=cloud,
                            mesh_ds=os.path.join(tmp, "mesh"),
                            cloud_ds=os.path.join(tmp, "cloud"), cfg=cfg,
                            run_dir=run_dir)


def _gt_hausdorff(gt, pts, mask):
    """Directed Hausdorff distance from the GT cloud to the masked points."""
    from dss_tpu_torch.geometry.knn import knn_points

    d, _ = knn_points(gt, pts, None, mask, k=1)
    return float(torch.sqrt(torch.amax(d[:, 0])))


def _reseed_runs(tmp, ds, model_npz, smi):
    """reseed_coverage on data_gen's model with the cap of its GEO_CAP
    largest-x points switched off, once on the lean path (K1 once per batch of ≤ 8 views)
    and once with --use-depth (K5 likewise): proposals, all inside every
    view's silhouette, and the GT→pred Hausdorff distance not above the
    one before.  Returns (summed launches, the lean run's grown npz)."""
    from dss_tpu_torch.apps import reseed_coverage
    from dss_tpu_torch.data.dataset import MVRDataset
    from dss_tpu_torch.models.point_model import prune_outside_silhouette
    from dss_tpu_torch.ops import kernels

    with np.load(model_npz) as f:
        ck = {k: f[k] for k in f.files}
    x = ck["params/points"][:, 0]
    cap = x > np.quantile(x, 1.0 - GEO_CAP)
    ck["filters/activation"] = ck["filters/activation"] & ~cap
    ckpt = os.path.join(tmp, "geometry", "cap.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    np.savez(ckpt, **ck)
    d = MVRDataset(ds)
    cams = d.get_cameras(None, device=DEV)
    masks = torch.as_tensor(d.masks, device=DEV)
    gt = torch.as_tensor(d.points, device=DEV)
    pts = torch.as_tensor(ck["params/points"], device=DEV)
    act = torch.as_tensor(ck["filters/activation"], device=DEV)
    h_before = _gt_hausdorff(gt, pts, act)
    n_batches = -(-GEO_VIEWS // reseed_coverage.RENDER_BATCH)
    total, grown = {}, None
    for label, extra, kernel in (("lean", [], "fwd_lean"),
                                 ("use-depth", ["--use-depth"], "fwd_frag")):
        out = os.path.join(tmp, "geometry", f"grown_{label}.npz")
        kernels.reset_launch_counts()
        (new, _), _, dt = _run_app(reseed_coverage.main, [
            "--ckpt", ckpt, "--data", ds, "--out", out, "--views",
            str(GEO_VIEWS), "--n-new", str(GEO_NEW), *extra])
        launches = kernels.launch_counts()
        check_counts(f"geometry reseed {label}", launches, {kernel: n_batches})
        if not len(new):
            raise AssertionError(f"geometry reseed {label}: no proposals")
        new_t = torch.as_tensor(new, device=DEV)
        inside = prune_outside_silhouette(new_t, cams, masks, outside_frac=0.05)
        if not bool(inside.all()):
            raise AssertionError(f"geometry reseed {label}: "
                                 f"{int((~inside).sum())} proposals outside "
                                 f"the full-view hull")
        ones = torch.ones(len(new), dtype=torch.bool, device=DEV)
        h_after = _gt_hausdorff(gt, torch.cat([pts, new_t]),
                                torch.cat([act, ones]))
        if not h_after <= h_before:
            raise AssertionError(f"geometry reseed {label}: GT→pred Hausdorff "
                                 f"{h_before:.6f} before, {h_after:.6f} after")
        print(f"geometry reseed {label}: {len(new)} proposals (of "
              f"{GEO_NEW} asked) into a cap of {int(cap.sum())} switched-off "
              f"points, all inside the {len(cams)}-view hull; GT→pred "
              f"Hausdorff {h_before:.6f} → {h_after:.6f}; {dt:.2f} s, "
              f"launches {launches}  [{smi}]")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        grown = grown or out
    return total, grown


def _reseed_every_run(tmp, ds, grown, smi):
    """train_mvr --reseed-every on the grown checkpoint with the cap of its
    GEO_CAP smallest-x points turned into floaters: every loss finite,
    n_reseeded > 0 at each event; K1 once per step and once per event, K2
    and K3 once per step, each also once per warm-up step before the train
    window's capture.  Returns the launches."""
    with np.load(grown) as f:
        ck = {k: f[k] for k in f.files}
    pts = ck["params/points"].copy()
    cap = pts[:, 0] < np.quantile(pts[:, 0], GEO_CAP)
    rng = np.random.default_rng(SEED)
    pts[cap] = 3.0 + 0.05 * rng.standard_normal((int(cap.sum()), 3))
    ck["params/points"] = pts.astype(np.float32)
    run_dir = os.path.join(tmp, "exp", "geometry_reseed")
    os.makedirs(run_dir)
    np.savez(os.path.join(run_dir, "model.npz"), **ck)
    it0 = int(ck["__scalar__/it"])
    cfg_path = _cli_config(tmp, ds, "geometry_reseed", training={
        "validate_every": -1, "checkpoint_every": GEO_TRAIN_ITERS,
        "print_every": 1})
    t0 = time.perf_counter()
    launches, lines = _cli_run(
        "reseed-every", cfg_path, it0 + GEO_TRAIN_ITERS, name="geometry_reseed",
        extra=["--reseed-every", str(GEO_RESEED_EVERY)], phase="geometry")
    n_events = GEO_TRAIN_ITERS // GEO_RESEED_EVERY
    n_steps = GEO_TRAIN_ITERS + _graph_warmup()
    check_counts("geometry reseed-every", launches, {
        "fwd_lean": n_steps + n_events, "occ_bwd": n_steps,
        "feat_bwd": n_steps})
    rows = [r for r in _metrics_rows(run_dir) if r["step"] > it0]
    losses = [r for r in rows if "loss" in r]
    seeded = [r["n_reseeded"] for r in rows if "n_reseeded" in r]
    bad = [r for r in losses if not (
        all(np.isfinite(v) for k, v in r.items() if k.startswith("loss"))
        and r["params_finite"] == 1.0)]
    if len(losses) != GEO_TRAIN_ITERS or bad:
        raise AssertionError(f"geometry reseed-every: losses {losses}")
    if len(seeded) != n_events or not all(n > 0 for n in seeded):
        raise AssertionError(f"geometry reseed-every: n_reseeded {seeded}; "
                             f"log {[ln for ln in lines if 'reseed' in ln]}")
    print(f"geometry reseed-every: {int(cap.sum())} floaters injected; "
          f"n_reseeded {seeded} at iterations "
          f"{[r['step'] for r in rows if 'n_reseeded' in r]}; losses "
          + ", ".join(f"{r['loss']:.6g}" for r in losses)
          + f"; {time.perf_counter() - t0:.2f} s, launches {launches}  [{smi}]")
    return launches


def _denoise_runs(tmp, verts, faces, smi):
    """denoise_pcl at its defaults on GEO_POINTS samples of the ellipsoid
    mesh with σ = GEO_NOISE of the bbox diagonal: chamfer below 0.9× and
    point-to-surface below 0.8× the noisy cloud's, against the clean
    samples (tests/test_denoise.py's thresholds); then with
    --remove-outliers --upsample GEO_UPSAMPLE, which must reach the count.
    The only kernel is the eigensolver, once per PCA pass: the normals'
    estimate and their final re-estimate, and with --upsample also the
    outlier test and the upsampled cloud's normals.  Returns the clean
    samples and their normals and the launches."""
    from dss_tpu_torch.apps import denoise_pcl
    from dss_tpu_torch.data.io import save_ply
    from dss_tpu_torch.geometry.shapes import sample_points_from_mesh
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.training.metrics import chamfer_hausdorff, point_to_surface

    rng = np.random.default_rng(SEED + 1)
    clean, normals = sample_points_from_mesh(verts, faces, GEO_POINTS, rng=rng)
    diag = float(np.linalg.norm(clean.max(0) - clean.min(0)))
    noisy = (clean + GEO_NOISE * diag * rng.standard_normal(clean.shape)
             ).astype(np.float32)
    src = os.path.join(tmp, "geometry", "noisy.ply")
    save_ply(src, noisy)
    gt = torch.as_tensor(clean, device=DEV)
    gt_n = torch.as_tensor(normals, device=DEV)

    def metrics(p):
        p = torch.as_tensor(p, device=DEV)
        return (float(chamfer_hausdorff(p, gt)["chamfer"]),
                float(point_to_surface(p, gt, gt_n)))

    cd0, p2f0 = metrics(noisy)
    total = {}
    for label, extra, n_pca in (("defaults", [], 2),
                                ("upsample", ["--remove-outliers", "--upsample",
                                              str(GEO_UPSAMPLE)], 4)):
        kernels.reset_launch_counts()
        (den, _), _, dt = _run_app(denoise_pcl.main, [
            "--input", src, "--out",
            os.path.join(tmp, "geometry", f"denoised_{label}.ply"), *extra])
        launches = kernels.launch_counts()
        check_counts(f"geometry denoise {label}", launches, {"symeig3": n_pca})
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        cd1, p2f1 = metrics(den)
        if label == "defaults" and not (cd1 < 0.9 * cd0 and p2f1 < 0.8 * p2f0):
            raise AssertionError(f"geometry denoise: chamfer {cd0:.6g} → "
                                 f"{cd1:.6g}, p2f {p2f0:.6g} → {p2f1:.6g}")
        if label == "upsample" and len(den) != GEO_UPSAMPLE:
            raise AssertionError(f"geometry upsample: {len(den)} points, "
                                 f"asked {GEO_UPSAMPLE}")
        print(f"geometry denoise {label}: {len(den)} points; chamfer "
              f"{cd0:.6g} → {cd1:.6g} ({cd1 / cd0:.3f}×), point-to-surface "
              f"{p2f0:.6g} → {p2f1:.6g} ({p2f1 / p2f0:.3f}×); {dt:.2f} s  "
              f"[{smi}]")
    return clean, normals, total


def _mesh_runs(clean, normals, smi):
    """Generator.generate_mesh on the clean cloud with the mesh's normals,
    Poisson at max(GEO_MESH_RES, 96) and MLS at GEO_MESH_RES: faces, and a mean vertex distance to
    the cloud below 1.5 voxels.  No kernel launches."""
    from dss_tpu_torch.geometry.knn import knn_points
    from dss_tpu_torch.models.generator import Generator
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render.ewa import RasterSettings

    params = PointModelParams.create(clean, normals, device=DEV,
                                     requires_grad=False)
    extent = float((clean.max(0) - clean.min(0)).max())
    # the voxel of each mesher's grid: Poisson's cube padded by 0.15 of the
    # extent each side, MLS's box padded by 0.1
    res = {"poisson": max(GEO_MESH_RES, 96), "mls": GEO_MESH_RES}
    voxel = {"poisson": extent * 1.3 / (res["poisson"] - 1),
             "mls": (extent + 0.2) / (res["mls"] - 1)}
    for method in ("poisson", "mls"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        verts, faces = Generator(RasterSettings(), GEO_MESH_RES,
                                 method).generate_mesh(params)
        dt = time.perf_counter() - t0
        check_counts(f"geometry mesh {method}", kernels.launch_counts(), {})
        d, _ = knn_points(torch.as_tensor(verts, device=DEV), params.points,
                          k=1)
        mean = float(torch.mean(torch.sqrt(d[:, 0])))
        if not (len(faces) > 0 and mean < 1.5 * voxel[method]):
            raise AssertionError(f"geometry mesh {method}: {len(faces)} faces, "
                                 f"mean vertex distance {mean:.6g} "
                                 f"(voxel {voxel[method]:.6g})")
        print(f"geometry mesh {method} at {res[method]}³: {len(verts)} "
              f"vertices, {len(faces)} faces; mean vertex distance to the "
              f"{len(clean)}-point cloud {mean:.6g} "
              f"({mean / voxel[method]:.3f} voxels); {dt:.2f} s  [{smi}]")


def _images_run(tmp, ds, cfg_path, model_npz, smi):
    """Generator.generate_images of data_gen's model from the dataset's
    cameras and lights: one PNG per view at the dataset's size that
    read_png reads back, from one K1 launch.  Returns the launches."""
    from dss_tpu_torch import config as config_mod
    from dss_tpu_torch.data.dataset import MVRDataset
    from dss_tpu_torch.data.png import read_png
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.models.generator import Generator
    from dss_tpu_torch.models.point_model import PointModelParams
    from dss_tpu_torch.ops import kernels

    d = MVRDataset(ds)
    with np.load(model_npz) as f:
        params = PointModelParams.create(f["params/points"], f["params/normals"],
                                         f["params/colors"], device=DEV,
                                         requires_grad=False)
        act = torch.as_tensor(f["filters/activation"], device=DEV)
    settings = config_mod.create_raster_settings(
        config_mod.load_config(cfg_path))
    out = os.path.join(tmp, "geometry", "images")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    paths = Generator(settings).generate_images(
        params, PointFilters(act, act, act), d.get_cameras(None, device=DEV),
        d.get_lights(None, device=DEV), out)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_counts("geometry images", launches, {"fwd_lean": 1})
    size = settings.image_size
    imgs = [read_png(p) for p in paths]
    if len(imgs) != len(d) or any(
            im.shape != (size, size, 3) or not (im < 250).any() for im in imgs):
        raise AssertionError(f"geometry images: {[im.shape for im in imgs]}")
    print(f"geometry images: {len(imgs)} PNGs at {size}² written and read "
          f"back; {dt:.2f} s, launches {launches}  [{smi}]")
    return launches


def geometry(tmp, ds, cfg_path, run_dir, verts, faces, smi):
    """The geometry processing apps at full width, in data_gen's directory
    on its dataset (`ds`, 16 views at 512²), config and trained model
    (`run_dir`/model.npz, 5000 points): reseed_coverage lean and with
    --use-depth, train_mvr --reseed-every, denoise_pcl (defaults, then
    with --upsample), the Poisson and MLS meshers, generate_images.
    Returns the summed launch counts."""
    model_npz = os.path.join(run_dir, "model.npz")
    times, total = [], {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    t0 = time.perf_counter()
    launches, grown = _reseed_runs(tmp, ds, model_npz, smi)
    add(launches)
    times.append(("reseed_coverage", time.perf_counter() - t0))
    t0 = time.perf_counter()
    add(_reseed_every_run(tmp, ds, grown, smi))
    times.append(("reseed-every", time.perf_counter() - t0))
    t0 = time.perf_counter()
    clean, normals, launches = _denoise_runs(tmp, verts, faces, smi)
    add(launches)
    times.append(("denoise_pcl", time.perf_counter() - t0))
    t0 = time.perf_counter()
    _mesh_runs(clean, normals, smi)
    times.append(("meshes", time.perf_counter() - t0))
    t0 = time.perf_counter()
    add(_images_run(tmp, ds, cfg_path, model_npz, smi))
    times.append(("images", time.perf_counter() - t0))
    print("geometry times: " + ", ".join(f"{k} {v:.2f} s" for k, v in times)
          + f"  [{smi}]")
    print(f"geometry launches: {total}")
    return total


def _iou(a, b):
    a, b = a > 0.5, b > 0.5
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def _texture_reference_check(dec, data):
    """The neural texture's render on the card, tile-binned against
    `backend="reference"`, at TEX_CHECK's size (the first points of the
    model's cloud, all views): rgba rtol 1e-5, atol 1e-6 of its largest
    entry, and the decoder's gradients under one random cotangent rtol
    1e-4, atol 1e-5 of their largest entry (check_small_reference's
    tolerances).  Its launches are not the phase's."""
    from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
    from dss_tpu_torch.render.renderer import render_views
    from dss_tpu_torch.render.texture import make_neural_texture

    n, dev = TEX_CHECK["points"], data["gt_pts"].device
    pts = torch.tensor(data["init"][0][:n], device=dev)
    nrm = torch.tensor(data["init"][1][:n], device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    vrk_h = compute_vrk_h_global(pts, mask)
    size = TEX_CHECK["image_size"]
    cot = torch.randn((len(data["cams"]), size, size, 4),
                      generator=torch.Generator().manual_seed(SEED)).to(dev)
    out = {}
    for backend in ("auto", "reference"):
        st = RasterSettings(**{**FLAGSHIP_RASTER, "image_size": size,
                               "tile_size": TEX_CHECK["tile_size"],
                               "backend": backend})
        dec.zero_grad(set_to_none=True)
        rgba, frags, _ = render_views(pts, nrm, torch.ones_like(pts), mask,
                                      data["cams"], None, st, vrk_h=vrk_h,
                                      texture_fn=make_neural_texture(dec))
        (rgba * cot).sum().backward()
        if int(frags.overflow.sum()):
            raise AssertionError(f"neural texture check ({backend}): overflow")
        out[backend] = (rgba.detach().cpu(),
                        [p.grad.detach().cpu() for p in dec.parameters()])
    dec.zero_grad(set_to_none=True)
    err = _close("neural texture rgba, tiled vs reference", out["auto"][0],
                 out["reference"][0], 1e-5, 1e-6)
    g_err = max(_close(f"neural texture decoder grad {i}, tiled vs reference",
                       a, b, 1e-4, 1e-5)
                for i, (a, b) in enumerate(zip(out["auto"][1],
                                               out["reference"][1])))
    print(f"neural texture at {size}², {n} points, {len(data['cams'])} views: "
          f"tile-binned matches backend='reference' on the card, max |Δ| "
          f"rgba {err:.3e}, decoder gradients {g_err:.3e}")


def neural_texture(data, smi):
    """A RenderingNetwork (TEX_DECODER) shades the model's 5000 points per
    view through the lean kernels at the flagship shape: targets from
    make_lighting_texture on the GT cloud (K1 once), then TEX_STEPS Adam
    steps of the decoder and the points on the L1 of rgba (K1, K2, K3 once
    each per step, no K4 or K5): every loss finite, the last below the
    first, every decoder gradient finite and one nonzero.  Returns (launch
    counts, the targets' rgb)."""
    from dss_tpu_torch.models.decoders import RenderingNetwork
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.render.ewa import RasterSettings, compute_vrk_h_global
    from dss_tpu_torch.render.renderer import render_views
    from dss_tpu_torch.render.texture import (make_lighting_texture,
                                              make_neural_texture)
    from dss_tpu_torch.utils.mathutil import normalize

    dev = data["gt_pts"].device
    dec = RenderingNetwork(**TEX_DECODER,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
    _texture_reference_check(dec, data)
    st = RasterSettings(**FLAGSHIP_RASTER)
    gt = data["gt_pts"]
    g_mask = torch.ones(gt.shape[0], dtype=torch.bool, device=dev)
    points = torch.tensor(data["init"][0], device=dev, requires_grad=True)
    normals = normalize(torch.tensor(data["init"][1], device=dev))
    mask = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    ones = torch.ones_like(points)
    tex = make_neural_texture(dec, view_freqs=4)
    opt = torch.optim.Adam([{"params": [points], "lr": TEX_LR[0]},
                            {"params": list(dec.parameters()), "lr": TEX_LR[1]}])
    losses, grads_ok, times = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        target = render_views(
            gt, data["gt_nrm"], torch.ones_like(gt), g_mask, data["cams"],
            None, st, vrk_h=compute_vrk_h_global(gt, g_mask),
            texture_fn=make_lighting_texture(data["lights"]))[0]
    for _ in range(TEX_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        rgba = render_views(points, normals, ones, mask, data["cams"], None, st,
                            vrk_h=compute_vrk_h_global(points.detach(), mask),
                            texture_fn=tex)[0]
        loss = torch.mean(torch.abs(rgba - target))
        loss.backward()
        g = [p.grad for p in dec.parameters()]
        grads_ok.append(torch.stack(
            [torch.isfinite(x).all() for x in g]
            + [torch.stack([x.abs().max() for x in g]).max() > 0]))
        opt.step()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    check_counts("neural texture (the target render, then K1, K2 and K3 once "
                 "per step)", launches,
                 {"fwd_lean": 1 + TEX_STEPS, "occ_bwd": TEX_STEPS,
                  "feat_bwd": TEX_STEPS})
    losses = torch.stack(losses).tolist()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"neural texture: losses {losses}")
    if not bool(torch.stack(grads_ok).all()):
        raise AssertionError("neural texture: a decoder gradient is not "
                             "finite, or all are zero")
    print(f"neural texture ({TEX_DECODER['hidden_size']} wide, "
          f"{TEX_DECODER['n_layers']} layers, {points.shape[0]} points, "
          f"{len(data['cams'])} views at {st.image_size}²): loss "
          f"{losses[0]:.6f} → {losses[-1]:.6f} over {TEX_STEPS} steps; median "
          f"step {statistics.median(times):.3f} ms (min {min(times):.3f}); "
          f"launches {launches}  [{smi}]")
    return launches, target[..., :3].contiguous()


def implicit(data, smi):
    """The SDF decoder (SDF_NET) at its geometric init, rendered by sphere
    tracing at SDF_SIZE² with SDF_STEPS steps under torch.no_grad() from
    the first flagship camera.  Along SDF_RAYS random rays the SDF changes
    sign between radius 0.05 and 1.4, and bisection finds its zero set at
    radii r_min..r_max (median r̂).  One draw of the init is a bumpy
    sphere, not ‖p‖ − 0.6 (its bias), in dss_tpu as here, so the render is
    held to the spheres of its own radii: its silhouette covers that of
    ‖p‖ − r_min and lies inside that of ‖p‖ − r_max, each but for 0.5% of
    the pixels; (r_max − r_min)/r̂ < 0.6.  The IoUs against ‖p‖ − r̂ and
    ‖p‖ − 0.6 are printed.  Central differences match autograd's gradient
    within 1e-2 at the zero-set points.  Siren, Occupancy and ResidualSDF
    at the reference's widths give finite outputs.  No kernel runs."""
    from dss_tpu_torch.models.decoders import (SDF, Occupancy, ResidualSDF,
                                               Siren, approximate_gradient)
    from dss_tpu_torch.render.implicit import render_sdf

    dev = data["gt_pts"].device
    gen = lambda: torch.Generator().manual_seed(SEED)
    sdf = SDF(**SDF_NET, generator=gen(), device=dev)
    f = lambda p: sdf(p)["sdf"][..., 0]
    cam = data["cams"]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_sdf(f, cam, SDF_SIZE, n_steps=SDF_STEPS)
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        dirs = torch.randn((SDF_RAYS, 3), generator=gen()).to(dev)
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        lo = torch.full((SDF_RAYS, 1), 0.05, device=dev)
        hi = torch.full((SDF_RAYS, 1), 1.4, device=dev)
        if not (bool((f(dirs * lo) < 0).all()) and bool((f(dirs * hi) > 0).all())):
            raise AssertionError("implicit: the SDF does not change sign "
                                 "between radius 0.05 and 1.4 on every ray")
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            inside = f(dirs * mid)[:, None] < 0
            lo, hi = torch.where(inside, mid, lo), torch.where(inside, hi, mid)
        surf = dirs * (0.5 * (lo + hi))
        radii = torch.linalg.vector_norm(surf, dim=-1)
        r_hat, r_min, r_max = (float(radii.median()), float(radii.min()),
                               float(radii.max()))
        sphere = lambda r: render_sdf(
            lambda p: torch.linalg.vector_norm(p, dim=-1) - r, cam, SDF_SIZE,
            n_steps=SDF_STEPS)[..., 3] > 0.5
        net = img[..., 3] > 0.5
        uncovered = float((sphere(r_min) & ~net).float().mean())
        outside = float((net & ~sphere(r_max)).float().mean())
        iou = {r: _iou(net, sphere(r)) for r in (r_hat, 0.6)}
        fd = approximate_gradient(surf, f)
    with torch.enable_grad():
        q = surf.clone().requires_grad_(True)
        (ag,) = torch.autograd.grad(f(q).sum(), q)
    g_err = float((fd - ag).abs().max())
    if not (torch.isfinite(img).all() and uncovered <= 0.005
            and outside <= 0.005 and (r_max - r_min) / r_hat < 0.6
            and g_err < 1e-2):
        raise AssertionError(
            f"implicit: zero set radii {r_min}..{r_max} (median {r_hat}), "
            f"pixels of ‖p‖ − r_min uncovered {uncovered}, outside ‖p‖ − r_max "
            f"{outside}, |fd − autograd| {g_err}")
    print(f"implicit: SDF {SDF_NET['hidden_size']} wide, "
          f"{SDF_NET['n_layers']} layers, render_sdf at {SDF_SIZE}², "
          f"{SDF_STEPS} steps in {t_render:.3f} s, peak memory {peak:.2f} GiB; "
          f"alpha coverage {float(net.float().mean()):.4f}; zero set radii "
          f"{r_min:.4f}–{r_max:.4f}, median {r_hat:.4f} ({SDF_RAYS} rays); "
          f"pixel share of ‖p‖ − r_min uncovered {uncovered:.4f}, outside "
          f"‖p‖ − r_max {outside:.4f}; IoU with ‖p‖ − {r_hat:.4f} "
          f"{iou[r_hat]:.4f}, with ‖p‖ − 0.6 {iou[0.6]:.4f}; max |central "
          f"difference − autograd| {g_err:.3e}  [{smi}]")

    x = torch.rand((DECODER_POINTS, 3), generator=gen()).to(dev) * 2.0 - 1.0
    for name, net in (("Siren", Siren(hidden_size=256, n_layers=3,
                                      generator=gen(), device=dev)),
                      ("Occupancy", Occupancy(hidden_size=512, n_blocks=5,
                                              generator=gen(), device=dev)),
                      ("ResidualSDF", ResidualSDF(generator=gen(), device=dev))):
        with torch.no_grad():
            out = net(x)
        if not all(bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError(f"implicit: {name} gives non-finite outputs")
        print(f"implicit: {name} on {x.shape[0]} points: "
              + ", ".join(f"{k} {tuple(v.shape)} in [{float(v.min()):.4f}, "
                          f"{float(v.max()):.4f}]" for k, v in out.items()))


def _tv(x):
    return (float((x[1:] - x[:-1]).abs().sum())
            + float((x[:, 1:] - x[:, :-1]).abs().sum()))


def image_filters(renders, smi):
    """The image filters on the V renders (the neural texture's targets):
    box_filter against a direct window sum (a convolution with ones),
    within 1e-4 of the largest window sum; guided_filter and l0_smooth
    finite, l0_smooth lowering each render's total variation; superpixel
    on render 0.  No kernel runs."""
    import torch.nn.functional as F

    from dss_tpu_torch.utils.image_filters import (box_filter, guided_filter,
                                                   l0_smooth, superpixel)

    r, times = FILTER_R, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with torch.no_grad():
        box = timed("box", lambda: torch.stack([box_filter(im, r)
                                                for im in renders]))
        chw = renders.permute(0, 3, 1, 2).reshape(-1, 1, *renders.shape[1:3])
        direct = F.conv2d(chw, torch.ones((1, 1, 2 * r + 1, 2 * r + 1),
                                          device=renders.device), padding=r)
        direct = direct.reshape(renders.shape[0], 3,
                                *renders.shape[1:3]).permute(0, 2, 3, 1)
        b_err = _close("box_filter against the window sums", box.cpu(),
                       direct.cpu(), 1e-4, 1e-4)
        guided = timed("guided", lambda: torch.stack(
            [guided_filter(im, im.mean(-1), r, 1e-3) for im in renders]))
        l0 = timed("l0", lambda: torch.stack([l0_smooth(im, 0.05)
                                              for im in renders]))
    sp = timed("superpixel", lambda: superpixel(renders[0].cpu().numpy()))
    tv = [(_tv(a), _tv(b)) for a, b in zip(renders, l0)]
    if not (torch.isfinite(guided).all() and torch.isfinite(l0).all()
            and np.isfinite(sp).all() and all(b < a for a, b in tv)):
        raise AssertionError(f"image filters: total variation {tv}")
    n_seg = len(np.unique(sp.reshape(-1, 3), axis=0))
    print(f"image filters on {renders.shape[0]} renders at "
          f"{renders.shape[1]}²: box (r {r}) max |Δ| {b_err:.3e} against the "
          f"window sums; l0 total variation {tv[0][0]:.1f} → {tv[0][1]:.1f} "
          f"(render 0); superpixel {n_seg} segment colours; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"  [{smi}]")


def pix2pix(renders, tmp, smi):
    """The pix2pix generator at full width (ngf 64, 9 blocks, pixel norm)
    from a seeded init, saved with torch.save(state_dict()) to a .pth and
    loaded back into another generator through load_generator_weights;
    denoise_images on the V renders: the same images as the saved
    generator's, finite, inside each image's per-channel min/max.  Returns
    the .pth path.  No kernel runs."""
    from dss_tpu_torch.models.pix2pix import (ResnetGenerator, denoise_images,
                                              load_generator_weights)

    dev = renders.device
    gen = ResnetGenerator(ngf=64, n_blocks=9, norm="pixel",
                          generator=torch.Generator().manual_seed(SEED),
                          device=dev).eval()
    path = os.path.join(tmp, "latest_net_G.pth")
    torch.save(gen.state_dict(), path)
    loaded = load_generator_weights(
        ResnetGenerator(norm="pixel", device=dev).eval(), path)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise_images(loaded, renders)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = denoise_images(gen, renders)
    lo = renders.amin(dim=(1, 2), keepdim=True)
    hi = renders.amax(dim=(1, 2), keepdim=True)
    err = _close("pix2pix: the loaded generator against the saved one",
                 out.cpu(), want.cpu(), 1e-5, 1e-6)
    if not (torch.isfinite(out).all() and bool((out >= lo - 1e-6).all())
            and bool((out <= hi + 1e-6).all())):
        raise AssertionError("pix2pix: denoised images are not finite or "
                             "leave their input's per-channel range")
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"pix2pix: ResnetGenerator ngf 64, 9 blocks ({n_params} weights, "
          f"{os.path.getsize(path)} bytes as .pth) denoised "
          f"{renders.shape[0]} renders at {renders.shape[1]}² in {dt:.3f} s; "
          f"reloaded max |Δ| {err:.3e}; mean |denoised − input| "
          f"{float((out - renders).abs().mean()):.4f}  [{smi}]")
    return path


def flow(tmp, weights, smi):
    """image_filter_flow in-process on a FLOW_POINTS-point ellipsoid cloud
    (DG_AXES, with normals) for each of FLOW_RUNS: K1 iters + 2 times (the
    initial and final renders), K2 and K3 iters times, nothing else; the
    four files written; every loss finite; the loss of the run without the
    regularisers falls.  Returns the summed launch counts."""
    from dss_tpu_torch.apps import image_filter_flow
    from dss_tpu_torch.data.io import save_ply
    from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
    from dss_tpu_torch.ops import kernels

    verts, faces = ico_sphere(level=4, radius=1.0)
    axes = np.asarray(DG_AXES, np.float32)
    pts, nrm = sample_points_from_mesh(verts * axes, faces, FLOW_POINTS,
                                       rng=np.random.default_rng(SEED))
    cloud = os.path.join(tmp, "flow_cloud.ply")
    save_ply(cloud, pts, normals=nrm)
    total = {}
    for i, (kind, iters, extra) in enumerate(FLOW_RUNS):
        out = os.path.join(tmp, f"flow_{i}_{kind}")
        argv = (["--points", cloud, "--out", out, "--filter", kind, "--iters",
                 str(iters), "--seed", str(SEED), *FLOW_ARGV, *extra]
                + (["--pix2pix-weights", weights] if kind == "pix2pix" else []))
        kernels.reset_launch_counts()
        res, _, dt = _run_app(image_filter_flow.main, argv)
        launches = kernels.launch_counts()
        label = f"image_filter_flow --filter {kind} {' '.join(extra)}".strip()
        check_counts(label, launches, {"fwd_lean": iters + 2,
                                       "occ_bwd": iters, "feat_bwd": iters})
        for k in ("initial", "target", "final", "points"):
            if not os.path.exists(res[k]):
                raise AssertionError(f"{label}: {res[k]} was not written")
        loss, img = res["losses"], res["image_losses"]
        if not (np.isfinite(loss).all() and np.isfinite(img).all()):
            raise AssertionError(f"{label}: losses {loss}")
        if extra and not loss[-1] < loss[0]:
            raise AssertionError(f"{label}: the loss does not fall: {loss}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        print(f"{label}: {iters} iterations in {dt:.2f} s; loss "
              f"{loss[0]:.6f} → {loss[-1]:.6f}, image L1 {img[0]:.6f} → "
              f"{img[-1]:.6f}; launches {launches}  [{smi}]")
    return total


def neural(data, smi):
    """The neural and image apps at full width: the neural texture through
    K1–K3, the implicit SDF render, the image filters and the pix2pix
    generator on the texture's 8 target renders, and image_filter_flow end
    to end.  Returns the summed launch counts of the texture steps and the
    flow runs."""
    times, total = [], {}
    t0 = time.perf_counter()
    launches, renders = neural_texture(data, smi)
    times.append(("texture", time.perf_counter() - t0))
    t0 = time.perf_counter()
    implicit(data, smi)
    times.append(("implicit", time.perf_counter() - t0))
    t0 = time.perf_counter()
    image_filters(renders, smi)
    times.append(("filters", time.perf_counter() - t0))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        weights = pix2pix(renders, tmp, smi)
        times.append(("pix2pix", time.perf_counter() - t0))
        t0 = time.perf_counter()
        runs = flow(tmp, weights, smi)
        times.append(("image_filter_flow", time.perf_counter() - t0))
    for part in (launches, runs):
        for k, n in part.items():
            total[k] = total.get(k, 0) + n
    print("neural times: " + ", ".join(f"{k} {v:.2f} s" for k, v in times)
          + f"  [{smi}]")
    print(f"neural launches: {total}")
    return total


def _gradient_fields(dg, tmp, smi):
    """collect_gradient_fields on data_gen's trained model and the first
    N_VIEWS views of its mesh dataset at DG_SIZE² (K1, K2, K3 once each
    for 'position'; the regularizers launch nothing): all three fields
    finite and nonzero; then dump_debug_quivers, both PNGs read back.
    Returns the launches."""
    from dss_tpu_torch import config as config_mod
    from dss_tpu_torch import convert
    from dss_tpu_torch.data.dataset import MVRDataset
    from dss_tpu_torch.data.png import read_png
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.training.debug import (collect_gradient_fields,
                                              dump_debug_quivers)

    with np.load(os.path.join(dg["run_dir"], "model.npz")) as f:
        ck = {k: f[k] for k in f.files}
    params = convert.params_from_numpy(ck, device=DEV)
    filters = PointFilters(**{
        k: torch.as_tensor(ck[f"filters/{k}"], device=DEV)
        for k in ("activation", "visibility", "inmask")})
    img, msk, cams, lights = MVRDataset(dg["mesh_ds"]).get_batch(
        list(range(N_VIEWS)), device=DEV)
    img, msk = (torch.as_tensor(x, device=DEV) for x in (img, msk))
    settings = config_mod.create_raster_settings(
        config_mod.load_config(dg["cfg"]))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fields = collect_gradient_fields(params, filters, cams, lights, settings,
                                     img, msk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_counts("aux gradient fields", launches,
                 {k: 1 for k in LEAN_KERNELS})
    norms = {k: float(torch.linalg.vector_norm(g, dim=-1).max())
             for k, g in fields.items()}
    if not all(bool(torch.isfinite(g).all()) and norms[k] > 0
               for k, g in fields.items()):
        raise AssertionError(f"aux: gradient fields not finite and nonzero: "
                             f"max norms {norms}")
    out = os.path.join(tmp, "debug")
    t1 = time.perf_counter()
    dump_debug_quivers(params, fields, cams, msk, out, DG_ITERS, DG_SIZE)
    shapes = [read_png(os.path.join(out, f"debug_{d}_{DG_ITERS:06d}.png")).shape
              for d in ("2d", "3d")]
    print(f"aux gradient fields: {N_VIEWS} views at {DG_SIZE}², "
          f"{params.points.shape[0]} points; max |g| per point "
          + ", ".join(f"{k} {v:.4e}" for k, v in norms.items())
          + f"; {dt * 1e3:.1f} ms, launches {launches}; quiver PNGs "
          f"{shapes[0]} and {shapes[1]} in {time.perf_counter() - t1:.2f} s"
          f"  [{smi}]")
    return launches


def _report(dg, tmp, smi):
    """make_result_report on data_gen's trained model and mesh dataset,
    AUX_VIEWS views (K1 once): the JSON holds every key, each finite, and
    the grid PNG reads back.  Returns the launches."""
    from dss_tpu_torch.apps import make_result_report
    from dss_tpu_torch.data.png import read_png
    from dss_tpu_torch.ops import kernels

    out = os.path.join(tmp, "report")
    kernels.reset_launch_counts()
    report, _, dt = _run_app(make_result_report.main, [
        "--data", dg["mesh_ds"], "--ckpt",
        os.path.join(dg["run_dir"], "model.npz"), "--out", out,
        "--config", dg["cfg"], "--json-name", "aux_metrics.json",
        "--views", *map(str, AUX_VIEWS)])
    launches = kernels.launch_counts()
    check_counts("aux report", launches, {"fwd_lean": 1})
    with open(os.path.join(out, "aux_metrics.json")) as f:
        written = json.load(f)
    grid = read_png(os.path.join(out, "aux_gt_vs_pred.png")).shape
    if not (set(written) == REPORT_KEYS and written == report
            and all(np.isfinite(v) for v in written.values())
            and grid == (len(AUX_VIEWS) * DG_SIZE, 2 * DG_SIZE, 3)):
        raise AssertionError(f"aux report: {written}, grid {grid}")
    print(f"aux report: {written}; grid {grid}; {dt:.2f} s, launches "
          f"{launches}  [{smi}]")
    return launches


def _depth_backfill(dg, tmp, smi):
    """gen_depth_for_dataset on copies of data_gen's mesh and cloud
    datasets without their depth maps: the same files as create_mvr_data
    wrote (max |Δ| ≤ 1e-6, printed); the mesh launches no kernel, the
    cloud K5 once per view and the eigensolver once (its PCA normals, as
    create_mvr_data estimates them).  Returns the launches."""
    from dss_tpu_torch.apps import gen_depth_for_dataset
    from dss_tpu_torch.ops import kernels

    total = {}
    for label, must in (("mesh", {}), ("cloud", {"fwd_frag": DG_CAMERAS,
                                                 "symeig3": 1})):
        src = dg[f"{label}_ds"]
        ds = os.path.join(tmp, f"depth_{label}")
        shutil.copytree(src, ds, ignore=shutil.ignore_patterns("depth"))
        kernels.reset_launch_counts()
        _, _, dt = _run_app(gen_depth_for_dataset.main,
                            ["--data", ds, "--mesh", dg[label]])
        launches = kernels.launch_counts()
        check_counts(f"aux depth {label}", launches, must)
        names = sorted(os.listdir(os.path.join(src, "depth")))
        if sorted(os.listdir(os.path.join(ds, "depth"))) != names:
            raise AssertionError(f"aux depth {label}: files differ")
        diff = max(float(np.abs(np.load(os.path.join(ds, "depth", n))
                                - np.load(os.path.join(src, "depth", n))).max())
                   for n in names)
        if not diff <= 1e-6:
            raise AssertionError(f"aux depth {label}: max |Δ| {diff} against "
                                 f"create_mvr_data's depth maps")
        print(f"aux depth {label}: {len(names)} maps at {DG_SIZE}², max |Δ| "
              f"against create_mvr_data's {diff:.3e}; {dt:.2f} s, launches "
              f"{launches}  [{smi}]")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def _sdf_weight_gradient(data, smi):
    """The weight gradient of Σ render_sdf · cot for the SDF (SDF_NET) at
    its init, AUX_SDF_SIZE², AUX_SDF_STEPS trace steps, under grad: finite,
    and off the gradient with the normals taken on detached hit points
    (which drops ∂n/∂p · ∂p/∂θ) by more than 1e-3 of its largest entry.
    No kernel runs."""
    from dss_tpu_torch.models.decoders import SDF
    from dss_tpu_torch.render import implicit

    sdf = SDF(**SDF_NET, generator=torch.Generator().manual_seed(SEED),
              device=DEV)
    f = lambda p: sdf(p)["sdf"][..., 0]
    cot = torch.randn((AUX_SDF_SIZE, AUX_SDF_SIZE, 4),
                      generator=torch.Generator().manual_seed(SEED)).to(DEV)

    def weight_grad():
        sdf.zero_grad()
        img = implicit.render_sdf(f, data["cams"], AUX_SDF_SIZE,
                                  n_steps=AUX_SDF_STEPS)
        (img * cot).sum().backward()
        return torch.cat([p.grad.reshape(-1) for p in sdf.parameters()
                          if p.grad is not None]), img

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, img = weight_grad()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    normals = implicit.sdf_normals
    implicit.sdf_normals = lambda fn, p: normals(fn, p.detach())
    try:
        g_detached, _ = weight_grad()
    finally:
        implicit.sdf_normals = normals
    gap = float((g - g_detached).abs().max()) / float(g.abs().max())
    if not (bool(torch.isfinite(g).all()) and gap > 1e-3):
        raise AssertionError(f"aux render_sdf: weight gradient finite "
                             f"{bool(torch.isfinite(g).all())}, relative gap "
                             f"to the detached-points gradient {gap}")
    print(f"aux render_sdf under grad: SDF {SDF_NET['hidden_size']} × "
          f"{SDF_NET['n_layers']} at {AUX_SDF_SIZE}², {AUX_SDF_STEPS} steps, "
          f"alpha coverage {float(img.detach()[..., 3].mean()):.4f}: {g.numel()} "
          f"weights, max |grad| {float(g.abs().max()):.4e}, max |Δ| to the "
          f"detached-points gradient {gap:.4f} of it; {dt:.2f} s, peak "
          f"memory {peak:.2f} GiB  [{smi}]")


def aux(data, dg, smi):
    """The debug, report and depth-backfill apps on data_gen's dataset and
    model (`dg`, data_gen's paths), and render_sdf's weight gradient under
    grad.  Returns the summed launches."""
    times, total = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (("gradient fields", lambda: _gradient_fields(dg, tmp, smi)),
                          ("report", lambda: _report(dg, tmp, smi)),
                          ("depth", lambda: _depth_backfill(dg, tmp, smi)),
                          ("render_sdf", lambda: _sdf_weight_gradient(data, smi))):
            t0 = time.perf_counter()
            for k, n in (run() or {}).items():
                total[k] = total.get(k, 0) + n
            times.append((name, time.perf_counter() - t0))
    print("aux times: " + ", ".join(f"{k} {v:.2f} s" for k, v in times)
          + f"  [{smi}]")
    print(f"aux launches: {total}")
    return total


def _view_slice(x, sl):
    return type(x)(**{f.name: getattr(x, f.name)[sl]
                      for f in dataclasses.fields(x)})


def parallel(data, targets, lean_times, smi):
    """The view-sharded lean train step at the flagship shape (N_VIEWS
    views, N_POINTS points, 512², K = 5, the flagship recipe) over ranks
    spawned on cuda:0 (parallel/dryrun.py::run_case): NCCL at world size 1
    (a real communicator: NCCL takes one rank per card) and gloo at world
    size 2 (both ranks on cuda:0; gloo takes CUDA tensors).  Each rank
    computes the reduced gradients, takes PAR_STEPS Adam steps, skips a
    step with a NaN in the last view's mask on every rank, takes one step
    of make_sharded_train_step (K1, K2, K3 once each for the gradients and
    for each of these 2 + PAR_STEPS steps), and row-shards view 0's
    reference render (no kernel); the ranks check that parameters, Adam state and gradients are
    bitwise equal among them.  Held here to the single-process gradients:
    at world size n against the mean of the single-process gradients of
    the ranks' view slices (rtol 1e-4, atol 1e-6 · max: K2's and K3's
    atomics), and the max |Δ| against the whole batch's printed (the
    masked means differ where the slices hold different mask counts, in
    dss_tpu too); the row render against render_single_view's reference
    render (max |Δ| ≤ 1e-6, visibility equal).  A backend that does not
    start fails the phase.  Returns the launches of the ranks and of the
    single-process gradients."""
    from dss_tpu_torch.geometry.pointclouds import PointFilters
    from dss_tpu_torch.ops import kernels
    from dss_tpu_torch.parallel.dryrun import run_case
    from dss_tpu_torch.render.ewa import RasterSettings
    from dss_tpu_torch.render.renderer import render_single_view
    from dss_tpu_torch.training.trainer import (AnnealSchedule, TrainConfig,
                                                make_loss_fn)

    settings = RasterSettings(**FLAGSHIP_RASTER)
    cams, lights = data["cams"], data["lights"]
    pts, nrm = data["init"]
    case = dict(points=pts, normals=nrm, colors=np.ones_like(pts),
                img=targets["img"].cpu().numpy(),
                mask=targets["mask_img"].cpu().numpy(),
                depth=targets["depth"].cpu().numpy())
    case.update({f"cam/{f.name}": getattr(cams, f.name).cpu().numpy()
                 for f in dataclasses.fields(cams)})
    case.update({f"lights/{f.name}": getattr(lights, f.name).cpu().numpy()
                 for f in dataclasses.fields(lights)})

    loss_fn = make_loss_fn(settings, TrainConfig(**FLAGSHIP_TRAIN),
                           AnnealSchedule(**FLAGSHIP_SCHEDULE))

    def single(sl):
        params = initial_params(data)
        total, _ = loss_fn(params, PointFilters.ones(N_POINTS, device=DEV),
                           _view_slice(cams, sl), _view_slice(lights, sl),
                           targets["img"][sl], targets["mask_img"][sl], 0,
                           targets["depth"][sl])
        return torch.stack(torch.autograd.grad(total, params.tensors())).cpu()

    total = {}
    kernels.reset_launch_counts()
    whole = single(slice(None))
    with torch.no_grad():
        ref_rgba, _, ref_vis = render_single_view(
            initial_params(data).points.detach(),
            torch.as_tensor(nrm, device=DEV),
            torch.ones((N_POINTS, 3), device=DEV),
            torch.ones(N_POINTS, dtype=torch.bool, device=DEV),
            _view_slice(cams, slice(0, 1)), _view_slice(lights, slice(0, 1)),
            settings.replace(backend="reference"))
    dev = f"{DEV}:0" if DEV == "cuda" else DEV
    for backend, n in PAR_RUNS:
        k = N_VIEWS // n
        want = sum(single(slice(i * k, (i + 1) * k)) for i in range(n)) / n
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ranks = run_case(case, n, tmp, device=dev, backend=backend,
                             raster=FLAGSHIP_RASTER, train=FLAGSHIP_TRAIN,
                             schedule=FLAGSHIP_SCHEDULE, opt=FLAGSHIP_OPT,
                             steps=PAR_STEPS, timeout=300.0)
            wall = time.perf_counter() - t0
        for r in ranks:
            if str(r["backend"]) != backend:
                raise AssertionError(f"parallel: ran {r['backend']}, not "
                                     f"{backend}")
            got = dict(zip(r["launch_names"].tolist(), r["launches"].tolist()))
            check_counts(f"parallel {backend} rank", got,
                         {kk: 1 + PAR_STEPS + 2 for kk in LEAN_KERNELS})
            for kk, m in got.items():
                total[kk] = total.get(kk, 0) + m
        g = torch.as_tensor(ranks[0]["grads"])
        err = _close(f"parallel {backend} × {n} gradients", g, want, 1e-4,
                     1e-6)
        vs_whole = float((g - whole).abs().max()) / float(whole.abs().max())
        rgba = torch.as_tensor(ranks[0]["rgba"])
        d_rgba = float((rgba - ref_rgba.cpu()).abs().max())
        if not (d_rgba <= 1e-6 and np.array_equal(ranks[0]["visible"],
                                                  ref_vis.cpu().numpy())):
            raise AssertionError(f"parallel {backend}: row-sharded render "
                                 f"max |Δ| {d_rgba} or visibility differs")
        step_ms = ranks[0]["step_ms"][1:]
        print(f"parallel {backend} × {n} on {dev}: max |Δ| gradients "
              f"{err:.3e} against the mean of the slices' single-process "
              f"gradients, {vs_whole:.3e} of max |g| against the whole "
              f"batch's; parameters, Adam state and gradients bitwise equal "
              f"across ranks; NaN step skipped on every rank; row-sharded "
              f"render max |Δ| {d_rgba:.3e}; losses "
              f"{[round(float(x), 6) for x in ranks[0]['losses']]}; median "
              f"step {statistics.median(step_ms):.3f} ms over "
              f"{len(step_ms)} (single process: "
              f"{statistics.median(lean_times):.3f} ms); {wall:.1f} s with "
              f"the spawn  [{smi}]")
    for kk, m in kernels.launch_counts().items():
        total[kk] = total.get(kk, 0) + m
    print(f"parallel launches: {total}")
    return total


def main():
    from dss_tpu_torch.render.ewa import RasterSettings

    t_start = time.perf_counter()
    smi = setup()
    torch.manual_seed(SEED)
    data = make_data(DEV)
    recs = check_kernels(data)
    check_k2_edges()
    check_cull_edges()
    check_k4_edges()
    check_cameras()
    check_small_reference()
    lean_targets = render_targets(data, RasterSettings(**FLAGSHIP_RASTER))
    frag_targets = render_targets(data, RasterSettings(**FLAGSHIP_FRAG_RASTER))
    lean, lean_times = train(data, FLAGSHIP_RASTER, lean_targets,
                             LEAN_KERNELS, "lean")
    frag, frag_times = train(data, FLAGSHIP_FRAG_RASTER, frag_targets,
                             FRAG_KERNELS, "fragment", once=("segment_sum",))
    print(f"median step: lean {statistics.median(lean_times):.3f} ms, "
          f"fragment {statistics.median(frag_times):.3f} ms")
    win_lean, lean_graph_ms, _ = window(data, FLAGSHIP_RASTER, lean_targets,
                                        LEAN_KERNELS, "lean", smi,
                                        grid_route=True)
    win_frag, frag_graph_ms, _ = window(data, FLAGSHIP_FRAG_RASTER,
                                        frag_targets, FRAG_KERNELS,
                                        "fragment", smi)
    win_aniso, aniso_graph_ms, aniso_eager_ms = window(
        data, ANISO_RASTER, lean_targets, EIG_KERNELS, "anisotropic Vrk", smi)
    win_pca, pca_graph_ms, pca_eager_ms = window(
        data, FLAGSHIP_RASTER, lean_targets, EIG_KERNELS, "PCA anchor", smi,
        train=PCA_TRAIN, knn=KNN_PER_STEP + 1)
    print(f"median step through the graph: lean "
          f"{statistics.median(lean_graph_ms):.3f} ms, fragment "
          f"{statistics.median(frag_graph_ms):.3f} ms, anisotropic Vrk "
          f"{statistics.median(aniso_graph_ms):.3f} ms (make_train_step "
          f"{statistics.median(aniso_eager_ms):.3f} ms), PCA anchor "
          f"{statistics.median(pca_graph_ms):.3f} ms (make_train_step "
          f"{statistics.median(pca_eager_ms):.3f} ms)  [{smi}]")
    cli = train_cli(smi)
    post = post_process(smi)
    new = [win_lean, win_frag, win_aniso, win_pca, bench_phase(smi),
           single_view(data, smi), multiscene(smi)]
    with tempfile.TemporaryDirectory() as dg_tmp:
        dg, geo, dg_paths = data_gen(smi, dg_tmp)
        new += [dg, geo, neural(data, smi), aux(data, dg_paths, smi)]
    new.append(parallel(data, lean_targets, lean_times, smi))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build "
          f"to the last phase  [{smi}]")
    print("launches by phase: " + json.dumps({
        name: [lean[name], frag[name], cli[name], post.get(name, 0),
               *(n.get(name, 0) for n in new)] for name in recs})
          + " (lean, fragment, train_cli, post_process, window lean, window "
          "fragment, window anisotropic Vrk, window PCA anchor, bench, "
          "single_view, multiscene, data_gen, geometry, neural, aux, "
          "parallel)")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_TABLE[name][0],
         "replaces": KERNEL_TABLE[name][1],
         "launches": (lean[name] + frag[name] + cli[name] + post.get(name, 0)
                      + sum(n.get(name, 0) for n in new)),
         **rec}
        for name, rec in recs.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
