"""Smoke run of dss_tpu_torch on one CUDA card: build the splat kernels,
hold each against its plain PyTorch version at the flagship shapes (with
its time, its least possible time from this run's bytes and (pixel,
candidate) pairs, and K4's library counterpart): K1, K2, K3 and K5 with the
scatter to points fused into their epilogues, K4 on the fragment path's
zbuf scatter.  Hold K2 on a table of pixels exactly on the disc's and the
box's edges, K1, K3 and K5 on the edge tables of their shared sub-tile
cull, and K4 on the edge cases of its warp merge; check the camera on the
card against the CPU, then drive the flagship train step
(configs/dss_depth.yml: 512² images, 5000 points, 8 views per step, K=5,
Vrk_invariant) through `make_train_step` on both of its paths, 1 warm-up
step and 5 timed steps each:

- the lean path (K1–K3; no K4), with depth L1 on the weighted-depth
  channel;
- the fragment path (`lean_fragments: false`; K5, K2, K3, and K4 once per
  step for the zbuf scatter), with depth L1 on the nearest fragment's z
  (zbuf[..., 0]).

    python3 chip_smoke.py

Every phase passes or raises; nothing is caught.  Without a CUDA card it
exits non-zero before printing any result.  The last two lines of standard
output are the per-kernel JSON summary and the device JSON line.
"""
import json
import statistics
import subprocess
import sys
import time

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
DEV = "cuda"

# The TPU kernels each CUDA kernel replaces (dss_tpu/ops/splat_pallas.py).
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
}
# Float operations per (pixel, candidate) pair, as each source's note
# counts them: K2 per pair inside the support disc, K1/K3/K5 per pair
# inside the candidate's box.  K4 is bound by bytes alone.
OPS_PER_PAIR = {"fwd_lean": 26, "occ_bwd": 16, "feat_bwd": 24, "fwd_frag": 24}
# H100 SXM peaks at the 700 W limit (NVIDIA's data sheet): FP32 outside
# the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# What each train phase must launch, and must not: the lean step scatters
# to points only in the epilogues of K1–K3, the fragment step launches K4
# once per step, for the zbuf cotangent.
LEAN_KERNELS = ("fwd_lean", "occ_bwd", "feat_bwd")
FRAG_KERNELS = ("fwd_frag", "occ_bwd", "feat_bwd", "segment_sum")


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
    t0 = time.perf_counter()
    lib_path = kernels.build_library()
    kernels.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")


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
    return out


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
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, data["cams"], data["lights"], targets["img"],
                        targets["mask_img"], targets["depth"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i > 0:
            times.append(dt)
        parts = {k: float(v) for k, v in m.items()}
        print(f"{label} step {i}{' (warm-up)' if i == 0 else ''}: {dt:.2f} ms  "
              + "  ".join(f"{k} {v:.6g}" for k, v in sorted(parts.items())))
        if not (all(np.isfinite(v) for v in parts.values())
                and bool(m["params_finite"])):
            raise AssertionError(f"{label} step {i}: non-finite loss or gradient")
    launches = kernels.launch_counts()
    missing = [k for k in must if launches[k] == 0]
    stray = [k for k, n in launches.items() if k not in must and n > 0]
    not_once = [k for k in once if launches[k] != 1 + TIMED_STEPS]
    if missing or stray or not_once:
        raise AssertionError(f"{label} steps: kernels not launched {missing}, "
                             f"kernels launched off their path {stray}, "
                             f"kernels not launched once per step {not_once}")
    cd1, _ = chamfer_distance(state.params.points.detach(), data["gt_pts"])
    print(f"{label} launches during the {1 + TIMED_STEPS} steps: {launches}")
    print(f"{label} median step {statistics.median(times):.3f} ms over "
          f"{TIMED_STEPS} steps (min {min(times):.3f}, max {max(times):.3f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{label} chamfer to ground truth: {float(cd0):.6f} before, "
          f"{float(cd1):.6f} after {1 + TIMED_STEPS} steps")
    return launches, times


def main():
    from dss_tpu_torch.render.ewa import RasterSettings

    setup()
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
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_TABLE[name][0],
         "replaces": KERNEL_TABLE[name][1],
         "launches": lean[name] + frag[name], **rec}
        for name, rec in recs.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
