"""The five splat kernels, the tile binning, the 3×3 eigensolver, the exact
kNN and the train window's guarded Adam: CUDA wrappers, their plain
PyTorch versions, the on-demand build and the launch counters.

| kernel        | CUDA source           | replaces (dss_tpu/ops/splat_pallas.py) |
| ------------- | --------------------- | -------------------------------------- |
| `fwd_lean`    | csrc/fwd_lean.cu      | `_fwd_kernel_lean` (K1)                |
| `occ_bwd`     | csrc/occ_bwd.cu       | `_bwd_kernel` (K2)                     |
| `feat_bwd`    | csrc/feat_bwd.cu      | `_feat_bwd_kernel` (K3)                |
| `segment_sum` | csrc/segment_sum.cu   | `_segsum_matmul_kernel` (K4)           |
| `fwd_frag`    | csrc/fwd_frag.cu      | `_fwd_kernel` (K5)                     |
| `symeig3`     | csrc/symeig3.cu       | no Pallas kernel: XLA's `jnp.linalg.eigh` |
| `knn_topk`    | csrc/knn_topk.cu      | no Pallas kernel: XLA's matmul and `top_k` |
| `all_finite`, `guarded_adam` | csrc/guarded_adam.cu | no Pallas kernel: optax's Adam under XLA |
| `prep_fwd`, `prep_bwd` | csrc/prep_splats.cu | no Pallas kernel: XLA's EWA set-up and shading |
| `bin_tiles`, `median_select` | csrc/bin_tiles.cu | no Pallas kernel: XLA's sort, cumsum and gathers of `bin_splats`, `masked_median` |

Beside them, `span_mark` (csrc/span_mark.cu) writes one device timestamp
of utils/spans.py's tracing; it computes nothing of the model.

K1, K2, K3 and K5 scatter their per-candidate results to points in their
epilogues (the TPU ran K4 after each of them): they return per-point
tensors (V, P[, C]).  Each has two plain versions: `<name>_plain`, the
per-candidate table the TPU kernel writes, and `<name>_points_plain`, that
table summed into points by K4's plain version over the slots' point ids,
which is the wrapper's contract.  K4 itself is left with the fragment
path's zbuf scatter.

Dispatch is by device only.  A wrapper given CPU tensors runs the
per-point plain version; given CUDA tensors it launches the kernel and
raises if the build or the launch fails.  Any other device reaches the
CUDA branch and raises.  `guarded_adam`, `prep_fwd` and `prep_bwd` take
CUDA tensors only: guarded_adam's plain version is the composite that
works on the optimizer's groups, training/trainer.py:guarded_adam_plain,
and trainer.guarded_adam_ dispatches between the two; the set-up kernels'
are render/prep.py:prep_composite (the forward) and prep_bwd_plain (the
backward's closed form), between which and the kernels
render/prep.py:_PrepSplats dispatches.  `bin_tiles` and `median_select`
take CUDA tensors only too: their plain versions are ops/splat.py's
bin_splats_plain, bin_for_occ_backward_plain and masked_median_plain, and
splat.bin_splats, bin_for_occ_backward and masked_median dispatch.

The sources are compiled with nvcc into one shared library with a plain C
interface (loaded with ctypes) at first use, under `build/dss_tpu_torch_kernels/`
beside the package, keyed by a hash of the sources and flags.  `-fmad=false`
keeps every product and sum rounded as in the plain version: a fused
multiply-add in the conic Q moves it by an ulp, and a candidate at
Q ≈ cutoff then flips accept, its rank, and every later fragment of the
pixel.

Layouts (V views, nt = n_tiles, tt = tile², M = table capacity, P points):
  counts (V, nt) int32; table (V, nt, C, M) float32 depth-sorted candidate
  channels, the point id in CH_ID of the forward table (exact below 2²⁴);
  per-pixel data in tile order (V, nt, tt[, ch]); per-point data (V, P[, C]).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

# Channel layout of the forward candidate table (as in the JAX package).
(CH_PX, CH_PY, CH_PZ, CH_A, CH_B, CH_C, CH_CUT, CH_RX, CH_RY,
 CH_SC, CH_R, CH_G, CH_B2, CH_ID) = range(14)
N_CHANNELS = 14
# Occupancy-backward table: px, py, pz, unscaled rx, ry.
(BCH_PX, BCH_PY, BCH_PZ, BCH_RX, BCH_RY) = range(5)
N_BWD_CHANNELS = 5
# Candidate chunk of K1's and K3's depth-window rule (z₀ is updated per
# chunk); compiled into the kernels.
CHUNK = 128
# Side of the pixel sub-tile that K1, K3 and K5 cull their candidates
# against (one 256-thread block).
SUB = 16
# Largest points_per_pixel K5 holds in registers.
FRAG_K_MAX = 16
# Point ids ride the float32 forward table, exact below 2²⁴.
MAX_POINTS = 1 << 24

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dss_tpu_torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


class KernelCompileError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


_loaded = {}  # "lib": the loaded library (sources are hashed once, at load)


def find_nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return shutil.which("nvcc")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (once per source hash);
    returns its path.  Each source gets an nvcc of its own, all started
    together, then one link.  The compiler's register and shared-memory
    report is kept beside the library as ptxas.log."""
    out_dir = _BUILD_ROOT / _source_hash()
    lib = out_dir / "libdss_tpu_torch_kernels.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelCompileError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the CUDA kernels of dss_tpu_torch "
            "cannot be built; CPU tensors take the plain versions"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    # a private directory: another process may build the same hash
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        srcs = sorted(_CSRC.glob("*.cu"))
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o",
                 str(work / (src.stem + ".o"))] for src in srcs]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise KernelCompileError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(work / lib.name),
               *[str(work / (src.stem + ".o")) for src in srcs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise KernelCompileError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        (out_dir / "ptxas.log").write_text("".join(
            f"== {src.name}\n{log}" for src, log in zip(srcs, logs)))
        os.replace(work / lib.name, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # counts, table, cnt, vis, rgbw, V, n_tiles_x, tile, M, K, dmt, inv_s,
    # with_depth, P, stream
    "dss_fwd_lean": [_VP] * 5 + [_I] * 5 + [_F, _F, _I, _I, _VP],
    # counts, table5, grad_occ, cur_r2, tile_ids, out, V, n_tiles_x, tile,
    # M, inv_s, P, stream
    "dss_occ_bwd": [_VP] * 6 + [_I] * 4 + [_F, _I, _VP],
    # counts, table, grad, out, V, n_tiles_x, tile, M, K, dmt, inv_s, P,
    # stream
    "dss_feat_bwd": [_VP] * 4 + [_I] * 5 + [_F, _F, _I, _VP],
    # vals, seg, out, V, C, N, P, stream
    "dss_segment_sum": [_VP] * 3 + [_I] * 4 + [_VP],
    # counts, table, z, q, ids, cnt, vis, rgbw, V, n_tiles_x, tile, M, K,
    # dmt, inv_s, P, stream
    "dss_fwd_frag": [_VP] * 8 + [_I] * 5 + [_F, _F, _I, _VP],
    # mats, w, v, N, stream
    "dss_symeig3": [_VP] * 3 + [_I, _VP],
    # query, qq, qmask, ref, rr, rmask, out_d, out_i, Q, P, k, exclude_self,
    # stream
    "dss_knn_topk": [_VP] * 8 + [_I] * 4 + [_VP],
    # ring, count, steps, cols, col, flags, layout, stream
    "dss_span_mark": [_VP] * 2 + [_I] * 4 + [ctypes.c_longlong, _VP],
    # entries, n_tensors, n_blocks, finite, tickets, stream
    "dss_guarded_adam": [_VP, _I, _I, _VP, _VP, _VP],
    # entries, n_tensors, n_blocks, finite, stream
    "dss_all_finite": [_VP, _I, _I, _VP, _VP],
    # points, normals, colors, mask, proj, R, T, znear, zfar, ambient,
    # diffuse, specular, where, h, vrk, sk, h_stride, vrk strides (3), sk
    # strides (3), shaded, screen, conic, cutoff, radii, scaler, render
    # mask, V, P, L, La, shade, backface, lam, lam_sq, cutoff, shininess,
    # stream
    "dss_prep_fwd": [_VP] * 16 + [_I] * 7 + [_VP] * 7 + [_I] * 6 + [_F] * 4
                    + [_VP],
    # points, normals, colors, proj, R, T, znear, zfar, ambient, diffuse,
    # specular, where, g_shaded, g_screen, d_points, d_normals, d_colors,
    # V, P, L, La, shade, shininess, clip, stream
    "dss_prep_bwd": [_VP] * 17 + [_I] * 5 + [_F] * 2 + [_VP],
    # pts, radii, ellipse, cutoff, scaler, features, visible, extra,
    # extra_s, scratch, seg, zinfo, keys, table, ids, counts, overflow,
    # overflow_base, overflow_sum, long_tiles, V, P, S, tile, nt, rx, ry,
    # M, pair_cap, sort_by_depth, backward_channels, zq_bits, stream
    "dss_bin_tiles": [_VP] * 8 + [_F] + [_VP] * 11 + [_I] * 12 + [_VP],
    # vals, mask, scale_p, scale_s, med, r, r2, V, n_vals, group, stream
    "dss_median_select": [_VP] * 3 + [_F] + [_VP] * 3 + [_I] * 3 + [_VP],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process;
    raises KernelCompileError where it cannot be built.  Never returns a
    stand-in."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def _call(name: str, *args) -> None:
    err = getattr(load_library(), name)(
        *args, torch.cuda.current_stream().cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check_points(n_points: int) -> None:
    if not 0 < n_points < MAX_POINTS:
        raise ValueError(f"n_points={n_points}: the fused scatters take "
                         f"0 < P < 2²⁴ (the id rides the float32 table)")


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add `times` × `counts` (kernel name → launches) to the counters.
    A CUDA graph launches its kernels on replay without calling the
    wrappers: training/trainer.py records what the wrappers counted while
    the graph was captured, takes it back (a capture launches nothing) and
    adds it once per replay."""
    for fn in KERNELS:
        fn.launches += times * counts.get(fn.__name__, 0)


# ---------------------------------------------------------------------------
# Shared geometry
# ---------------------------------------------------------------------------


def _pixel_centres(n_tiles_x: int, tile_size: int, image_size: int, device):
    """NDC pixel centres (xf, yf), each (nt, tt): pixel (row, col) →
    (1 − (2·col+1)/S, 1 − (2·row+1)/S), the JAX kernels' operation order."""
    t = tile_size
    g = torch.arange(n_tiles_x * n_tiles_x, device=device)
    lin = torch.arange(t * t, device=device)
    row = (g // n_tiles_x)[:, None] * t + (lin // t)[None, :]
    col = (g % n_tiles_x)[:, None] * t + (lin % t)[None, :]
    inv_s = 1.0 / image_size
    yf = 1.0 - (2.0 * row.to(torch.float32) + 1.0) * inv_s
    xf = 1.0 - (2.0 * col.to(torch.float32) + 1.0) * inv_s
    return xf, yf


def _n_tiles_x(n_tiles: int) -> int:
    nt = int(round(n_tiles ** 0.5))
    if nt * nt != n_tiles:
        raise ValueError(f"n_tiles={n_tiles} is not a square")
    return nt


def _chunk_accept(d, xf, yf):
    """Accept test of one candidate chunk: d (nt, C, CM) table slice,
    xf/yf (nt, tt, 1).  Returns (q, accept), each (nt, tt, CM)."""
    ch = lambda i: d[:, i, None, :]
    dx = xf - ch(CH_PX)
    dy = yf - ch(CH_PY)
    q = ch(CH_A) * dx * dx + ch(CH_B) * dx * dy + ch(CH_C) * dy * dy
    accept = (
        (ch(CH_PZ) >= 0.0)
        & (torch.abs(dx) <= ch(CH_RX))
        & (torch.abs(dy) <= ch(CH_RY))
        & (q <= ch(CH_CUT))
    )
    return q, accept


def _window_weights(d, q, accept, cnt, z0, k, dmt):
    """Rank, chunk-granular depth window and weights of one chunk, as in
    the JAX kernels: rank = running count + exclusive prefix of accepts;
    z₀ = min(z₀, min accepted pz of this WHOLE chunk); a candidate wins if
    accepted, rank < K and pz − z₀ ≤ dmt; w = exp(−Q/2)·scaler·win.
    Returns (wins, w, new cnt, new z0)."""
    pz = d[:, CH_PZ, None, :]
    accf = accept.to(torch.float32)
    slot = cnt[..., None] + torch.cumsum(accf, dim=-1) - accf
    z0 = torch.minimum(
        z0, torch.amin(torch.where(accept, pz, torch.inf), dim=-1)
    )
    in_window = (pz - z0[..., None]) <= dmt
    wins = accept & (slot < float(k)) & in_window
    w = (torch.exp(-0.5 * torch.where(accept, q, 0.0))
         * d[:, CH_SC, None, :] * wins)
    return wins, w, cnt + accf.sum(dim=-1), z0


def _n_chunks(counts_v: torch.Tensor, m: int) -> int:
    return -(-int(torch.clamp(counts_v, max=m).max()) // CHUNK)


def _live_ids(counts, ids):
    """(V, nt·M) int32 point id of each table slot, from ids (V, nt, M)
    (int, or the forward table's float CH_ID row): −1 past the tile's
    count, where the fused kernels never write."""
    live = torch.arange(ids.shape[-1], device=ids.device) < counts[..., None]
    return torch.where(live, ids.to(torch.int32), -1).reshape(ids.shape[0], -1)


def _to_points(partials, seg, n_points: int):
    """Per-slot partials (V, nt, C, M) summed into points over the slots'
    ids seg (V, nt·M) by K4's plain version: (V, P, C)."""
    v, _, c, _ = partials.shape
    return segment_sum_plain(partials.transpose(1, 2).reshape(v, c, -1), seg,
                             n_points)


def _visible_points(vis, seg, n_points: int):
    """Per-slot "won a fragment" flags (V, nt, M) → (V, P) float32 1/0:
    K4's sum of the flags over each point's slots, tested > 0."""
    return (_to_points(vis[:, :, None], seg, n_points)[..., 0] > 0).to(
        torch.float32)


def subtile_cull_plain(counts, table, image_size: int, tile_size: int,
                       margin: int = 1):
    """Plain version of the sub-tile cull of K1, K3 and K5 (csrc/common.cuh:
    sub_tile, box_meets).  counts (V, nt) int32, table (V, nt, C, M) with
    px, py, pz in channels 0–2 and rx, ry in CH_RX, CH_RY.  Returns the
    survivors (V, nt, subs², M) bool: live slots whose candidate has pz ≥ 0
    and whose box meets the sub-tile's pixel centres widened by `margin`
    pixels (the kernels' 1; a negative margin narrows the range).  Sub-tile
    u of a tile is row u // subs, column u % subs.  The bounds and tests
    take the kernels' rounded float32 operations in their order."""
    v, n_tiles, _, m = table.shape
    ntx = _n_tiles_x(n_tiles)
    subs = tile_size // SUB
    dev = table.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    inv_s = f32(1.0 / image_size)
    ndc = lambda i: 1.0 - (2.0 * f32(i) + 1.0) * inv_s  # common.cuh pixel_ndc
    g = torch.arange(n_tiles, device=dev)[:, None]
    u = torch.arange(subs * subs, device=dev)[None, :]
    row0 = (g // ntx) * tile_size + (u // subs) * SUB  # (nt, subs²)
    col0 = (g % ntx) * tile_size + (u % subs) * SUB
    w = 2.0 * inv_s * margin
    lo_hi = lambda i0: (ndc(i0 + SUB - 1) - w, ndc(i0) + w)
    (xlo, xhi), (ylo, yhi) = lo_hi(col0), lo_hi(row0)
    ch = lambda i: table[:, :, None, i, :]  # (V, nt, 1, M)
    px, py, rx, ry = ch(CH_PX), ch(CH_PY), ch(CH_RX), ch(CH_RY)
    b = lambda x: x[None, :, :, None]  # (1, nt, subs², 1)
    meets = ((ch(CH_PZ) >= 0.0)
             & (b(xlo) - px <= rx) & (b(xhi) - px >= -rx)
             & (b(ylo) - py <= ry) & (b(yhi) - py >= -ry))
    live = torch.arange(m, device=dev) < counts[:, :, None, None]
    return meets & live


# ---------------------------------------------------------------------------
# K1: lean forward
# ---------------------------------------------------------------------------


def fwd_lean_plain(counts, table, dmt: float, image_size: int,
                   tile_size: int, points_per_pixel: int,
                   with_depth: bool = False):
    """Plain version of K1.  counts (V, nt) int32, table (V, nt, 14, M).
    Returns cnt (V, nt, tt) accepted count, vis (V, nt, M) per-candidate
    "won a fragment anywhere" flag, rgbw (V, nt, 4(+1), tt) = Σw·[r, g, b,
    1(, z)].  Vectorized over (pixels × chunk) with cumsum for the rank;
    one view at a time bounds the temporaries."""
    v, n_tiles, _, m = table.shape
    ntx = _n_tiles_x(n_tiles)
    tt = tile_size * tile_size
    co = 5 if with_depth else 4
    xf, yf = _pixel_centres(ntx, tile_size, image_size, table.device)
    xf, yf = xf[..., None], yf[..., None]
    cnt_out = torch.zeros((v, n_tiles, tt), device=table.device)
    vis_out = torch.zeros((v, n_tiles, m), device=table.device)
    rgb_out = torch.zeros((v, n_tiles, co, tt), device=table.device)
    for vi in range(v):
        z0 = torch.full((n_tiles, tt), torch.inf, device=table.device)
        cnt = torch.zeros((n_tiles, tt), device=table.device)
        frgb = torch.zeros((n_tiles, tt, co), device=table.device)
        # Slots past a tile's count hold sentinel rows (pz = −1,
        # cutoff = −inf), which accept nothing: sweeping the longest tile's
        # chunk range for every tile changes no output.
        for i in range(_n_chunks(counts[vi], m)):
            d = table[vi, :, :, i * CHUNK:(i + 1) * CHUNK]
            q, accept = _chunk_accept(d, xf, yf)
            wins, w, cnt, z0 = _window_weights(
                d, q, accept, cnt, z0, points_per_pixel, dmt)
            cols = [d[:, CH_R], d[:, CH_G], d[:, CH_B2],
                    torch.ones_like(d[:, CH_R])]
            if with_depth:
                cols.append(d[:, CH_PZ])
            frgb = frgb + w @ torch.stack(cols, dim=-1)  # (nt, tt, co)
            vis_out[vi, :, i * CHUNK:(i + 1) * CHUNK] = (
                wins.any(dim=1).to(torch.float32))
        cnt_out[vi] = cnt
        rgb_out[vi] = frgb.transpose(1, 2)
    return cnt_out, vis_out, rgb_out


def fwd_lean_points_plain(counts, table, n_points: int, dmt: float,
                          image_size: int, tile_size: int,
                          points_per_pixel: int, with_depth: bool = False):
    """Plain version of K1 with its fused scatter: fwd_lean_plain, its
    per-candidate flags summed into points over the table's id channel and
    tested > 0.  Returns cnt (V, nt, tt), vis (V, P) float32 1/0 ("won a
    fragment anywhere"), rgbw (V, nt, 4(+1), tt)."""
    cnt, vis, rgbw = fwd_lean_plain(counts, table, dmt, image_size,
                                    tile_size, points_per_pixel, with_depth)
    seg = _live_ids(counts, table[:, :, CH_ID])
    return cnt, _visible_points(vis, seg, n_points), rgbw


def fwd_lean(counts, table, n_points: int, dmt: float, image_size: int,
             tile_size: int, points_per_pixel: int, with_depth: bool = False):
    """K1: see fwd_lean_points_plain for the contract."""
    if _on_cpu(table):
        return fwd_lean_points_plain(counts, table, n_points, dmt, image_size,
                                     tile_size, points_per_pixel, with_depth)
    v, n_tiles, c, m = table.shape
    _check("table", table, torch.float32, 4, table.device)
    _check("counts", counts, torch.int32, 2, table.device)
    _check_points(n_points)
    if c != N_CHANNELS or m % CHUNK or tile_size % 16 or counts.shape != (v, n_tiles):
        raise ValueError("fwd_lean: table must be (V, nt, 14, M·128) and "
                         "the tile a multiple of 16")
    tt = tile_size * tile_size
    co = 5 if with_depth else 4
    cnt = torch.empty((v, n_tiles, tt), device=table.device)
    vis = torch.zeros((v, n_points), device=table.device)
    rgbw = torch.empty((v, n_tiles, co, tt), device=table.device)
    _call("dss_fwd_lean", _ptr(counts), _ptr(table), _ptr(cnt), _ptr(vis),
          _ptr(rgbw), v, _n_tiles_x(n_tiles), tile_size, m,
          points_per_pixel, dmt, 1.0 / image_size, int(with_depth), n_points)
    fwd_lean.launches += 1
    return cnt, vis, rgbw


# ---------------------------------------------------------------------------
# K2: occupancy backward
# ---------------------------------------------------------------------------


def occ_bwd_plain(counts, table5, grad_occ, cur_r2, image_size: int,
                  tile_size: int):
    """Plain version of K2.  table5 (V, nt, 5, Mb) support table, grad_occ
    (V, nt, tt) in tile order, cur_r2 (V,).  For each candidate, the sum
    over the tile's pixels of g·(dx, dy)/max(dx² + dy², 1e-10), over the
    pixels with dist² ≤ cur_r², a point on screen with pz ≥ 0, g ≠ 0, and
    not (g > 0 and the pixel outside the splat box).  Only the pixels
    with g ≠ 0 are visited (the others add 0): a tile with none is
    skipped, and each other tile's are taken in pixel order, padded with
    pixels of g = 0 to the most any tile has.  Returns gx, gy
    (V, nt, Mb)."""
    v, n_tiles, _, m = table5.shape
    ntx = _n_tiles_x(n_tiles)
    xf_all, yf_all = _pixel_centres(ntx, tile_size, image_size, table5.device)
    gx = torch.zeros((v, n_tiles, m), device=table5.device)
    gy = torch.zeros((v, n_tiles, m), device=table5.device)
    for vi in range(v):
        nz = grad_occ[vi] != 0.0
        live = torch.nonzero(nz.any(dim=1)).squeeze(1)
        if live.numel() == 0:
            continue
        nz = nz[live]
        pix = torch.argsort((~nz).to(torch.uint8), dim=1, stable=True)
        pix = pix[:, :int(nz.sum(dim=1).max())]
        g = torch.gather(grad_occ[vi, live], 1, pix)[..., None]
        xf = torch.gather(xf_all[live], 1, pix)[..., None]
        yf = torch.gather(yf_all[live], 1, pix)[..., None]
        tab = table5[vi, live]
        for i in range(_n_chunks(counts[vi], m)):
            sl = slice(i * CHUNK, (i + 1) * CHUNK)
            d = tab[:, :, sl]
            ch = lambda j: d[:, j, None, :]
            px, py = ch(BCH_PX), ch(BCH_PY)
            dx = xf - px
            dy = yf - py
            dist2 = dx * dx + dy * dy
            pt_ok = ((ch(BCH_PZ) >= 0.0) & (torch.abs(px) <= 1.0)
                     & (torch.abs(py) <= 1.0))
            outside = ((torch.abs(dx) > ch(BCH_RX))
                       | (torch.abs(dy) > ch(BCH_RY)))
            contribute = ((dist2 <= cur_r2[vi]) & pt_ok & (g != 0.0)
                          & ~((g > 0.0) & outside))
            w = torch.where(contribute,
                            g / torch.clamp(dist2, min=1e-10), 0.0)
            gx[vi, live, sl] = torch.sum(w * dx, dim=1)
            gy[vi, live, sl] = torch.sum(w * dy, dim=1)
    return gx, gy


def occ_bwd_points_plain(counts, table5, tile_ids, grad_occ, cur_r2,
                         n_points: int, image_size: int, tile_size: int):
    """Plain version of K2 with its fused scatter: occ_bwd_plain, its
    per-candidate (gx, gy) summed into points over tile_ids (V, nt, Mb),
    the support binning's point id of each slot.  Returns (V, P, 2)."""
    gx, gy = occ_bwd_plain(counts, table5, grad_occ, cur_r2, image_size,
                           tile_size)
    return _to_points(torch.stack([gx, gy], dim=2),
                      _live_ids(counts, tile_ids), n_points)


def occ_bwd(counts, table5, tile_ids, grad_occ, cur_r2, n_points: int,
            image_size: int, tile_size: int):
    """K2: see occ_bwd_points_plain for the contract."""
    if _on_cpu(table5):
        return occ_bwd_points_plain(counts, table5, tile_ids, grad_occ,
                                    cur_r2, n_points, image_size, tile_size)
    v, n_tiles, c, m = table5.shape
    tt = tile_size * tile_size
    _check("table5", table5, torch.float32, 4, table5.device)
    _check("counts", counts, torch.int32, 2, table5.device)
    _check("tile_ids", tile_ids, torch.int32, 3, table5.device)
    _check("grad_occ", grad_occ, torch.float32, 3, table5.device)
    _check("cur_r2", cur_r2, torch.float32, 1, table5.device)
    _check_points(n_points)
    if (c != N_BWD_CHANNELS or grad_occ.shape != (v, n_tiles, tt)
            or tile_ids.shape != (v, n_tiles, m)):
        raise ValueError("occ_bwd: shapes do not match the support table")
    out = torch.zeros((v, n_points, 2), device=table5.device)
    _call("dss_occ_bwd", _ptr(counts), _ptr(table5), _ptr(grad_occ),
          _ptr(cur_r2), _ptr(tile_ids), _ptr(out), v, _n_tiles_x(n_tiles),
          tile_size, m, 1.0 / image_size, n_points)
    occ_bwd.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: feature / depth backward through the fused composite
# ---------------------------------------------------------------------------


def feat_bwd_plain(counts, table, grad, dmt: float, image_size: int,
                   tile_size: int, points_per_pixel: int):
    """Plain version of K3.  grad (V, nt, tt, 4) in tile order: rgb
    cotangents in rows 0–2 and, with the depth channel, the Σw·z cotangent
    in row 3.  Recomputes K1's accept, rank, window and weights and returns
    (V, nt, 4, M) = Σ_pix w·grad per candidate (weights held constant)."""
    v, n_tiles, _, m = table.shape
    ntx = _n_tiles_x(n_tiles)
    tt = tile_size * tile_size
    xf, yf = _pixel_centres(ntx, tile_size, image_size, table.device)
    xf, yf = xf[..., None], yf[..., None]
    out = torch.zeros((v, n_tiles, 4, m), device=table.device)
    for vi in range(v):
        z0 = torch.full((n_tiles, tt), torch.inf, device=table.device)
        cnt = torch.zeros((n_tiles, tt), device=table.device)
        g_t = grad[vi].transpose(1, 2)  # (nt, 4, tt)
        for i in range(_n_chunks(counts[vi], m)):
            d = table[vi, :, :, i * CHUNK:(i + 1) * CHUNK]
            q, accept = _chunk_accept(d, xf, yf)
            _, w, cnt, z0 = _window_weights(
                d, q, accept, cnt, z0, points_per_pixel, dmt)
            out[vi, :, :, i * CHUNK:(i + 1) * CHUNK] = g_t @ w
    return out


def feat_bwd_points_plain(counts, table, grad, n_points: int, dmt: float,
                          image_size: int, tile_size: int,
                          points_per_pixel: int):
    """Plain version of K3 with its fused scatter: feat_bwd_plain, its
    per-candidate sums summed into points over the table's id channel.
    Returns (V, P, 4) = Σ w·grad over each point's pixels and slots."""
    out = feat_bwd_plain(counts, table, grad, dmt, image_size, tile_size,
                         points_per_pixel)
    return _to_points(out, _live_ids(counts, table[:, :, CH_ID]), n_points)


def feat_bwd(counts, table, grad, n_points: int, dmt: float, image_size: int,
             tile_size: int, points_per_pixel: int):
    """K3: see feat_bwd_points_plain for the contract."""
    if _on_cpu(table):
        return feat_bwd_points_plain(counts, table, grad, n_points, dmt,
                                     image_size, tile_size, points_per_pixel)
    v, n_tiles, c, m = table.shape
    tt = tile_size * tile_size
    _check("table", table, torch.float32, 4, table.device)
    _check("counts", counts, torch.int32, 2, table.device)
    _check("grad", grad, torch.float32, 4, table.device)
    _check_points(n_points)
    if (c != N_CHANNELS or m % CHUNK or tile_size % 16
            or grad.shape != (v, n_tiles, tt, 4) or grad.data_ptr() % 16):
        raise ValueError("feat_bwd: shapes do not match the candidate "
                         "table, or grad is not 16-byte aligned")
    out = torch.zeros((v, n_points, 4), device=table.device)
    _call("dss_feat_bwd", _ptr(counts), _ptr(table), _ptr(grad), _ptr(out),
          v, _n_tiles_x(n_tiles), tile_size, m, points_per_pixel, dmt,
          1.0 / image_size, n_points)
    feat_bwd.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4: segment sum (per-slot values → per-point sums)
# ---------------------------------------------------------------------------


def segment_sum_plain(vals, seg, num_segments: int):
    """Plain version of K4.  vals (V, C, N) channel-major, seg (V, N) int;
    the ids outside [0, num_segments) (−1 for an empty slot) are dropped.
    Returns (V, num_segments, C)."""
    v, c, n = vals.shape
    seg = seg.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((v, num_segments + 1, c), device=vals.device)
    out.scatter_add_(1, seg[..., None].expand(v, n, c), vals.transpose(1, 2))
    return out[:, :num_segments]


def segment_sum(vals, seg, num_segments: int):
    """K4: see segment_sum_plain for the contract.  On the card C is 1–4
    and N a multiple of 4, both tensors 16-byte aligned."""
    if _on_cpu(vals):
        return segment_sum_plain(vals, seg, num_segments)
    v, c, n = vals.shape
    _check("vals", vals, torch.float32, 3, vals.device)
    _check("seg", seg, torch.int32, 2, vals.device)
    if (seg.shape != (v, n) or not 0 < c <= 4 or n % 4
            or vals.data_ptr() % 16 or seg.data_ptr() % 16):
        raise ValueError("segment_sum: seg must be (V, N), 1 ≤ C ≤ 4, N a "
                         "multiple of 4, and both 16-byte aligned")
    out = torch.zeros((v, num_segments, c), device=vals.device)
    _call("dss_segment_sum", _ptr(vals), _ptr(seg), _ptr(out), v, c, n,
          num_segments)
    segment_sum.launches += 1
    return out


# ---------------------------------------------------------------------------
# K5: full-fragment forward
# ---------------------------------------------------------------------------


def fwd_frag_plain(counts, table, dmt: float, image_size: int,
                   tile_size: int, points_per_pixel: int):
    """Plain version of K5.  counts (V, nt) int32, table (V, nt, 14, M).

    K1's accept test and rank, plus K-slot fragment buffers: slot r holds
    the z, the Q and the global id of the pixel's rank-r accept, whatever
    the window says.  The window's z₀ is the rank-0 fragment's z (the
    first accept in table order, as the JAX kernel's `fz[0] + dz[0]`), not
    K1's chunk minimum, so `_window_weights` does not apply.  Returns z, q
    (V, nt, K, tt) float32 and ids (V, nt, K, tt) int32, −1 where empty;
    cnt (V, nt, tt) accepted count; vis (V, nt, M) "won a fragment
    anywhere"; rgbw (V, nt, 4, tt) = Σw·[r, g, b, 1] over the winners."""
    v, n_tiles, _, m = table.shape
    ntx = _n_tiles_x(n_tiles)
    tt = tile_size * tile_size
    k = points_per_pixel
    dev = table.device
    xf, yf = _pixel_centres(ntx, tile_size, image_size, dev)
    xf, yf = xf[..., None], yf[..., None]
    z_out = torch.empty((v, n_tiles, k, tt), device=dev)
    q_out = torch.empty((v, n_tiles, k, tt), device=dev)
    id_out = torch.empty((v, n_tiles, k, tt), dtype=torch.int32, device=dev)
    cnt_out = torch.zeros((v, n_tiles, tt), device=dev)
    vis_out = torch.zeros((v, n_tiles, m), device=dev)
    rgb_out = torch.zeros((v, n_tiles, 4, tt), device=dev)
    for vi in range(v):
        cnt = torch.zeros((n_tiles, tt), device=dev)
        # slot sums over the chunks: exactly one accept lands in each slot
        fz = torch.zeros((n_tiles, k, tt), device=dev)
        fq = torch.zeros((n_tiles, k, tt), device=dev)
        fpos = torch.zeros((n_tiles, k, tt), device=dev)  # id + 1, 0 = empty
        frgb = torch.zeros((n_tiles, tt, 4), device=dev)
        for i in range(_n_chunks(counts[vi], m)):
            d = table[vi, :, :, i * CHUNK:(i + 1) * CHUNK]
            q, accept = _chunk_accept(d, xf, yf)
            accf = accept.to(torch.float32)
            slot = cnt[..., None] + torch.cumsum(accf, dim=-1) - accf
            zrow = torch.where(accept, d[:, CH_PZ, None, :], 0.0)
            qrow = torch.where(accept, q, 0.0)
            idp1 = d[:, CH_ID, None, :] + 1.0
            for r in range(k):
                mine = accept & (slot == float(r))
                fz[:, r] += torch.where(mine, zrow, 0.0).sum(dim=-1)
                fq[:, r] += torch.where(mine, qrow, 0.0).sum(dim=-1)
                fpos[:, r] += torch.where(mine, idp1, 0.0).sum(dim=-1)
            # rank 0's z is final once the chunk holding it has landed
            in_window = (zrow - fz[:, 0, :, None]) <= dmt
            wins = accept & (slot < float(k)) & in_window
            w = torch.exp(-0.5 * qrow) * d[:, CH_SC, None, :] * wins
            cols = torch.stack([d[:, CH_R], d[:, CH_G], d[:, CH_B2],
                                torch.ones_like(d[:, CH_R])], dim=-1)
            frgb = frgb + w @ cols  # (nt, tt, 4)
            cnt = cnt + accf.sum(dim=-1)
            vis_out[vi, :, i * CHUNK:(i + 1) * CHUNK] = (
                wins.any(dim=1).to(torch.float32))
        filled = fpos > 0.0
        z_out[vi] = torch.where(filled, fz, -1.0)
        q_out[vi] = torch.where(filled, fq, -1.0)
        id_out[vi] = (fpos - 1.0).to(torch.int32)
        cnt_out[vi] = cnt
        rgb_out[vi] = frgb.transpose(1, 2)
    return z_out, q_out, id_out, cnt_out, vis_out, rgb_out


def fwd_frag_points_plain(counts, table, n_points: int, dmt: float,
                          image_size: int, tile_size: int,
                          points_per_pixel: int):
    """Plain version of K5 with its fused scatter: fwd_frag_plain with its
    per-candidate flags summed into points over the table's id channel and
    tested > 0.  Returns z, q, ids, cnt, vis (V, P) float32 1/0, rgbw."""
    *frags, vis, rgbw = fwd_frag_plain(counts, table, dmt, image_size,
                                       tile_size, points_per_pixel)
    seg = _live_ids(counts, table[:, :, CH_ID])
    return (*frags, _visible_points(vis, seg, n_points), rgbw)


def fwd_frag(counts, table, n_points: int, dmt: float, image_size: int,
             tile_size: int, points_per_pixel: int):
    """K5: see fwd_frag_points_plain for the contract."""
    if _on_cpu(table):
        return fwd_frag_points_plain(counts, table, n_points, dmt, image_size,
                                     tile_size, points_per_pixel)
    v, n_tiles, c, m = table.shape
    k = points_per_pixel
    _check("table", table, torch.float32, 4, table.device)
    _check("counts", counts, torch.int32, 2, table.device)
    _check_points(n_points)
    if (c != N_CHANNELS or m % CHUNK or tile_size % 16
            or counts.shape != (v, n_tiles) or not 0 < k <= FRAG_K_MAX):
        raise ValueError(f"fwd_frag: table must be (V, nt, 14, M·128), the "
                         f"tile a multiple of 16 and 0 < K ≤ {FRAG_K_MAX}")
    tt = tile_size * tile_size
    dev = table.device
    z = torch.empty((v, n_tiles, k, tt), device=dev)
    q = torch.empty((v, n_tiles, k, tt), device=dev)
    ids = torch.empty((v, n_tiles, k, tt), dtype=torch.int32, device=dev)
    cnt = torch.empty((v, n_tiles, tt), device=dev)
    vis = torch.zeros((v, n_points), device=dev)
    rgbw = torch.empty((v, n_tiles, 4, tt), device=dev)
    _call("dss_fwd_frag", _ptr(counts), _ptr(table), _ptr(z), _ptr(q),
          _ptr(ids), _ptr(cnt), _ptr(vis), _ptr(rgbw), v, _n_tiles_x(n_tiles),
          tile_size, m, k, dmt, 1.0 / image_size, n_points)
    fwd_frag.launches += 1
    return z, q, ids, cnt, vis, rgbw


# ---------------------------------------------------------------------------
# symeig3: batched symmetric 3×3 eigensolver
# ---------------------------------------------------------------------------

# Cyclic Jacobi sweeps: 3–4 converge in float32 for well-separated
# eigenvalues, clusters near 1 ± 1e-6 take up to 6.
SYMEIG3_SWEEPS = 8
# Above |τ| = 2⁶⁰ the rotation takes t = 1/2τ, before τ² overflows.
_HUGE_TAU = 2.0 ** 60
# (p, q, r) of each rotation, in cyclic row order; r is the third index.
_ROTATIONS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))


def symeig3_plain(mats):
    """Plain version of symeig3: mats (N, 3, 3), symmetric, of which only
    the lower triangle is read → eigenvalues w (N, 3) ascending and
    eigenvectors v (N, 3, 3) as columns, `jnp.linalg.eigh`'s contract.
    A zero matrix gives w = 0 and v = I; a matrix with a NaN or an infinite
    entry gives NaN in all of its w and v.

    Cyclic Jacobi (csrc/symeig3.cu says why), vectorised over N: every
    matrix takes SYMEIG3_SWEEPS sweeps, a skipped rotation is a
    `torch.where`, and nothing is read on the host.  Each operation is one
    rounded torch op in the kernel's order, so the two agree bit for bit
    in float32; other dtypes compute in their own precision."""
    d = [mats[:, 0, 0], mats[:, 1, 1], mats[:, 2, 2]]
    o = [mats[:, 2, 1], mats[:, 2, 0], mats[:, 1, 0]]  # pair without i
    one, zero = torch.ones_like(d[0]), torch.zeros_like(d[0])
    v = [[one if k == j else zero for j in range(3)] for k in range(3)]
    finite = torch.isfinite(torch.stack(d + o, dim=-1)).all(dim=-1)
    for _ in range(SYMEIG3_SWEEPS):
        for p, q, r in _ROTATIONS:
            apq, app, aqq = o[r], d[p], d[q]
            g = 100.0 * apq.abs()
            skip = (apq == 0.0) | (((app.abs() + g) == app.abs())
                                   & ((aqq.abs() + g) == aqq.abs()))
            tau = (aqq - app) / (apq + apq)
            at = tau.abs()
            tabs = torch.where(
                at > _HUGE_TAU, torch.reciprocal(at) * 0.5,
                torch.reciprocal(at + torch.sqrt(at * at + 1.0)))
            t = torch.where(tau >= 0.0, tabs, -tabs)
            c = torch.reciprocal(torch.sqrt(t * t + 1.0))
            s = t * c
            tapq = t * apq
            d[p] = torch.where(skip, app, app - tapq)
            d[q] = torch.where(skip, aqq, aqq + tapq)
            o[r] = torch.where(skip, apq, 0.0)
            arp, arq = o[q], o[p]
            o[q] = torch.where(skip, arp, c * arp - s * arq)
            o[p] = torch.where(skip, arq, s * arp + c * arq)
            for k in range(3):
                vkp, vkq = v[k][p], v[k][q]
                v[k][p] = torch.where(skip, vkp, c * vkp - s * vkq)
                v[k][q] = torch.where(skip, vkq, s * vkp + c * vkq)
    for i, j in ((0, 1), (1, 2), (0, 1)):  # stable: no swap at ties or NaN
        swap = d[j] < d[i]
        d[i], d[j] = (torch.where(swap, d[j], d[i]),
                      torch.where(swap, d[i], d[j]))
        for k in range(3):
            v[k][i], v[k][j] = (torch.where(swap, v[k][j], v[k][i]),
                                torch.where(swap, v[k][i], v[k][j]))
    w = torch.stack(d, dim=-1)
    vecs = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    nan = float("nan")
    return (torch.where(finite[:, None], w, nan),
            torch.where(finite[:, None, None], vecs, nan))


def symeig3(mats):
    """The eigensolver kernel: see symeig3_plain for the contract.  On the
    card mats is a contiguous (N, 3, 3) float32 tensor, N < 2³¹."""
    if _on_cpu(mats):
        return symeig3_plain(mats)
    _check("mats", mats, torch.float32, 3, mats.device)
    n = mats.shape[0]
    if mats.shape[1:] != (3, 3) or n >= 2 ** 31:
        raise ValueError(f"symeig3: mats must be (N, 3, 3) with N < 2³¹, "
                         f"got {tuple(mats.shape)}")
    w = torch.empty((n, 3), device=mats.device)
    v = torch.empty((n, 3, 3), device=mats.device)
    if n:
        _call("dss_symeig3", _ptr(mats), _ptr(w), _ptr(v), n)
        symeig3.launches += 1
    return w, v


# ---------------------------------------------------------------------------
# knn_topk: the exact kNN's distances, masks and selection
# ---------------------------------------------------------------------------

# Largest min(k, P) the kernel keeps: four slots per lane of a warp-wide
# list.
KNN_K_MAX = 128


def knn_topk_plain(query, ref, query_mask=None, ref_mask=None, k: int = 8,
                   exclude_self: bool = False, query_chunk: int = 4096):
    """Plain version of knn_topk, the masked brute force chunked over
    queries: the distance matrix is one float32 matmul per chunk (TF32 is
    off, see the package __init__) and the selection is `torch.topk`.

    query (Q, 3), ref (P, 3); invalid refs are never matched; exclude_self
    drops the self match (ref is query).  Returns (sq_dists (Q, k), idx
    (Q, k) int64), ascending; invalid slots inf / -1."""
    qn, pn = query.shape[0], ref.shape[0]
    dev = query.device
    if query_mask is None:
        query_mask = torch.ones((qn,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((pn,), dtype=torch.bool, device=dev)
    k_eff = min(k + (1 if exclude_self else 0), pn)
    ref_ids = torch.arange(pn, device=dev)

    dists_out, idx_out = [], []
    for s in range(0, qn, query_chunk):
        q = query[s:s + query_chunk]
        qmask = query_mask[s:s + query_chunk]
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        rr = torch.sum(ref * ref, dim=-1)[None, :]
        d = torch.clamp(qq + rr - 2.0 * (q @ ref.T), min=0.0)
        d = torch.where(ref_mask[None, :], d, float("inf"))
        if exclude_self:
            qidx = torch.arange(s, s + q.shape[0], device=dev)
            d = torch.where(qidx[:, None] == ref_ids[None, :], float("inf"), d)
        neg_top, idx = torch.topk(-d, k_eff, dim=1)
        dists = -neg_top
        idx = torch.where(torch.isinf(dists), -1, idx)
        if k_eff < k:
            pad = k - k_eff
            dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
            idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        else:
            dists, idx = dists[:, :k], idx[:, :k]
        dists_out.append(torch.where(qmask[:, None], dists, float("inf")))
        idx_out.append(torch.where(qmask[:, None], idx, -1))
    return torch.cat(dists_out), torch.cat(idx_out)


def _mask_ptr(mask, n: int, name: str, device) -> int:
    if mask is None:
        return 0
    _check(name, mask, torch.bool, 1, device)
    if mask.shape[0] != n:
        raise ValueError(f"knn_topk: {name} has {mask.shape[0]} rows, "
                         f"expected {n}")
    return _ptr(mask)


def knn_topk_grads(query, ref, dists, idx, grad):
    """The gradient of the kNN's distances (Q, k) with respect to query and
    ref, from the k selected pairs alone: the expansion's ∂d/∂q = 2q − 2r
    and ∂d/∂r = 2r − 2q, zero where the slot is empty, inf or clamped to
    0.  Plain torch on (Q, k) gathers; the kernel's backward."""
    ok = (idx >= 0) & torch.isfinite(dists) & (dists > 0.0)
    g = torch.where(ok, grad, 0.0)
    safe = torch.clamp(idx, min=0)
    w = (2.0 * g)[..., None] * (query[:, None, :] - ref[safe])  # (Q, k, 3)
    gr = torch.zeros_like(ref).index_add_(0, safe.reshape(-1),
                                          -w.reshape(-1, 3))
    return torch.sum(w, dim=1), gr


class _KnnTopk(torch.autograd.Function):
    """The kernel's forward; its backward is knn_topk_grads."""

    @staticmethod
    def forward(ctx, query, ref, query_mask, ref_mask, k, exclude_self):
        q = query.contiguous()
        r = ref.contiguous()
        dev = q.device
        _check("query", q, torch.float32, 2, dev)
        _check("ref", r, torch.float32, 2, dev)
        qn, pn = q.shape[0], r.shape[0]
        if q.shape[1] != 3 or r.shape[1] != 3:
            raise ValueError(f"knn_topk: query and ref must be (N, 3), got "
                             f"{tuple(q.shape)} and {tuple(r.shape)}")
        if min(k, pn) > KNN_K_MAX or max(qn, pn) >= 2 ** 31:
            raise ValueError(f"knn_topk: min(k, P) = {min(k, pn)} above "
                             f"{KNN_K_MAX}, or more than 2³¹ points")
        # the plain version's expressions, so that the sums are its bits
        qq = torch.sum(q * q, dim=-1)
        rr = qq if ref is query else torch.sum(r * r, dim=-1)
        dists = torch.empty((qn, k), device=dev)
        idx = torch.empty((qn, k), dtype=torch.int64, device=dev)
        qm = _mask_ptr(query_mask, qn, "query_mask", dev)
        rm = _mask_ptr(ref_mask, pn, "ref_mask", dev)
        if qn and k:
            _call("dss_knn_topk", _ptr(q), _ptr(qq), qm, _ptr(r), _ptr(rr), rm,
                  _ptr(dists), _ptr(idx), qn, pn, k, int(exclude_self))
            knn_topk.launches += 1
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(q, r, dists, idx)
        return dists, idx

    @staticmethod
    def backward(ctx, grad_d, grad_idx):
        gq, gr = knn_topk_grads(*ctx.saved_tensors, grad_d)
        return (gq if ctx.needs_input_grad[0] else None,
                gr if ctx.needs_input_grad[1] else None,
                None, None, None, None)


def knn_topk(query, ref, query_mask=None, ref_mask=None, k: int = 8,
             exclude_self: bool = False, query_chunk: int = 4096):
    """The exact kNN kernel: see knn_topk_plain for the contract.  CPU
    tensors take the plain version.  On the card query and ref are float32
    (N, 3), the masks bool or None, min(k, P) ≤ KNN_K_MAX; the distances
    equal the plain version's bit for bit and ties go to the lower index
    (`query_chunk` is the plain version's alone).  Differentiable in query
    and ref (_KnnTopk)."""
    if _on_cpu(query):
        return knn_topk_plain(query, ref, query_mask, ref_mask, k,
                              exclude_self, query_chunk)
    return _KnnTopk.apply(query, ref, query_mask, ref_mask, k, exclude_self)


# ---------------------------------------------------------------------------
# span_mark: the trace's device timestamp (utils/spans.py)
# ---------------------------------------------------------------------------

SPAN_BEGIN = 1  # csrc/span_mark.cu BEGIN: the mark opens a new step
SPAN_END = 2  # END: the mark completes the step and names its layout


def span_mark_plain(ring, count, col: int, flags: int, layout: int) -> None:
    """span_mark.cu's arithmetic on CPU tensors, with the host's
    time.perf_counter_ns() for the device's %globaltimer: ring (steps,
    cols) int64, count (1,) int64, both updated in place."""
    t = time.perf_counter_ns()
    n = int(count[0])
    if flags & SPAN_BEGIN:
        n += 1
        count[0] = n
    if n <= 0:
        return
    row = ring[(n - 1) % ring.shape[0]]
    if flags & SPAN_BEGIN:
        row[0] = -1
    row[1 + col] = t
    if flags & SPAN_END:
        row[0] = layout


def span_mark(ring, count, col: int, flags: int, layout: int) -> None:
    """One timestamp into the ring, in stream order: the kernel on the
    current stream for CUDA tensors (captured into a CUDA graph like any
    launch), span_mark_plain for CPU tensors.  utils/spans.py allocates
    and checks the ring; the launch is not counted (it is not a kernel of
    the model)."""
    if _on_cpu(ring):
        span_mark_plain(ring, count, col, flags, layout)
        return
    _call("dss_span_mark", _ptr(ring), _ptr(count), ring.shape[0],
          ring.shape[1], col, flags, layout)


# ---------------------------------------------------------------------------
# all_finite, guarded_adam: the train window's guard and update
# ---------------------------------------------------------------------------

# Elements per block of both kernels, tensors per launch of the update and
# of the guard, and milestones per tensor (csrc/guarded_adam.cu: CHUNK,
# MAX_TENSORS, MAX_FINITE, MAX_MILESTONES; a launch's tensors ride its
# arguments, under a kernel's 4 KB).
MT_CHUNK = 1024
ADAM_MAX_TENSORS = 32
FINITE_MAX_TENSORS = 128
ADAM_MAX_MILESTONES = 8


class AdamHyper(NamedTuple):
    """One parameter group's Adam as `trainer.guarded_adam_plain` runs it:
    the betas, eps, and the lr base·gamma per milestone ≤ the count."""

    b1: float
    b2: float
    eps: float
    base_lr: float
    gamma: float
    milestones: Tuple[int, ...] = ()


def chunk_launches(sizes, max_tensors: int):
    """The launches of a multi-tensor kernel over tensors of `sizes`
    elements: a list of launches, each a list of (tensor index, first
    block, blocks).  The tensors go in order, at most `max_tensors` to a
    launch; tensor i takes max(1, ⌈n / MT_CHUNK⌉) consecutive blocks of
    its launch (an empty tensor one, which still counts its update), and
    its k-th block the elements [k·MT_CHUNK, min((k + 1)·MT_CHUNK, n))."""
    launches = []
    for lo in range(0, len(sizes), max_tensors):
        launch, block = [], 0
        for i in range(lo, min(lo + max_tensors, len(sizes))):
            n_blocks = max(1, -(-int(sizes[i]) // MT_CHUNK))
            launch.append((i, block, n_blocks))
            block += n_blocks
        launches.append(launch)
    return launches


class _AdamEntry(ctypes.Structure):
    """csrc/guarded_adam.cu AdamEntry, field for field."""

    _fields_ = [("p", _VP), ("g", _VP), ("m", _VP), ("v", _VP),
                ("count", _VP), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong),
                ("b1", ctypes.c_double), ("b2", ctypes.c_double),
                ("eps", ctypes.c_double), ("base_lr", ctypes.c_double),
                ("gamma", ctypes.c_double),
                ("n_milestones", ctypes.c_longlong),
                ("milestones", ctypes.c_double * ADAM_MAX_MILESTONES)]


class _FiniteEntry(ctypes.Structure):
    """csrc/guarded_adam.cu FiniteEntry."""

    _fields_ = [("x", _VP), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong)]


def _float32_operand(name, t, device):
    """t as the multi-tensor kernels read it: float32 on `device`, copied
    contiguous where it is not."""
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def all_finite_plain(tensors):
    """Plain version of all_finite: a 0-d bool, every element of every
    tensor finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def all_finite(tensors):
    """The guard kernel: see all_finite_plain for the contract; the result
    stays on the device.  On the card the tensors are float32 on one
    device (copied contiguous where they are not): the flag is filled with
    true, then one launch per FINITE_MAX_TENSORS tensors clears it where
    an element is NaN or infinite."""
    if _on_cpu(tensors[0]):
        return all_finite_plain(tensors)
    dev = tensors[0].device
    xs = [_float32_operand("all_finite", t, dev) for t in tensors]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for launch in chunk_launches([x.numel() for x in xs], FINITE_MAX_TENSORS):
        entries = (_FiniteEntry * len(launch))(*[
            _FiniteEntry(_ptr(xs[i]), xs[i].numel(), first)
            for i, first, _ in launch])
        _call("dss_all_finite", entries, len(launch),
              launch[-1][1] + launch[-1][2], _ptr(finite))
        all_finite.launches += 1
    return finite


def guarded_adam(params, grads, exp_avgs, exp_avg_sqs, counts, hypers,
                 finite, tickets):
    """The update kernel: where the 0-d bool `finite` holds, one Adam step
    on each tensor i (params[i] with grads[i], its moments exp_avgs[i] and
    exp_avg_sqs[i], its 0-d float32 applied-update count counts[i] and its
    group's AdamHyper hypers[i]), all updated in place; where it does not,
    nothing is written.  Equal bit for bit to
    training/trainer.py:guarded_adam_plain on the same state (its
    docstring has the arithmetic), whose composite is the plain version:
    this wrapper takes CUDA tensors only.

    params and the moments are contiguous float32 of one shape per
    tensor; grads float32 (copied contiguous where they are not); at most
    ADAM_MAX_MILESTONES milestones a group.  `tickets` is an int32 vector
    of at least ADAM_MAX_TENSORS zeros, which every launch leaves zero:
    one set per optimizer, never shared by two updates at once.  One
    launch per ADAM_MAX_TENSORS tensors."""
    dev = finite.device
    if dev.type == "cpu":
        raise ValueError("guarded_adam takes CUDA tensors: on the CPU "
                         "training.trainer.guarded_adam_plain is the update")
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(counts)
            == len(hypers) == n):
        raise ValueError("guarded_adam: one grad, moment pair, count and "
                         "hyper-parameter set per parameter")
    _check("finite", finite, torch.bool, 0, dev)
    _check("tickets", tickets, torch.int32, 1, dev)
    if tickets.numel() < min(n, ADAM_MAX_TENSORS):
        raise ValueError(f"guarded_adam: {tickets.numel()} tickets, needs "
                         f"{min(n, ADAM_MAX_TENSORS)}")
    gs = []
    for p, g, m, v, c, h in zip(params, grads, exp_avgs, exp_avg_sqs, counts,
                                hypers):
        for name, t in (("param", p), ("exp_avg", m), ("exp_avg_sq", v)):
            _check(name, t, torch.float32, p.ndim, dev)
        _check("count", c, torch.float32, 0, dev)
        gs.append(_float32_operand("grad", g, dev))
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"guarded_adam: param {tuple(p.shape)}, grad "
                             f"{tuple(g.shape)}, moments {tuple(m.shape)} "
                             f"{tuple(v.shape)}")
        if len(set(h.milestones)) > ADAM_MAX_MILESTONES:
            raise ValueError(f"guarded_adam: {len(set(h.milestones))} "
                             f"milestones, at most {ADAM_MAX_MILESTONES}")
    for launch in chunk_launches([p.numel() for p in params],
                                 ADAM_MAX_TENSORS):
        entries = (_AdamEntry * len(launch))()
        for e, (i, first, _) in zip(entries, launch):
            h = hypers[i]
            ms = sorted(set(h.milestones))
            e.p, e.g, e.m, e.v, e.count = (
                _ptr(params[i]), _ptr(gs[i]), _ptr(exp_avgs[i]),
                _ptr(exp_avg_sqs[i]), _ptr(counts[i]))
            e.n, e.first_block = params[i].numel(), first
            e.b1, e.b2, e.eps, e.base_lr, e.gamma = (
                h.b1, h.b2, h.eps, h.base_lr, h.gamma)
            e.n_milestones = len(ms)
            e.milestones[:len(ms)] = [float(m) for m in ms]
        _call("dss_guarded_adam", entries, len(launch),
              launch[-1][1] + launch[-1][2], _ptr(finite), _ptr(tickets))
        guarded_adam.launches += 1


# ---------------------------------------------------------------------------
# prep_fwd, prep_bwd: the render's per-(view, point) set-up
# ---------------------------------------------------------------------------

# Lights a view's record in shared memory holds (csrc/prep_splats.cu
# MAX_LIGHTS: the backward stages 8 views' records).
PREP_MAX_LIGHTS = 64
# csrc/prep_splats.cu SHADE_NONE, SHADE_COPY (render/prep.py SHADE_*)
_SHADE_COPY, _SHADE_NONE = 0, 3


def _prep_operand(name, t, shape, device):
    """t as a contiguous float32 tensor of `shape` on `device`."""
    if t.dtype != torch.float32 or t.device != device or t.shape != shape:
        raise ValueError(f"prep: {name} must be float32 {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _prep_constants(views, lights, device):
    """The views' (proj, R, T, znear, zfar) and the lights' (ambient,
    diffuse, specular, where) as the kernels read them (contiguous float32,
    each a view's rows), with the light count L and the ambient's La."""
    v = views.R.shape[0]
    shapes = ((v, 4, 4), (v, 3, 3), (v, 3), (v,), (v,))
    vw = [_prep_operand(name, t, shape, device)
          for name, t, shape in zip(views._fields, views, shapes)]
    if v > 65535:
        raise ValueError(f"prep: {v} views, at most 65535 in one call")
    if lights is None:
        return vw, [None] * 4, 0, 0
    n_lights, n_amb = lights.where.shape[1], lights.ambient.shape[1]
    if n_lights > PREP_MAX_LIGHTS:
        raise ValueError(f"prep: {n_lights} lights a view, at most "
                         f"{PREP_MAX_LIGHTS}")
    lt = [_prep_operand(name, t, (v, n_amb if name == "ambient" else n_lights,
                                  3), device)
          for name, t in zip(lights._fields, lights)]
    return vw, lt, n_lights, n_amb


def _ptr_or_0(t) -> int:
    return 0 if t is None else _ptr(t)


def prep_fwd(points, normals, colors, mask, views, lights, args):
    """The set-up's forward kernel: render/prep.py:prep_composite is its
    plain version and contract, bit for bit on the card (views a
    PrepViews, lights a PrepLights or None, args a PrepArgs).  CUDA
    tensors only: points, normals and colors float32 (P, 3), mask bool
    (P,), h float32 with 1 or P entries, vrk (P, 3, 3) and sk (P, 2, 3)
    float32 of any strides."""
    dev = points.device
    if dev.type == "cpu":
        raise ValueError("prep_fwd takes CUDA tensors: on the CPU "
                         "render.prep.prep_composite is the forward")
    p = points.shape[0]
    _check_points(p)
    pts, nrm, col = (_prep_operand(name, t, (p, 3), dev) for name, t in
                     (("points", points), ("normals", normals),
                      ("colors", colors)))
    if mask.dtype != torch.bool or mask.shape != (p,) or mask.device != dev:
        raise ValueError(f"prep: mask must be bool ({p},) on {dev}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    mask = mask.contiguous()
    vw, lt, n_lights, n_amb = _prep_constants(views, lights, dev)
    v = vw[1].shape[0]
    frame = [0, 0, 0]
    strides = [0] * 7
    if args.h is not None:
        h = args.h
        if h.dtype != torch.float32 or h.device != dev or h.ndim != 1 \
                or h.shape[0] not in (1, p):
            raise ValueError(f"prep_fwd: h must be float32 (1,) or ({p},) "
                             f"on {dev}, got {h.dtype} {tuple(h.shape)}")
        h = h.contiguous()
        frame[0], strides[0] = _ptr(h), 0 if h.shape[0] == 1 else 1
    else:
        h = None
        for i, (name, t, shape) in enumerate((("vrk", args.vrk, (p, 3, 3)),
                                               ("sk", args.sk, (p, 2, 3)))):
            if t.dtype != torch.float32 or t.device != dev or t.shape != shape:
                raise ValueError(f"prep: {name} must be float32 {shape} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)}")
            frame[1 + i] = _ptr(t)
            strides[1 + 3 * i:4 + 3 * i] = t.stride()
    shaded = (None if args.shade == _SHADE_NONE
              else torch.empty((v, p, 3), device=dev))
    screen = torch.empty((v, p, 3), device=dev)
    ell = torch.empty((v, p, 3), device=dev)
    cut = torch.empty((v, p), device=dev)
    rad = torch.empty((v, p, 2), device=dev)
    scl = torch.empty((v, p), device=dev)
    rmask = torch.empty((v, p), dtype=torch.bool, device=dev)
    if v:
        _call("dss_prep_fwd", _ptr(pts), _ptr(nrm), _ptr(col), _ptr(mask),
              *(_ptr(t) for t in vw), *(_ptr_or_0(t) for t in lt), *frame,
              *strides, _ptr_or_0(shaded), _ptr(screen), _ptr(ell), _ptr(cut),
              _ptr(rad), _ptr(scl), _ptr(rmask), v, p, n_lights, n_amb,
              args.shade, int(args.backface), args.lam, args.lam_sq, args.cutoff,
              args.shininess)
        prep_fwd.launches += 1
    return shaded, screen, ell, cut, rad, scl, rmask


def prep_bwd(points, normals, colors, views, lights, args, g_shaded,
             g_screen, needs=(True, True, True)):
    """The set-up's backward kernel: render/prep.py:prep_bwd_plain is its
    plain version and contract.  CUDA tensors only; the cotangents float32
    (V, P, 3) or None (zero)."""
    dev = points.device
    if dev.type == "cpu":
        raise ValueError("prep_bwd takes CUDA tensors: on the CPU "
                         "render.prep.prep_bwd_plain is the backward")
    p = points.shape[0]
    _check_points(p)
    pts, nrm, col = (_prep_operand(name, t, (p, 3), dev) for name, t in
                     (("points", points), ("normals", normals),
                      ("colors", colors)))
    vw, lt, n_lights, n_amb = _prep_constants(views, lights, dev)
    v = vw[1].shape[0]
    g_sh, g_scr = (None if g is None else _prep_operand(name, g, (v, p, 3),
                                                        dev)
                   for name, g in (("g_shaded", g_shaded),
                                   ("g_screen", g_screen)))
    shading = g_sh is not None and args.shade != _SHADE_NONE
    d_p = torch.empty((p, 3), device=dev) if needs[0] else None
    d_n = (torch.empty((p, 3), device=dev)
           if needs[1] and shading and args.shade != _SHADE_COPY else None)
    d_c = torch.empty((p, 3), device=dev) if needs[2] and shading else None
    if d_p is not None or d_n is not None or d_c is not None:
        _call("dss_prep_bwd", _ptr(pts), _ptr(nrm), _ptr(col),
              *(_ptr(t) for t in vw), *(_ptr_or_0(t) for t in lt),
              _ptr_or_0(g_sh), _ptr_or_0(g_scr), _ptr_or_0(d_p),
              _ptr_or_0(d_n), _ptr_or_0(d_c), v, p, n_lights, n_amb,
              args.shade, args.shininess, args.clip)
        prep_bwd.launches += 1
    return d_p, d_n, d_c


# ---------------------------------------------------------------------------
# bin_tiles, median_select: the tile binning and the support radius's median
# ---------------------------------------------------------------------------

# Bytes of a tile's candidate keys that csrc/bin_tiles.cu sorts in shared
# memory (SORT_SMEM_BYTES): 4096 keys of (quantized depth, point id) or
# 8192 point ids.  A longer segment takes the device-memory path.
BIN_SMEM_BYTES = 32768
BIN_LAUNCHES = 4  # kernels per table: count, scan, scatter, tiles
_BIN_STATS = 3  # ints per view after the counts (csrc/bin_tiles.cu STATS)
_long_tiles = {}  # device → the persistent long-segment counter


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def bin_long_tiles(device) -> torch.Tensor:
    """The device's (1,) int32 count of the tiles whose candidates took
    bin_tiles' device-memory path (a segment longer than BIN_SMEM_BYTES
    holds), summed by the kernels over every table since it was last
    zeroed; a graph replay adds to it like an eager call.  Made at the
    first call on a device, which must not be inside a capture (its fill
    would be captured)."""
    device = _cuda_device(device)
    buf = _long_tiles.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bin_long_tiles: the counter is made by the "
                               "first binning on a device, which must run "
                               "before a CUDA graph capture")
        buf = _long_tiles[device] = torch.zeros((1,), dtype=torch.int32,
                                                device=device)
    return buf


def read_bin_long_tiles(device) -> int:
    """The long-segment count since the last read (a host read), then
    zeroed; 0 on the CPU, whose binning has no such path."""
    if torch.device(device).type != "cuda":
        return 0
    buf = bin_long_tiles(device)
    n = int(buf[0])
    buf.zero_()
    return n


def _bin_operand(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device or t.shape != shape:
        raise ValueError(f"bin_tiles: {name} must be float32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def bin_tiles(pts, radii, image_size: int, tile_size: int, bin_capacity: int,
              max_tiles_x: int, max_tiles_y: int, pair_cap: int,
              sort_by_depth: bool = True, backward_channels: bool = False,
              extra_radius=0.0, ellipse=None, cutoff=None, scaler=None,
              features=None, visible=None, overflow_base=None):
    """The binning kernels (csrc/bin_tiles.cu): ops/splat.py's
    bin_splats_plain is the plain version and the contract, bit for bit,
    with pair_cap already resolved (splat._pair_cap).  CUDA tensors only:
    pts (V, P, 3), radii (V, P, 2), ellipse (V, P, 3), cutoff and scaler
    (V, P), features (V, P, 3) float32; extra_radius a float or (V,)
    float32; visible (V, P) bool or None — a point it masks off is binned
    as bin_for_occ_backward bins it (pz = −1, radii 0): never.  The forward
    channels need ellipse and cutoff unless backward_channels.

    Returns (tile_data (V, nt, C, M), tile_ids (V, nt, M), tile_counts
    (V, nt), overflow (V,), overflow_sum): overflow_sum is overflow_base
    (V,) int32 + overflow, or None without a base.  Adds the tables'
    long segments to bin_long_tiles(device)."""
    dev = pts.device
    if dev.type == "cpu":
        raise ValueError("bin_tiles takes CUDA tensors: on the CPU "
                         "ops.splat.bin_splats_plain is the binning")
    v, p = pts.shape[:2]
    _check_points(p)
    nt = image_size // tile_size
    n_tiles = nt * nt
    n_pairs = p * max_tiles_x * max_tiles_y
    if (nt < 1 or bin_capacity < 1 or min(max_tiles_x, max_tiles_y) < 1
            or n_pairs >= 2 ** 31 or v > 65535):
        raise ValueError(f"bin_tiles: {image_size}² at tile {tile_size}, "
                         f"capacity {bin_capacity}, {max_tiles_x}×"
                         f"{max_tiles_y} tiles a splat, {v} views: needs a "
                         f"tile, a slot, P·tiles < 2³¹ and at most 65535 views")
    pts = _bin_operand("pts", pts, (v, p, 3), dev)
    radii = _bin_operand("radii", radii, (v, p, 2), dev)
    opt = lambda name, t, shape: (None if t is None
                                  else _bin_operand(name, t, shape, dev))
    if not backward_channels and (ellipse is None or cutoff is None):
        raise ValueError("bin_tiles: the forward channels need ellipse and "
                         "cutoff")
    ellipse = None if backward_channels else opt("ellipse", ellipse, (v, p, 3))
    cutoff = None if backward_channels else opt("cutoff", cutoff, (v, p))
    scaler = None if backward_channels else opt("scaler", scaler, (v, p))
    features = (None if backward_channels
                else opt("features", features, (v, p, 3)))
    if visible is not None:
        _check("visible", visible, torch.bool, 2, dev)
    extra, extra_s = None, 0.0
    if isinstance(extra_radius, torch.Tensor):
        extra = _bin_operand("extra_radius", extra_radius.reshape(v),
                             (v,), dev)
    else:
        extra_s = float(extra_radius)
    if overflow_base is not None:
        _check("overflow_base", overflow_base, torch.int32, 1, dev)
    zq_bits = max(1, 30 - max(n_tiles - 1, 1).bit_length())
    c = N_BWD_CHANNELS if backward_channels else N_CHANNELS
    m = bin_capacity
    scratch = torch.zeros((v * (n_tiles + _BIN_STATS),), dtype=torch.int32,
                          device=dev)
    seg = torch.empty((v * (n_tiles + 1),), dtype=torch.int32, device=dev)
    zinfo = torch.empty((v * 2,), device=dev)
    keys = torch.empty((v * n_pairs,), device=dev,
                       dtype=torch.int64 if sort_by_depth else torch.int32)
    table = torch.empty((v, n_tiles, c, m), device=dev)
    ids = torch.empty((v, n_tiles, m), dtype=torch.int32, device=dev)
    counts = torch.empty((v, n_tiles), dtype=torch.int32, device=dev)
    overflow = torch.empty((v,), dtype=torch.int32, device=dev)
    total = (None if overflow_base is None
             else torch.empty((v,), dtype=torch.int32, device=dev))
    _call("dss_bin_tiles", _ptr(pts), _ptr(radii), _ptr_or_0(ellipse),
          _ptr_or_0(cutoff), _ptr_or_0(scaler), _ptr_or_0(features),
          _ptr_or_0(visible), _ptr_or_0(extra), extra_s, _ptr(scratch),
          _ptr(seg), _ptr(zinfo), _ptr(keys), _ptr(table), _ptr(ids),
          _ptr(counts), _ptr(overflow), _ptr_or_0(overflow_base),
          _ptr_or_0(total), _ptr(bin_long_tiles(dev)), v, p, image_size,
          tile_size, nt, max_tiles_x, max_tiles_y, m, pair_cap,
          int(sort_by_depth), int(backward_channels), zq_bits)
    bin_tiles.launches += BIN_LAUNCHES
    return table, ids, counts, overflow, total


def median_select(vals, mask, scale=None):
    """The masked median's kernel (csrc/bin_tiles.cu
    median_sort_select_kernel): ops/splat.py's masked_median_plain is the
    plain version and the contract, bit for bit but for a NaN's payload.
    CUDA tensors only: vals (V, N) float32, mask (V, N / g) bool, entry
    i // g masking value i (g = 1: masked_median's own (V, N) mask).
    Returns the median (V,); with `scale` (a float or a one-element
    float32 tensor) returns (median, r, r²) instead, r = median · scale
    and 0 where not finite (bin_for_occ_backward's support radius)."""
    dev = vals.device
    if dev.type == "cpu":
        raise ValueError("median_select takes CUDA tensors: on the CPU "
                         "ops.splat.masked_median_plain is the median")
    vals = vals.contiguous()
    mask = mask.contiguous()
    _check("vals", vals, torch.float32, 2, dev)
    _check("mask", mask, torch.bool, 2, dev)
    v, n = vals.shape
    nm = mask.shape[1]
    if mask.shape[0] != v or nm < 1 or n % nm or v > 65535 or n >= 2 ** 31:
        raise ValueError(f"median_select: vals {tuple(vals.shape)} and mask "
                         f"{tuple(mask.shape)}: the mask's row must divide "
                         f"the values' row")
    med = torch.empty((v,), device=dev)
    r = r2 = scale_t = None
    scale_s = 0.0
    if scale is not None:
        r = torch.empty((v,), device=dev)
        r2 = torch.empty((v,), device=dev)
        if isinstance(scale, torch.Tensor):
            if scale.numel() != 1:
                raise ValueError(f"median_select: scale has {scale.numel()} "
                                 f"entries, expected one")
            scale_t = _bin_operand("scale", scale.reshape(()), (), dev)
        else:
            scale_s = float(scale)
    if v:
        _call("dss_median_select", _ptr(vals), _ptr(mask), _ptr_or_0(scale_t),
              scale_s, _ptr(med), _ptr_or_0(r), _ptr_or_0(r2), v, n, n // nm)
        median_select.launches += 1
    return med if scale is None else (med, r, r2)


KERNELS = (fwd_lean, occ_bwd, feat_bwd, segment_sum, fwd_frag, symeig3,
           knn_topk, all_finite, guarded_adam, prep_fwd, prep_bwd, bin_tiles,
           median_select)
reset_launch_counts()
