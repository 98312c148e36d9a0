"""The five splat kernels: CUDA wrappers, their plain PyTorch versions, the
on-demand build and the launch counters.

| kernel        | CUDA source           | replaces (dss_tpu/ops/splat_pallas.py) |
| ------------- | --------------------- | -------------------------------------- |
| `fwd_lean`    | csrc/fwd_lean.cu      | `_fwd_kernel_lean` (K1)                |
| `occ_bwd`     | csrc/occ_bwd.cu       | `_bwd_kernel` (K2)                     |
| `feat_bwd`    | csrc/feat_bwd.cu      | `_feat_bwd_kernel` (K3)                |
| `segment_sum` | csrc/segment_sum.cu   | `_segsum_matmul_kernel` (K4)           |
| `fwd_frag`    | csrc/fwd_frag.cu      | `_fwd_kernel` (K5)                     |

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
CUDA branch and raises.

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
from pathlib import Path

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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


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
    returns its path.  The compiler's register and shared-memory report is
    kept beside it as ptxas.log."""
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
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp,
           *[str(p) for p in sorted(_CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.remove(tmp)
        raise KernelCompileError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    (out_dir / "ptxas.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
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
    not (g > 0 and the pixel outside the splat box).  Returns gx, gy
    (V, nt, Mb)."""
    v, n_tiles, _, m = table5.shape
    ntx = _n_tiles_x(n_tiles)
    xf, yf = _pixel_centres(ntx, tile_size, image_size, table5.device)
    xf, yf = xf[..., None], yf[..., None]
    gx = torch.zeros((v, n_tiles, m), device=table5.device)
    gy = torch.zeros((v, n_tiles, m), device=table5.device)
    for vi in range(v):
        g = grad_occ[vi][..., None]  # (nt, tt, 1)
        for i in range(_n_chunks(counts[vi], m)):
            sl = slice(i * CHUNK, (i + 1) * CHUNK)
            d = table5[vi, :, :, sl]
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
            gx[vi, :, sl] = torch.sum(w * dx, dim=1)
            gy[vi, :, sl] = torch.sum(w * dy, dim=1)
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


KERNELS = (fwd_lean, occ_bwd, feat_bwd, segment_sum, fwd_frag)
reset_launch_counts()
