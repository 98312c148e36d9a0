// K2 — occupancy backward to screen-space x/y.
//
// Replaces dss_tpu/ops/splat_pallas.py:_bwd_kernel (launched by
// occ_backward_views_from_binned).  For each candidate of a tile's support
// table it sums, over the tile's pixels, g·(dx, dy)/max(dx² + dy², 1e-10),
// where g is the pixel's occupancy gradient.  A pixel counts only if
// dist² ≤ cur_r², the point is on screen with pz ≥ 0, g ≠ 0, and not
// (g > 0 and the pixel lies outside the splat's box).  The candidates'
// sums go straight to their points (V, P, 2): K4's scatter
// (segment_sum_views_matmul) is fused into the epilogue.
//
// What bounds it on the H100: arithmetic on the (pixel, candidate) pairs
// inside the support disc clipped to the tile — 16 float operations each
// (two differences, two squares, the sum, four compares, the clamp, one
// IEEE division, two products and two sums); 4.1e7 pairs at the flagship
// tables, about 10 µs at 67 TFLOP/s.  The bytes (grad_occ once, the live
// candidates' five channels and ids, the per-point sums) take about 3 µs.
//
// Design: one warp per candidate, its lanes over the pixels of the disc's
// bounding box clipped to the tile (row-major, 32 pixels per step); the
// box is the disc's row and column range widened by one pixel, so every
// pixel that passes the exact dist² ≤ cur_r² test below lies in it, and
// the pixels of the tile outside it are never visited.  Each lane sums
// its pixels in registers and the warp reduces gx, gy with a fixed
// __shfl_xor_sync tree (in another order than the plain version's sum).
// Lane 0 then adds the two sums, where not exactly 0, into the candidate's
// point with atomicAdd, at the id the backward binning gave its slot
// (tile_ids; the support table has no id channel): j < the tile's count,
// so the slot is live and its id a point's.  The wrapper zero-fills the
// output; the points' sums come in an order that changes from run to run,
// as K4's atomics did.  A block holds WARPS warps
// and takes CPB candidates of one (view, tile) at a time; the BLOCKS_Y
// blocks of a (view, tile) stride over its candidate list, so a long list
// is spread over many SMs, and the blocks past the list's end return
// before touching anything.  grad_occ is read through L1 (it stays in
// L2); the tile's pixel centres are staged in shared memory.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;      // warps per block, one candidate each
constexpr int CPB = 16;       // candidates a block takes at a time
constexpr int BLOCKS_Y = 16;  // blocks per (view, tile)

// Local index range [lo, hi] of the pixels whose NDC centre
// 1 − (2·i + 1)/S lies within r of p, widened by one pixel and clipped to
// the tile [0, tile).  Rounding moves the ends by far less than a pixel.
__device__ __forceinline__ void disc_span(float p, float r, float s_img,
                                          int tile0, int tile, int& lo,
                                          int& hi) {
  if (!(r < 4.0f)) {  // the disc covers the screen (or r is NaN)
    lo = 0;
    hi = tile - 1;
    return;
  }
  const float a = ((1.0f - p - r) * s_img - 1.0f) * 0.5f;
  const float b = ((1.0f - p + r) * s_img - 1.0f) * 0.5f;
  lo = max((int)floorf(a) - 1 - tile0, 0);
  hi = min((int)ceilf(b) + 1 - tile0, tile - 1);
}

__global__ void __launch_bounds__(WARPS * 32)
occ_bwd_kernel(const int* __restrict__ counts,
               const float* __restrict__ table,
               const float* __restrict__ grad_occ,
               const float* __restrict__ cur_r2,
               const int* __restrict__ tile_ids, float* __restrict__ out,
               int n_tiles_x, int tile, int m, float inv_s, int n_points) {
  using namespace dss;
  const int vt = blockIdx.x;  // view · n_tiles + tile
  const int n_cand = min(counts[vt], m);
  if ((int)blockIdx.y * CPB >= n_cand) return;

  extern __shared__ float sh[];
  float* xcol = sh;           // [tile] NDC x of the tile's columns
  float* yrow = sh + tile;    // [tile] NDC y of the tile's rows
  const int n_tiles = n_tiles_x * n_tiles_x;
  const int v = vt / n_tiles, g = vt % n_tiles;
  const int ty = g / n_tiles_x, tx = g % n_tiles_x;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    xcol[i] = pixel_ndc(tx * tile + i, inv_s);
    yrow[i] = pixel_ndc(ty * tile + i, inv_s);
  }
  __syncthreads();

  const float r2 = cur_r2[v];
  const float rad = sqrtf(r2);
  const float s_img = (float)(n_tiles_x * tile);
  const float* tab = table + (size_t)vt * N_BWD_CHANNELS * m;
  const float* gpix = grad_occ + (size_t)vt * tile * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int base = (int)blockIdx.y * CPB; base < n_cand;
       base += (int)gridDim.y * CPB) {
    const int end = min(base + CPB, n_cand);
    for (int j = base + warp; j < end; j += WARPS) {
      const float px = tab[BPX * m + j], py = tab[BPY * m + j];
      const float pz = tab[BPZ * m + j];
      const float rx = tab[BRX * m + j], ry = tab[BRY * m + j];
      float gx = 0.f, gy = 0.f;
      int r0 = 0, r1 = -1, c0 = 0, c1 = -1;
      if (pz >= 0.0f && fabsf(px) <= 1.0f && fabsf(py) <= 1.0f) {
        disc_span(py, rad, s_img, ty * tile, tile, r0, r1);
        disc_span(px, rad, s_img, tx * tile, tile, c0, c1);
      }
      const int nc = c1 - c0 + 1;
      const int total = (r1 >= r0 && nc > 0) ? (r1 - r0 + 1) * nc : 0;
      if (total > 0) {
        // this lane's pixel (r0 + rr, c0 + cc), advanced 32 at a time
        int rr = lane / nc, cc = lane % nc;
        const int step_r = 32 / nc, step_c = 32 % nc;
        for (int i = lane; i < total; i += 32) {
          const int r = r0 + rr, c = c0 + cc;
          const float gp = __ldg(gpix + r * tile + c);
          const float dy = __fsub_rn(yrow[r], py);
          const float dx = __fsub_rn(xcol[c], px);
          const float dist2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const bool outside = fabsf(dy) > ry || fabsf(dx) > rx;
          if (dist2 <= r2 && gp != 0.0f && !(gp > 0.0f && outside)) {
            const float w = __fdiv_rn(gp, fmaxf(dist2, 1e-10f));
            gx = __fadd_rn(gx, __fmul_rn(w, dx));
            gy = __fadd_rn(gy, __fmul_rn(w, dy));
          }
          rr += step_r;
          cc += step_c;
          if (cc >= nc) {
            cc -= nc;
            ++rr;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        gx = __fadd_rn(gx, __shfl_xor_sync(0xffffffffu, gx, o));
        gy = __fadd_rn(gy, __shfl_xor_sync(0xffffffffu, gy, o));
      }
      if (lane == 0) {
        const int id = tile_ids[(size_t)vt * m + j];
        float* o = out + ((size_t)v * n_points + id) * 2;
        if (gx != 0.f) atomicAdd(o, gx);
        if (gy != 0.f) atomicAdd(o + 1, gy);
      }
    }
  }
}

}  // namespace

extern "C" int dss_occ_bwd(const int* counts, const float* table,
                           const float* grad_occ, const float* cur_r2,
                           const int* tile_ids, float* out, int n_views,
                           int n_tiles_x, int tile, int m, float inv_s,
                           int n_points, cudaStream_t stream) {
  const int per_tile = (m + CPB - 1) / CPB;
  const dim3 grid(n_views * n_tiles_x * n_tiles_x,
                  per_tile < BLOCKS_Y ? per_tile : BLOCKS_Y);
  if (grid.x == 0 || grid.y == 0) return 0;
  const size_t smem = (size_t)2 * tile * sizeof(float);
  occ_bwd_kernel<<<grid, WARPS * 32, smem, stream>>>(
      counts, table, grad_occ, cur_r2, tile_ids, out, n_tiles_x, tile, m,
      inv_s, n_points);
  return (int)cudaGetLastError();
}
