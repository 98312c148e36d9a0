// K2 — occupancy backward to screen-space x/y.
//
// Replaces dss_tpu/ops/splat_pallas.py:_bwd_kernel (launched by
// occ_backward_views_from_binned).  For each candidate of a tile's support
// table it sums, over the tile's pixels, g·(dx, dy)/max(dx² + dy², 1e-10),
// where g is the pixel's occupancy gradient.  A pixel counts only if
// dist² ≤ cur_r², the point is on screen with pz ≥ 0, g ≠ 0, and not
// (g > 0 and the pixel lies outside the splat's box).
//
// What bounds it on the H100: arithmetic — ~15 float operations and one
// division per (pixel, candidate) pair; the pixels' gradients are read
// from shared memory and each candidate's five channels once.
//
// Design: one block per (view, tile), one thread per candidate (strided
// when the tile holds more candidates than threads).  The tile's grad_occ
// values are staged in shared memory (t² floats, 16 KB at t = 64) and
// every thread loops over all pixels, keeping gx and gy in registers.
// Each candidate owns its partial sum: no atomics, and the result is
// deterministic.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
occ_bwd_kernel(const int* __restrict__ counts,
               const float* __restrict__ table,
               const float* __restrict__ grad_occ,
               const float* __restrict__ cur_r2, float* __restrict__ gx_out,
               float* __restrict__ gy_out, int n_tiles_x, int tile, int m,
               float inv_s) {
  using namespace dss;
  extern __shared__ float sh[];
  const int tt = tile * tile;
  float* gpix = sh;          // [tt]
  float* xcol = sh + tt;     // [tile] NDC x of the tile's columns
  float* yrow = xcol + tile;  // [tile] NDC y of the tile's rows
  const int v = blockIdx.y;
  const int g = blockIdx.x;
  const int n_tiles = n_tiles_x * n_tiles_x;
  const size_t vt = (size_t)v * n_tiles + g;
  const int ty = g / n_tiles_x, tx = g % n_tiles_x;
  for (int i = threadIdx.x; i < tt; i += blockDim.x)
    gpix[i] = grad_occ[vt * tt + i];
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    xcol[i] = pixel_ndc(tx * tile + i, inv_s);
    yrow[i] = pixel_ndc(ty * tile + i, inv_s);
  }
  __syncthreads();

  const float r2 = cur_r2[v];
  const float* tab = table + vt * N_BWD_CHANNELS * m;
  const int n_cand = min(counts[vt], m);
  for (int j = threadIdx.x; j < n_cand; j += blockDim.x) {
    const float px = tab[BPX * m + j], py = tab[BPY * m + j];
    const float pz = tab[BPZ * m + j];
    const float rx = tab[BRX * m + j], ry = tab[BRY * m + j];
    float gx = 0.f, gy = 0.f;
    if (pz >= 0.0f && fabsf(px) <= 1.0f && fabsf(py) <= 1.0f) {
      for (int r = 0; r < tile; ++r) {
        const float dy = __fsub_rn(yrow[r], py);
        const float dy2 = __fmul_rn(dy, dy);
        if (dy2 > r2) continue;  // dist² ≥ dy² > r²: no pixel of this row
        const bool out_y = fabsf(dy) > ry;
        for (int c = 0; c < tile; ++c) {
          const float gp = gpix[r * tile + c];
          const float dx = __fsub_rn(xcol[c], px);
          const float dist2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
          const bool outside = out_y || fabsf(dx) > rx;
          if (dist2 <= r2 && gp != 0.0f && !(gp > 0.0f && outside)) {
            const float w = __fdiv_rn(gp, fmaxf(dist2, 1e-10f));
            gx = __fadd_rn(gx, __fmul_rn(w, dx));
            gy = __fadd_rn(gy, __fmul_rn(w, dy));
          }
        }
      }
    }
    gx_out[vt * m + j] = gx;
    gy_out[vt * m + j] = gy;
  }
}

}  // namespace

extern "C" int dss_occ_bwd(const int* counts, const float* table,
                           const float* grad_occ, const float* cur_r2,
                           float* gx, float* gy, int n_views, int n_tiles_x,
                           int tile, int m, float inv_s,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(tile * tile + 2 * tile) * sizeof(float);
  const dim3 grid(n_tiles_x * n_tiles_x, n_views);
  occ_bwd_kernel<<<grid, 256, smem, stream>>>(counts, table, grad_occ, cur_r2,
                                              gx, gy, n_tiles_x, tile, m,
                                              inv_s);
  return (int)cudaGetLastError();
}
