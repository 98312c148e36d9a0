// K1 — lean splat forward.
//
// Replaces dss_tpu/ops/splat_pallas.py:_fwd_kernel_lean (launched by
// rasterize_forward_views_lean).  For each view, tile and pixel it walks
// the tile's depth-sorted candidates: accept if pz ≥ 0, |dx| ≤ rx,
// |dy| ≤ ry and Q ≤ cutoff; rank = running count of accepts; a candidate
// wins if rank < K and pz − z0 ≤ dmt, with z0 the minimum accepted depth
// updated once per 128-candidate chunk; w = exp(−Q/2)·scaler over winners.
// Outputs per pixel the accepted count and Σw·[r, g, b, 1(, z)], and per
// candidate a "won in some pixel" flag.
//
// What bounds it on the H100: bytes — the per-pixel outputs (cnt and
// Σw·[r, g, b, 1, z], 24 B per pixel, 50 MB at the flagship shape) and the
// live candidates' 13 channels, about 17 µs at 3.35 TB/s.  The arithmetic
// the inputs need is ~26 float operations (accept test, weight, five
// products and sums) per pair of a pixel and a candidate whose box holds
// it, 3.2e6 pairs at the flagship tables.  As written, every pixel runs
// the ~15-operation accept test on every candidate of its tile (2.1e8
// pairs), and that is where its time goes; the sub-tile cull of K3
// (common.cuh: box_meets, walk_culled) is the remedy, not yet applied here.
//
// Design: one 256-thread block per (view, tile, 16×16 pixel sub-tile), one
// thread per pixel.  The tile's candidates stream through shared memory in
// 128-candidate chunks (13 channels × 128 × 4 B = 6.5 KB; the whole table
// of a tile would be 114 KB).  Each pixel walks its chunk in depth order,
// so the rank is a plain counter, replacing the TPU's triangular-matmul
// prefix sum.  The visibility flag is a plain store of 1.0f into a
// zero-filled buffer: every writer stores the same value.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
fwd_lean_kernel(const int* __restrict__ counts,
                const float* __restrict__ table, float* __restrict__ cnt_out,
                float* __restrict__ vis_out, float* __restrict__ rgbw_out,
                int n_tiles_x, int tile, int m, int k, float dmt, float inv_s,
                int with_depth) {
  using namespace dss;
  __shared__ Chunk s;
  const int v = blockIdx.y;
  const int n_tiles = n_tiles_x * n_tiles_x;
  const int subs = tile / SUB;
  const int g = blockIdx.x / (subs * subs);
  const int sub = blockIdx.x % (subs * subs);
  const int lr = (sub / subs) * SUB + threadIdx.x / SUB;
  const int lc = (sub % subs) * SUB + threadIdx.x % SUB;
  const float yf = pixel_ndc((g / n_tiles_x) * tile + lr, inv_s);
  const float xf = pixel_ndc((g % n_tiles_x) * tile + lc, inv_s);
  const size_t vt = (size_t)v * n_tiles + g;
  const float* tab = table + vt * N_CHANNELS * m;
  float* vis = vis_out + vt * m;
  const int n_cand = min(counts[vt], m);

  int cnt = 0;
  float z0 = CUDART_INF_F;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n_cand; base += CHUNK) {
    __syncthreads();
    load_chunk(s, tab, m, base);
    __syncthreads();
    walk_chunk<Z0::kChunkMin>(s, xf, yf, k, dmt, cnt, z0,
                              [&](const Chunk& c, int j, int, float q,
                                  bool win) {
      if (!win) return;
      const float w = splat_weight(c, j, q);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, c.ch[CR][j]));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, c.ch[CG][j]));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, c.ch[CB2][j]));
      acc[3] = __fadd_rn(acc[3], w);
      acc[4] = __fadd_rn(acc[4], __fmul_rn(w, c.ch[PZ][j]));
      vis[base + j] = 1.0f;
    });
  }
  const int tt = tile * tile;
  const int lin = lr * tile + lc;
  cnt_out[vt * tt + lin] = (float)cnt;
  const int co = with_depth ? 5 : 4;
  for (int c = 0; c < co; ++c) rgbw_out[(vt * co + c) * tt + lin] = acc[c];
}

}  // namespace

extern "C" int dss_fwd_lean(const int* counts, const float* table,
                            float* cnt, float* vis, float* rgbw, int n_views,
                            int n_tiles_x, int tile, int m, int k, float dmt,
                            float inv_s, int with_depth, cudaStream_t stream) {
  const int subs = tile / dss::SUB;
  const dim3 grid(n_tiles_x * n_tiles_x * subs * subs, n_views);
  fwd_lean_kernel<<<grid, dss::SUB * dss::SUB, 0, stream>>>(
      counts, table, cnt, vis, rgbw, n_tiles_x, tile, m, k, dmt, inv_s,
      with_depth);
  return (int)cudaGetLastError();
}
