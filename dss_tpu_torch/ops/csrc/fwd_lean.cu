// K1 — lean splat forward.
//
// Replaces dss_tpu/ops/splat_pallas.py:_fwd_kernel_lean (launched by
// rasterize_forward_views_lean).  For each view, tile and pixel it walks
// the tile's depth-sorted candidates: accept if pz ≥ 0, |dx| ≤ rx,
// |dy| ≤ ry and Q ≤ cutoff; rank = running count of accepts; a candidate
// wins if rank < K and pz − z0 ≤ dmt, with z0 the minimum accepted depth
// updated once per 128-candidate chunk; w = exp(−Q/2)·scaler over winners.
// Outputs per pixel the accepted count and Σw·[r, g, b, 1(, z)], and per
// point a "won in some pixel" flag: the TPU kernel's per-candidate flags
// with K4's scatter to points (segment_sum_views_matmul) fused into the
// epilogue.
//
// What bounds it on the H100: bytes — the per-pixel outputs (cnt and
// Σw·[r, g, b, 1, z], 24 B per pixel, 50 MB at the flagship shape), the
// live candidates' 14 channels and the per-point flags, about 0.016 ms at
// 3.35 TB/s on the flagship tables.  The arithmetic the inputs need is ~26
// float operations (accept test, weight, five products and sums) per pair
// of a pixel and a candidate whose box holds it, 3.2e6 pairs there,
// against 2.1e8 pairs of a pixel and any candidate of its tile.
//
// Design: one 256-thread block per (view, tile, 16×16 pixel sub-tile), one
// thread per pixel.  For each 128-candidate chunk of the tile's table the
// block culls the candidates whose box cannot reach the sub-tile
// (common.cuh: cull_chunk), stages the survivors' 14 channels in shared
// memory in table order, skips the chunk where none survives, and each
// pixel walks only the survivors (walk_culled, z0 per chunk): ~13 of the
// tile's ~100 candidates at the flagship tables.  The rank is a plain
// counter, replacing the TPU's triangular-matmul prefix sum.  Every pixel
// writes its cnt and sums at the end, also where every chunk was skipped.
// The visibility flag is a plain store of 1.0f at the winner's point id
// (its staged id channel) into a zero-filled (V, P) buffer: every writer
// stores the same value, so the flags equal K4's sum of per-candidate
// flags > 0 exactly.  A winner is a survivor, so a live slot: its id is a
// point's.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
fwd_lean_kernel(const int* __restrict__ counts,
                const float* __restrict__ table, float* __restrict__ cnt_out,
                float* __restrict__ vis_out, float* __restrict__ rgbw_out,
                int n_tiles_x, int tile, int m, int k, float dmt, float inv_s,
                int with_depth, int n_points) {
  using namespace dss;
  __shared__ Chunk s;
  const SubTile st = sub_tile(n_tiles_x, tile, inv_s);
  const float* tab = table + st.vt * N_CHANNELS * m;
  float* vis = vis_out + (size_t)blockIdx.y * n_points;
  const int n_cand = min(counts[st.vt], m);

  int cnt = 0;
  float z0 = CUDART_INF_F;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n_cand; base += CHUNK) {
    const int n = cull_chunk(s, tab, m, base, st);
    if (n == 0) continue;  // no candidate of the chunk reaches the sub-tile
    walk_culled<Z0::kChunkMin>(s, n, st.xf, st.yf, k, dmt, cnt, z0,
                               [&](const Chunk& c, int js, int, float q,
                                   bool win) {
      if (!win) return;
      const float w = splat_weight(c, js, q);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, c.ch[CR][js]));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, c.ch[CG][js]));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, c.ch[CB2][js]));
      acc[3] = __fadd_rn(acc[3], w);
      acc[4] = __fadd_rn(acc[4], __fmul_rn(w, c.ch[PZ][js]));
      vis[(int)c.ch[ID][js]] = 1.0f;
    });
  }
  const int tt = tile * tile;
  cnt_out[st.vt * tt + st.lin] = (float)cnt;
  const int co = with_depth ? 5 : 4;
  for (int c = 0; c < co; ++c)
    rgbw_out[(st.vt * co + c) * tt + st.lin] = acc[c];
}

}  // namespace

extern "C" int dss_fwd_lean(const int* counts, const float* table,
                            float* cnt, float* vis, float* rgbw, int n_views,
                            int n_tiles_x, int tile, int m, int k, float dmt,
                            float inv_s, int with_depth, int n_points,
                            cudaStream_t stream) {
  const int subs = tile / dss::SUB;
  const dim3 grid(n_tiles_x * n_tiles_x * subs * subs, n_views);
  fwd_lean_kernel<<<grid, dss::SUB * dss::SUB, 0, stream>>>(
      counts, table, cnt, vis, rgbw, n_tiles_x, tile, m, k, dmt, inv_s,
      with_depth, n_points);
  return (int)cudaGetLastError();
}
