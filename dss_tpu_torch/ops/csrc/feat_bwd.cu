// K3 — feature and depth backward through the fused composite.
//
// Replaces dss_tpu/ops/splat_pallas.py:_feat_bwd_kernel (launched by
// feat_backward_views).  It recomputes K1's accept, rank, window and
// weight for every (pixel, candidate) pair and emits, per candidate,
// Σ_pix w·g over four cotangent rows: rgb in rows 0–2 and, with the depth
// channel, the Σw·z cotangent in row 3, which is dL/dz because the weights
// are held constant.
//
// What bounds it on the H100: bytes — the 16 B of cotangents per pixel
// (33.5 MB at the flagship shape) and the live candidates' 13 channels,
// about 11 µs at 3.35 TB/s.  The arithmetic is small: ~24 float operations
// (accept test, weight, four products and sums) for each pair of a pixel
// and a candidate whose box holds it, 3.2e6 pairs at the flagship tables.
//
// Design: one 256-thread block per view, tile and 16×16 sub-tile, one
// thread per pixel, as K1.  A sub-tile without a live cotangent returns at
// once.  Per 128-candidate chunk of the tile's table, the sub-tile cull
// K1 and K5 share (common.cuh: cull_chunk — box_meets over the sub-tile's
// pixel centres widened by a pixel, survivors compacted in table order
// with a ballot and a popc prefix and staged in shared memory) leaves
// each pixel only the survivors to walk (walk_culled<kChunkMin>: the same
// accept, rank counter and per-chunk z0 as a walk over the whole chunk).
// A forward splat covers few sub-tiles, so a pixel walks ~13 candidates
// instead of the tile's ~100.  A chunk with no survivor is skipped.  A
// pixel holds its four cotangents in registers; each win adds w·g into a
// [4][128] shared buffer with shared atomicAdd, and the block flushes its
// survivors' entries per chunk with one global atomicAdd per non-zero
// entry (the 16 sub-tiles of a tile share the output slots; the wrapper
// zero-fills the output).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
feat_bwd_kernel(const int* __restrict__ counts,
                const float* __restrict__ table,
                const float4* __restrict__ grad, float* __restrict__ out,
                int n_tiles_x, int tile, int m, int k, float dmt,
                float inv_s) {
  using namespace dss;
  __shared__ Chunk s;
  __shared__ float part[4][CHUNK];
  const SubTile st = sub_tile(n_tiles_x, tile, inv_s);
  const float4 gp = grad[st.vt * tile * tile + st.lin];
  const bool live = gp.x != 0.f || gp.y != 0.f || gp.z != 0.f || gp.w != 0.f;
  if (!__syncthreads_or(live)) return;

  const float* tab = table + st.vt * N_CHANNELS * m;
  float* o = out + st.vt * 4 * m;
  const int n_cand = min(counts[st.vt], m);
  for (int i = threadIdx.x; i < 4 * CHUNK; i += blockDim.x)
    part[i / CHUNK][i % CHUNK] = 0.f;
  float(*pp)[CHUNK] = part;  // captured by the win callback
  int cnt = 0;
  float z0 = CUDART_INF_F;
  for (int base = 0; base < n_cand; base += CHUNK) {
    const int n = cull_chunk<FWD_CH>(s, tab, m, base, st);
    if (n == 0) continue;  // no candidate of the chunk reaches the sub-tile
    if (live) {
      walk_culled<Z0::kChunkMin>(s, n, st.xf, st.yf, k, dmt, cnt, z0,
                                 [&](const Chunk& c, int js, int, float q,
                                     bool win) {
        if (!win) return;
        const float w = splat_weight(c, js, q);
        atomicAdd(&pp[0][js], __fmul_rn(w, gp.x));
        atomicAdd(&pp[1][js], __fmul_rn(w, gp.y));
        atomicAdd(&pp[2][js], __fmul_rn(w, gp.z));
        atomicAdd(&pp[3][js], __fmul_rn(w, gp.w));
      });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) {
      const int r = i / n, js = i % n;
      const float p = part[r][js];
      if (p != 0.f) {
        atomicAdd(&o[(size_t)r * m + base + s.slot[js]], p);
        part[r][js] = 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int dss_feat_bwd(const int* counts, const float* table,
                            const float* grad, float* out, int n_views,
                            int n_tiles_x, int tile, int m, int k, float dmt,
                            float inv_s, cudaStream_t stream) {
  const int subs = tile / dss::SUB;
  const dim3 grid(n_tiles_x * n_tiles_x * subs * subs, n_views);
  if (grid.x == 0 || grid.y == 0) return 0;
  feat_bwd_kernel<<<grid, dss::SUB * dss::SUB, 0, stream>>>(
      counts, table, reinterpret_cast<const float4*>(grad), out, n_tiles_x,
      tile, m, k, dmt, inv_s);
  return (int)cudaGetLastError();
}
