// K3 — feature and depth backward through the fused composite.
//
// Replaces dss_tpu/ops/splat_pallas.py:_feat_bwd_kernel (launched by
// feat_backward_views).  It recomputes K1's accept, rank, window and
// weight for every (pixel, candidate) pair and emits, per candidate,
// Σ_pix w·g over four cotangent rows: rgb in rows 0–2 and, with the depth
// channel, the Σw·z cotangent in row 3, which is dL/dz because the weights
// are held constant.
//
// What bounds it on the H100: arithmetic, as K1 — the same walk over the
// same shared-memory chunks; the extra work is 4 shared atomics per
// winning (pixel, candidate) pair, and at most K = 5 pairs win per pixel.
//
// Design: K1's block shape (one 256-thread block per view, tile and 16×16
// sub-tile; one thread per pixel).  A pixel holds its four cotangents in
// registers; each win adds w·g into a [4][128] shared buffer with shared
// atomicAdd, and the block flushes the buffer per chunk with one global
// atomicAdd per non-zero entry (the 16 sub-tiles of a tile share the
// output slots; the wrapper zero-fills the output).
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
  float* o = out + vt * 4 * m;
  const int n_cand = min(counts[vt], m);
  const float4 gp = grad[vt * tile * tile + lr * tile + lc];
  const bool live = gp.x != 0.f || gp.y != 0.f || gp.z != 0.f || gp.w != 0.f;

  for (int i = threadIdx.x; i < 4 * CHUNK; i += blockDim.x)
    part[i / CHUNK][i % CHUNK] = 0.f;
  float(*pp)[CHUNK] = part;  // captured by the win callback
  int cnt = 0;
  float z0 = CUDART_INF_F;
  for (int base = 0; base < n_cand; base += CHUNK) {
    __syncthreads();
    load_chunk(s, tab, m, base);
    __syncthreads();
    if (live) {
      walk_chunk<Z0::kChunkMin>(s, xf, yf, k, dmt, cnt, z0,
                                [&](const Chunk& c, int j, int, float q,
                                    bool win) {
        if (!win) return;
        const float w = splat_weight(c, j, q);
        atomicAdd(&pp[0][j], __fmul_rn(w, gp.x));
        atomicAdd(&pp[1][j], __fmul_rn(w, gp.y));
        atomicAdd(&pp[2][j], __fmul_rn(w, gp.z));
        atomicAdd(&pp[3][j], __fmul_rn(w, gp.w));
      });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * CHUNK; i += blockDim.x) {
      const int r = i / CHUNK, j = i % CHUNK;
      const float p = part[r][j];
      if (p != 0.f) {
        atomicAdd(&o[(size_t)r * m + base + j], p);
        part[r][j] = 0.f;
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
  feat_bwd_kernel<<<grid, dss::SUB * dss::SUB, 0, stream>>>(
      counts, table, reinterpret_cast<const float4*>(grad), out, n_tiles_x,
      tile, m, k, dmt, inv_s);
  return (int)cudaGetLastError();
}
