// K5 — full-fragment splat forward.
//
// Replaces dss_tpu/ops/splat_pallas.py:_fwd_kernel (launched by
// rasterize_forward_pallas).  K1's walk (accept if pz ≥ 0, |dx| ≤ rx,
// |dy| ≤ ry and Q ≤ cutoff; rank = running count of accepts) plus the
// per-pixel fragment buffers: slot r < K holds the z, the Q and the global
// splat id of the pixel's rank-r accepted candidate, whatever the depth
// window says (z = Q = −1 and id = −1 where empty).  The depth window gates
// only the composite and the visibility flags, and its z0 is the depth of
// the rank-0 fragment (the first accept in table order), not K1's
// chunk-granular minimum: the two differ when quantized-depth ties put a
// deeper splat first.  Outputs per pixel the accepted count and
// Σw·[r, g, b, 1] over the winners (w = exp(−Q/2)·scaler), and per
// candidate a "won in some pixel" flag.
//
// What bounds it on the H100: bytes — the fragment buffers (3·K·4 B = 60 B
// per pixel at K = 5, 126 MB at 512² × 8 views) with cnt and Σw·[r, g, b,
// 1], about 54 µs at 3.35 TB/s.  The arithmetic the inputs need is ~24
// float operations per pair of a pixel and a candidate whose box holds it
// (3.2e6 pairs at the flagship tables).  As written, it runs K1's walk, the
// ~15-operation accept test on every (pixel, candidate) pair of the tile,
// plus the slot bookkeeping of at most K accepts per pixel, and that walk
// is where its time goes.
//
// Design: K1's block shape (one 256-thread block per view, tile and 16×16
// sub-tile; one thread per pixel), with the id channel staged too
// (14 channels × 128 × 4 B = 7 KB of shared memory per chunk).  A pixel
// holds its K slots in registers — KMAX-sized arrays written through an
// unrolled compare, so no dynamic register indexing spills them to local
// memory — and stores them once at the end, coalesced along the pixel axis.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(256)
fwd_frag_kernel(const int* __restrict__ counts,
                const float* __restrict__ table, float* __restrict__ z_out,
                float* __restrict__ q_out, int* __restrict__ id_out,
                float* __restrict__ cnt_out, float* __restrict__ vis_out,
                float* __restrict__ rgbw_out, int n_tiles_x, int tile, int m,
                int k, float dmt, float inv_s) {
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

  float zs[KMAX], qs[KMAX];
  int ids[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    zs[r] = -1.0f;
    qs[r] = -1.0f;
    ids[r] = -1;
  }
  int cnt = 0;
  float z0 = 0.0f;  // set by the first accept
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n_cand; base += CHUNK) {
    __syncthreads();
    load_chunk<N_CHANNELS>(s, tab, m, base);
    __syncthreads();
    walk_chunk<Z0::kFirstAccept>(s, xf, yf, k, dmt, cnt, z0,
                                 [&](const Chunk& c, int j, int rank, float q,
                                     bool win) {
#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        if (r == rank) {
          zs[r] = c.ch[PZ][j];
          qs[r] = q;
          ids[r] = (int)c.ch[ID][j];
        }
      }
      if (!win) return;
      const float w = splat_weight(c, j, q);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, c.ch[CR][j]));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, c.ch[CG][j]));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, c.ch[CB2][j]));
      acc[3] = __fadd_rn(acc[3], w);
      vis[base + j] = 1.0f;
    });
  }
  const int tt = tile * tile;
  const int lin = lr * tile + lc;
  cnt_out[vt * tt + lin] = (float)cnt;
#pragma unroll
  for (int c = 0; c < 4; ++c) rgbw_out[(vt * 4 + c) * tt + lin] = acc[c];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      const size_t o = (vt * k + r) * tt + lin;
      z_out[o] = zs[r];
      q_out[o] = qs[r];
      id_out[o] = ids[r];
    }
  }
}

}  // namespace

extern "C" int dss_fwd_frag(const int* counts, const float* table, float* z,
                            float* q, int* ids, float* cnt, float* vis,
                            float* rgbw, int n_views, int n_tiles_x, int tile,
                            int m, int k, float dmt, float inv_s,
                            cudaStream_t stream) {
  const int subs = tile / dss::SUB;
  const dim3 grid(n_tiles_x * n_tiles_x * subs * subs, n_views);
  const dim3 block(dss::SUB * dss::SUB);
  if (k <= 8) {
    fwd_frag_kernel<8><<<grid, block, 0, stream>>>(
        counts, table, z, q, ids, cnt, vis, rgbw, n_tiles_x, tile, m, k, dmt,
        inv_s);
  } else if (k <= 16) {
    fwd_frag_kernel<16><<<grid, block, 0, stream>>>(
        counts, table, z, q, ids, cnt, vis, rgbw, n_tiles_x, tile, m, k, dmt,
        inv_s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
