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
// 1], 0.0510 ms at 3.35 TB/s on the flagship tables.  The arithmetic the
// inputs need is ~24 float operations per pair of a pixel and a candidate
// whose box holds it (3.2e6 pairs there), plus the slot bookkeeping of at
// most K accepts per pixel.
//
// Design: K1's (one 256-thread block per view, tile and 16×16 sub-tile;
// one thread per pixel; per 128-candidate chunk the sub-tile cull of
// common.cuh, a skip where nothing survives, and a walk over the
// survivors), with the id channel staged too (14 channels) and z0 from the
// first accept (walk_culled<kFirstAccept>): the cull keeps table order and
// drops only candidates no pixel of the sub-tile accepts, so the first
// accept, the slots and the ids are the unculled walk's.  A pixel holds its
// K slots in registers — KMAX-sized arrays written through an unrolled
// compare, so no dynamic register indexing spills them to local memory —
// and stores them once at the end, coalesced along the pixel axis.
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
  const SubTile st = sub_tile(n_tiles_x, tile, inv_s);
  const float* tab = table + st.vt * N_CHANNELS * m;
  float* vis = vis_out + st.vt * m;
  const int n_cand = min(counts[st.vt], m);

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
    const int n = cull_chunk<N_CHANNELS>(s, tab, m, base, st);
    if (n == 0) continue;  // no candidate of the chunk reaches the sub-tile
    walk_culled<Z0::kFirstAccept>(s, n, st.xf, st.yf, k, dmt, cnt, z0,
                                  [&](const Chunk& c, int js, int rank,
                                      float q, bool win) {
#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        if (r == rank) {
          zs[r] = c.ch[PZ][js];
          qs[r] = q;
          ids[r] = (int)c.ch[ID][js];
        }
      }
      if (!win) return;
      const float w = splat_weight(c, js, q);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, c.ch[CR][js]));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, c.ch[CG][js]));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, c.ch[CB2][js]));
      acc[3] = __fadd_rn(acc[3], w);
      vis[base + c.slot[js]] = 1.0f;
    });
  }
  const int tt = tile * tile;
  cnt_out[st.vt * tt + st.lin] = (float)cnt;
#pragma unroll
  for (int c = 0; c < 4; ++c) rgbw_out[(st.vt * 4 + c) * tt + st.lin] = acc[c];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      const size_t o = (st.vt * k + r) * tt + st.lin;
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
