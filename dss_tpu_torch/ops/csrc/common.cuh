// Shared definitions of the dss_tpu_torch splat kernels.
//
// Every product and sum that decides a candidate's accept test is written
// with the round-to-nearest intrinsics (__fmul_rn / __fadd_rn / __fsub_rn)
// in the operation order of the plain PyTorch versions (ops/kernels.py) and
// of the JAX kernels they replace; the library is also compiled with
// -fmad=false.  A contracted FMA would move Q by an ulp, and a candidate at
// Q ≈ cutoff would then flip its accept, its rank and the pixel's colour.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dss {

// Forward candidate table channels (ops/kernels.py CH_*).
enum { PX = 0, PY, PZ, CA, CB, CC, CUT, RX, RY, SC, CR, CG, CB2, ID,
       N_CHANNELS };
// Occupancy-backward table channels (ops/kernels.py BCH_*).
enum { BPX = 0, BPY, BPZ, BRX, BRY, N_BWD_CHANNELS };

constexpr int CHUNK = 128;   // candidates per shared-memory chunk (z0 rule)
constexpr int SUB = 16;      // pixel sub-tile side: one 256-thread block

// NDC centre of pixel index i along one axis: 1 − (2·i + 1)·(1/S).
__device__ __forceinline__ float pixel_ndc(int i, float inv_s) {
  return __fsub_rn(1.0f, __fmul_rn(__fadd_rn(__fmul_rn(2.0f, (float)i), 1.0f),
                                   inv_s));
}

// Q = a·dx·dx + b·dx·dy + c·dy·dy, left to right.
__device__ __forceinline__ float conic_q(float a, float b, float c, float dx,
                                         float dy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                             __fmul_rn(__fmul_rn(b, dx), dy)),
                   __fmul_rn(__fmul_rn(c, dy), dy));
}

// One chunk's survivors of a sub-tile's cull, staged in shared memory
// channel-major and compacted in table order: all 14 channels, the point id
// included, which the epilogues of K1, K3 and K5 scatter to.
struct Chunk {
  float ch[N_CHANNELS][CHUNK];
  int warp_n[CHUNK / 32];  // survivors per culling warp
};

// The block's 16×16 pixel sub-tile (one 256-thread block per view, tile
// and sub-tile; one thread per pixel) and this thread's pixel.
struct SubTile {
  size_t vt;   // view · n_tiles + tile
  int lin;     // the pixel's index within its tile
  float xf, yf;  // its NDC centre
  // The sub-tile's pixel centres widened by one pixel (NDC falls as the
  // index grows).
  float xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ SubTile sub_tile(int n_tiles_x, int tile,
                                            float inv_s) {
  const int subs = tile / SUB;
  const int g = blockIdx.x / (subs * subs);
  const int sub = blockIdx.x % (subs * subs);
  const int row0 = (g / n_tiles_x) * tile + (sub / subs) * SUB;
  const int col0 = (g % n_tiles_x) * tile + (sub % subs) * SUB;
  const int lr = (sub / subs) * SUB + threadIdx.x / SUB;
  const int lc = (sub % subs) * SUB + threadIdx.x % SUB;
  const float px_w = __fmul_rn(2.0f, inv_s);
  SubTile st;
  st.vt = (size_t)blockIdx.y * n_tiles_x * n_tiles_x + g;
  st.lin = lr * tile + lc;
  st.yf = pixel_ndc(row0 + threadIdx.x / SUB, inv_s);
  st.xf = pixel_ndc(col0 + threadIdx.x % SUB, inv_s);
  st.xlo = __fsub_rn(pixel_ndc(col0 + SUB - 1, inv_s), px_w);
  st.xhi = __fadd_rn(pixel_ndc(col0, inv_s), px_w);
  st.ylo = __fsub_rn(pixel_ndc(row0 + SUB - 1, inv_s), px_w);
  st.yhi = __fadd_rn(pixel_ndc(row0, inv_s), px_w);
  return st;
}

// K1's accept test for candidate j of the staged chunk at pixel (xf, yf).
__device__ __forceinline__ bool accept(const Chunk& s, int j, float xf,
                                       float yf, float* q_out) {
  const float dx = __fsub_rn(xf, s.ch[PX][j]);
  const float dy = __fsub_rn(yf, s.ch[PY][j]);
  const float q = conic_q(s.ch[CA][j], s.ch[CB][j], s.ch[CC][j], dx, dy);
  *q_out = q;
  return s.ch[PZ][j] >= 0.0f && fabsf(dx) <= s.ch[RX][j] &&
         fabsf(dy) <= s.ch[RY][j] && q <= s.ch[CUT][j];
}

// Splat weight exp(−Q/2)·scaler of candidate j.
__device__ __forceinline__ float splat_weight(const Chunk& s, int j, float q) {
  return __fmul_rn(expf(__fmul_rn(-0.5f, q)), s.ch[SC][j]);
}

// Whether candidate (px, py, pz, rx, ry) can pass accept()'s pz and box
// tests at any pixel centre in [xlo, xhi] × [ylo, yhi].  __fsub_rn(x, px)
// does not decrease as x grows, so where the box test fails at both ends
// of an axis it fails at every pixel between them: a candidate refused
// here is accepted by no pixel of the range.  NaNs are refused, as by
// accept().
__device__ __forceinline__ bool box_meets(float px, float py, float pz,
                                          float rx, float ry, float xlo,
                                          float xhi, float ylo, float yhi) {
  return pz >= 0.0f && __fsub_rn(xlo, px) <= rx && __fsub_rn(xhi, px) >= -rx &&
         __fsub_rn(ylo, py) <= ry && __fsub_rn(yhi, py) >= -ry;
}

// The sub-tile cull of K1, K3 and K5, for candidates [base, base + CHUNK)
// of one tile's table (channel stride m; sentinel rows past the count):
// 128 threads each test one candidate with box_meets against the
// sub-tile, a ballot and a popc prefix compact the survivors in table
// order, and their channels are staged into s.  Survivors are live slots,
// whose id is a point's: the sentinel rows past a tile's count (pz = −1,
// id = −1) meet no box.  Returns the survivor count, the same in every
// thread; where it is 0 nothing was staged.
// Every thread of the block calls it: it opens with a barrier (the
// previous chunk's walk is done) and ends with one where it stages.
__device__ __forceinline__ int cull_chunk(Chunk& s, const float* tab, int m,
                                          int base, const SubTile& st) {
  __syncthreads();
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const bool keep =
      j < CHUNK &&
      box_meets(tab[PX * m + base + j], tab[PY * m + base + j],
                tab[PZ * m + base + j], tab[RX * m + base + j],
                tab[RY * m + base + j], st.xlo, st.xhi, st.ylo, st.yhi);
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0 && warp < CHUNK / 32) s.warp_n[warp] = __popc(ballot);
  __syncthreads();
  int n = 0, at = 0;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    at += w < warp ? s.warp_n[w] : 0;
    n += s.warp_n[w];
  }
  if (n == 0) return 0;
  if (keep) {
    at += __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int c = 0; c < N_CHANNELS; ++c)
      s.ch[c][at] = tab[(size_t)c * m + base + j];
  }
  __syncthreads();
  return n;
}

// Where the depth window's z0 comes from.  K1 and K3: the minimum accepted
// depth, updated once per whole 128-candidate chunk.  K5: the depth of the
// pixel's first accepted candidate in table order (its rank-0 fragment),
// which does not depend on the chunk.  The two differ when quantized-depth
// ties put a deeper splat first in the table.
enum class Z0 { kChunkMin, kFirstAccept };

// The per-pixel walk of K1, K3 and K5 over the n survivors of one chunk's
// cull: pass 1 finds the accepts (as bits) and updates z0 by the policy;
// pass 2 walks the accepts in table order, ranks them with a plain counter
// and calls on_slot(s, js, rank, q, win) for each accept of rank < K, where
// js is the survivor's index in s and win means pz − z0 ≤ dmt.
//
// Exactness: a culled candidate is accepted by no pixel of the sub-tile
// (box_meets), and the survivors keep table order.  So each pixel's
// accepts, in order, are those of the whole chunk: its ranks, its chunk
// minimum (K1, K3; a chunk without survivors changes nothing), its first
// accept in table order (K5's rank-0 z0, slots and ids) and its weights
// are unchanged, and its sums take the same terms in the same order.
// Compaction stays within one 128-candidate chunk: K1's and K3's z0 is
// updated per chunk of the table, never over two chunks' survivors.
template <Z0 kZ0, typename OnSlot>
__device__ __forceinline__ void walk_culled(const Chunk& s, int n, float xf,
                                            float yf, int k, float dmt,
                                            int& cnt, float& z0,
                                            OnSlot on_slot) {
  unsigned bits[CHUNK / 32];
  float zmin = CUDART_INF_F;
#pragma unroll
  for (int wd = 0; wd < CHUNK / 32; ++wd) {
    unsigned b = 0;
    const int nl = min(32, n - wd * 32);
    for (int l = 0; l < nl; ++l) {
      float q;
      const int j = wd * 32 + l;
      if (accept(s, j, xf, yf, &q)) {
        b |= 1u << l;
        zmin = fminf(zmin, s.ch[PZ][j]);
      }
    }
    bits[wd] = b;
  }
  if (kZ0 == Z0::kChunkMin) {
    z0 = fminf(z0, zmin);
  } else if (cnt == 0) {
#pragma unroll
    for (int wd = 0; wd < CHUNK / 32; ++wd) {
      if (bits[wd]) {
        z0 = s.ch[PZ][wd * 32 + __ffs(bits[wd]) - 1];
        break;
      }
    }
  }
#pragma unroll
  for (int wd = 0; wd < CHUNK / 32; ++wd) {
    unsigned b = bits[wd];
    while (b) {
      const int l = __ffs(b) - 1;
      b &= b - 1;
      const int j = wd * 32 + l;
      const int rank = cnt++;
      if (rank < k) {
        float q;
        accept(s, j, xf, yf, &q);  // same ops → the same q
        on_slot(s, j, rank, q, __fsub_rn(s.ch[PZ][j], z0) <= dmt);
      }
    }
  }
}

}  // namespace dss
