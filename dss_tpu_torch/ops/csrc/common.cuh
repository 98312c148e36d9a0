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
constexpr int FWD_CH = 13;   // channels K1/K3 read (all but the id)

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

// The candidate chunk staged in shared memory, channel-major.  K1 and K3
// stage the first FWD_CH channels; K5 also stages the id.
struct Chunk {
  float ch[N_CHANNELS][CHUNK];
};

// Stage channels [0, NCH) of candidates [base, base + CHUNK) of one tile's
// table (channel stride m) into shared memory; the table holds sentinel
// rows past the count.
template <int NCH = FWD_CH>
__device__ __forceinline__ void load_chunk(Chunk& s, const float* tab, int m,
                                           int base) {
  for (int i = threadIdx.x; i < NCH * CHUNK; i += blockDim.x) {
    const int c = i / CHUNK, j = i % CHUNK;
    s.ch[c][j] = tab[(size_t)c * m + base + j];
  }
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

// Where the depth window's z0 comes from.  K1 and K3: the minimum accepted
// depth, updated once per whole 128-candidate chunk.  K5: the depth of the
// pixel's first accepted candidate in table order (its rank-0 fragment),
// which does not depend on the chunk.  The two differ when quantized-depth
// ties put a deeper splat first in the table.
enum class Z0 { kChunkMin, kFirstAccept };

// The per-pixel walk shared by K1, K3 and K5 over one staged chunk: pass 1
// finds the accepts (as bits) and updates z0 by the policy; pass 2 walks
// the accepts in table order, ranks them with a plain counter and calls
// on_slot(s, j, rank, q, win) for each accept of rank < K, where win means
// pz − z0 ≤ dmt.
template <Z0 kZ0, typename OnSlot>
__device__ __forceinline__ void walk_chunk(const Chunk& s, float xf, float yf,
                                           int k, float dmt, int& cnt,
                                           float& z0, OnSlot on_slot) {
  unsigned bits[CHUNK / 32];
  float zmin = CUDART_INF_F;
#pragma unroll
  for (int wd = 0; wd < CHUNK / 32; ++wd) {
    unsigned b = 0;
    for (int l = 0; l < 32; ++l) {
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

// walk_chunk<Z0::kChunkMin> over the n survivors of a box_meets cull,
// staged in table order in s (K3).  The culled candidates are accepted by
// no pixel of the range the cull tested, so every pixel's accept bits,
// ranks, z0 and weights are those of walk_chunk over the whole chunk;
// on_slot gets the survivor's index in s.
template <typename OnSlot>
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
  z0 = fminf(z0, zmin);
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
