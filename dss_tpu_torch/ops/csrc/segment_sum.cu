// K4 — segment sum of per-slot values into per-point sums.
//
// Replaces dss_tpu/ops/splat_pallas.py:_segsum_matmul_kernel (launched by
// segment_sum_views_matmul): out[v, id, c] = Σ_n vals[v, c, n] over the
// slots n with seg[v, n] = id; ids outside [0, P) (−1 for an empty
// fragment) are dropped.  On the TPU the scatter was a one-hot matmul
// because scatters serialize there; Hopper has float atomics in L2.  The
// scatters of per-candidate partials (visibility, the occupancy and the
// feature gradients) are fused into the epilogues of K1, K2, K3 and K5;
// this kernel is left with the scatter no kernel produces: the fragment
// path's zbuf cotangent (V, S, S, K) to its points (the reference's
// _zbuf_backward, an XLA segment_sum in dss_tpu), C = 1.
//
// What bounds it on the H100: bytes — an id and C values per slot, each
// read once (8 B per slot at C = 1: 84 MB, 0.025 ms at 3.35 TB/s for
// 8 views of 512² × 5 fragments), and V·P·C sums written.  The depth L1's
// cotangent is non-zero only on the rank-0 fragment, and neighbouring
// pixels' rank-0 fragments are mostly the same splat.
//
// Design: one thread per 4 slots of a view, loading their ids and each
// channel's values 16 bytes at a time (N % 4 == 0, 16-byte aligned rows).
// For each of its 4 slots in turn the warp drops the slots whose values
// are all exactly 0 or whose id is out of range, merges the lanes holding
// the same id (__match_any_sync, then a shuffle tree over each group), and
// the lowest lane of each group adds its group's sums with one atomicAdd
// per non-zero channel into the zero-filled output.  Every lane of a warp
// takes part in the collectives: threads past the end hold id −1 and
// values 0 instead of returning.  The sums come in an order that changes
// from run to run.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float elem(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// Sums x over the lanes of this lane's group `peers` (a mask from
// __match_any_sync that holds this lane; 0 for a lane that takes no part)
// with a tree of shuffles: in round r every remaining lane adds the value
// of the next remaining peer above it, then the peers of odd rank within
// the remaining ones drop out.  The group's lowest lane ends with the
// whole sum.  Every lane of the warp calls it.
template <int C>
__device__ __forceinline__ void sum_peers(unsigned peers, float (&x)[C]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, or 0
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t = __shfl_sync(FULL, x[c], next ? next - 1 : lane);
      if (next) x[c] += t;
    }
    above &= ~__ballot_sync(FULL, rank & 1);
    rank >>= 1;
  }
}

template <int C>
__global__ void __launch_bounds__(256)
segment_sum_kernel(const float* __restrict__ vals,
                   const int* __restrict__ seg, float* __restrict__ out,
                   int n, int p) {
  const int v = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;  // slots 4q .. 4q + 3
  const int lane = threadIdx.x & 31;
  int4 id4 = make_int4(-1, -1, -1, -1);
  float4 x4[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (4 * q < n) {
    id4 = reinterpret_cast<const int4*>(seg + (size_t)v * n)[q];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* row = vals + ((size_t)v * C + c) * n;
      x4[c] = reinterpret_cast<const float4*>(row)[q];
    }
  }
  float* o = out + (size_t)v * p * C;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float x[C];
    bool nonzero = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x[c] = elem(x4[c], e);
      nonzero |= x[c] != 0.f;
    }
    const int raw = e == 0 ? id4.x : e == 1 ? id4.y : e == 2 ? id4.z : id4.w;
    const int id = nonzero && raw >= 0 && raw < p ? raw : -1;
    if (!__any_sync(FULL, id >= 0)) continue;
    const unsigned peers = __match_any_sync(FULL, id);
    sum_peers<C>(id >= 0 ? peers : 0u, x);
    if (id >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (x[c] != 0.f) atomicAdd(&o[(size_t)id * C + c], x[c]);
    }
  }
}

template <int C>
int launch(const float* vals, const int* seg, float* out, int n_views, int n,
           int p, cudaStream_t stream) {
  const dim3 grid((n / 4 + 255) / 256, n_views);
  if (grid.x == 0 || grid.y == 0) return 0;
  segment_sum_kernel<C><<<grid, 256, 0, stream>>>(vals, seg, out, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dss_segment_sum(const float* vals, const int* seg, float* out,
                               int n_views, int c, int n, int p,
                               cudaStream_t stream) {
  switch (c) {
    case 1: return launch<1>(vals, seg, out, n_views, n, p, stream);
    case 2: return launch<2>(vals, seg, out, n_views, n, p, stream);
    case 3: return launch<3>(vals, seg, out, n_views, n, p, stream);
    case 4: return launch<4>(vals, seg, out, n_views, n, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
