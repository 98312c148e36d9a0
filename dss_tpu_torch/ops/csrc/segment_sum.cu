// K4 — segment sum of per-candidate partials into per-point sums.
//
// Replaces dss_tpu/ops/splat_pallas.py:_segsum_matmul_kernel (launched by
// segment_sum_views_matmul): out[v, id, c] = Σ_n vals[v, c, n] over the
// table slots n with seg[v, n] = id; id = P is the dump bucket of empty
// slots and is dropped.  On the TPU the scatter was a one-hot matmul
// because scatters serialize there; Hopper has float atomics.
//
// What bounds it on the H100: device-memory traffic and atomic
// throughput — (C + 1)·4 bytes read per slot and one atomicAdd per live
// slot and channel (8 × 131k slots at the flagship shape, 4 MB per
// channel); the per-point output (V·P·C floats) stays in L2.
//
// Design: one thread per (view, slot), looping over the C channels, with
// a global atomicAdd into the zero-filled output.  Fusing the scatter into
// the epilogues of K1–K3 is later work; here it stays a kernel of its own.
#include "common.cuh"

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ seg,
                                   float* __restrict__ out, int c, int n,
                                   int p) {
  const int v = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = seg[(size_t)v * n + i];
  if (id < 0 || id >= p) return;
  for (int ch = 0; ch < c; ++ch) {
    const float x = vals[((size_t)v * c + ch) * n + i];
    if (x != 0.0f) atomicAdd(&out[((size_t)v * p + id) * c + ch], x);
  }
}

}  // namespace

extern "C" int dss_segment_sum(const float* vals, const int* seg, float* out,
                               int n_views, int c, int n, int p,
                               cudaStream_t stream) {
  const dim3 grid((n + 255) / 256, n_views);
  segment_sum_kernel<<<grid, 256, 0, stream>>>(vals, seg, out, c, n, p);
  return (int)cudaGetLastError();
}
