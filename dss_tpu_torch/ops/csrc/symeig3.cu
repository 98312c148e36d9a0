// symeig3 — batched symmetric 3×3 eigendecomposition.
//
// Replaces no Pallas kernel: in dss_tpu the operation is XLA's
// jnp.linalg.eigh (dss_tpu/geometry/normals.py:estimate_local_coord_frames,
// dss_tpu/utils/mathutil.py:symeig3x3).  The port cannot leave it to the
// library: PyTorch's eigh reads its error flags on the host, so a CUDA
// graph capture refuses it, and the anisotropic Vrk and the PCA normal
// anchor call it every train step.  This kernel reads nothing on the host.
//
// Contract (jnp.linalg.eigh's): mats (N, 3, 3) float32, contiguous,
// symmetric, of which only the lower triangle is read; w (N, 3) the
// eigenvalues in ascending order, v (N, 3, 3) the eigenvectors as columns.
// A zero matrix gives w = 0 and v = I; a matrix with a NaN or an infinite
// entry gives NaN in all of its w and v.
//
// Algorithm: cyclic Jacobi in the row order (0,1), (0,2), (1,2), at most
// SWEEPS sweeps, with Golub & Van Loan's stable rotation (sym.schur2):
// τ = (a_qq − a_pp) / 2a_pq, t = sign(τ) / (|τ| + √(τ² + 1)), and
// t = sign(τ) / 2|τ| where τ² would overflow.  A rotation whose a_pq is
// zero, or too small to move |a_pp| and |a_qq| even when multiplied by 100,
// is skipped.  A sweep that rotates nothing leaves the matrix as it was, so
// every later sweep would skip too: the loop stops there, with the result
// of the plain version's fixed SWEEPS sweeps.  Then the eigenpairs are
// sorted ascending by a stable 3-element network (index order at ties).
// Not Cardano's closed form: its absolute error is ~eps·λmax, and the
// smallest eigenvalue, whose eigenvector is the normal of a planar
// neighbourhood, is the one that matters here.  Jacobi in float32 lands
// nearer a float64 solve than LAPACK's float32 answer does.
//
// Rounding: every operation is a round-to-nearest intrinsic in the order
// of ops/kernels.py:symeig3_plain (the library builds with -fmad=false),
// so the kernel and the plain version agree bit for bit.
//
// What bounds it on the H100: bytes — 36 B read and 48 B written per
// matrix (0.025 ms for 10⁶ matrices at 3.35 TB/s).  A rotation is ~40
// float operations, at most 3 · SWEEPS of them per matrix (~1000 ops,
// 0.015 ms for 10⁶ matrices at 67 TFLOP/s).  At the main path's N = P
// (5000 points) the launch itself dominates.
//
// Design: one thread per matrix, everything in registers (the rotation
// index triples are template arguments, so the arrays never spill to local
// memory).  Loads and stores go straight to device memory: a warp's 32
// matrices are 1152 contiguous bytes, which L1 serves to the nine strided
// loads.  The per-matrix branching (skips, early stop, sort) is why this
// is not a Triton kernel.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int SWEEPS = 8;        // ops/kernels.py SYMEIG3_SWEEPS
constexpr float HUGE_TAU = 0x1p60f;  // above it τ² + 1 is not formed

__device__ __forceinline__ bool negligible(float apq, float app, float aqq) {
  const float g = __fmul_rn(100.0f, fabsf(apq));
  return apq == 0.0f || (__fadd_rn(fabsf(app), g) == fabsf(app) &&
                         __fadd_rn(fabsf(aqq), g) == fabsf(aqq));
}

// One Jacobi rotation in the plane (P, Q); R is the third index.  d holds
// the diagonal, o[i] the off-diagonal entry of the pair without i, and
// v[k][j] component k of eigenvector j.  Returns whether it rotated.
template <int P, int Q, int R>
__device__ __forceinline__ bool rotate(float (&d)[3], float (&o)[3],
                                       float (&v)[3][3]) {
  const float apq = o[R], app = d[P], aqq = d[Q];
  if (negligible(apq, app, aqq)) return false;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fadd_rn(apq, apq));
  const float at = fabsf(tau);
  const float tabs =
      at > HUGE_TAU
          ? __fmul_rn(__frcp_rn(at), 0.5f)
          : __frcp_rn(__fadd_rn(at, __fsqrt_rn(__fadd_rn(__fmul_rn(at, at),
                                                         1.0f))));
  const float t = tau >= 0.0f ? tabs : -tabs;
  const float c = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.0f)));
  const float s = __fmul_rn(t, c);
  const float tapq = __fmul_rn(t, apq);
  d[P] = __fsub_rn(app, tapq);
  d[Q] = __fadd_rn(aqq, tapq);
  o[R] = 0.0f;
  const float arp = o[Q], arq = o[P];
  o[Q] = __fsub_rn(__fmul_rn(c, arp), __fmul_rn(s, arq));
  o[P] = __fadd_rn(__fmul_rn(s, arp), __fmul_rn(c, arq));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float vkp = v[k][P], vkq = v[k][Q];
    v[k][P] = __fsub_rn(__fmul_rn(c, vkp), __fmul_rn(s, vkq));
    v[k][Q] = __fadd_rn(__fmul_rn(s, vkp), __fmul_rn(c, vkq));
  }
  return true;
}

// Swaps eigenpairs I and J where d[J] < d[I] (not at ties, not on NaN).
template <int I, int J>
__device__ __forceinline__ void order(float (&d)[3], float (&v)[3][3]) {
  if (d[J] < d[I]) {
    const float t = d[I];
    d[I] = d[J];
    d[J] = t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float u = v[k][I];
      v[k][I] = v[k][J];
      v[k][J] = u;
    }
  }
}

__global__ void __launch_bounds__(256)
symeig3_kernel(const float* __restrict__ mats, float* __restrict__ w_out,
               float* __restrict__ v_out, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* a = mats + (size_t)i * 9;
  float d[3] = {a[0], a[4], a[8]};
  float o[3] = {a[7], a[6], a[3]};  // pairs (1,2), (0,2), (0,1)
  float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  float* w = w_out + (size_t)i * 3;
  float* vo = v_out + (size_t)i * 9;
  const bool finite = isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]) &&
                      isfinite(o[0]) && isfinite(o[1]) && isfinite(o[2]);
  if (!finite) {
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = CUDART_NAN_F;
#pragma unroll
    for (int k = 0; k < 9; ++k) vo[k] = CUDART_NAN_F;
    return;
  }
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    bool rotated = rotate<0, 1, 2>(d, o, v);
    rotated |= rotate<0, 2, 1>(d, o, v);
    rotated |= rotate<1, 2, 0>(d, o, v);
    if (!rotated) break;
  }
  order<0, 1>(d, v);
  order<1, 2>(d, v);
  order<0, 1>(d, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = d[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) vo[k * 3 + j] = v[k][j];
}

}  // namespace

extern "C" int dss_symeig3(const float* mats, float* w, float* v, int n,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255LL) / 256);
  symeig3_kernel<<<blocks, 256, 0, stream>>>(mats, w, v, n);
  return (int)cudaGetLastError();
}
