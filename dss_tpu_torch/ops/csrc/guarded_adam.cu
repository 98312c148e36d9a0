// guarded_adam — the train window's NaN-guarded Adam over every parameter
// tensor in one launch, and the finiteness guard in front of it.
//
// Replaces no Pallas kernel: in dss_tpu the update is optax.adam under the
// guard of dss_tpu/training/trainer.py:apply_update, which XLA fuses into
// the one program of the step.  The port's composite
// (training/trainer.py:guarded_adam_plain) runs each parameter group as its
// own chain of ~30 stock-torch kernels, and the guard as two more per
// gradient: ~95 graph nodes a step for the flagship's 3 leaves, ~560 for
// the neural texture's 18.
//
// Contracts.
//   all_finite_kernel: clears *finite where any element of any tensor is
//   NaN or infinite; it never sets it (the wrapper fills it with true).
//   guarded_adam_kernel: where *finite holds, one Adam step in optax's
//   order on each tensor, every operation a round-to-nearest intrinsic in
//   the composite's order, so that the two agree bit for bit:
//     μ = (1−b1)·g + b1·m;  ν = (1−b2)·(g·g) + b2·v;
//     μ̂ = μ / (1 − b1^(c+1));  ν̂ = ν / (1 − b2^(c+1));
//     lr = base_lr, times gamma once per milestone ≤ c (trainer.group_lr);
//     p ← p + μ̂ / (√ν̂ + eps) · (−lr);  m ← μ;  v ← ν;  c ← c + 1,
//   with c the tensor's float32 applied-update count.  Where *finite does
//   not hold it writes nothing, the counts included.  The constants come
//   from the host's doubles rounded to float32 once, as torch rounds a
//   Python scalar.
//
// What bounds it on the H100: bytes.  The update reads p, g, m, v and
// writes p, m, v: 28 B per element, 24 MB for the neural texture's 0.85 M
// (7 µs at 3.35 TB/s), ≪ 1 µs for the flagship's three 5000 × 3 leaves.
// The guard reads 4 B per element.  A launch costs more than that work:
// the design is about launches.
//
// Design: multi-tensor, as PyTorch's multi_tensor_apply.  The wrapper
// (ops/kernels.py) plans the launches: each tensor gets ⌈n / CHUNK⌉
// blocks (at least one), a launch holds at most MAX_TENSORS tensors
// (MAX_FINITE for the guard), and the tensors of one launch take
// consecutive blocks.  The launcher packs a launch's tensors (pointers,
// sizes, first blocks and constants) into a struct passed by value, under
// the 4 KB of a kernel's parameters (`__grid_constant__`: read where it
// lies, never copied per thread), so a CUDA graph captures the values and
// no host-to-device copy runs.  A block finds its tensor by a scan of
// the first blocks and walks its chunk, UNROLL loads per thread in flight.
// The count is read once per block; the last block of a tensor to finish,
// found by an atomic ticket, writes c + 1 and puts the ticket back to 0.
// No block reads a count that another block of its launch has written:
// every block takes its ticket after its read.  The tickets are zeros
// that every complete launch leaves as it found them (one set per
// optimizer, training/trainer.py).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // elements per block: ops/kernels.py MT_CHUNK
constexpr int UNROLL = 4;
constexpr int MAX_TENSORS = 32;  // per update launch: ADAM_MAX_TENSORS
constexpr int MAX_MILESTONES = 8;  // ADAM_MAX_MILESTONES
constexpr int MAX_FINITE = 128;  // per guard launch: FINITE_MAX_TENSORS

// One tensor of an update launch, as the kernel reads it.
struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* count;
  long long n;
  int first_block;
  int n_milestones;
  float one_minus_b1, b1, one_minus_b2, b2, eps, base_lr, gamma;
  float milestones[MAX_MILESTONES];
};

struct AdamBatch {
  int n_tensors;
  AdamTensor t[MAX_TENSORS];
};

struct FiniteTensor {
  const float* x;
  long long n;
  long long first_block;
};

struct FiniteBatch {
  int n_tensors;
  FiniteTensor t[MAX_FINITE];
};

static_assert(sizeof(AdamBatch) + 2 * sizeof(void*) <= 4096,
              "the update's arguments exceed a kernel's 4 KB");
static_assert(sizeof(FiniteBatch) + sizeof(void*) <= 4096,
              "the guard's arguments exceed a kernel's 4 KB");

// The tensor that block b of a launch works on: the last whose first
// block is ≤ b.
template <typename Batch>
__device__ __forceinline__ int tensor_of(const Batch& batch, long long b) {
  int i = 0;
  while (i + 1 < batch.n_tensors && batch.t[i + 1].first_block <= b) ++i;
  return i;
}

__global__ void __launch_bounds__(THREADS)
    all_finite_kernel(const __grid_constant__ FiniteBatch batch, bool* finite) {
  const int i = tensor_of(batch, blockIdx.x);
  const float* __restrict__ x = batch.t[i].x;
  const long long start =
      ((long long)blockIdx.x - batch.t[i].first_block) * CHUNK;
  const long long end = min(start + CHUNK, batch.t[i].n);
  bool bad = false;
  for (long long j0 = start + threadIdx.x; j0 < end; j0 += THREADS * UNROLL) {
    float e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = j0 + (long long)u * THREADS;
      e[u] = j < end ? x[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) bad |= !isfinite(e[u]);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *finite = false;
}

__global__ void __launch_bounds__(THREADS)
    guarded_adam_kernel(const __grid_constant__ AdamBatch batch,
                        const bool* finite, int* tickets) {
  if (!*finite) return;  // the same for every block: no ticket is taken
  const int i = tensor_of(batch, blockIdx.x);
  const AdamTensor& t = batch.t[i];
  __shared__ float count;
  if (threadIdx.x == 0) count = *t.count;
  __syncthreads();
  const float c = count;
  const float c1 = __fadd_rn(c, 1.0f);
  const float bc1 = __fsub_rn(1.0f, powf(t.b1, c1));
  const float bc2 = __fsub_rn(1.0f, powf(t.b2, c1));
  float lr = t.base_lr;
  for (int k = 0; k < t.n_milestones; ++k)
    if (!(c < t.milestones[k])) lr = __fmul_rn(t.gamma, lr);
  const float neg_lr = -lr;

  float* __restrict__ P = t.p;
  const float* __restrict__ G = t.g;
  float* __restrict__ M = t.m;
  float* __restrict__ V = t.v;
  const long long start = ((long long)blockIdx.x - t.first_block) * CHUNK;
  const long long end = min(start + CHUNK, t.n);
  for (long long j0 = start + threadIdx.x; j0 < end; j0 += THREADS * UNROLL) {
    float p[UNROLL], g[UNROLL], m[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = j0 + (long long)u * THREADS;
      if (j < end) {
        p[u] = P[j];
        g[u] = G[j];
        m[u] = M[j];
        v[u] = V[j];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = j0 + (long long)u * THREADS;
      if (j < end) {
        const float mu = __fadd_rn(__fmul_rn(t.one_minus_b1, g[u]),
                                   __fmul_rn(t.b1, m[u]));
        const float nu =
            __fadd_rn(__fmul_rn(t.one_minus_b2, __fmul_rn(g[u], g[u])),
                      __fmul_rn(t.b2, v[u]));
        const float mu_hat = __fdiv_rn(mu, bc1);
        const float nu_hat = __fdiv_rn(nu, bc2);
        const float step = __fmul_rn(
            __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), t.eps)), neg_lr);
        P[j] = __fadd_rn(p[u], step);
        M[j] = mu;
        V[j] = nu;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long next = i + 1 < batch.n_tensors ? batch.t[i + 1].first_block
                                                  : (long long)gridDim.x;
    __threadfence();
    if (atomicAdd(&tickets[i], 1) == (int)(next - t.first_block) - 1) {
      *t.count = c1;
      tickets[i] = 0;
    }
  }
}

}  // namespace

// One tensor of an update launch as the host gives it (ops/kernels.py
// _AdamEntry, field for field): the group's hyper-parameters as Python's
// doubles, the milestones sorted and unique.
struct AdamEntry {
  void* p;
  void* g;
  void* m;
  void* v;
  void* count;
  long long n;
  long long first_block;
  double b1, b2, eps, base_lr, gamma;
  long long n_milestones;
  double milestones[MAX_MILESTONES];
};

// ops/kernels.py _FiniteEntry.
struct FiniteEntry {
  void* x;
  long long n;
  long long first_block;
};

extern "C" int dss_guarded_adam(const AdamEntry* entries, int n_tensors,
                                int n_blocks, const bool* finite,
                                int* tickets, cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > MAX_TENSORS || n_blocks < n_tensors)
    return (int)cudaErrorInvalidValue;
  AdamBatch batch;
  batch.n_tensors = n_tensors;
  for (int i = 0; i < n_tensors; ++i) {
    const AdamEntry& e = entries[i];
    AdamTensor& t = batch.t[i];
    if (e.n_milestones < 0 || e.n_milestones > MAX_MILESTONES)
      return (int)cudaErrorInvalidValue;
    t.p = (float*)e.p;
    t.g = (const float*)e.g;
    t.m = (float*)e.m;
    t.v = (float*)e.v;
    t.count = (float*)e.count;
    t.n = e.n;
    t.first_block = (int)e.first_block;
    t.n_milestones = (int)e.n_milestones;
    t.one_minus_b1 = (float)(1.0 - e.b1);
    t.b1 = (float)e.b1;
    t.one_minus_b2 = (float)(1.0 - e.b2);
    t.b2 = (float)e.b2;
    t.eps = (float)e.eps;
    t.base_lr = (float)e.base_lr;
    t.gamma = (float)e.gamma;
    for (int k = 0; k < MAX_MILESTONES; ++k)
      t.milestones[k] = k < e.n_milestones ? (float)e.milestones[k] : 0.0f;
  }
  guarded_adam_kernel<<<n_blocks, THREADS, 0, stream>>>(batch, finite,
                                                        tickets);
  return (int)cudaGetLastError();
}

extern "C" int dss_all_finite(const FiniteEntry* entries, int n_tensors,
                              int n_blocks, bool* finite,
                              cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > MAX_FINITE || n_blocks < n_tensors)
    return (int)cudaErrorInvalidValue;
  FiniteBatch batch;
  batch.n_tensors = n_tensors;
  for (int i = 0; i < n_tensors; ++i) {
    batch.t[i].x = (const float*)entries[i].x;
    batch.t[i].n = entries[i].n;
    batch.t[i].first_block = entries[i].first_block;
  }
  all_finite_kernel<<<n_blocks, THREADS, 0, stream>>>(batch, finite);
  return (int)cudaGetLastError();
}
