// knn_topk — the exact k nearest neighbours of a masked brute force, with
// the distances, the masks and the top-k selection fused in one kernel.
//
// Replaces no Pallas kernel: in dss_tpu the brute force is plain XLA
// (dss_tpu/geometry/knn.py:knn_points, a distance matmul and lax.top_k).
// The port's plain version (ops/kernels.py:knn_topk_plain) writes the
// Q × P float32 matrix |q|² + |r|² − 2 q·r to device memory, passes over
// it about eight times to mask it, and radix-selects over it with
// torch.topk: ~2 GB of traffic for a 5000² kNN, which runs twice in every
// train step.  This kernel keeps each distance in a register.
//
// Contract (ops/kernels.py:knn_topk_plain's, bit for bit): query (Q, 3),
// ref (P, 3) float32; qq (Q) and rr (P) their squared norms, computed by
// the wrapper with the plain version's torch expression; optional bool
// masks (Q) and (P).  For each query the k ≤ 128 smallest d = max((qq +
// rr) − 2·dot, 0) over the unmasked refs (without the query's own row when
// exclude_self), ascending, equal distances by lower index; a NaN distance
// ranks first (torch.topk's order).  Slots past min(k, P), slots whose
// distance is inf and the rows of masked queries read (inf, −1).  The dot
// is the FFMA chain cuBLAS's float32 GEMM runs for K = 3 (one product,
// then two fused multiply-adds, in coordinate order), and every step is a
// round-to-nearest intrinsic (the library builds with -fmad=false).
//
// What bounds it on the H100: operations.  ~8 float operations per
// (query, ref) pair: 0.2 GFLOP for a 5000² kNN, 3 µs at 67 TFLOP/s; the
// inputs are 16 B per point (80 KB at 5000 points), read once from device
// memory and then from shared memory.  The selection is the hard part: a
// candidate must be kept in order among the best k found so far.
//
// Design: one warp per query (more for few queries, below).  The block's
// 256 threads stage 1024 refs at a time in shared memory as float4
// (x, y, z, |r|²; a masked ref as (0, 0, 0, inf)); lane l of a warp takes
// refs l, l + 32, … of the tile, so a warp reads 32 consecutive float4s,
// four per step (independent chains, and one branch per four).  The k
// best of the warp's query live in a sorted warp-wide list of 32, 64 or
// 128 keys (one, two or four per lane, by k) of 64 bits: the distance's
// bits, ordered, above the ref's index, so one unsigned compare orders by
// distance, then index.  Each candidate is first tested against the
// list's k-th key, so after the first few tiles almost none pass; a warp
// vote collects the ones that do, and each goes into the list by one
// broadcast and one shuffle up (every rank above it moves up a lane).
// While the list fills, a step with more than 8 candidates sorts them
// with a 32-lane bitonic network and merges them in instead (the 32
// smallest of two sorted warp lists are one reversed min and five shuffle
// stages away).  A list per thread would insert on nearly every warp
// step: each of the 32 lanes would keep its own k best of a thin slice of
// the refs.  Slices per query come from Q and P, which the entry point
// observes: a query takes 1, 2, 4 or 8 warps (32 to 256 interleaved
// slices), doubling while the queries alone give fewer than 32 warps per
// SM and every lane still scans 32 refs; the warps of one query merge
// their lists in shared memory at the end.  No tensor cores: K = 3 is
// degenerate for wgmma, and the recipes forbid TF32.  It reads nothing on
// the host and allocates nothing, so a CUDA graph captures it.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;  // per block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 1024;  // refs staged in shared memory per pass
constexpr int MAX_SLOTS = 4;  // list slots per lane: k ≤ 32 · MAX_SLOTS
constexpr int MAX_WARPS_PER_QUERY = WARPS;
constexpr int TARGET_WARPS_PER_SM = 32;
constexpr int MIN_REFS_PER_LANE = 32;
constexpr int BULK = 8;  // more candidates at once: sort and merge
constexpr int UNROLL = 4;  // refs per lane and warp step
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 EMPTY = ~0ull;  // no candidate: above every key
// Distance codes: a NaN first, then the distance's bits + 2 (+0 → 2,
// inf → INF_CODE), which order as the non-negative floats do.
constexpr unsigned NAN_CODE = 1u;
constexpr unsigned INF_CODE = 0x7f800000u + 2u;

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }

__device__ __forceinline__ u64 make_key(float d, unsigned j) {
  const unsigned u = __float_as_uint(d);
  const unsigned code = u > 0x7f800000u ? NAN_CODE : u + 2u;
  return ((u64)code << 32) | j;
}

// Ascending bitonic sort of one key per lane.
__device__ __forceinline__ u64 warp_sort(u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(FULL, v, stride);
      const bool low = (lane & stride) == 0;
      const bool up = (lane & size) == 0;
      v = low == up ? umin(v, o) : umax(v, o);
    }
  }
  return v;
}

// A bitonic sequence over the lanes, sorted ascending: five half-cleaners.
__device__ __forceinline__ u64 warp_clean(u64 v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(FULL, v, stride);
    v = (lane & stride) == 0 ? umin(v, o) : umax(v, o);
  }
  return v;
}

// The list: 32 · SLOTS keys in ascending order, slot s of lane l holding
// rank 32·s + l.

// Merge 32 keys sorted over the lanes into the list, keeping the smallest.
// The elementwise min of a sorted slot and the keys reversed holds the 32
// smallest of the two (a bitonic sequence), the max the 32 largest, which
// go on to the next slot.
template <int SLOTS>
__device__ __forceinline__ void merge_sorted(u64 (&list)[SLOTS], u64 c,
                                             int lane) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const u64 r = __shfl_sync(FULL, c, 31 - lane);
    const u64 lo = umin(list[s], r), hi = umax(list[s], r);
    list[s] = warp_clean(lo, lane);
    if (s + 1 < SLOTS) c = warp_clean(hi, lane);
  }
}

// Insert the candidates of the lanes in `hits` (each lane's own `key`).
// One at a time, a candidate moves every rank above it up by one lane: a
// broadcast, a shuffle up and two compares per slot.  More than BULK at
// once (the first refs of a query, while the list fills) are sorted with
// a bitonic network and merged instead.
template <int SLOTS>
__device__ __forceinline__ void insert(u64 (&list)[SLOTS], u64 key,
                                       unsigned hits, int lane) {
  if (__popc(hits) > BULK) {
    merge_sorted(list, warp_sort((hits >> lane) & 1u ? key : EMPTY, lane),
                 lane);
    return;
  }
  while (hits) {
    const int src = __ffs(hits) - 1;
    hits &= hits - 1;
    const u64 c = __shfl_sync(FULL, key, src);
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; --s) {  // the slot below still as it was
      u64 prev = __shfl_up_sync(FULL, list[s], 1);
      const u64 below = s ? __shfl_sync(FULL, list[s - 1], 31) : 0ull;
      if (lane == 0) prev = below;
      list[s] = c < prev ? prev : (c < list[s] ? c : list[s]);
    }
  }
}

// The key of rank r, in every lane.
template <int SLOTS>
__device__ __forceinline__ u64 rank_key(const u64 (&list)[SLOTS], int r) {
  u64 v = list[0];
#pragma unroll
  for (int s = 1; s < SLOTS; ++s)
    if (s == r >> 5) v = list[s];
  return __shfl_sync(FULL, v, r & 31);
}

// The key of the pair (query, staged ref r): d = max((qq + rr) − 2·dot, 0)
// rounded as the plain version rounds it.
__device__ __forceinline__ u64 pair_key(float q0, float q1, float q2, float qn,
                                        const float4& r, int g) {
  const float dot = __fmaf_rn(q2, r.z, __fmaf_rn(q1, r.y, __fmul_rn(q0, r.x)));
  float d = __fsub_rn(__fadd_rn(qn, r.w), __fmul_rn(2.0f, dot));
  d = d <= 0.0f ? 0.0f : d;  // torch.clamp(min=0) keeps a NaN
  return make_key(d, (unsigned)g);
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS, SLOTS == 1 ? 5 : 4)
    knn_topk_kernel(const float* __restrict__ query,
                    const float* __restrict__ qq,
                    const bool* __restrict__ qmask,
                    const float* __restrict__ ref,
                    const float* __restrict__ rr,
                    const bool* __restrict__ rmask, float* __restrict__ out_d,
                    long long* __restrict__ out_i, int nq, int np, int k,
                    int lk, int wpq, int exclude_self) {
  __shared__ float4 tile[TILE];
  __shared__ u64 lists[WARPS][SLOTS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = warp % wpq;  // this warp's share of the query's refs
  const long long row = (long long)blockIdx.x * (WARPS / wpq) + warp / wpq;
  const bool in_range = row < nq;
  const int q = in_range ? (int)row : 0;
  const bool live = in_range && (qmask == nullptr || qmask[q]);
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, qn = 0.0f;
  if (live) {
    q0 = query[3 * (size_t)q];
    q1 = query[3 * (size_t)q + 1];
    q2 = query[3 * (size_t)q + 2];
    qn = qq[q];
  }
  const int slices = 32 * wpq, slice = 32 * part + lane;
  const int step = UNROLL * slices;  // refs of the query per warp step
  // A masked ref (and the padding of the last tile) is staged at distance
  // inf, so it cannot pass a finite k-th key; its index is checked only
  // while the list holds fewer than k finite keys, or for a query with a
  // non-finite |q|² (whose distances to it are NaN).
  const int self = exclude_self ? q : -1;
  const bool finite_q = fabsf(qn) < CUDART_INF_F;
  const u64 finite_tau = (u64)INF_CODE << 32;  // keys below: finite d
  u64 list[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) list[s] = EMPTY;
  u64 tau = EMPTY;  // the k-th key so far

  for (int base = 0; base < np; base += TILE) {
    // the tile padded to whole steps (TILE is a multiple of every step)
    const int n = min(TILE, np - base), padded = (n + step - 1) / step * step;
    __syncthreads();  // the previous tile is read
    for (int j = threadIdx.x; j < padded; j += THREADS) {
      const size_t g = (size_t)base + j;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
      if (j < n && (rmask == nullptr || rmask[g]))
        v = make_float4(ref[3 * g], ref[3 * g + 1], ref[3 * g + 2], rr[g]);
      tile[j] = v;
    }
    __syncthreads();
    if (!live) continue;  // the whole warp: one query per warp
    const float4* mine = tile + slice;
    for (int j = 0; j < padded; j += step) {
      u64 key[UNROLL];
      unsigned hit[UNROLL], any = 0u;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int g = base + j + u * slices + slice;
        key[u] = pair_key(q0, q1, q2, qn, mine[j + u * slices], g);
        hit[u] = __ballot_sync(FULL, key[u] < tau && g != self);
        any |= hit[u];
      }
      if (any) {  // rare once the list holds k keys
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (!hit[u]) continue;
          // against the k-th key as the earlier refs of the step left it
          const int g = base + j + u * slices + slice;
          bool ok = key[u] < tau && g != self;
          if (ok && !(finite_q && tau < finite_tau))
            ok = g < np && (rmask == nullptr || rmask[g]);
          const unsigned hits = __ballot_sync(FULL, ok);
          if (hits) {
            insert(list, key[u], hits, lane);
            tau = rank_key(list, lk - 1);
          }
        }
      }
    }
  }

  if (wpq > 1) {  // the same for the whole block
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) lists[warp][s][lane] = list[s];
    __syncthreads();
    if (part == 0 && live)
      for (int p = 1; p < wpq; ++p)
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          merge_sorted(list, lists[warp + p][s][lane], lane);
  }
  if (part != 0 || !in_range) return;
  const size_t out = (size_t)q * k;
  for (int r = lane; r < k; r += 32) {
    u64 key = EMPTY;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (s == r >> 5) key = list[s];
    if (!live || r >= lk) key = EMPTY;
    const unsigned code = (unsigned)(key >> 32);
    float d = CUDART_INF_F;
    long long i = -1;
    if (code == NAN_CODE) {
      d = CUDART_NAN_F;
      i = (long long)(unsigned)key;
    } else if (code < INF_CODE) {
      d = __uint_as_float(code - 2u);
      i = (long long)(unsigned)key;
    }
    out_d[out + r] = d;
    out_i[out + r] = i;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for min(k, P) above 32 · MAX_SLOTS).  qmask and
// rmask may be null: every query and every ref valid.
extern "C" int dss_knn_topk(const float* query, const float* qq,
                            const bool* qmask, const float* ref,
                            const float* rr, const bool* rmask, float* out_d,
                            long long* out_i, int nq, int np, int k,
                            int exclude_self, cudaStream_t stream) {
  if (nq <= 0 || k <= 0) return 0;
  const int lk = np < k ? np : k;
  if (lk > 32 * MAX_SLOTS || np < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  int wpq = 1;
  while (wpq < MAX_WARPS_PER_QUERY &&
         (long long)nq * wpq < (long long)TARGET_WARPS_PER_SM * n_sm &&
         (long long)np >= 2LL * wpq * 32 * MIN_REFS_PER_LANE)
    wpq *= 2;
  const int per_block = WARPS / wpq;
  const unsigned blocks = (unsigned)((nq + (long long)per_block - 1) / per_block);
  if (lk <= 32)
    knn_topk_kernel<1><<<blocks, THREADS, 0, stream>>>(
        query, qq, qmask, ref, rr, rmask, out_d, out_i, nq, np, k, lk, wpq,
        exclude_self);
  else if (lk <= 64)
    knn_topk_kernel<2><<<blocks, THREADS, 0, stream>>>(
        query, qq, qmask, ref, rr, rmask, out_d, out_i, nq, np, k, lk, wpq,
        exclude_self);
  else
    knn_topk_kernel<MAX_SLOTS><<<blocks, THREADS, 0, stream>>>(
        query, qq, qmask, ref, rr, rmask, out_d, out_i, nq, np, k, lk, wpq,
        exclude_self);
  return (int)cudaGetLastError();
}
