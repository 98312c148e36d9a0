// bin_tiles — the tile binning of ops/splat.py (bin_splats, the forward and
// the occupancy-backward candidate tables) and the support radius's median
// (masked_median), on the card.
//
// Replaces no Pallas kernel: in dss_tpu the binning is XLA's sort, cumsum
// and gathers around the kernels (dss_tpu/ops/splat_pallas.py:bin_splats,
// bin_for_occ_backward, masked_median).  In PyTorch the same ops cost
// ~230 stock launches a table (a stable sort of fused keys, searchsorted,
// gathers, a `where` with the sentinel row and a permute copy) and three
// full copies of a table that is mostly padding.
//
// Contract: bit-equal to ops/splat.py:bin_splats_plain and
// masked_median_plain at every shape.  The plain version sorts every
// (tile, splat) pair of a view stably by one fused key (tile, quantized
// depth) or by the tile alone.  Within one tile the remaining key is
// unique: a splat lands in a tile at most once, so (zq, point id) — or the
// point id alone — orders the tile's candidates exactly as the stable
// sort's pair order does.  Hence no global sort: any exact sort of a
// tile's candidates by that key gives the plain version's order, and the
// atomic order in which the pairs were scattered leaks into nothing.
//
// Kernels (one table: four launches after the wrapper's zero fill):
//   bin_sort_count_kernel    one thread per (view, point): the live test,
//                            the tile span, the span overflow, the view's
//                            live z range (ordered-int atomics: exact), an
//                            atomicAdd per pair into the (V, n_tiles) count;
//   bin_sort_scan_kernel     one block per view: the tiles' offsets, the
//                            counts truncated by the pair cap and the tile
//                            capacity, the three overflow terms, the tiles
//                            whose segment is too long for shared memory
//                            (summed into the persistent counter);
//   bin_sort_scatter_kernel  one thread per (view, point): each live pair's
//                            unique key into its tile's segment at an atomic
//                            cursor, unordered (tiles past the pair cap skip);
//   bin_sort_tiles_kernel    one block per (view, tile): the segment sorted
//                            (bitonic, in shared memory; longer segments by
//                            radix selection over device memory in rounds
//                            that each fill shared memory), the first
//                            `count` keys written as channel rows straight
//                            into the (V, n_tiles, C, M) layout, the
//                            sentinel row in the empty slots, the int32 ids.
//   median_sort_select_kernel  one block per view: the two middle order
//                            statistics of the masked values (masked-out as
//                            +inf, NaN above it, as torch.sort places them)
//                            by radix selection, their mean, and with a
//                            scale the support radius r and r².
//
// Rounding: every float operation is a round-to-nearest intrinsic in the
// plain version's order (the library also builds with -fmad=false); `/` is
// IEEE division.  NaN coordinates land where torch's clamp and cast put
// them (tile 0).
//
// What bounds it on the H100: bytes — the two tables are written whole,
// (V, n_tiles, 14 + 1, M) + (V, n_tiles, 5 + 1, M) words, 88 MB a flagship
// step (0.026 ms at 3.35 TB/s); the pairs' integer work is a few hundred
// thousand atomics and keys.  The design writes each table once, coalesced
// along the slots, and keeps the keys' sort inside each tile's block.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ID_BITS = 24;  // point ids < 2²⁴ (ops/kernels.py MAX_POINTS)
constexpr uint32_t ID_MASK = (1u << ID_BITS) - 1;
constexpr int SORT_SMEM_BYTES = 32768;  // ops/kernels.py BIN_SMEM_BYTES
constexpr int POINT_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int TILE_THREADS = 256;
constexpr int MEDIAN_THREADS = 1024;
constexpr int STATS = 3;  // per view: span overflow, ~min z key, max z key
constexpr unsigned FULL = 0xffffffffu;

struct Raster {
  int image_size, tile, nt, rx_max, ry_max;
};

// ops/splat.py ndc_to_pixel: (S·(1 − x) − 1)·0.5.
__device__ __forceinline__ float ndc_to_pixel(float x, float s) {
  return __fmul_rn(__fsub_rn(__fmul_rn(s, __fsub_rn(1.0f, x)), 1.0f), 0.5f);
}

// ops/splat.py _tile_index: floor(c / tile) clamped to [−1, nt] as a float,
// cast, clamped to [0, nt − 1]; a NaN casts to a value the clamp sends to 0.
__device__ __forceinline__ int tile_index(float c, float tile, int nt) {
  const float f = floorf(__fdiv_rn(c, tile));
  if (f != f) return 0;
  const int i = (int)fminf(fmaxf(f, -1.0f), (float)nt);
  return min(max(i, 0), nt - 1);
}

// Monotone unsigned key of a float (−0 just below +0).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// A point's tiles in one view: ops/splat.py _sorted_pairs.
struct Span {
  bool live, span_over;
  int tx_lo, tx_hi, ty_lo, ty_hi;
  float pz;
};

__device__ __forceinline__ Span point_span(
    const float* __restrict__ pts, const float* __restrict__ radii,
    const unsigned char* __restrict__ visible, const float* __restrict__ extra,
    float extra_s, int v, size_t vp, const Raster& g) {
  Span sp;
  const float px = pts[vp * 3], py = pts[vp * 3 + 1];
  sp.pz = pts[vp * 3 + 2];
  const float e = extra ? extra[v] : extra_s;
  const float rx = __fadd_rn(radii[vp * 2], e);
  const float ry = __fadd_rn(radii[vp * 2 + 1], e);
  const float s = (float)g.image_size;
  const float cx_lo = ndc_to_pixel(__fadd_rn(px, rx), s);
  const float cx_hi = ndc_to_pixel(__fsub_rn(px, rx), s);
  const float cy_lo = ndc_to_pixel(__fadd_rn(py, ry), s);
  const float cy_hi = ndc_to_pixel(__fsub_rn(py, ry), s);
  const float last = (float)(g.image_size - 1);
  const bool offscreen =
      cx_hi < 0.0f || cx_lo > last || cy_hi < 0.0f || cy_lo > last;
  sp.live = (visible == nullptr || visible[vp] != 0) && rx > 0.0f &&
            sp.pz >= 0.0f && !offscreen;
  const float t = (float)g.tile;
  sp.tx_lo = tile_index(cx_lo, t, g.nt);
  sp.tx_hi = tile_index(cx_hi, t, g.nt);
  sp.ty_lo = tile_index(cy_lo, t, g.nt);
  sp.ty_hi = tile_index(cy_hi, t, g.nt);
  sp.span_over = (sp.tx_hi - sp.tx_lo + 1 > g.rx_max) ||
                 (sp.ty_hi - sp.ty_lo + 1 > g.ry_max);
  return sp;
}

__global__ void __launch_bounds__(POINT_THREADS)
bin_sort_count_kernel(const float* __restrict__ pts,
                      const float* __restrict__ radii,
                      const unsigned char* __restrict__ visible,
                      const float* __restrict__ extra, float extra_s,
                      int* __restrict__ counts, int* __restrict__ stats, int P,
                      Raster g, int sort_by_depth) {
  const int v = blockIdx.y;
  const int p = blockIdx.x * POINT_THREADS + threadIdx.x;
  const int n_tiles = g.nt * g.nt;
  bool live = false;
  float pz = 0.0f;
  if (p < P) {
    const Span sp = point_span(pts, radii, visible, extra, extra_s, v,
                               (size_t)v * P + p, g);
    live = sp.live;
    pz = sp.pz;
    if (live) {
      int* cnt = counts + (size_t)v * n_tiles;
      for (int i = 0; i < g.rx_max && sp.tx_lo + i <= sp.tx_hi; ++i)
        for (int j = 0; j < g.ry_max && sp.ty_lo + j <= sp.ty_hi; ++j)
          atomicAdd(cnt + (sp.ty_lo + j) * g.nt + sp.tx_lo + i, 1);
      if (sp.span_over) atomicAdd(stats + v * STATS, 1);
    }
  }
  if (sort_by_depth) {
    // Both keys of a live point are nonzero, so 0 is "no live point".
    const uint32_t k = live ? ordered(pz) : 0u;
    const uint32_t lo = __reduce_max_sync(FULL, live ? ~k : 0u);
    const uint32_t hi = __reduce_max_sync(FULL, k);
    if ((threadIdx.x & 31) == 0 && hi != 0u) {
      atomicMax(reinterpret_cast<unsigned*>(stats + v * STATS + 1), lo);
      atomicMax(reinterpret_cast<unsigned*>(stats + v * STATS + 2), hi);
    }
  }
}

// Exclusive scan of one int per thread over a SCAN_THREADS block; *total
// receives the sum.
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int s = warp_sums[lane];
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, si, o);
      if (lane >= o) si += y;
    }
    warp_sums[lane] = si - s;
    if (lane == 31) *total = si;
  }
  __syncthreads();
  return warp_sums[w] + incl - x;
}

__global__ void __launch_bounds__(SCAN_THREADS)
bin_sort_scan_kernel(int* __restrict__ counts, const int* __restrict__ stats,
                     int* __restrict__ seg, float* __restrict__ zinfo,
                     int* __restrict__ tile_counts, int* __restrict__ overflow,
                     const int* __restrict__ overflow_base,
                     int* __restrict__ overflow_sum,
                     int* __restrict__ long_tiles, int n_tiles, int M,
                     int pair_cap, int smem_keys, int sort_by_depth) {
  __shared__ int warp_sums[32];
  __shared__ int total, cap_over, n_long;
  const int v = blockIdx.x;
  int* cnt = counts + (size_t)v * n_tiles;
  int* sv = seg + (size_t)v * (n_tiles + 1);
  if (threadIdx.x == 0) cap_over = n_long = 0;
  const int chunk = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int t0 = min(threadIdx.x * chunk, n_tiles);
  const int t1 = min(t0 + chunk, n_tiles);
  int mine = 0;
  for (int t = t0; t < t1; ++t) mine += cnt[t];
  int s = block_exclusive_scan(mine, warp_sums, &total);
  int my_over = 0, my_long = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = cnt[t];
    sv[t] = s;
    // searchsorted's starts clamped at the pair cap, then the capacity
    const int full = min(s + c, pair_cap) - min(s, pair_cap);
    tile_counts[(size_t)v * n_tiles + t] = min(full, M);
    my_over += max(full - M, 0);
    my_long += (s < pair_cap && c > smem_keys) ? 1 : 0;
    cnt[t] = 0;  // the scatter's cursor
    s += c;
  }
  if (my_over) atomicAdd(&cap_over, my_over);
  if (my_long) atomicAdd(&n_long, my_long);
  __syncthreads();
  if (threadIdx.x == 0) {
    sv[n_tiles] = total;
    const int* st = stats + v * STATS;
    const int over = cap_over + st[0] + max(total - pair_cap, 0);
    overflow[v] = over;
    if (overflow_sum) overflow_sum[v] = overflow_base[v] + over;
    if (n_long) atomicAdd(long_tiles, n_long);
    if (sort_by_depth) {
      // amin / amax over the live points, ±inf (no live point) or another
      // non-finite value replaced by 0 / 1, the range clamped at 1e-9.
      const uint32_t klo = ~(uint32_t)st[1], khi = (uint32_t)st[2];
      float z_lo = st[1] ? unordered(klo) : CUDART_INF_F;
      float z_hi = st[2] ? unordered(khi) : -CUDART_INF_F;
      if (!isfinite(z_lo)) z_lo = 0.0f;
      if (!isfinite(z_hi)) z_hi = 1.0f;
      const float d = __fsub_rn(z_hi, z_lo);
      zinfo[v * 2] = z_lo;
      zinfo[v * 2 + 1] = d < 1e-9f ? 1e-9f : d;
    }
  }
}

template <typename Key>
__global__ void __launch_bounds__(POINT_THREADS)
bin_sort_scatter_kernel(const float* __restrict__ pts,
                        const float* __restrict__ radii,
                        const unsigned char* __restrict__ visible,
                        const float* __restrict__ extra, float extra_s,
                        int* __restrict__ cursor, const int* __restrict__ seg,
                        const float* __restrict__ zinfo, Key* __restrict__ keys,
                        int P, size_t n_pairs, Raster g, int pair_cap,
                        int zq_bits) {
  const int v = blockIdx.y;
  const int p = blockIdx.x * POINT_THREADS + threadIdx.x;
  if (p >= P) return;
  const Span sp = point_span(pts, radii, visible, extra, extra_s, v,
                             (size_t)v * P + p, g);
  if (!sp.live) return;
  Key key = (Key)p;
  if constexpr (sizeof(Key) == 8) {
    // zq = clamp(int(clamp((pz − z_lo) / z_range · zq_max, 0, zq_max)))
    const long long zq_max = (1ll << zq_bits) - 1;
    const float zmax_f = (float)zq_max;
    float zf = __fmul_rn(__fdiv_rn(__fsub_rn(sp.pz, zinfo[v * 2]),
                                   zinfo[v * 2 + 1]), zmax_f);
    zf = zf < 0.0f ? 0.0f : (zf > zmax_f ? zmax_f : zf);
    long long zq = zf != zf ? 0 : (long long)zf;
    zq = min(max(zq, 0ll), zq_max);
    key = (Key)(((unsigned long long)zq << ID_BITS) | (unsigned)p);
  }
  const int n_tiles = g.nt * g.nt;
  const int* sv = seg + (size_t)v * (n_tiles + 1);
  int* cur = cursor + (size_t)v * n_tiles;
  Key* kv = keys + (size_t)v * n_pairs;
  for (int i = 0; i < g.rx_max && sp.tx_lo + i <= sp.tx_hi; ++i)
    for (int j = 0; j < g.ry_max && sp.ty_lo + j <= sp.ty_hi; ++j) {
      const int t = (sp.ty_lo + j) * g.nt + sp.tx_lo + i;
      const int start = sv[t];
      if (start >= pair_cap) continue;  // the whole tile is truncated
      kv[start + atomicAdd(cur + t, 1)] = key;
    }
}

// Ascending bitonic sort of k[0, n), n a power of two, by the block.
template <typename Key>
__device__ void bitonic_sort(Key* k, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += TILE_THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key a = k[lo], b = k[hi];
        if ((a > b) == ((lo & size) == 0)) {
          k[lo] = b;
          k[hi] = a;
        }
      }
      __syncthreads();
    }
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The key of rank `k` among the n unique keys at `keys` (device memory),
// by the block: most significant byte first over `key_bits` bits.
template <typename Key>
__device__ Key select_rank(const Key* __restrict__ keys, int n, int k,
                           int key_bits, int* hist, int* pick) {
  Key prefix = 0, mask = 0;
  for (int shift = ((key_bits + 7) / 8 - 1) * 8; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += TILE_THREADS) hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += TILE_THREADS) {
      const Key x = keys[i];
      if ((x & mask) == prefix) atomicAdd(&hist[(int)(x >> shift) & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = 0, b = 0;
      while (acc + hist[b] <= k) acc += hist[b++];
      pick[0] = b;
      pick[1] = k - acc;
    }
    __syncthreads();
    prefix |= (Key)pick[0] << shift;
    mask |= (Key)255 << shift;
    k = pick[1];
    __syncthreads();
  }
  return prefix;
}

struct Inputs {
  const float *pts, *radii, *ellipse, *cutoff, *scaler, *features, *extra;
  float extra_s;
};

// ops/splat.py _channel_matrix's sentinel rows.
template <int C>
__device__ __forceinline__ float sentinel(int c) {
  if (c < 2) return 2.0f;
  if (c == 2) return -1.0f;
  if (C == 14 && c == 6) return -CUDART_INF_F;
  if (C == 14 && c == 13) return -1.0f;
  return 0.0f;
}

// Slots [j0, j0 + n) of one tile from the sorted keys k[0, n).
template <typename Key, int C>
__device__ void write_slots(const Key* k, int j0, int n, const Inputs& in,
                            int v, int P, float* __restrict__ rows,
                            int* __restrict__ ids, int M) {
  for (int j = threadIdx.x; j < n; j += TILE_THREADS) {
    const int id = (int)(k[j] & ID_MASK);
    const size_t vp = (size_t)v * P + id;
    float ch[C];
    ch[0] = in.pts[vp * 3];
    ch[1] = in.pts[vp * 3 + 1];
    ch[2] = in.pts[vp * 3 + 2];
    if constexpr (C == 5) {
      ch[3] = in.radii[vp * 2];
      ch[4] = in.radii[vp * 2 + 1];
    } else {
      const float e = in.extra ? in.extra[v] : in.extra_s;
      ch[3] = in.ellipse[vp * 3];
      ch[4] = in.ellipse[vp * 3 + 1];
      ch[5] = in.ellipse[vp * 3 + 2];
      ch[6] = in.cutoff[vp];
      ch[7] = __fadd_rn(in.radii[vp * 2], e);
      ch[8] = __fadd_rn(in.radii[vp * 2 + 1], e);
      ch[9] = in.scaler ? in.scaler[vp] : 0.0f;
      ch[10] = in.features ? in.features[vp * 3] : 0.0f;
      ch[11] = in.features ? in.features[vp * 3 + 1] : 0.0f;
      ch[12] = in.features ? in.features[vp * 3 + 2] : 0.0f;
      ch[13] = (float)id;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) rows[(size_t)c * M + j0 + j] = ch[c];
    ids[j0 + j] = id;
  }
}

template <typename Key, int C>
__global__ void __launch_bounds__(TILE_THREADS)
bin_sort_tiles_kernel(Inputs in, const int* __restrict__ seg,
                      const Key* __restrict__ keys,
                      const int* __restrict__ tile_counts,
                      float* __restrict__ table, int* __restrict__ tile_ids,
                      int P, int n_tiles, int M, size_t n_pairs, int pair_cap,
                      int key_bits) {
  constexpr int SMEM_KEYS = SORT_SMEM_BYTES / (int)sizeof(Key);
  __shared__ Key sk[SMEM_KEYS];
  __shared__ int hist[256], pick[2], n_in;
  const int t = blockIdx.x, v = blockIdx.y;
  const size_t vt = (size_t)v * n_tiles + t;
  const int* sv = seg + (size_t)v * (n_tiles + 1);
  const int start = sv[t];
  const int n = start < pair_cap ? sv[t + 1] - start : 0;
  const int c = tile_counts[vt];
  const Key* kv = keys + (size_t)v * n_pairs + start;
  float* rows = table + vt * C * M;
  int* ids = tile_ids + vt * M;
  const Key pad = ~(Key)0;
  if (n <= SMEM_KEYS) {
    if (c > 0) {
      const int n2 = next_pow2(n);
      for (int i = threadIdx.x; i < n2; i += TILE_THREADS)
        sk[i] = i < n ? kv[i] : pad;
      __syncthreads();
      bitonic_sort(sk, n2);
      write_slots<Key, C>(sk, 0, c, in, v, P, rows, ids, M);
    }
  } else {
    // The long segment: each round selects the next SMEM_KEYS ranks' upper
    // key in device memory, gathers the keys of those ranks (unique keys:
    // exactly `want` of them) and sorts them in shared memory.
    Key lo = 0;
    for (int r0 = 0; r0 < c; r0 += SMEM_KEYS) {
      const int want = min(SMEM_KEYS, c - r0);
      const Key hi = select_rank(kv, n, r0 + want - 1, key_bits, hist, pick);
      if (threadIdx.x == 0) n_in = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += TILE_THREADS) {
        const Key x = kv[i];
        if (x <= hi && (r0 == 0 || x > lo)) sk[atomicAdd(&n_in, 1)] = x;
      }
      __syncthreads();
      const int n2 = next_pow2(want);
      for (int i = want + threadIdx.x; i < n2; i += TILE_THREADS) sk[i] = pad;
      __syncthreads();
      bitonic_sort(sk, n2);
      write_slots<Key, C>(sk, r0, want, in, v, P, rows, ids, M);
      __syncthreads();
      lo = hi;
    }
  }
  for (int j = c + threadIdx.x; j < M; j += TILE_THREADS) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) rows[(size_t)ch * M + j] = sentinel<C>(ch);
    ids[j] = -1;
  }
}

// The keys of rank lo and hi (0-based) among n_vals values, masked-out as
// +inf and NaN above +inf (torch.sort's order), by radix selection over
// 8-bit digits; two histograms, one search each.
__global__ void __launch_bounds__(MEDIAN_THREADS)
median_sort_select_kernel(const float* __restrict__ vals,
                          const unsigned char* __restrict__ mask, int n_vals,
                          int group, const float* __restrict__ scale_p,
                          float scale_s, float* __restrict__ med,
                          float* __restrict__ r, float* __restrict__ r2) {
  __shared__ int hist[2][256];
  __shared__ int pick[2][2];
  __shared__ int n_masked;
  const int v = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* x = vals + (size_t)v * n_vals;
  const unsigned char* m = mask + (size_t)v * (n_vals / group);
  const uint32_t inf_key = ordered(CUDART_INF_F);
  uint32_t prefix[2] = {0u, 0u}, pmask = 0u;
  int rank[2] = {0, 0};
  if (threadIdx.x == 0) n_masked = 0;
  const int n_iter = (n_vals + MEDIAN_THREADS - 1) / MEDIAN_THREADS;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 512; b += MEDIAN_THREADS) (&hist[0][0])[b] = 0;
    __syncthreads();
    int mine = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int i = it * MEDIAN_THREADS + threadIdx.x;
      uint32_t key = 0;
      bool ok = i < n_vals;
      if (ok) {
        const bool in = m[i / group] != 0;
        const float f = x[i];
        mine += in ? 1 : 0;
        key = !in ? inf_key : (f != f ? 0xffffffffu : ordered(f));
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool hit = ok && (key & pmask) == prefix[s];
        const unsigned d = hit ? (key >> shift) & 255u : 256u;
        const unsigned peers = __match_any_sync(FULL, d);
        if (hit && lane == __ffs(peers) - 1)
          atomicAdd(&hist[s][d], __popc(peers));
      }
    }
    if (shift == 24) {
      mine = __reduce_add_sync(FULL, mine);
      if (lane == 0 && mine) atomicAdd(&n_masked, mine);
    }
    __syncthreads();
    if (shift == 24) {
      // torch: lo = clamp((n − 1) // 2, 0), hi = n // 2
      rank[0] = n_masked > 0 ? (n_masked - 1) / 2 : 0;
      rank[1] = n_masked / 2;
    }
    if (w < 2) {
      // warp w finds the bin of search w: lane l holds bins 8l .. 8l + 7
      int h[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) sum += (h[b] = hist[w][lane * 8 + b]);
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int acc = incl - sum;
      const int k = rank[w];
      if (acc <= k && k < incl) {
        int b = 0;
        while (acc + h[b] <= k) acc += h[b++];
        pick[w][0] = lane * 8 + b;
        pick[w][1] = k - acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      prefix[s] |= (uint32_t)pick[s][0] << shift;
      rank[s] = pick[s][1];
    }
    pmask |= 255u << shift;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // ops/splat.py masked_median_plain: 0.5·(lo + hi), 0 without a value
    const float mv = n_masked > 0 ? __fmul_rn(0.5f, __fadd_rn(
                                        unordered(prefix[0]),
                                        unordered(prefix[1])))
                                  : 0.0f;
    med[v] = mv;
    if (r) {
      // bin_for_occ_backward: r = median · scale, 0 where not finite
      float rv = __fmul_rn(mv, scale_p ? *scale_p : scale_s);
      if (!isfinite(rv)) rv = 0.0f;
      r[v] = rv;
      r2[v] = __fmul_rn(rv, rv);
    }
  }
}

template <typename Key, int C>
int launch_tables(const Inputs& in, const unsigned char* visible, int* counts,
                  int* stats, int* seg, float* zinfo, void* keys, float* table,
                  int* tile_ids, int* tile_counts, int* overflow,
                  const int* overflow_base, int* overflow_sum, int* long_tiles,
                  int V, int P, const Raster& g, int M, int pair_cap,
                  int zq_bits, cudaStream_t stream) {
  const int n_tiles = g.nt * g.nt;
  const size_t n_pairs = (size_t)P * g.rx_max * g.ry_max;
  const int depth = sizeof(Key) == 8;
  const dim3 points((P + POINT_THREADS - 1) / POINT_THREADS, V);
  bin_sort_count_kernel<<<points, POINT_THREADS, 0, stream>>>(
      in.pts, in.radii, visible, in.extra, in.extra_s, counts, stats, P, g,
      depth);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_sort_scan_kernel<<<V, SCAN_THREADS, 0, stream>>>(
      counts, stats, seg, zinfo, tile_counts, overflow, overflow_base,
      overflow_sum, long_tiles, n_tiles, M, pair_cap,
      SORT_SMEM_BYTES / (int)sizeof(Key), depth);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bin_sort_scatter_kernel<Key><<<points, POINT_THREADS, 0, stream>>>(
      in.pts, in.radii, visible, in.extra, in.extra_s, counts, seg, zinfo,
      static_cast<Key*>(keys), P, n_pairs, g, pair_cap, zq_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bin_sort_tiles_kernel<Key, C><<<dim3(n_tiles, V), TILE_THREADS, 0, stream>>>(
      in, seg, static_cast<const Key*>(keys), tile_counts, table, tile_ids, P,
      n_tiles, M, n_pairs, pair_cap, depth ? zq_bits + ID_BITS : ID_BITS);
  return (int)cudaGetLastError();
}

}  // namespace

// One candidate table (ops/kernels.py bin_tiles).  scratch_i holds
// V·n_tiles counts then V·STATS stats, zero-filled by the caller; seg
// V·(n_tiles + 1) ints, zinfo V·2 floats, keys V·P·rx·ry keys of 8 bytes
// (sort_by_depth) or 4.  ellipse, cutoff, scaler, features, visible, extra,
// overflow_base and overflow_sum may be null (a null extra takes extra_s).
extern "C" int dss_bin_tiles(
    const float* pts, const float* radii, const float* ellipse,
    const float* cutoff, const float* scaler, const float* features,
    const unsigned char* visible, const float* extra, float extra_s,
    int* scratch_i, int* seg, float* zinfo, void* keys, float* table,
    int* tile_ids, int* tile_counts, int* overflow, const int* overflow_base,
    int* overflow_sum, int* long_tiles, int V, int P, int image_size,
    int tile, int nt, int rx_max, int ry_max, int M, int pair_cap,
    int sort_by_depth, int backward_channels, int zq_bits,
    cudaStream_t stream) {
  if (V <= 0 || P <= 0) return 0;
  const Inputs in{pts, radii, ellipse, cutoff, scaler, features, extra,
                  extra_s};
  const Raster g{image_size, tile, nt, rx_max, ry_max};
  int* counts = scratch_i;
  int* stats = scratch_i + (size_t)V * nt * nt;
#define DSS_BIN_ARGS                                                       \
  in, visible, counts, stats, seg, zinfo, keys, table, tile_ids,           \
      tile_counts, overflow, overflow_base, overflow_sum, long_tiles, V, P, \
      g, M, pair_cap, zq_bits, stream
  if (sort_by_depth)
    return backward_channels
               ? launch_tables<unsigned long long, 5>(DSS_BIN_ARGS)
               : launch_tables<unsigned long long, 14>(DSS_BIN_ARGS);
  return backward_channels ? launch_tables<uint32_t, 5>(DSS_BIN_ARGS)
                           : launch_tables<uint32_t, 14>(DSS_BIN_ARGS);
#undef DSS_BIN_ARGS
}

// The masked median of each of V rows of n_vals values (ops/kernels.py
// median_select); mask (V, n_vals / group), entry i // group masking value
// i.  With r non-null also r = median · scale (*scale_p, or scale_s where
// scale_p is null), 0 where not finite, and r2 = r².
extern "C" int dss_median_select(const float* vals, const unsigned char* mask,
                                 const float* scale_p, float scale_s,
                                 float* med, float* r, float* r2, int V,
                                 int n_vals, int group, cudaStream_t stream) {
  if (V <= 0) return 0;
  median_sort_select_kernel<<<V, MEDIAN_THREADS, 0, stream>>>(
      vals, mask, n_vals, group, scale_p, scale_s, med, r, r2);
  return (int)cudaGetLastError();
}
