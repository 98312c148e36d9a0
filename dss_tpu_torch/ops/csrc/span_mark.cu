// span_mark — one device timestamp of utils/spans.py.
//
// Replaces no Pallas kernel: it is the port's tracing, not its math.  A
// span of the train step is two marks, and a CUDA graph replays a mark as
// it replays any kernel, so the stamps of every replayed step reach the
// host although the replay runs no Python.
//
// Contract: `ring` is a (steps, cols) int64 array and `count` one int64,
// both on the device, allocated before any capture and never moved.  A
// mark with BEGIN adds one to *count (a new step) and writes −1 into
// column 0 of the step's row, which is row (*count − 1) mod steps; every
// mark writes the %globaltimer (ns) into column 1 + col of that row; a
// mark with END writes `layout` into column 0 (the step is complete, and
// the host's layout table names its columns).  With *count still 0 (no
// step begun) a mark writes nothing.  ops/kernels.py's span_mark_plain is
// the same arithmetic on the CPU with the host's clock.
//
// What bounds it: the launch.  One thread reads one word and writes at
// most three; a mark costs the device about one graph node's gap.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BEGIN = 1;  // ops/kernels.py SPAN_BEGIN
constexpr int END = 2;    // ops/kernels.py SPAN_END

__global__ void span_mark_kernel(int64_t* ring, int64_t* count, int steps,
                                 int cols, int col, int flags,
                                 int64_t layout) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  int64_t n = *count;
  if (flags & BEGIN) {
    n += 1;
    *count = n;
  }
  if (n <= 0) return;
  int64_t* row = ring + ((n - 1) % steps) * (int64_t)cols;
  if (flags & BEGIN) row[0] = -1;
  row[1 + col] = (int64_t)t;
  if (flags & END) row[0] = layout;
}

}  // namespace

extern "C" int dss_span_mark(int64_t* ring, int64_t* count, int steps,
                             int cols, int col, int flags, long long layout,
                             cudaStream_t stream) {
  span_mark_kernel<<<1, 1, 0, stream>>>(ring, count, steps, cols, col, flags,
                                        (int64_t)layout);
  return (int)cudaGetLastError();
}
