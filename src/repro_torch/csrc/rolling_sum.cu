// Rolling-window sum for the DSL's sum/mean aggregations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rolling_sum_kernel` /
// `rolling_sum_kernel_call` in src/repro/kernels/rolling_agg/kernel.py:
// out[i, f] = sum(values[starts[i] .. i, f]) for values (N, F) float32 and
// starts (N,) int32 with 0 <= starts[i] <= i.  The TPU kernel carried an
// H-row history between grid steps (its grid runs in order) and built the
// prefix and the gather from MXU matmuls, which capped the span at H <= 4096.
// Blocks on Hopper run in no order, so nothing is carried between them, and
// this kernel has no span limit.
//
// Bound on this card: bytes.  The function reads N*F values and N starts once
// and writes N*F sums: 28 MB for the main path's N = 1.4M, F = 2, about 8 us
// at 3.35 TB/s.  Its additions (the sum of the spans, times F) stay far below
// the FP64 peak at the main path's spans, a handful of rows per entity.
//
// Design: one thread per (row, feature), threads of a warp on neighbouring
// (row, feature) pairs so each step of the window loop reads neighbouring
// addresses, mostly from L1/L2 since neighbouring windows overlap.  The
// window is summed directly in float64 and rounded to float32 once, so the
// result is as accurate as the plain float64 prefix-difference version and
// free of the cancellation a float32 prefix suffers over long columns.  Time
// grows with the span: a block-local prefix in shared memory is the step for
// long windows.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rolling_sum_direct(const float* __restrict__ values, const int32_t* __restrict__ starts,
                   float* __restrict__ out, int64_t N, int F) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= N * F) return;
  const int64_t i = t / F;
  const int f = static_cast<int>(t - i * F);
  double acc = 0.0;
  for (int64_t j = starts[i]; j <= i; ++j) acc += static_cast<double>(values[j * F + f]);
  out[t] = static_cast<float>(acc);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int rolling_sum_f32(const void* values, const void* starts, void* out,
                               long long N, int F, void* stream) {
  const int64_t n = static_cast<int64_t>(N) * F;
  if (n > 0) {
    rolling_sum_direct<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(starts),
        static_cast<float*>(out), N, F);
  }
  return static_cast<int>(cudaGetLastError());
}
