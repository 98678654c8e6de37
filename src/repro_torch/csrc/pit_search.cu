// Point-in-time (as-of) search for offline retrieval, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pit_kernel` / `pit_search_kernel_call` in
// src/repro/kernels/pit_join/kernel.py.  Same contract: for each query, the
// count of rows r in [lo, hi) with table_ts[r] <= q_ts, returned as
// idx = lo + count - 1 and valid = count > 0.  The history is sorted by
// (key, event_ts, creation_ts), so within a segment the count is an upper
// bound minus lo, and equal timestamps resolve to the last row: the latest
// creation_ts wins a tie.
//
// The TPU kernel streamed every table tile past every query block as a
// broadcast compare-count, O(B*M), because random access is the wrong
// primitive for its vector memory, and it compared int32 timestamps rebased
// on the host (wide spans fell back to an oracle).  Hopper compares int64
// natively and serves random reads from L2, so this kernel binary-searches
// the native int64 timestamps directly, in every span regime.
//
// Bound on this card: bytes.  The function reads each query's (q_ts, lo, hi)
// once and writes its (idx, valid) once, plus about one 32-byte sector per
// bisection step, at most the whole table once; chip_smoke.py computes it
// from each run's data.  Its compares, log2 of the segment length per query,
// stay far below any issue limit.
//
// Design: one thread per query, neighbouring threads on neighbouring queries
// so the query and result accesses coalesce; each thread bisects its own
// segment with read-only loads.  Segments are short on the offline path (a
// few rows per entity), so most searches end after a few steps.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pit_upper_bound(const int64_t* __restrict__ table_ts, const int64_t* __restrict__ q_ts,
                const int32_t* __restrict__ q_lo, const int32_t* __restrict__ q_hi,
                int32_t* __restrict__ idx, uint8_t* __restrict__ valid, int64_t B) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= B) return;
  const int64_t t = q_ts[i];
  const int32_t lo0 = q_lo[i];
  int32_t lo = lo0;
  int32_t hi = q_hi[i];
  while (lo < hi) {  // first row of [lo, hi) with ts > t
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (table_ts[mid] <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  idx[i] = lo - 1;
  valid[i] = lo > lo0;
}

}  // namespace

// table_ts (M,) int64; q_ts (B,) int64; q_lo/q_hi (B,) int32 with
// 0 <= lo <= hi <= M; idx (B,) int32; valid (B,) bool (one byte each).
// Returns cudaGetLastError() after the launch.
extern "C" int pit_search_i64(const void* table_ts, const void* q_ts, const void* q_lo,
                              const void* q_hi, void* idx, void* valid, long long B,
                              void* stream) {
  if (B > 0) {
    pit_upper_bound<<<static_cast<unsigned>((B + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(table_ts), static_cast<const int64_t*>(q_ts),
        static_cast<const int32_t*>(q_lo), static_cast<const int32_t*>(q_hi),
        static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid), B);
  }
  return static_cast<int>(cudaGetLastError());
}
