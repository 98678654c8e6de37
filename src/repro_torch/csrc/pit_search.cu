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
// natively and serves random reads from L2, so this kernel searches the
// native int64 timestamps directly, in every span regime.
//
// Bound on this card: bytes.  The function reads each query's (q_ts, lo, hi)
// once and writes its (idx, valid) once, plus the table's 32-byte sectors
// that a search must see; chip_smoke.py computes both from each run's data.
// The compares stay far below any issue limit, so what a query costs is the
// number of memory round trips in series on its path.
//
// Design: one thread per query, neighbouring threads on neighbouring queries
// so the query and result accesses coalesce.  A bisection is a chain of
// dependent loads, one round trip a step, so the kernel cuts the chain:
//   * a range of kShort rows or fewer is read at once, as 16-byte pairs of
//     rows where the table is aligned, and its rows at or before q_ts are
//     counted with no dependence between the loads.  The offline path's
//     segments hold about five rows, so most queries finish in one round
//     trip after their own inputs;
//   * a longer range is halved by bisection down to kShort rows first.
// The kernel is bound by the table requests it sends to L2 as much as by
// their chain: k-ary steps (7 independent probes cutting a range 8-fold in
// one round trip) made the 2,048-row wide-span search slower, not faster,
// so they are not used (PERF.md).
// Bounds are checked here, not on the host: a query without
// 0 <= lo <= hi <= M reads nothing, gets valid = false and idx = -1, and
// sets the error word (csrc/errors.cu) that the wrapper's caller reads after
// its next synchronization.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 8;  // a range this short is read in one round of loads

// Rows of [l, h) (h - l <= kShort) with ts <= t.  Reads the pairs of rows
// that start at even indices from l & ~1 and hold a row of [l, h); a pair is
// one 16-byte load where the table is aligned and both rows lie in it.
__device__ __forceinline__ int32_t count_short(const int64_t* __restrict__ ts, int64_t M,
                                               bool aligned, int32_t l, int32_t h, int64_t t) {
  const int64_t a = l & ~1;
  int64_t x[kShort + 2];
#pragma unroll
  for (int k = 0; k < kShort + 2; k += 2) {
    const int64_t p = a + k;
    x[k] = x[k + 1] = 0;
    if (p < h) {
      if (aligned && p + 1 < M) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(ts + p));
        x[k] = v.x;
        x[k + 1] = v.y;
      } else {
        x[k] = ts[p];
        if (p + 1 < h) x[k + 1] = ts[p + 1];
      }
    }
  }
  int32_t c = 0;
#pragma unroll
  for (int k = 0; k < kShort + 2; ++k) {
    const int64_t p = a + k;
    c += (p >= l) & (p < h) & (x[k] <= t);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
pit_upper_bound(const int64_t* __restrict__ table_ts, const int64_t* __restrict__ q_ts,
                const int32_t* __restrict__ q_lo, const int32_t* __restrict__ q_hi,
                int32_t* __restrict__ idx, uint8_t* __restrict__ valid, int32_t* err,
                int64_t M, int64_t B) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= B) return;
  const int64_t t = q_ts[i];
  const int32_t lo0 = q_lo[i];
  const int32_t hi0 = q_hi[i];
  if (!(lo0 >= 0 && lo0 <= hi0 && hi0 <= M)) {
    idx[i] = -1;
    valid[i] = 0;
    *reinterpret_cast<volatile int32_t*>(err) = 1;
    return;
  }
  // the upper bound (first row of [lo0, hi0) with ts > t) lies in [l, h]
  int32_t l = lo0;
  int32_t h = hi0;
  while (h - l > kShort) {
    const int32_t mid = l + ((h - l) >> 1);
    if (table_ts[mid] <= t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(table_ts) & 15) == 0;
  const int32_t upper = l + count_short(table_ts, M, aligned, l, h, t);
  idx[i] = upper - 1;
  valid[i] = upper > lo0;
}

}  // namespace

// table_ts (M,) int64; q_ts (B,) int64; q_lo/q_hi (B,) int32; idx (B,) int32;
// valid (B,) bool (one byte each); err: an error word from
// repro_error_word_alloc, set when a query's bounds fail 0 <= lo <= hi <= M.
// Returns cudaGetLastError() after the launch.
extern "C" int pit_search_i64(const void* table_ts, const void* q_ts, const void* q_lo,
                              const void* q_hi, void* idx, void* valid, void* err,
                              long long M, long long B, void* stream) {
  if (B > 0) {
    pit_upper_bound<<<static_cast<unsigned>((B + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(table_ts), static_cast<const int64_t*>(q_ts),
        static_cast<const int32_t*>(q_lo), static_cast<const int32_t*>(q_hi),
        static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid), static_cast<int32_t*>(err),
        M, B);
  }
  return static_cast<int>(cudaGetLastError());
}
