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
// at 3.35 TB/s.  Its additions, a prefix and a difference per element, stay
// far below the FP64 rate.
//
// Design: a prefix whose work is O(N*F) whatever the spans, every sum in
// float64 and rounded to float32 once.
//   1. `rolling_tile`, one block per tile of kTile rows and up to kFMax
//      features: cp.async copies the tile's starts and values into shared
//      memory; each thread sums kRows consecutive rows in registers, one
//      block scan (warp shuffles, then the warp totals in a fixed order)
//      gives each thread its offset, and the tile's inclusive float64
//      prefixes go back to shared memory.  A window that starts inside its
//      row's tile is the difference of two of them and is written at once.
//   2. `rolling_tile_scan`, one block per feature: the exclusive scan of the
//      tile totals, in a fixed order.
//   3. `rolling_cross_tile`, one thread per row: a window that starts in an
//      earlier tile is its row's local prefix, plus the full tiles between
//      (a difference of the scanned totals), plus the start tile's suffix
//      (its total minus its local prefix before the start).  For this, step
//      1 writes every local prefix and each tile's total to a float64
//      scratch.
// Each difference is taken within one tile's magnitude or over tile totals.
// No atomics and no order that depends on timing: the result is the same
// bits on every run.  A row whose start fails 0 <= starts[i] <= i reads
// nothing, gets NaN, and sets the error word (csrc/errors.cu) that the
// wrapper's caller reads after its next synchronization.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                 // consecutive rows a thread sums
constexpr int kTile = kThreads * kRows;  // rows of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kFMax = 4;                 // features a tile's block holds at once
constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 256;

template <int FC>
constexpr size_t tile_smem() {  // prefixes (f64), values (f32), starts (i32)
  return static_cast<size_t>(kTile) * FC * (sizeof(double) + sizeof(float)) +
         static_cast<size_t>(kTile) * sizeof(int32_t);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy n contiguous 4-byte words from global src to shared dst (16-byte
// aligned): 16 bytes a thread where src is aligned too, else 4.
__device__ __forceinline__ void copy_words_async(void* dst, const void* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int k = threadIdx.x; k < n / 4; k += kThreads) {
      cp_async16(static_cast<char*>(dst) + 16 * k, static_cast<const char*>(src) + 16 * k);
    }
    done = n / 4 * 4;
  }
  for (int k = done + threadIdx.x; k < n; k += kThreads) {
    cp_async4(static_cast<char*>(dst) + 4 * k, static_cast<const char*>(src) + 4 * k);
  }
}

// Features [f0, f0 + FC) of one tile.  A window that starts before the tile
// is left to rolling_cross_tile; for it, the local prefixes and the tile's
// total go to `local` and `totals`.
template <int FC>
__global__ void __launch_bounds__(kThreads)
rolling_tile(const float* __restrict__ values, const int32_t* __restrict__ starts,
             float* __restrict__ out, double* __restrict__ local, double* __restrict__ totals,
             int32_t* err, int64_t N, int F, int f0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double wsum[kWarps][FC];
  double* P = reinterpret_cast<double*>(smem);
  float* V = reinterpret_cast<float*>(smem + sizeof(double) * kTile * FC);
  int32_t* S = reinterpret_cast<int32_t*>(smem + (sizeof(double) + sizeof(float)) * kTile * FC);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(N - row0 < kTile ? N - row0 : kTile);

  copy_words_async(S, starts + row0, rows);
  if (FC == F) {
    copy_words_async(V, values + row0 * F, rows * F);
  } else {
    for (int k = threadIdx.x; k < rows * FC; k += kThreads) {
      cp_async4(V + k, values + (row0 + k / FC) * F + f0 + k % FC);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's kRows rows, FC features each: kRows * FC floats, 16-byte
  // aligned, read as FC float4 (rows past the tile's end count as 0)
  const int r0 = threadIdx.x * kRows;
  float v[kRows * FC];
#pragma unroll
  for (int m = 0; m < FC; ++m) {
    const float4 q = reinterpret_cast<const float4*>(V + r0 * FC)[m];
    v[4 * m] = q.x;
    v[4 * m + 1] = q.y;
    v[4 * m + 2] = q.z;
    v[4 * m + 3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < kRows * FC; ++k) {
    if (r0 + k / FC >= rows) v[k] = 0.0f;
  }
  // exclusive scan of the threads' sums: shuffles within a warp, then the
  // warps' totals added in order
  double run[FC];
#pragma unroll
  for (int c = 0; c < FC; ++c) {
    double incl = 0.0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) incl += static_cast<double>(v[j * FC + c]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const double before_lane = __shfl_up_sync(0xffffffffu, incl, 1);
    run[c] = lane == 0 ? 0.0 : before_lane;
    if (lane == 31) wsum[warp][c] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < FC; ++c) {
    double before_warp = 0.0;
    for (int w = 0; w < warp; ++w) before_warp += wsum[w][c];
    run[c] += before_warp;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < FC; ++c) {
      run[c] += static_cast<double>(v[j * FC + c]);
      P[(r0 + j) * FC + c] = run[c];
    }
  }
  __syncthreads();

  // one row a thread, neighbouring threads on neighbouring rows
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = j * kThreads + threadIdx.x;
    if (r >= rows) break;
    const int64_t i = row0 + r;
    const int64_t s = S[r];
    float* o = out + i * F + f0;
    // every row's, since any row can start a later window
#pragma unroll
    for (int c = 0; c < FC; ++c) local[i * F + f0 + c] = P[r * FC + c];
    if (s < 0 || s > i) {
      bad = true;
#pragma unroll
      for (int c = 0; c < FC; ++c) o[c] = __int_as_float(0x7fc00000);
      continue;
    }
    if (s >= row0) {
      const int k = static_cast<int>(s - row0);
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        const double head = k > 0 ? P[(k - 1) * FC + c] : 0.0;
        o[c] = static_cast<float>(P[r * FC + c] - head);
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < FC; ++c) {
      totals[blockIdx.x * static_cast<int64_t>(F) + f0 + c] = P[(rows - 1) * FC + c];
    }
  }
  if (bad) *reinterpret_cast<volatile int32_t*>(err) = 1;
}

// excl[k, f] = sum of totals[0 .. k-1, f], in a fixed order; one block per
// feature.
__global__ void __launch_bounds__(kScanThreads)
rolling_tile_scan(const double* __restrict__ totals, double* __restrict__ excl,
                  int64_t tiles, int F) {
  __shared__ double wsum[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x;
  double carry = 0.0;
  for (int64_t base = 0; base < tiles; base += kScanThreads) {
    const int64_t k = base + threadIdx.x;
    double incl = k < tiles ? totals[k * F + f] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const double before_lane = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' totals
      double w = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const double before = carry + (warp > 0 ? wsum[warp - 1] : 0.0);
    if (k < tiles) excl[k * F + f] = before + (lane > 0 ? before_lane : 0.0);
    carry += wsum[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// Windows that start in an earlier tile than their row.
__global__ void __launch_bounds__(kRowThreads)
rolling_cross_tile(const int32_t* __restrict__ starts, const double* __restrict__ local,
                   const double* __restrict__ totals, const double* __restrict__ excl,
                   float* __restrict__ out, int64_t N, int F) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kRowThreads) + threadIdx.x;
  if (i >= N) return;
  const int64_t s = starts[i];
  const int64_t ti = i / kTile;
  if (s < 0 || s >= ti * kTile) return;  // bad, or done by rolling_tile
  const int64_t ts = s / kTile;
  for (int f = 0; f < F; ++f) {
    const double between = excl[ti * F + f] - excl[(ts + 1) * F + f];
    const double before_start = s > ts * kTile ? local[(s - 1) * F + f] : 0.0;
    const double head = totals[ts * F + f] - before_start;
    out[i * F + f] = static_cast<float>(local[i * F + f] + between + head);
  }
}

template <int FC>
cudaError_t launch_tile(const float* values, const int32_t* starts, float* out, double* local,
                        double* totals, int32_t* err, int64_t N, int F, int f0,
                        unsigned tiles, cudaStream_t stream) {
  constexpr size_t smem = tile_smem<FC>();
  const cudaError_t e = cudaFuncSetAttribute(rolling_tile<FC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  rolling_tile<FC><<<tiles, kThreads, smem, stream>>>(values, starts, out, local, totals, err, N,
                                                      F, f0);
  return cudaSuccess;
}

cudaError_t launch_tiles(const float* values, const int32_t* starts, float* out, double* local,
                         double* totals, int32_t* err, int64_t N, int F, unsigned tiles,
                         cudaStream_t stream) {
  for (int f0 = 0; f0 < F; f0 += kFMax) {
    const int fc = F - f0 < kFMax ? F - f0 : kFMax;
    const auto launch = fc == 1   ? launch_tile<1>
                        : fc == 2 ? launch_tile<2>
                        : fc == 3 ? launch_tile<3>
                                  : launch_tile<4>;
    const cudaError_t e =
        launch(values, starts, out, local, totals, err, N, F, f0, tiles, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// values (N, F) float32; starts (N,) int32; out (N, F) float32; err: an
// error word from repro_error_word_alloc, set when a row's start fails
// 0 <= starts[i] <= i; scratch: at least (N + 2 * ceil(N / kTile)) * F
// float64 (local prefixes, tile totals, their scan).  Launches ceil(F / kFMax)
// tile kernels, the scan and the cross-tile pass; returns cudaGetLastError()
// after them.
extern "C" int rolling_sum_f32(const void* values, const void* starts, void* out,
                               void* scratch, long long scratch_len, void* err, long long N,
                               int F, void* stream) {
  if (N <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles = (N + kTile - 1) / kTile;
  if (tiles >= (int64_t{1} << 31) || scratch_len < (N + 2 * tiles) * static_cast<int64_t>(F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(values);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<float*>(out);
  auto* e = static_cast<int32_t*>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* local = static_cast<double*>(scratch);
  double* totals = local + N * F;
  double* excl = totals + tiles * F;
  const cudaError_t r =
      launch_tiles(v, st, o, local, totals, e, N, F, static_cast<unsigned>(tiles), s);
  if (r != cudaSuccess) return static_cast<int>(r);
  rolling_tile_scan<<<F, kScanThreads, 0, s>>>(totals, excl, tiles, F);
  rolling_cross_tile<<<static_cast<unsigned>((N + kRowThreads - 1) / kRowThreads), kRowThreads,
                       0, s>>>(st, local, totals, excl, o, N, F);
  return static_cast<int>(cudaGetLastError());
}
