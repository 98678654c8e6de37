// Online-store GET over the hash-partitioned key table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lookup_kernel` / `lookup_kernel_call` in
// src/repro/kernels/online_lookup/kernel.py.  Same contract on native int64:
// keys (P, C) int64 with -1 for an empty slot, routed queries (P, Q) int64
// with -2 for a pad, out (P, Q) int32 = the largest slot of partition p whose
// key equals the query, or -1.  The TPU kernel split every int64 into two
// int32 planes because its vector compare is 32-bit; Hopper compares int64
// natively, so the planes are gone.
//
// Bound on this card: bytes.  The function must read the P*C keys and the
// P*Q queries once and write P*Q slots, e.g. 134 MB at P=256, C=65536 -- about
// 0.04 ms at 3.35 TB/s.  This design keeps the Pallas kernel's O(P*C*Q)
// compare scan, so at serving shapes it is limited by integer issue rate, not
// by memory: simple and exact first.  A device hash probe that reads O(Q)
// keys instead of O(C) is the later step.
//
// Design: grid (C tiles, P, Q blocks).  Each block stages one tile of kTile
// keys of its partition in shared memory with coalesced loads; each thread
// owns one query and scans the tile (every thread reads the same shared word
// at a time: a broadcast, no bank conflicts), keeping the best 1-based slot.
// Tiles of one partition run as separate blocks in no order, so they combine
// through atomicMax into an output the caller zeroed; a second pass turns the
// 1-based best (0 = miss) into 0-based / -1.  Ragged C and Q are masked; P
// need not be a power of two.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 2048;     // int64 keys per block: 16 KiB of shared memory
constexpr int kThreads = 128;   // queries per block

__global__ void __launch_bounds__(kThreads)
lookup_scan(const int64_t* __restrict__ keys, const int64_t* __restrict__ queries,
            int32_t* __restrict__ best, int C, int Q) {
  __shared__ int64_t tile[kTile];
  const int p = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int n = min(kTile, C - c0);
  const int64_t* kp = keys + static_cast<size_t>(p) * C + c0;
  for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = kp[i];
  __syncthreads();

  const int64_t* qp = queries + static_cast<size_t>(p) * Q;
  int32_t* bp = best + static_cast<size_t>(p) * Q;
  for (int q = blockIdx.z * kThreads + threadIdx.x; q < Q; q += gridDim.z * kThreads) {
    const int64_t key = qp[q];
    int hit = 0;
    for (int i = 0; i < n; ++i) {
      if (tile[i] == key) hit = c0 + i + 1;  // ascending: the last match is the max slot
    }
    if (hit) atomicMax(bp + q, hit);
  }
}

__global__ void to_zero_based(int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n) out[i] -= 1;
}

}  // namespace

// out must hold P*Q zeros on entry.  Returns cudaGetLastError() after the launches.
extern "C" int online_lookup_i64(const void* keys, const void* queries, void* out,
                                 int P, int C, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(P) * Q;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (C > 0) {
    const int q_blocks = min((Q + kThreads - 1) / kThreads, 65535);
    dim3 grid((C + kTile - 1) / kTile, P, q_blocks);
    lookup_scan<<<grid, kThreads, 0, s>>>(static_cast<const int64_t*>(keys),
                                          static_cast<const int64_t*>(queries),
                                          static_cast<int32_t*>(out), C, Q);
  }
  const int threads = 256;
  to_zero_based<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
