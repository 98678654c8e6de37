// Index-free Algorithm-2 merge scan of the online store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_merge_kernel` / `merge_kernel_call` in
// src/repro/kernels/online_merge/kernel.py.  Same contract on native int64:
// table keys (P, C) with -1 for an empty slot, event_ts / creation_ts (P, C),
// values (P, C, D) float32; one batch of per-id winners routed to their
// partitions, (P, Q) keys with -2 for a pad, (P, Q) event_ts, (P, Q, D)
// values, and one creation_ts for the batch.  Every slot whose key equals a
// winner's takes the winner's (event_ts, creation_ts, values) iff
// (q_ev, creation) >lex (ev, cr), strictly; every other slot keeps its state.
//
// The TPU kernel matched every slot block against every query as a (Cb x Q)
// broadcast, gathered the winning rows with a one-hot float32 matmul on the
// MXU, and split each int64 into two int32 planes for its 32-bit vector
// compare.  None of that is needed here: the wrapper sorts each partition's
// winner keys on the card (torch.sort, which also gives the permutation back
// to the winners' rows), and each slot binary-searches its own key.
//
// Bound on this card: bytes.  There is no index, so every one of the P*C
// keys must be read once; each matched slot also reads its old (ev, cr) and
// the winner's (ev, values) and writes (ev, cr, values).  chip_smoke.py
// computes the bound from each run's data.
//
// Design: one thread per table slot, grid (slot blocks, P).  A block first
// stages its partition's sorted winner keys in shared memory (dynamic, above
// 48 KiB after cudaFuncSetAttribute) when they fit under kMaxShared, and
// searches them in global memory (read-only, cached in L2) when they do not.
// Each slot is written by its own thread only: no atomics, and the result
// does not depend on the order the blocks run in.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 64;  // so a block's key staging serves many slots
constexpr int kSlotsPerBlock = kThreads * kSlotsPerThread;
constexpr size_t kMaxShared = 96 * 1024;  // two blocks still fit on one SM

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
merge_scan(const int64_t* __restrict__ keys, int64_t* __restrict__ ev,
           int64_t* __restrict__ cr, float* __restrict__ values,
           const int64_t* __restrict__ sorted_q, const int64_t* __restrict__ order,
           const int64_t* __restrict__ q_ev, const float* __restrict__ q_values,
           int64_t creation, int C, int Q, int D) {
  extern __shared__ int64_t staged[];
  const int p = blockIdx.y;
  const int64_t* qk = sorted_q + static_cast<size_t>(p) * Q;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < Q; i += kThreads) staged[i] = qk[i];
    __syncthreads();
    qk = staged;
  }
  const int64_t* qo = order + static_cast<size_t>(p) * Q;
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < C; c += gridDim.x * kThreads) {
    const size_t s = static_cast<size_t>(p) * C + c;
    const int64_t key = keys[s];
    if (key < 0) continue;  // empty slot; pads (-2) can only meet negative keys
    int lo = 0, hi = Q;     // first sorted winner key >= key
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (qk[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo == Q || qk[lo] != key) continue;
    const size_t j = static_cast<size_t>(p) * Q + static_cast<size_t>(qo[lo]);
    const int64_t e = q_ev[j];
    const int64_t old_e = ev[s];
    if (e > old_e || (e == old_e && creation > cr[s])) {
      ev[s] = e;
      cr[s] = creation;
      const float* src = q_values + j * D;
      float* dst = values + s * D;
      for (int d = 0; d < D; ++d) dst[d] = src[d];
    }
  }
}

}  // namespace

// keys (P, C) int64; ev, cr (P, C) int64 and values (P, C, D) float32, all
// updated in place; sorted_q (P, Q) int64 each row ascending, order (P, Q)
// int64 the row position of each sorted key (torch.sort's indices), q_ev
// (P, Q) int64, q_values (P, Q, D) float32.  Non-pad keys of one partition
// must be distinct.  Returns the first CUDA error of the launch, or 0.
extern "C" int merge_scan_i64(const void* keys, void* ev, void* cr, void* values,
                              const void* sorted_q, const void* order, const void* q_ev,
                              const void* q_values, long long creation, int P, int C, int Q,
                              int D, void* stream) {
  if (P == 0 || C == 0 || Q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kSlotsPerBlock - 1) / kSlotsPerBlock, P);
  const size_t shared = static_cast<size_t>(Q) * sizeof(int64_t);
  const auto* k = static_cast<const int64_t*>(keys);
  auto* e = static_cast<int64_t*>(ev);
  auto* c = static_cast<int64_t*>(cr);
  auto* v = static_cast<float*>(values);
  const auto* sq = static_cast<const int64_t*>(sorted_q);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* qe = static_cast<const int64_t*>(q_ev);
  const auto* qv = static_cast<const float*>(q_values);
  if (shared <= kMaxShared) {
    if (shared > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_scan<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    merge_scan<true><<<grid, kThreads, shared, s>>>(k, e, c, v, sq, o, qe, qv, creation, C,
                                                    Q, D);
  } else {
    merge_scan<false><<<grid, kThreads, 0, s>>>(k, e, c, v, sq, o, qe, qv, creation, C, Q,
                                                D);
  }
  return static_cast<int>(cudaGetLastError());
}
