// One block's range of a row of int64 keys streamed through a ring of
// shared-memory tiles by TMA bulk copies, shared by online_lookup.cu and
// merge_scan.cu.
//
// Thread 0 keeps kStages tiles in flight: each is one cp.async.bulk from
// device memory that completes on the tile's `full` mbarrier.  Every thread
// waits for a tile, reads it from shared memory, and arrives on its `empty`
// mbarrier; thread 0 refills a stage once all have arrived.  The bytes in
// flight are the ring's, not the registers', so the scan can reach the
// memory rate with few threads and no unrolled loads.  A bulk copy needs a
// 16-byte-aligned source and a length that is a multiple of 16, so a first
// key off that alignment and an odd last key are handed to `one` instead.
#pragma once

#include <cstdint>

namespace kstream {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory the ring takes: the tiles, then 2 * kStages mbarriers.
template <int kStages>
__host__ __device__ constexpr size_t ring_bytes(int tile) {
  return sizeof(int64_t) * kStages * static_cast<size_t>(tile) + 16 * kStages;
}

// Keys [a, e) of `row` through the ring at `ring` (16-byte aligned,
// ring_bytes<kStages>(tile) bytes; tile even): every thread of the block
// calls tile_fn(keys, first, n) for each tile (n keys, keys[i] in shared
// memory is row[first + i]), in order; before them, one thread calls
// one(key, index) for a first key off the 16-byte alignment and another for
// an odd last key.  Begins and ends with a barrier of the block.
template <int kStages, typename TileFn, typename OneFn>
__device__ __forceinline__ void stream(const int64_t* __restrict__ row, int64_t a, int64_t e,
                                       unsigned char* ring, int tile, TileFn&& tile_fn,
                                       OneFn&& one) {
  int64_t* buf = reinterpret_cast<int64_t*>(ring);
  uint64_t* bars = reinterpret_cast<uint64_t*>(buf + static_cast<int64_t>(kStages) * tile);
  const uint32_t full = smem_u32(bars);
  const uint32_t empty = smem_u32(bars + kStages);
  __syncthreads();  // nobody still waits on the barriers of an earlier stream
  if (a < e && (reinterpret_cast<uintptr_t>(row + a) & 15)) {
    if (threadIdx.x == 0) one(row[a], a);
    ++a;
  }
  if (((e - a) & 1) && threadIdx.x == blockDim.x - 1) one(row[e - 1], e - 1);
  const int64_t n = (e - a) & ~int64_t{1};
  const int64_t tiles = (n + tile - 1) / tile;
  auto issue = [&](int64_t k, int s) {
    const int64_t count = n - k * tile < tile ? n - k * tile : tile;
    bulk_load(smem_u32(buf + static_cast<int64_t>(s) * tile), row + a + k * tile,
              static_cast<uint32_t>(count * sizeof(int64_t)), full + 8 * s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, blockDim.x);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages && s < tiles; ++s) issue(s, s);
  }
  __syncthreads();
  for (int64_t k = 0; k < tiles; ++k) {
    const int s = static_cast<int>(k % kStages);
    const uint32_t parity = static_cast<uint32_t>(k / kStages) & 1;
    mbar_wait(full + 8 * s, parity);
    const int64_t count = n - k * tile < tile ? n - k * tile : tile;
    tile_fn(buf + static_cast<int64_t>(s) * tile, a + k * tile, static_cast<int>(count));
    mbar_arrive(empty + 8 * s);
    if (threadIdx.x == 0 && k + kStages < tiles) {
      mbar_wait(empty + 8 * s, parity);
      issue(k + kStages, s);
    }
  }
  __syncthreads();
}

}  // namespace kstream
