// An open-addressing hash of one partition's int64 query keys, with a bit
// filter in front of it, shared by online_lookup.cu and merge_scan.cu.
//
// A table of 2^bits entries and a filter of 2^fbits bits live in shared or
// global memory (the functions take generic pointers) and are built and read
// by the threads of one block.
//   * Entry h is empty while own[h] == 0; a column j that claims it sets
//     own[h] = j + 1 and key[h] to its key.  Occupancy is kept apart from
//     the key, so no int64 value is reserved to mean "empty": every value,
//     -1, -2, INT64_MIN and INT64_MAX included, is an ordinary key.  Equal
//     keys share one entry (insert_all).  Linear probing; the callers keep
//     the load at or below one half.
//   * Each key also sets one bit of the filter, from other bits of the same
//     mix.  A probe reads its bit first (one 32-bit word) and goes on to the
//     table only when it is set: with 16 or more filter bits a key, most
//     keys that match nothing stop there.  The table's random 4- and 8-byte
//     reads, with their bank conflicts, are what the scans of both kernels
//     spend their shared-memory time on without it.
#pragma once

#include <cstdint>

namespace qhash {

struct Table {
  int32_t* own;
  int64_t* key;
  uint32_t* filt;
  int bits;   // 2^bits entries
  int fbits;  // 2^fbits filter bits, fbits <= 20
};

// A multiplicative mix of the key.  The xor-shift first folds the high word
// in, so keys that differ only above bit 31 spread too, and the multiplier
// is not the partition router's (kernels/online_lookup/ops.py
// `partition_of`), so the keys of one partition do not share hash bits.
__device__ __forceinline__ uint64_t mix(int64_t k) {
  uint64_t x = static_cast<uint64_t>(k);
  x ^= x >> 29;
  return x * 0xBF58476D1CE4E5B9ull;
}

// The first entry of a key: the mix's top bits.
__device__ __forceinline__ uint32_t slot(uint64_t x, int bits) {
  return static_cast<uint32_t>(x >> (64 - bits));
}

// The filter bit of a key: bits 20 and up of the mix, below the entry's.
__device__ __forceinline__ uint32_t fbit(uint64_t x, int fbits) {
  return static_cast<uint32_t>(x >> 20) & ((1u << fbits) - 1);
}

__device__ __forceinline__ bool passes(const Table& t, uint64_t x) {
  const uint32_t f = fbit(x, t.fbits);
  return (t.filt[f >> 5] >> (f & 31)) & 1u;
}

// An empty table and filter, by the threads of one block.
__device__ __forceinline__ void clear(const Table& t) {
  for (int h = threadIdx.x; h < (1 << t.bits); h += blockDim.x) t.own[h] = 0;
  for (int w = threadIdx.x; w < (1 << t.fbits) / 32; w += blockDim.x) t.filt[w] = 0;
}

// The entry holding key k (mixed: x), or -1.  The table must be complete
// (its builders synchronized with the reader).
__device__ __forceinline__ int32_t find_table(const Table& t, int64_t k, uint64_t x) {
  const uint32_t mask = (1u << t.bits) - 1;
  uint32_t h = slot(x, t.bits);
  while (true) {
    if (t.own[h] == 0) return -1;
    if (t.key[h] == k) return static_cast<int32_t>(h);
    h = (h + 1) & mask;
  }
}

// Hash the n columns cols[0, n) by the threads of one block, four columns a
// thread at a time (their loads in flight together).  A column claims the
// first free entry of its probe sequence with atomicCAS of own[h] from 0 to
// j + 1 and stores its key there.  A column that finds an entry taken
// compares its key with the owner's column in `cols` (read-only, so always
// there; the owner's store into the table may not have landed yet): equal,
// it shares the entry; else it probes on.  No column waits for another's
// store, so no warp spins on one of its own lanes.  keep(v) says whether to
// place a column at all; done(j, h, first) is called once for each placed
// column with its entry, and whether the column claimed it itself (false:
// an equal key did).  The filter bit of each placed key is set too.  Every
// thread of the block must call this; it begins and ends with a barrier.
template <typename Keep, typename Done>
__device__ __forceinline__ void insert_all(const Table& t, const int64_t* __restrict__ cols,
                                           int n, Keep keep, Done done) {
  const uint32_t mask = (1u << t.bits) - 1;
  __syncthreads();  // the table is clear
  for (int j0 = 0; j0 < n; j0 += 4 * blockDim.x) {
    int64_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      v[u] = j < n ? cols[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      if (j < n && keep(v[u])) {
        const uint64_t x = mix(v[u]);
        const uint32_t f = fbit(x, t.fbits);
        atomicOr(t.filt + (f >> 5), 1u << (f & 31));
        uint32_t h = slot(x, t.bits);
        while (true) {
          const int32_t o = atomicCAS(t.own + h, 0, j + 1);
          if (o == 0) {
            t.key[h] = v[u];
            done(j, h, true);
            break;
          }
          if (cols[o - 1] == v[u]) {
            done(j, h, false);
            break;
          }
          h = (h + 1) & mask;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int32_t find(const Table& t, int64_t k) {
  const uint64_t x = mix(k);
  return passes(t, x) ? find_table(t, k, x) : -1;
}

// find for N keys at once: every key's filter word is read before any is
// tested, so the N loads overlap, and only keys that pass go on to the
// table.  e[i] is the entry of k[i], or -1 (also where live[i] is false).
template <int N>
__device__ __forceinline__ void find_n(const Table& t, const int64_t (&k)[N],
                                       const bool (&live)[N], int32_t (&e)[N]) {
  uint64_t x[N];
  bool pass[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = mix(k[i]);
    pass[i] = live[i] && passes(t, x[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = pass[i] ? find_table(t, k[i], x[i]) : -1;
}

}  // namespace qhash
