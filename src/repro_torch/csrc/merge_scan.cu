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
// A winner key that is neither live (>= 0) nor the pad, or a live key twice
// in one partition, refuses the whole batch: no slot changes.
//
// The TPU kernel matched every slot block against every query as a (Cb x Q)
// broadcast, gathered the winning rows with a one-hot float32 matmul on the
// MXU, and split each int64 into two int32 planes for its 32-bit vector
// compare.  Here each partition's winner keys go into a hash
// (query_hash.cuh) and each slot probes it with its native int64 key.
//
// Bound on this card: bytes.  There is no index, so every one of the P*C
// keys must be read once; each matched slot also reads its old (ev, cr) and
// the winner's (ev, values) and writes (ev, cr, values).  chip_smoke.py
// computes the bound from each run's data.
//
// Design: two kernels on the stream, after zeroing a verdict word in the
// wrapper's scratch.
//   1. `merge_check`, one block per partition, hashes the partition's winner
//      keys (query_hash.cuh), 2 entries and 64 filter bits or more per key,
//      into the scratch for kernel 2: built in shared memory and copied out
//      when the hash fits in kMaxSharedHash, else built there.  A key found
//      already in the hash is a duplicate (bit 2 of the verdict), a negative
//      key other than the pad a bad one (bit 1).
//   2. `merge_update` reads the verdict first.  If it is set, block 0 copies
//      it into the error word (csrc/errors.cu) and every block returns, so
//      a refused batch writes nothing.  Otherwise each block copies its
//      partition's hash from the scratch into its shared memory (or, when
//      it does not fit, probes it there) and works in two phases over its
//      share of the slots:
//      * scan: every key is read once, through a ring of four shared-memory
//        tiles fed by TMA bulk copies (key_stream.cuh), so the bytes in
//        flight do not depend on registers; each thread probes four keys of
//        a tile at once (the filter, then the table for the few that pass),
//        and each warp lists its matched slots (slot, winner column) in its
//        own part of shared memory;
//      * apply, by each warp on its own list whenever the next tile could
//        overflow it, and at the end: 128 matches a round, all their
//        (ev, cr) and winner ev loaded at once, the slots decided and
//        stamped, and the winning rows copied by the whole warp, eight
//        16-byte pieces in flight a lane where D is a multiple of 4 (a D=32
//        row is one 128-byte line).
//      No barrier of the block falls inside the scan, so while one warp
//      waits on its matches' loads the others go on scanning.  Each slot is
//      written by one warp (a first key off the 16-byte alignment and an odd
//      last key by one thread), with no atomics on the table, so the result
//      does not depend on the order the blocks or warps run in.
// Partitions lie on grid x, which takes 2^31 - 1: P is not capped.  A block
// takes 64 to 512 threads, by its share of slots, so a table of many small
// partitions does not pay 512 threads' hash building per partition.
#include <cuda_runtime.h>

#include <cstdint>

#include "key_stream.cuh"
#include "query_hash.cuh"

namespace {

constexpr int kThreads = 512;                  // the most a block takes
constexpr int kCheckThreads = 512;
constexpr int kStages = 4;                     // key tiles in flight a block
constexpr int kApply = 4;                      // matches a lane per round of the update
constexpr int kCopy = 8;                       // row pieces a lane loads before storing
constexpr size_t kMaxSharedHash = 96 * 1024;   // + filter, ring and match lists: 224 KiB
constexpr int kMaxSplit = 8;                   // blocks sharing one partition's slots
constexpr int kMinSlots = 4096;                // slots per block below which none split
constexpr int kWave = 264;                     // two blocks on each of an H100's 132 SMs
constexpr int64_t kPad = -2;
constexpr int kBadKey = 1, kDuplicate = 2;     // verdict bits, as the error word's

// entries of a partition's hash: 2^bits >= 2 * Q, and at least 4 (so that
// every table in the scratch stays 16-byte aligned)
int hash_bits(int Q) {
  int bits = 2;
  while ((int64_t{1} << bits) < 2 * static_cast<int64_t>(Q)) ++bits;
  return bits;
}

// bits of its filter: 64 a key or more, between 2^10 and 2^20
int filter_bits(int Q) {
  int fbits = 10;
  while (fbits < 20 && (int64_t{1} << fbits) < 64 * static_cast<int64_t>(Q)) ++fbits;
  return fbits;
}

bool shared_hash(int bits) { return (size_t{12} << bits) <= kMaxSharedHash; }

// bytes of one partition's hash and filter: keys, owners, filter words
__host__ __device__ constexpr size_t table_bytes(int bits, int fbits) {
  return (size_t{12} << bits) + (size_t{1} << fbits) / 8;
}

__device__ __forceinline__ qhash::Table table_at(unsigned char* base, int bits, int fbits) {
  qhash::Table t;
  t.bits = bits;
  t.fbits = fbits;
  t.key = reinterpret_cast<int64_t*>(base);
  t.own = reinterpret_cast<int32_t*>(t.key + (1 << bits));
  t.filt = reinterpret_cast<uint32_t*>(t.own + (1 << bits));
  return t;
}

// matches a warp's list holds: eight a lane, applied when a tile of the scan
// could overflow it
constexpr int kWarpList = 256;

// Hash the live keys of one partition's winners `qk` (Q of them); the bits
// of the verdict they earn.
__device__ int build(const qhash::Table& t, const int64_t* __restrict__ qk, int Q) {
  qhash::clear(t);
  int flags = 0;
  qhash::insert_all(
      t, qk, Q,
      [&](int64_t v) {
        if (v < 0 && v != kPad) flags |= kBadKey;
        return v >= 0;
      },
      [&](int, uint32_t, bool fresh) {
        if (!fresh) flags |= kDuplicate;
      });
  return flags;
}

// n bytes (a multiple of 16, both ends 16-byte aligned) by the threads of
// one block, eight 16-byte loads in flight a thread.
__device__ __forceinline__ void copy16(unsigned char* dst, const unsigned char* src,
                                       size_t n) {
  const int4* from = reinterpret_cast<const int4*>(src);
  int4* to = reinterpret_cast<int4*>(dst);
  const int64_t m = static_cast<int64_t>(n / 16);
  for (int64_t i0 = 0; i0 < m; i0 += 8 * blockDim.x) {
    int4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = i0 + u * blockDim.x + threadIdx.x;
      if (i < m) x[u] = from[i];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = i0 + u * blockDim.x + threadIdx.x;
      if (i < m) to[i] = x[u];
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kCheckThreads)
merge_check(const int64_t* __restrict__ q_keys, unsigned char* __restrict__ g_tables,
            int32_t* __restrict__ verdict, int Q, int bits, int fbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t p = blockIdx.x;
  unsigned char* global = g_tables + p * table_bytes(bits, fbits);
  const qhash::Table t = table_at(kShared ? smem : global, bits, fbits);
  const int flags = build(t, q_keys + p * Q, Q);
  if (flags) atomicOr(verdict, flags);
  if constexpr (kShared) copy16(global, smem, table_bytes(bits, fbits));  // for kernel 2
}

// What the update of one partition's slots writes and reads.
struct Update {
  int64_t* ev;
  int64_t* cr;
  float* values;
  const int64_t* q_ev;
  const float* q_values;
  int64_t creation;
  int64_t row0;  // the partition's first table row
  int64_t src0;  // its first winner row
  int D;
};

// Apply the n matches a warp listed (slot c of the partition, winner column
// j), 32 * kApply a round: load every one's (ev, cr) and winner ev at once,
// stamp the slots it wins, list the winners in place of its matches, and
// copy their rows with the whole warp, kCopy loads in flight a lane
// (16-byte pieces where T is float4).  Called by all lanes of the warp.
template <typename T>
__device__ void apply(const Update& u, int32_t* m_c, int32_t* m_j, int n) {
  constexpr int kW = sizeof(T) / sizeof(float);
  const int lane = threadIdx.x & 31;
  const int per_row = u.D / kW;
  for (int i0 = 0; i0 < n; i0 += 32 * kApply) {
    int32_t c[kApply], j[kApply];
    int64_t qe[kApply], old_e[kApply], old_c[kApply];
#pragma unroll
    for (int a = 0; a < kApply; ++a) {
      const int i = i0 + a * 32 + lane;
      c[a] = -1;
      if (i < n) {
        c[a] = m_c[i];
        j[a] = m_j[i];
        qe[a] = u.q_ev[u.src0 + j[a]];
        old_e[a] = u.ev[u.row0 + c[a]];
        old_c[a] = u.cr[u.row0 + c[a]];
      }
    }
    __syncwarp();  // the matches are read before the winners overwrite them
    int w = 0;
#pragma unroll
    for (int a = 0; a < kApply; ++a) {
      const bool win =
          c[a] >= 0 && (qe[a] > old_e[a] || (qe[a] == old_e[a] && u.creation > old_c[a]));
      const unsigned ballot = __ballot_sync(0xffffffffu, win);
      if (win) {
        u.ev[u.row0 + c[a]] = qe[a];
        u.cr[u.row0 + c[a]] = u.creation;
        const int r = i0 + w + __popc(ballot & ((1u << lane) - 1));
        m_c[r] = c[a];
        m_j[r] = j[a];
      }
      w += __popc(ballot);
    }
    __syncwarp();
    const int pieces = w * per_row;
    for (int p0 = 0; p0 < pieces; p0 += 32 * kCopy) {
      T x[kCopy];
      int64_t dst[kCopy];
#pragma unroll
      for (int a = 0; a < kCopy; ++a) {
        const int q = p0 + a * 32 + lane;
        if (q < pieces) {
          const int r = q / per_row;
          const int piece = q - r * per_row;
          dst[a] = (u.row0 + m_c[i0 + r]) * per_row + piece;
          x[a] = __ldg(reinterpret_cast<const T*>(u.q_values) + (u.src0 + m_j[i0 + r]) * per_row +
                       piece);
        }
      }
#pragma unroll
      for (int a = 0; a < kCopy; ++a) {
        if (p0 + a * 32 + lane < pieces) reinterpret_cast<T*>(u.values)[dst[a]] = x[a];
      }
    }
    __syncwarp();  // the list is read before the next round's winners overwrite it
  }
}

// Apply one match by one thread: a slot outside the scan's tiles.
__device__ void apply_one(const Update& u, int64_t c, int32_t j) {
  const int64_t s = u.row0 + c;
  const int64_t src = u.src0 + j;
  const int64_t qe = u.q_ev[src];
  if (qe > u.ev[s] || (qe == u.ev[s] && u.creation > u.cr[s])) {
    u.ev[s] = qe;
    u.cr[s] = u.creation;
    for (int d = 0; d < u.D; ++d) u.values[s * u.D + d] = u.q_values[src * u.D + d];
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
merge_update(const int64_t* __restrict__ keys, int64_t* __restrict__ ev,
             int64_t* __restrict__ cr, float* __restrict__ values,
             const int64_t* __restrict__ q_ev, const float* __restrict__ q_values,
             unsigned char* __restrict__ g_tables, const int32_t* __restrict__ verdict,
             int32_t* err, int64_t creation, int C, int Q, int D, int bits, int fbits, int split,
             bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int refused = *reinterpret_cast<const volatile int32_t*>(verdict);
  if (refused) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *reinterpret_cast<volatile int32_t*>(err) = refused;
    return;
  }
  const int64_t p = blockIdx.x / split;
  const int part = blockIdx.x % split;
  const int tile = 4 * blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* ring = smem;
  int32_t* lists = reinterpret_cast<int32_t*>(smem + kstream::ring_bytes<kStages>(tile));
  int32_t* m_c = lists + 2 * kWarpList * warp;  // this warp's matches
  int32_t* m_j = m_c + kWarpList;
  unsigned char* global = g_tables + p * table_bytes(bits, fbits);
  qhash::Table t;
  if constexpr (kShared) {
    auto* local = reinterpret_cast<unsigned char*>(lists + 2 * kWarpList * (blockDim.x >> 5));
    copy16(local, global, table_bytes(bits, fbits));  // kernel 1's hash
    t = table_at(local, bits, fbits);
  } else {
    t = table_at(global, bits, fbits);
  }
  const Update u{ev, cr, values, q_ev, q_values, creation, p * C, p * Q, D};
  const int64_t per_block = (C + split - 1) / split;
  const int64_t a = part * per_block < C ? part * per_block : C;
  const int64_t e = a + per_block < C ? a + per_block : C;
  int n = 0;  // matches in this warp's list, the same in every lane
  auto flush = [&] {
    if (vec4) {
      apply<float4>(u, m_c, m_j, n);
    } else {
      apply<float>(u, m_c, m_j, n);
    }
    n = 0;
  };
  // scan, each warp listing its matched slots and applying its list
  // whenever the next tile could overflow it: no barrier of the block
  kstream::stream<kStages>(
      keys + u.row0, a, e, ring, tile,
      [&](const int64_t* keys_s, int64_t first, int count) {
        int64_t k[4];
        bool live[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = i * blockDim.x + threadIdx.x;
          k[i] = at < count ? keys_s[at] : -1;
          live[i] = k[i] >= 0;  // empty slots (-1) never match; pads (-2) are not hashed
        }
        int32_t h[4];
        qhash::find_n(t, k, live, h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned ballot = __ballot_sync(0xffffffffu, h[i] >= 0);
          if (h[i] >= 0) {
            const int r = n + __popc(ballot & ((1u << lane) - 1));
            m_c[r] = static_cast<int32_t>(first + i * blockDim.x + threadIdx.x);
            m_j[r] = t.own[h[i]] - 1;
          }
          n += __popc(ballot);
        }
        if (n > kWarpList - 4 * 32) {
          __syncwarp();
          flush();
        }
      },
      [&](int64_t k, int64_t slot) {
        const int32_t h = k >= 0 ? qhash::find(t, k) : -1;
        if (h >= 0) apply_one(u, slot, t.own[h] - 1);
      });
  __syncwarp();
  flush();
}

// int64 words of scratch: the verdict (padded to 16 bytes), and every
// partition's hash and filter (kernels/online_merge/ops.py `scratch_len`
// mirrors this)
int64_t scratch_words(int P, int bits, int fbits) {
  return 2 + static_cast<int64_t>(P) * table_bytes(bits, fbits) / 8;
}

}  // namespace

// keys (P, C) int64; ev, cr (P, C) int64 and values (P, C, D) float32, all
// updated in place; q_keys, q_ev (P, Q) int64, q_values (P, Q, D) float32;
// scratch: scratch_len int64 words, at least scratch_words(P, bits, fbits); err: an
// error word from repro_error_word_alloc, set to the verdict (1: a bad key,
// 2: a duplicate, 3: both) when the batch is refused.  Returns the first
// CUDA error of the launches, or 0.
extern "C" int merge_scan_i64(const void* keys, void* ev, void* cr, void* values,
                              const void* q_keys, const void* q_ev, const void* q_values,
                              void* scratch, long long scratch_len, void* err,
                              long long creation, int P, int C, int Q, int D, void* stream) {
  if (static_cast<int64_t>(P) * C * Q == 0) return static_cast<int>(cudaGetLastError());
  const int bits = hash_bits(Q);
  const int fbits = filter_bits(Q);
  if (bits > 30 || scratch_len < scratch_words(P, bits, fbits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in_shared = shared_hash(bits);
  auto* verdict = static_cast<int32_t*>(scratch);
  auto* g_tables = reinterpret_cast<unsigned char*>(static_cast<int64_t*>(scratch) + 2);
  const size_t hash_smem = in_shared ? table_bytes(bits, fbits) : 0;
  int split = 1;
  while (split < kMaxSplit && static_cast<int64_t>(P) * split * 2 <= kWave &&
         C / (split * 2) >= kMinSlots) {
    split *= 2;
  }
  // enough threads for a block's slots, so many small partitions do not
  // each pay for 512 threads' hash building and barriers
  int threads = 64;
  while (threads < kThreads && threads * 8 < (C + split - 1) / split) threads *= 2;
  const size_t lists_smem = kstream::ring_bytes<kStages>(4 * threads) +
                            2 * sizeof(int32_t) * kWarpList * (threads / 32);
  const bool vec4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(q_values) & 15) == 0;

  cudaError_t e = cudaMemsetAsync(verdict, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto check = in_shared ? merge_check<true> : merge_check<false>;
  if (hash_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(check, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(hash_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int check_threads = 64;
  while (check_threads < kCheckThreads && check_threads < Q) check_threads *= 2;
  check<<<static_cast<unsigned>(P), check_threads, hash_smem, s>>>(
      static_cast<const int64_t*>(q_keys), g_tables, verdict, Q, bits, fbits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const auto kernel = in_shared ? merge_update<true> : merge_update<false>;
  const size_t smem = hash_smem + lists_smem;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    // all of the SM's unified memory as shared memory
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(static_cast<int64_t>(P) * split), threads, smem, s>>>(
      static_cast<const int64_t*>(keys), static_cast<int64_t*>(ev), static_cast<int64_t*>(cr),
      static_cast<float*>(values), static_cast<const int64_t*>(q_ev),
      static_cast<const float*>(q_values), g_tables, verdict, static_cast<int32_t*>(err),
      creation, C, Q, D, bits, fbits, split, vec4);
  return static_cast<int>(cudaGetLastError());
}
