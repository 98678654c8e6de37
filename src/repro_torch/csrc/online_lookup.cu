// Online-store GET over the hash-partitioned key table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lookup_kernel` / `lookup_kernel_call` in
// src/repro/kernels/online_lookup/kernel.py.  Same contract on native int64:
// keys (P, C) int64, routed queries (P, Q) int64, out (P, Q) int32 = the
// largest slot of partition p whose key equals the query, or -1.  Any int64
// value is a key like any other: a query of -1 finds the largest empty slot,
// a pad of -2 a key of -2 if one is there, as in the plain version.  The TPU
// kernel compared every query with every key of its partition, O(P*C*Q), on
// two int32 planes (its vector compare is 32-bit); this kernel reads each
// key once and compares native int64.
//
// Bound on this card: bytes.  The function must read the P*C keys and the
// P*Q queries once and write P*Q slots: (8*P*C + 12*P*Q) bytes over
// 3.35 TB/s, e.g. 0.00253 ms at P=16, C=65536, Q=512 and 0.0402 ms at P=256,
// C=65536, Q=128; one int64 compare per key and per query is far below the
// integer rate.  chip_smoke.py computes the bound the same way.
//
// Design: inverted, keys stream past a hash of the queries.
//   * A block hashes one partition's query columns (query_hash.cuh) into
//     shared memory, 4 entries or more per column, behind a filter of 64
//     bits or more per column, so a key that matches nothing mostly costs
//     one 32-bit shared read.  Equal queries share an entry; each column
//     keeps the entry it maps to.
//   * It then streams its share of the partition's keys once, through a
//     ring of four shared-memory tiles fed by TMA bulk copies
//     (key_stream.cuh), so the bytes in flight do not depend on registers or
//     threads; each thread probes four keys of a tile at once, and a hit
//     raises the entry's best 1-based slot with a shared atomicMax, so the
//     largest equal slot wins whatever the order.  A block takes 64 to 512
//     threads by its share of keys and columns: the filter reads and the
//     rare table probes are chains of shared-memory latency, which more
//     warps hide.
//   * At small P a partition is split across the blocks of a thread-block
//     cluster (up to 8, so P=16 fills 128 SMs).  Each block hashes the same
//     columns in its own shared memory; after a cluster barrier each block
//     raises the leader's entries with its own bests through distributed
//     shared memory (the leader's column -> entry map, then atomicMax), and
//     after a second barrier the leader writes every column's 0-based slot,
//     or -1.  One launch a call: nothing is zeroed or fixed up afterwards.
//   * Partitions lie on grid x (times the cluster), which takes 2^31 - 1, so
//     P is not capped at 65,535.  A partition's columns are cut into chunks
//     of at most kMaxChunk (the hash and filter of a chunk fill at most
//     152 KiB of shared memory); chunks lie on grid y, and each chunk
//     rereads the partition's keys: Q > 2,048 costs ceil(Q / 2048) reads of
//     the keys.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "key_stream.cuh"
#include "query_hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // the most a block takes; small partitions take fewer
constexpr int kStages = 4;        // key tiles in flight a block
constexpr int kMaxChunk = 2048;   // query columns hashed at once
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMinKeys = 4096;    // keys per block below which no more are split
constexpr int kWave = 264;        // two blocks on each of an H100's 132 SMs

struct Hash {
  qhash::Table q;
  int32_t* best;  // 1-based best slot, 0: no key equal yet
  int32_t* col;   // column -> entry
};

__device__ __forceinline__ void raise_best(const Hash& t, int32_t h, int64_t slot) {
  if (h >= 0 && slot + 1 > t.best[h]) atomicMax(t.best + h, static_cast<int32_t>(slot + 1));
}

// Hash the chunk's n query columns `cols`.
__device__ __forceinline__ void build(const Hash& t, const int64_t* __restrict__ cols, int n) {
  qhash::clear(t.q);
  for (int h = threadIdx.x; h < (1 << t.q.bits); h += blockDim.x) t.best[h] = 0;
  qhash::insert_all(
      t.q, cols, n, [](int64_t) { return true; },
      [&](int j, uint32_t h, bool) { t.col[j] = static_cast<int32_t>(h); });
}

// Probe the hash with keys [a, e) of one partition's row, streamed through
// the ring: a thread takes two 16-byte pairs of each tile and probes their
// four keys at once.
__device__ __forceinline__ void scan(const Hash& t, const int64_t* __restrict__ row, int64_t a,
                                     int64_t e, unsigned char* ring) {
  kstream::stream<kStages>(
      row, a, e, ring, 4 * blockDim.x,
      [&](const int64_t* tile, int64_t first, int count) {
        int64_t k[4];
        bool live[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int pair = u * blockDim.x + threadIdx.x;
          live[2 * u] = live[2 * u + 1] = 2 * pair < count;
          longlong2 x = make_longlong2(0, 0);
          if (2 * pair < count) x = reinterpret_cast<const longlong2*>(tile)[pair];
          k[2 * u] = x.x;
          k[2 * u + 1] = x.y;
        }
        int32_t h[4];
        qhash::find_n(t.q, k, live, h);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          raise_best(t, h[u], first + 2 * ((u >> 1) * blockDim.x + threadIdx.x) + (u & 1));
        }
      },
      [&](int64_t k, int64_t slot) { raise_best(t, qhash::find(t.q, k), slot); });
}

__global__ void __launch_bounds__(kThreads)
lookup_hash(const int64_t* __restrict__ keys, const int64_t* __restrict__ queries,
            int32_t* __restrict__ out, int C, int Q, int chunk, int bits, int fbits,
            int cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = 1 << bits;
  unsigned char* ring = smem;
  Hash t;
  t.q.bits = bits;
  t.q.fbits = fbits;
  t.q.key = reinterpret_cast<int64_t*>(smem + kstream::ring_bytes<kStages>(4 * blockDim.x));
  t.q.own = reinterpret_cast<int32_t*>(t.q.key + H);
  t.best = t.q.own + H;
  t.q.filt = reinterpret_cast<uint32_t*>(t.best + H);
  t.col = reinterpret_cast<int32_t*>(t.q.filt + (1 << fbits) / 32);

  const int64_t p = blockIdx.x / cluster;
  const int rank = blockIdx.x % cluster;  // the cluster spans grid x
  const int64_t* row = keys + p * C;
  const int64_t per_block = ((C + cluster - 1) / cluster + 1) & ~1;  // even: 16-byte pairs
  const int64_t a = rank * per_block < C ? rank * per_block : C;
  const int64_t e = a + per_block < C ? a + per_block : C;
  const int chunks = (Q + chunk - 1) / chunk;

  for (int ch = blockIdx.y; ch < chunks; ch += gridDim.y) {
    const int q0 = ch * chunk;
    const int n = min(chunk, Q - q0);
    build(t, queries + p * Q + q0, n);
    scan(t, row, a, e, ring);
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();  // every block's bests are final
      if (rank != 0) {
        int32_t* lead_best = cl.map_shared_rank(t.best, 0);
        const int32_t* lead_col = cl.map_shared_rank(t.col, 0);
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
          const int32_t h = t.col[j];
          const int32_t b = t.best[h];
          if (b && t.q.own[h] == j + 1) atomicMax(lead_best + lead_col[j], b);
        }
      }
      cl.sync();  // the leader's bests are final; no block reads another after this
      if (rank != 0) continue;
    }
    int32_t* o = out + p * Q + q0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) o[j] = t.best[t.col[j]] - 1;
    __syncthreads();  // the next chunk's hash overwrites this one
  }
}

}  // namespace

// keys (P, C) int64, queries (P, Q) int64, out (P, Q) int32, written whole
// (no zeroing needed).  One launch.  Returns cudaGetLastError() after it.
extern "C" int online_lookup_i64(const void* keys, const void* queries, void* out, int P,
                                 int C, int Q, void* stream) {
  if (static_cast<int64_t>(P) * Q == 0) return static_cast<int>(cudaGetLastError());
  const int chunks = (Q + kMaxChunk - 1) / kMaxChunk;
  const int chunk = (Q + chunks - 1) / chunks;
  int bits = 1;
  while ((1 << bits) < 4 * chunk) ++bits;
  int fbits = 10;  // 64 filter bits a column or more: under 2% of misses pass
  while ((1 << fbits) < 64 * chunk) ++fbits;
  int cluster = 1;
  while (cluster < kMaxCluster && static_cast<int64_t>(P) * cluster * 2 <= kWave &&
         C / (cluster * 2) >= kMinKeys) {
    cluster *= 2;
  }
  // enough threads for a block's keys and columns, so many small partitions
  // do not each pay for 512 threads' clearing and barriers
  const int64_t per_block = (C + cluster - 1) / cluster + chunk;
  int threads = 64;
  while (threads < kThreads && threads * 16 < per_block) threads *= 2;
  const size_t smem = kstream::ring_bytes<kStages>(4 * threads) +
                      (static_cast<size_t>(16) << bits) + (size_t{1} << fbits) / 8 +
                      sizeof(int32_t) * chunk;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookup_hash, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<int64_t>(P) * cluster),
                     static_cast<unsigned>(min(chunks, 65535)), 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, lookup_hash, static_cast<const int64_t*>(keys),
                         static_cast<const int64_t*>(queries), static_cast<int32_t*>(out), C,
                         Q, chunk, bits, fbits, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
