// Causal GQA flash attention, backward, on Hopper's tensor cores (sm_90a).
//
// The bf16 route of the port's flash backward at head dims 64, 112, 128 and
// 256, behind flash_attn_tc.cu's forward.  No TPU kernel to replace: the JAX
// package leaves its backward to XLA, which differentiates the einsum path
// (and cannot differentiate its Pallas forward).  The contract is ref.py's
// attention_bwd_lse_ref: from q (B, S, H, D), k and v (B, T, KV, D), the
// forward's log-sum-exp lse (B, H, S) and dO, in the model's layout (no GQA
// expansion, no transpose copies): P = exp(q.k / sqrt(D) - lse) with key t
// masked for query s when t > s (causal) or t >= T, dP = dO.V^T, delta =
// rowsum(P * dP) in float32 (flash_bwd_common.cuh says why not rowsum(dO *
// O)), dV = P^T.dO, dS = P * (dP - delta), dK = dS^T.Q / sqrt(D), dQ =
// dS.K / sqrt(D).  Every product takes bf16 operands and float32
// accumulation (P and dS are rounded to bf16 as wgmma operands, as the
// forward's P.V rounds P and as scaled_dot_product_attention's backward
// does); each gradient is rounded once to bf16.
//
// Bound on this card: operations.  At gemma-2b's training shape (B=4,
// S=T=2,048, H=8, KV=1, D=256) five products (QK^T again, dV, dP, dQ, dK)
// of 2 D operations per visible (query head, key) pair are 1.72e11
// operations, 0.174 ms at the tensor cores' 989 TFLOP/s.  This schedule
// does seven at every head dim, none recomputed: QK^T and dO.V^T in the
// delta pass, then each of the five once in the fused pass.
//
// Three kernels.  The first two are blocks of 384 threads: a producer
// warpgroup (setmaxnreg 24) whose one thread TMA-loads the resident tiles
// and streams the others through a two-stage ring (full and empty
// mbarriers), and two consumer warpgroups (setmaxnreg 240).  Tiles are the
// forward's: 4-D tensor maps (D, heads, rows, B) over the model layout, one
// 64-column panel (128 bytes) a box, 128-byte swizzled, zero-filled past the
// edges.
//  - flash_bwd_delta<D>: one block per (b, h, 128 queries); Q and dO
//    resident and read once into registers as wgmma A fragments (at D=256
//    their shared memory then holds two more stages of K and V), K and V
//    streamed 128 keys a tile (64 at D=256) up to the diagonal; S = Q.K^T
//    and dP = dO.V^T, delta = rowsum(P * dP) in registers, written with the
//    row's lse (times log2 e) as its (lse, delta) pair.
//  - flash_bwd_fused<D>: persistent, one block an SM, taking (b, query head
//    h, key tile n) work items from an atomic counter in increasing order
//    (decode_item).  K and V of kv head h / G resident; Q, dO and their
//    (lse, delta) pairs streamed 64 queries a tile, from the last query tile
//    up to the diagonal's.  S^T and dP^T once each, dV += P^T.dO and dK +=
//    dS^T.Q into registers, dQ_tile = dS.K (dS from shared memory as an
//    M-major A operand, K read N-major) added into float32 sums in global
//    memory.
//      D <= 128: 128 keys an item, 64 a warpgroup.  Each forms its keys' P^T
//      and dS^T in registers (register A operands for dV and dK), writes dS^T
//      to a double-buffered exchange, and after a barrier of both computes
//      one 64-column half of the tile's dQ over all 128 keys (D=64: all of
//      it, warpgroup (query tile & 1)).  It stages that share in shared
//      memory; its writer lane (a producer-warpgroup thread) adds it to the
//      sum with one TMA bulk reduce, so the warpgroup never waits on global
//      memory.  226 KB of shared memory at D=128.
//      D=256: 64 keys an item, the columns split.  Warpgroup 0 computes S^T
//      and P^T, warpgroup 1 dP^T and then dS^T from P^T handed over in
//      float32; both exchange P^T and dS^T as bf16 through shared memory,
//      and each accumulates its 128 columns of dK and dV (64 + 64
//      accumulators a thread) and of dQ, which it adds with red.global.add
//      once its turn lane grants the turn.  226 KB of shared memory: no room
//      to stage dQ.
//    D=112 runs the D=128 tiles: the maps keep the head dim at 112, TMA
//    zero-fills columns 112..127, the contractions over D take 7 k-steps,
//    and no zero column is stored.
//  - flash_bwd_dq<D>: the dQ sums times 1/sqrt(D), rounded once to bf16 in
//    q's strides.
//
// Deterministic: no floating-point atomic whose order varies.  The dQ of
// (b, h, query tile m, column half) is summed over key tiles n = 0, 1, ...
// in that order: a counter per sum says whose turn it is.  Key tile n's
// turn comes when the counter reads n (an acquire load); it stores (n = 0)
// or adds its share, and the counter is passed on with a release add once
// the writes are complete, so each float32 sum is ((d_0 + d_1) + d_2) + ...
// and two calls give the same bits.  It cannot deadlock: a turn waits only
// on a lower key tile of its (b, h), claimed earlier, by a block that was
// then running and that never waits on a later claim.  Visiting query tiles
// from the last one up keeps the blocks of one (b, h) in step: tile n and
// tile n - 1 reach the same query tile at the same iteration.  With GQA the
// query heads of a group add their dK and dV the same way, in head order
// (each head's claims a sweep after the one before), into float32 sums of
// (b, kv head, key tile), the last head rounding them into dk and dv.  The
// delta pass zeroes the turn counters, so the wrapper launches nothing else.
//
// Left for later: overlapping a warpgroup's S^T and dP^T with its own
// elementwise step (the forward's software pipeline: a second S^T and dP^T
// do not fit in the registers beside 128 dK/dV accumulators; the two
// warpgroups' products overlap each other's instead), staging dQ at D=256,
// delta in the fused pass (from dO.O it fails the gradient check).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>
#include <initializer_list>

#include "flash_bwd_common.cuh"
#include "hopper_tc.cuh"

namespace {

constexpr int kStages = 2;            // ring depth of the streamed tiles
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kBQ = 64;               // queries of a fused-pass tile
constexpr int kSmemMax = 232448;      // what a block can have
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDevices = 64;          // devices a process can launch on

// ---- the delta pass -------------------------------------------------------

template <int D>
struct DeltaTile {
  static constexpr int kBM = 128;                        // queries a block
  static constexpr int kPanels = (D + 63) / 64;          // 128-byte panels of the head dim
  static constexpr int kBN = D == 256 ? 64 : 128;        // keys a streamed tile
  static constexpr int kMPanel = kBM * 128;
  static constexpr int kNPanel = kBN * 128;
  static constexpr int kMBytes = kPanels * kMPanel;      // Q (or dO)
  static constexpr int kNBytes = kPanels * kNPanel;      // a tile of K (or V)
  // D=256: Q and dO are read once into registers, and their 64 KB each then
  // hold the second and third stage of K and V, beside the first: three
  // 64 KB regions.  D <= 128: Q, dO and two stages.
  static constexpr bool kRecycle = D == 256;
  static constexpr int kStages = kRecycle ? 3 : 2;
  static_assert(!kRecycle || 2 * kNBytes == kMBytes, "a stage fills a region");
  static constexpr int kBarOffset = kRecycle ? 3 * kMBytes : 2 * kMBytes + 4 * kNBytes;
  // + 8 mbarriers, + 1 KB to align the base to the swizzle's 1,024 bytes
  static constexpr int kSmem = kBarOffset + 64 + 1024;
  static_assert(kSmem <= kSmemMax, "the delta pass's tiles exceed a block's shared memory");
};

// Resident Q and dO (head h), streamed K and V (kv head h / G); writes the
// rows' (lse * log2 e, delta) pairs into `stats` from `lse`, and zeroes the
// n_ctr counters at `ctr`.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_delta(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, float2* __restrict__ stats, int* __restrict__ ctr,
                int n_ctr, int S, int Tk, int S_pad, int H, int group, float scale_log2,
                int causal) {
  using L = DeltaTile<D>;
  // the fused pass's turn counters, zeroed for it (it runs next on the stream)
  for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x; i < n_ctr;
       i += gridDim.x * gridDim.y * kThreads)
    ctr[i] = 0;
  constexpr int BN = L::kBN;
  constexpr int NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + L::kMBytes;
  const uint32_t bars = sq + L::kBarOffset;
  // barriers: Q and dO full, then full and empty for each stage, then (D=256)
  // Q's and dO's regions free
  const uint32_t a_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + NS + st); };
  const uint32_t freed = bars + 8u * (1 + 2 * NS);
  auto sk = [&](int st) {
    if constexpr (L::kRecycle)  // regions: after Q and dO, then Q's, then dO's
      return sq + (st == 0 ? 2 : st - 1) * L::kMBytes;
    else
      return sq + 2 * L::kMBytes + st * 2 * L::kNBytes;
  };
  auto sv = [&](int st) { return sk(st) + L::kNBytes; };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * L::kBM;  // heaviest tiles first
  const int c_end = causal ? min(Tk, r0 + L::kBM) : Tk;  // the keys any of the queries sees
  const int n_tiles = (c_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(freed, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int kvh = h / group;
      mbar_expect_tx(a_full, 2 * L::kMBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(sq + p * L::kMPanel, &tq, a_full, 64 * p, h, r0, b);
        tma_load(sdo + p * L::kMPanel, &tdo, a_full, 64 * p, h, r0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % NS;
        if (i >= NS)
          mbar_wait(empty(st), ((i / NS) - 1) & 1);
        else if (L::kRecycle && st > 0)
          mbar_wait(freed, 0);  // Q and dO are in the consumers' registers
        mbar_expect_tx(full(st), 2 * L::kNBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(sk(st) + p * L::kNPanel, &tk, full(st), 64 * p, kvh, i * BN, b);
          tma_load(sv(st) + p * L::kNPanel, &tv, full(st), 64 * p, kvh, i * BN, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // warpgroup wg owns query rows [row_lo, row_lo + 64); this thread holds
  // rows row0 and row0 + 8 of them (the wgmma accumulator layout), columns
  // 8 j + col0 + {0, 1} of each 8-column chunk j
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row_lo = r0 + wg * 64;
  const int row0 = row_lo + (tid / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int rl = (tid / 32) * 16 + lane / 4;  // row0 within the warpgroup's rows
  // rows past S have lse = +inf (P = 0)
  float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? lse[bh * S + row] * kLog2e : __int_as_float(0x7f800000);
  }
  // key tiles this warpgroup computes: past them every key is masked
  const int n_live = causal ? min(n_tiles, (row_lo + 63) / BN + 1) : n_tiles;

  // this warpgroup's rows of Q and dO as wgmma A fragments, read once, so a
  // product reads only its K or V tile from shared memory
  uint32_t qf[D / 16][4], of[D / 16][4];
  mbar_wait(a_full, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a_frag(qf[kk], sq + wg * 64 * 128, L::kMPanel, kk, rl, col0);
    load_a_frag(of[kk], sdo + wg * 64 * 128, L::kMPanel, kk, rl, col0);
  }
  if (L::kRecycle && tid == 0) mbar_arrive(freed);

  for (int i = 0; i < n_live; ++i) {
    const int st = i % NS;
    const int c0 = i * BN;
    float s[BN / 2], dp[BN / 2];
    mbar_wait(full(st), (i / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
      wgmma_rs_k<BN>(s, qf[kk], sw128_desc(sk(st) + (kk / 4) * L::kNPanel + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_rs_k<BN>(dp, of[kk], sw128_desc(sv(st) + (kk / 4) * L::kNPanel + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);
    keep(qf);
    keep(of);
    if (tid == 0) mbar_arrive(empty(st));
    if ((causal && c0 + BN - 1 > row_lo) || c0 + BN > Tk) {  // the diagonal or T
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = row0 + 8 * (e >> 1);
          const int key = c0 + 8 * j + col0 + (e & 1);
          float p = ex2_ftz(s[4 * j + e] * scale_log2 - lse2[e >> 1]);
          if ((causal && key > query) || key >= Tk) p = 0.f;
          delta[e >> 1] += p * dp[4 * j + e];
        }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          delta[e >> 1] += ex2_ftz(s[4 * j + e] * scale_log2 - lse2[e >> 1]) * dp[4 * j + e];
    }
  }
  for (int i = n_live; i < n_tiles; ++i) {  // loaded for the other warpgroup only
    mbar_wait(full(i % NS), (i / NS) & 1);
    if (tid == 0) mbar_arrive(empty(i % NS));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(delta[r]);
    if (col0 == 0) stats[bh * S_pad + row0 + 8 * r] = make_float2(lse2[r], sum);
  }
}

// ---- the fused pass ---------------------------------------------------------

template <int D>
struct Fused {
  static constexpr bool kCols = D == 256;                 // the column split
  static constexpr int kPanels = (D + 63) / 64;
  static constexpr int kBK = kCols ? 64 : 128;            // keys of a work item
  static constexpr int kWPanels = kCols ? 2 : kPanels;    // dK/dV panels a warpgroup holds
  static constexpr int kKPanel = kBK * 128;               // bytes of one resident panel
  static constexpr int kQPanel = kBQ * 128;               // bytes of one streamed panel
  static constexpr int kKBytes = kPanels * kKPanel;       // K (or V)
  static constexpr int kQBytes = kPanels * kQPanel;       // Q (or dO)
  static constexpr int kStageOffset = 2 * kKBytes;
  static constexpr int kStageBytes = 2 * kQBytes;
  // the exchange between the consumer warpgroups: kBK keys x 64 queries of
  // bf16 a tile; D <= 128: dS^T twice (double-buffered); D=256: P^T, dS^T,
  // and dP^T in float32 (fragment order)
  static constexpr int kTileBytes = kBK * 128;
  static constexpr int kXOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kXBytes = 2 * kTileBytes + (kCols ? 64 * 64 * 4 : 0);
  // D <= 128: each warpgroup's dQ share staged for its writer lane, twice
  // (64 rows x 64 columns of float32, fragment order)
  static constexpr int kStagingOffset = kXOffset + kXBytes;
  static constexpr int kStagingBytes = 64 * 64 * 4;
  static constexpr int kPairOffset = kStagingOffset + (kCols ? 0 : 4 * kStagingBytes);
  static constexpr int kBarOffset = kPairOffset + kStages * kBQ * 8;  // after (lse, delta)
  // + 14 mbarriers, the work-item slot and the staged shares' slabs and
  // positions, + 1 KB to align the base
  static constexpr int kSmem = kBarOffset + 192 + 1024;
  static_assert(kSmem <= kSmemMax, "the fused pass's tiles exceed a block's shared memory");
  // whether warpgroup w writes a share of query tile m's dQ: its half of the
  // columns, or at D=64 all of them in turns
  static __device__ __forceinline__ bool writes(int w, int m) {
    return kCols || kPanels > 1 || (m & 1) == w;
  }
};

struct FusedArgs {
  const float2* stats;   // (B*H, S_pad) (lse * log2 e, delta)
  __nv_bfloat16* dk;     // k's strides, as dv
  __nv_bfloat16* dv;
  // float32 sums kept in fragment order: slabs of 64 rows by D columns, the
  // 8-column chunk c of a slab at c * 512 floats, thread t's 4 floats at t * 4
  float* dq_acc;         // (B*H, M) slabs
  float* dkv;            // GQA (else null): (2, B*KV, ceil(T / 64)) slabs of dK, dV sums
  int* ctr;              // [0] work items claimed, dQ turns (B*H, M, 2), dK/dV turns (B*KV, N, 2)
  // null, or cycles spent waiting: consumers for a dQ turn (D=256) or a
  // staging buffer (D <= 128), consumers for a dK/dV turn, writer lanes for
  // a dQ turn
  long long* waits;
  int B, S, Tk, H, KV, group, S_pad, M, N;
  int heads, blocks;  // heads of a group a sweep, blocks a sweep: the order of claims
  int64_t k_sb, k_st, k_sh;
  float scale_log2, scale;
  int causal;
};

// Work item idx: key tile n of (b, query head h), h the group's head g of
// kv head kvh.  The order of claims: sweeps of `heads` heads of every group
// (each head g after head g - 1, so a head seldom waits long for the one
// before at a dK/dV sum); within a sweep, its (g, b, kvh) triples in blocks
// of about a quarter of the SMs, key tiles heaviest first within a block.
// So a few tiles of one (b, h) run at once: a dQ sum's turns follow closely
// (its slab stays in L2) and few wait on each other.
struct Item {
  int n, b, h;
};

__device__ __forceinline__ Item decode_item(int idx, const FusedArgs& a) {
  const int nb = a.B * a.KV;
  const int triples = a.heads * nb;  // a sweep's
  const int per_sweep = a.N * triples;
  const int sweep = idx / per_sweep;
  int r = idx % per_sweep;
  // a.blocks blocks of triples, the first triples % blocks one triple larger
  const int small = triples / a.blocks, big = small + 1, n_big = triples % a.blocks;
  int first, size;
  if (r < n_big * a.N * big) {
    const int bi = r / (a.N * big);
    first = bi * big;
    size = big;
    r -= bi * a.N * big;
  } else {
    r -= n_big * a.N * big;
    const int bi = r / (a.N * small);
    first = n_big * big + bi * small;
    size = small;
    r -= bi * a.N * small;
  }
  const int t = first + r % size;  // (g within the sweep) * nb + b * KV + kvh
  const int bkv = t % nb;
  return {r / size, bkv / a.KV, (bkv % a.KV) * a.group + sweep * a.heads + t / nb};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A warpgroup (named barrier `bar`) waits until the turn counter reads `pos`
// (position 0 never waits); thread 0 spins, adding its cycles to *waits.
__device__ __forceinline__ void wait_turn(const int* ctr, int pos, int bar, int tid,
                                          long long* waits) {
  if (pos == 0) return;
  if (tid == 0) {
    const long long t0 = clock64();
    while (ld_acquire(ctr) != pos) {
    }
    if (waits != nullptr)
      atomicAdd(reinterpret_cast<unsigned long long*>(waits),
                static_cast<unsigned long long>(clock64() - t0));
  }
  named_sync(bar, 128);
}

// Every thread of the warpgroup has stored its share: pass the turn on.
__device__ __forceinline__ void pass_turn(int* ctr, int bar, int tid) {
  named_sync(bar, 128);
  if (tid == 0) red_release_add(ctr, 1);
}

// x (chunks c0 + j of a 64-row slab, j < 8, chunk 8 (c0 + j) < D) += the
// earlier turns' sum at `acc` (this thread's floats of the slab)
template <int D>
__device__ __forceinline__ void add_earlier(float (&x)[32], const float* acc, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (8 * (c0 + j) < D) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(acc + (c0 + j) * 512));
      x[4 * j] = p.x + x[4 * j];
      x[4 * j + 1] = p.y + x[4 * j + 1];
      x[4 * j + 2] = p.z + x[4 * j + 2];
      x[4 * j + 3] = p.w + x[4 * j + 3];
    }
}

template <int D>
__device__ __forceinline__ void store_sum(const float (&x)[32], float* acc, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (8 * (c0 + j) < D)
      __stcg(reinterpret_cast<float4*>(acc + (c0 + j) * 512),
             make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]));
}

// x (a 64-row fragment: rows row_base + rl + {0, 8}, columns col_base + 8 j
// + col0 + {0, 1}) times `scale`, rounded to bf16 into out (row stride
// s_row); rows from `rows` and columns from D are not stored
template <int D>
__device__ __forceinline__ void store_bf16(const float (&x)[32], __nv_bfloat16* out,
                                           int64_t s_row, int row_base, int rows, int col_base,
                                           int rl, int col0, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + rl + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col_base + 8 * j;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + row * s_row + col + col0) =
          __floats2bfloat162_rn(x[4 * j + 2 * r] * scale, x[4 * j + 2 * r + 1] * scale);
    }
  }
}

// P^T = exp2(s * scale_log2 - lse2) masked, in place in s; with kGrad,
// dS^T = P^T * (dP^T - delta) in place in dp.  Rows are keys (key_row + {0,
// 8}), columns queries (q0 + 8 j + col0 + {0, 1}); masks only on an edge.
template <bool kGrad, bool kEdge>
__device__ __forceinline__ void softmax_grad_tile(float (&s)[32], float (&dp)[32],
                                                  const float2* pairs, float scale_log2,
                                                  int causal, int Tk, int key_row, int q0,
                                                  int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 cp = *reinterpret_cast<const float4*>(pairs + 8 * j + col0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 pr = (e & 1) ? make_float2(cp.z, cp.w) : make_float2(cp.x, cp.y);
      float p = ex2_ftz(s[4 * j + e] * scale_log2 - pr.x);
      if constexpr (kEdge) {
        const int key = key_row + 8 * (e >> 1);
        const int query = q0 + 8 * j + col0 + (e & 1);
        if ((causal && key > query) || key >= Tk) p = 0.f;
      }
      s[4 * j + e] = p;
      if constexpr (kGrad) dp[4 * j + e] = p * (dp[4 * j + e] - pr.y);
    }
  }
}

template <bool kGrad>
__device__ __forceinline__ void softmax_grad(float (&s)[32], float (&dp)[32], const float2* pairs,
                                             float scale_log2, bool edge, int causal, int Tk,
                                             int key_row, int q0, int col0) {
  if (edge)
    softmax_grad_tile<kGrad, true>(s, dp, pairs, scale_log2, causal, Tk, key_row, q0, col0);
  else
    softmax_grad_tile<kGrad, false>(s, dp, pairs, scale_log2, causal, Tk, key_row, q0, col0);
}

// A 64 x 64 fragment (rows rl + {0, 8}) as bf16 into a 128-byte-swizzled
// tile of 64-query rows at `rows` (the fragment's first row)
__device__ __forceinline__ void store_tile_bf16(uint32_t rows, const float (&x)[32], int rl,
                                                int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      st_shared_u32(rows + row * 128 + ((j ^ (row & 7)) << 4) + col0 * 2,
                    pack_bf16(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]));
    }
}

// A warpgroup's share of a dQ sum (chunks c0 + 8 p + j of the slab): once
// its turn lane grants the turn (barrier `ready`, phase `parity`), store
// (the first turn) or add in L2 (red, nothing read back) this thread's
// floats, and hand the turn back (barrier `handoff`).
template <int D, int kHalves>
__device__ __forceinline__ void dq_out(const FusedArgs& a, const float (&x)[kHalves][32],
                                       int64_t slab, int n, int c0, int tid, uint32_t ready,
                                       uint32_t handoff, uint32_t parity) {
  const long long t0 = clock64();
  mbar_wait(ready, parity);
  if (a.waits != nullptr && tid == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.waits),
              static_cast<unsigned long long>(clock64() - t0));
  float* acc = a.dq_acc + slab * (64 * D) + tid * 4;
#pragma unroll
  for (int p = 0; p < kHalves; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * p + j;
      if (8 * c >= D) continue;
      const float4 v = make_float4(x[p][4 * j], x[p][4 * j + 1], x[p][4 * j + 2], x[p][4 * j + 3]);
      float4* dst = reinterpret_cast<float4*>(acc + c * 512);
      if (n == 0)
        __stcg(dst, v);
      else
        atomicAdd(dst, v);
    }
  mbar_arrive(handoff);
}

// Where a staged dQ share's sum is and which turn it takes
struct Staged {
  int64_t slab;
  int n;
  int pad;
};

// Warpgroup w's writer lane (D <= 128; one thread of the producer
// warpgroup): takes the warpgroup's staged dQ shares in order; for each,
// waits until the sum's counter reads its position n, stores (n = 0) or adds
// (a bulk reduce, done in L2) the 64 x 64 share from shared memory with one
// bulk copy, frees the staging buffer once it has been read, and passes the
// turn on once the writes are complete.  The consumers never wait on global
// memory.
template <int D>
__device__ void writer_lane(const FusedArgs& a, int w, uint32_t staging, uint32_t staged,
                            uint32_t freed, const Staged* meta) {
  const int c0 = (D + 63) / 64 > 1 ? 8 * w : 0;  // the share's first 8-column chunk
  const uint32_t bytes = min(8, D / 8 - c0) * 2048;
  for (uint32_t j = 0;; ++j) {
    const int x = j & 1;
    mbar_wait(staged + 8 * x, (j >> 1) & 1);
    const Staged sh = meta[x];
    if (sh.n < 0) break;
    int* ctr = a.ctr + 1 + sh.slab * 2 + w;
    if (sh.n > 0) {
      const long long t0 = clock64();
      while (ld_acquire(ctr) != sh.n) {
      }
      if (a.waits != nullptr)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.waits + 2),
                  static_cast<unsigned long long>(clock64() - t0));
    }
    fence_async_global();
    float* dst = a.dq_acc + sh.slab * (64 * D) + c0 * 512;
    const uint32_t src = staging + x * (64 * 64 * 4);
    if (sh.n == 0)
      bulk_store(dst, src, bytes);
    else
      bulk_reduce_add(dst, src, bytes);
    bulk_commit();
    bulk_wait<true>();
    mbar_arrive(freed + 8 * x);
    bulk_wait<false>();
    fence_async_global();
    red_release_add(ctr, 1);
  }
}

// Consumer warpgroup w's turn j at a dQ sum (D <= 128): the share x (chunks
// c0 .. c0 + 7 of slab `slab`, position n) into staging buffer j & 1 once
// the writer lane has read what it held before.  With n < 0, the stop.
template <int D>
__device__ __forceinline__ void dq_stage(const FusedArgs& a, const float (&x)[32], int64_t slab,
                                         int n, int c0, int tid, uint32_t j, uint8_t* staging,
                                         uint32_t staged, uint32_t freed, Staged* meta) {
  const int b = j & 1;
  if (j >= 2) {
    const long long t0 = clock64();
    mbar_wait(freed + 8 * b, ((j >> 1) - 1) & 1);
    if (a.waits != nullptr && tid == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.waits),
                static_cast<unsigned long long>(clock64() - t0));
  }
  if (n >= 0) {
    float4* dst = reinterpret_cast<float4*>(staging + b * (64 * 64 * 4)) + tid;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (8 * (c0 + jj) < D)
        dst[jj * 128] = make_float4(x[4 * jj], x[4 * jj + 1], x[4 * jj + 2], x[4 * jj + 3]);
  }
  if (tid == 0) meta[b] = Staged{slab, n, 0};
  fence_async_smem();
  mbar_arrive(staged + 8 * b);
}

// A writer warpgroup's turn lane (one thread of the producer warpgroup):
// follows the work items as the consumers do, grants the warpgroup's turns
// at the dQ sums in order, at most two ahead (a turn at position n once the
// sum's counter reads n), and passes each on with a release add once the
// warpgroup has handed it back, so the consumers never wait on global
// memory for a turn that is due.
template <int D>
__device__ void turn_lane(const FusedArgs& a, int w, uint32_t kv_full, uint32_t kv_empty,
                          volatile int* item_slot, uint32_t ready, uint32_t handoff) {
  using L = Fused<D>;
  int64_t ring[4];  // counters of the turns granted and not yet passed on
  uint32_t granted = 0, passed = 0;
  int t = 0, bh = 0, n = 0, m = -1, m_lo = 0;
  bool have = false, done = false;
  while (!done || passed < granted) {
    if (!done && granted < passed + 2) {
      if (!have && mbar_test(kv_full, t & 1)) {
        const int idx = *item_slot;
        mbar_arrive(kv_empty);
        ++t;
        if (idx < 0) {
          done = true;
        } else {
          const Item it = decode_item(idx, a);
          n = it.n;
          bh = it.b * a.H + it.h;
          m = a.M - 1;
          m_lo = a.causal ? n * L::kBK / kBQ : 0;
          have = true;
        }
      }
      if (have) {
        while (m >= m_lo && !L::writes(w, m)) --m;
        if (m < m_lo) {
          have = false;
        } else {
          const int64_t c = 1 + (static_cast<int64_t>(bh) * a.M + m) * 2 + w;
          if (n == 0 || ld_acquire(a.ctr + c) == n) {
            ring[granted & 3] = c;
            mbar_arrive(ready + 8 * (granted & 1));
            ++granted;
            --m;
          }
        }
      }
    }
    if (passed < granted && mbar_test(handoff + 8 * (passed & 1), (passed >> 1) & 1)) {
      red_release_add(a.ctr + ring[passed & 3], 1);
      ++passed;
    }
  }
}

// A warpgroup's dK and dV (kWP panels of rows key_base + rl + {0, 8},
// columns col_base + 64 p): into dk and dv (H == KV), or the group's sums.
template <int D, int kWP>
__device__ __forceinline__ void dkv_out(const FusedArgs& a, float (&dk)[kWP][32],
                                        float (&dv)[kWP][32], int b, int h, int n, int wg,
                                        int key_base, int slab, int col_base, int tid, int rl,
                                        int col0) {
  const int kvh = h / a.group;
  if (a.dkv == nullptr) {
    const int64_t off = b * a.k_sb + kvh * a.k_sh;
#pragma unroll
    for (int p = 0; p < kWP; ++p) {
      store_bf16<D>(dk[p], a.dk + off, a.k_st, key_base, a.Tk, col_base + 64 * p, rl, col0,
                    a.scale);
      store_bf16<D>(dv[p], a.dv + off, a.k_st, key_base, a.Tk, col_base + 64 * p, rl, col0,
                    1.f);
    }
    return;
  }
  if (key_base >= a.Tk) return;  // no key of these rows exists, for any head
  // the group's heads in order: head g waits for turn g
  const int g = h % a.group;
  const int slabs = (a.Tk + 63) / 64;
  const int64_t bkv = static_cast<int64_t>(b) * a.KV + kvh;
  float* acc_k = a.dkv + (bkv * slabs + slab) * (64 * D) + tid * 4;
  float* acc_v = acc_k + static_cast<int64_t>(a.B) * a.KV * slabs * (64 * D);
  int* ctr = a.ctr + 1 + static_cast<int64_t>(a.B) * a.H * a.M * 2 + (bkv * a.N + n) * 2 + wg;
  wait_turn(ctr, g, 2 + wg, tid, a.waits == nullptr ? nullptr : a.waits + 1);
  const bool last = g == a.group - 1;
  const int64_t off = b * a.k_sb + kvh * a.k_sh;
#pragma unroll
  for (int p = 0; p < kWP; ++p) {
    const int c0 = (col_base + 64 * p) / 8;
    if (g > 0) {
      add_earlier<D>(dk[p], acc_k, c0);
      add_earlier<D>(dv[p], acc_v, c0);
    }
    if (last) {
      store_bf16<D>(dk[p], a.dk + off, a.k_st, key_base, a.Tk, col_base + 64 * p, rl, col0,
                    a.scale);
      store_bf16<D>(dv[p], a.dv + off, a.k_st, key_base, a.Tk, col_base + 64 * p, rl, col0,
                    1.f);
    } else {
      store_sum<D>(dk[p], acc_k, c0);
      store_sum<D>(dv[p], acc_v, c0);
    }
  }
  if (!last) pass_turn(ctr, 2 + wg, tid);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ FusedArgs a) {
  using L = Fused<D>;
  constexpr int kWP = L::kWPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sk = base;
  const uint32_t sv = base + L::kKBytes;
  auto sq = [&](int st) { return base + L::kStageOffset + st * L::kStageBytes; };
  auto sdo = [&](int st) { return sq(st) + L::kQBytes; };
  const uint32_t sx = base + L::kXOffset;
  const uint32_t bars = base + L::kBarOffset;
  // barriers: K/V full and empty; full and empty for each stage; for each
  // writer warpgroup, its turn granted and handed back, for each parity
  const uint32_t kv_full = bars;
  const uint32_t kv_empty = bars + 8u;
  auto full = [&](int st) { return bars + 16u + 8u * st; };
  auto empty = [&](int st) { return bars + 16u + 8u * (kStages + st); };
  // D=256: turn granted (ready) and handed back (handoff); D <= 128: share
  // staged and staging read (the same barriers)
  auto ready = [&](int w) { return bars + 48u + 16u * w; };
  auto handoff = [&](int w) { return bars + 80u + 16u * w; };
  volatile int* const item_slot = reinterpret_cast<volatile int*>(gbase + L::kBarOffset + 112);
  Staged* const staged_meta = reinterpret_cast<Staged*>(gbase + L::kBarOffset + 128);  // [w][x]
  auto staging = [&](int w) { return base + L::kStagingOffset + 2 * w * L::kStagingBytes; };
  const float2* const pairs = reinterpret_cast<const float2*>(gbase + L::kPairOffset);

  const int n_items = a.B * a.H * a.N;
  // the first query tile that sees key tile n
  auto m_first = [&](int n) { return a.causal ? n * L::kBK / kBQ : 0; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, L::kCols ? 4 : 2);  // each consumer warpgroup and (D=256) turn lane
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        // the lane, or every thread of the warpgroup
        mbar_init(ready(w) + 8 * par, L::kCols ? 1 : 128);
        mbar_init(handoff(w) + 8 * par, L::kCols ? 128 : 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    const int pw = warp - kConsumers / 32;
    if (threadIdx.x == kConsumers) {  // the producer
      uint32_t it = 0;  // streamed tiles so far, across work items
      for (int t = 0;; ++t) {
        if (t > 0) mbar_wait(kv_empty, (t - 1) & 1);  // K, V and the slot are free
        const int idx = atomicAdd(a.ctr, 1);
        if (idx >= n_items) {
          *item_slot = -1;
          mbar_arrive(kv_full);
          break;
        }
        *item_slot = idx;
        const Item item = decode_item(idx, a);
        const int kvh = item.h / a.group;
        const int64_t bh = static_cast<int64_t>(item.b) * a.H + item.h;
        mbar_expect_tx(kv_full, 2 * L::kKBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(sk + p * L::kKPanel, &tk, kv_full, 64 * p, kvh, item.n * L::kBK, item.b);
          tma_load(sv + p * L::kKPanel, &tv, kv_full, 64 * p, kvh, item.n * L::kBK, item.b);
        }
        for (int m = a.M - 1; m >= m_first(item.n); --m, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
          mbar_expect_tx(full(st), 2 * L::kQBytes + kBQ * 8);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p) {
            tma_load(sq(st) + p * L::kQPanel, &tq, full(st), 64 * p, item.h, m * kBQ, item.b);
            tma_load(sdo(st) + p * L::kQPanel, &tdo, full(st), 64 * p, item.h, m * kBQ, item.b);
          }
          bulk_load(base + L::kPairOffset + st * kBQ * 8, a.stats + bh * a.S_pad + m * kBQ,
                    kBQ * 8, full(st));
        }
      }
    } else if ((pw == 1 || pw == 2) && threadIdx.x % 32 == 0) {
      if constexpr (L::kCols)
        turn_lane<D>(a, pw - 1, kv_full, kv_empty, item_slot, ready(pw - 1), handoff(pw - 1));
      else
        writer_lane<D>(a, pw - 1, staging(pw - 1), ready(pw - 1), handoff(pw - 1),
                       staged_meta + 2 * (pw - 1));
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // this thread holds rows rl and rl + 8 of a warpgroup's 64-row fragment
  // (the wgmma accumulator layout), columns 8 j + col0 + {0, 1} of each
  // 8-column chunk j
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int rl = (tid / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);

  uint32_t it = 0;    // streamed tiles so far, across work items
  uint32_t turn = 0;  // this warpgroup's dQ turns so far
  for (int t = 0;; ++t) {
    mbar_wait(kv_full, t & 1);
    const int idx = *item_slot;
    if (idx < 0) break;
    const Item item = decode_item(idx, a);
    const int n = item.n;
    const int64_t bh = static_cast<int64_t>(item.b) * a.H + item.h;
    float acc_k[kWP][32], acc_v[kWP][32];  // dK, dV
#pragma unroll
    for (int p = 0; p < kWP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[p][i] = acc_v[p][i] = 0.f;

    for (int m = a.M - 1; m >= m_first(n); --m, ++it) {
      const int st = it % kStages;
      const int q0 = m * kBQ;
      mbar_wait(full(st), (it / kStages) & 1);
      if constexpr (!L::kCols) {
        // D <= 128: this warpgroup's 64 keys
        const int key_lo = n * L::kBK + wg * 64;
        const bool dead = key_lo >= a.Tk || (a.causal && q0 + kBQ - 1 < key_lo);
        const uint32_t ds_buf = sx + (it & 1) * L::kTileBytes;
        uint32_t pa[4][4], da[4][4];  // P^T and dS^T as bf16 A fragments
        if (!dead) {
          float s[32], dp[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
            wgmma_ss<64>(s, sw128_desc(sk + wg * 64 * 128 + (kk / 4) * L::kKPanel + off),
                         sw128_desc(sq(st) + (kk / 4) * L::kQPanel + off), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            wgmma_ss<64>(dp, sw128_desc(sv + wg * 64 * 128 + (kk / 4) * L::kKPanel + off),
                         sw128_desc(sdo(st) + (kk / 4) * L::kQPanel + off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          keep(s);
          keep(dp);
          const bool edge = (a.causal && q0 < key_lo + 63) || key_lo + 64 > a.Tk;
          softmax_grad<true>(s, dp, pairs + st * kBQ, a.scale_log2, edge, a.causal, a.Tk,
                             key_lo + rl, q0, col0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
              da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
            }
        }
        // dS^T into this warpgroup's rows of the exchange (zeros if dead):
        // A fragment register r of k-step kk is row rl + 8 (r & 1), chunk
        // 2 kk + (r >> 1)
        const uint32_t ds_rows = ds_buf + wg * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = rl + 8 * (r & 1);
            st_shared_u32(ds_rows + row * 128 + (((2 * kk + (r >> 1)) ^ (row & 7)) << 4) + col0 * 2,
                          dead ? 0u : da[kk][r]);
          }
        fence_async_smem();
        if (!dead) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int p = 0; p < kWP; ++p) {  // dV += P^T.dO, dK += dS^T.Q
              wgmma_rs_n64(acc_v[p], pa[kk], sw128_desc(sdo(st) + p * L::kQPanel + kk * 2048));
              wgmma_rs_n64(acc_k[p], da[kk], sw128_desc(sq(st) + p * L::kQPanel + kk * 2048));
            }
          wgmma_commit();
        }
        named_sync(1, kConsumers);  // the tile's whole dS^T is in ds_buf
        // dQ: the half of columns of panel wg, or (D=64) all of it in turns
        const bool mine = L::writes(wg, m);
        float dq[1][32];
        if (mine) {
          wgmma_fence();
          const uint32_t kp = sk + (L::kPanels > 1 ? wg : 0) * L::kKPanel;
#pragma unroll
          for (int kk = 0; kk < L::kBK / 16; ++kk)
            wgmma_ss_n64_t<1, 1>(dq[0], sw128_desc(ds_buf + kk * 2048), sw128_desc(kp + kk * 2048),
                                 kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < kWP; ++p) {
          keep(acc_k[p]);
          keep(acc_v[p]);
        }
        keep(pa);
        keep(da);
        if (tid == 0) mbar_arrive(empty(st));
        if (mine) {
          keep(dq[0]);
          dq_stage<D>(a, dq[0], bh * a.M + m, n, L::kPanels > 1 ? 8 * wg : 0, tid, turn,
                      gbase + (staging(wg) - base), ready(wg), handoff(wg), staged_meta + 2 * wg);
          ++turn;
        }
      } else {
        // D=256: 64 keys; warpgroup 0 takes S^T and P^T, warpgroup 1 dP^T and
        // dS^T, handing P^T over in float32; each accumulates columns
        // [128 wg, 128 wg + 128).  Named barriers of both: 4, warpgroup 1 is
        // done with the exchange's tile before; 5, P^T is in it; 6, dS^T is.
        const int key_lo = n * L::kBK;
        const uint32_t p_buf = sx;
        const uint32_t ds_buf = sx + L::kTileBytes;
        float4* const p_x = reinterpret_cast<float4*>(gbase + L::kXOffset + 2 * L::kTileBytes);
        if (wg == 0) {
          float s[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            wgmma_ss<64>(s, sw128_desc(sk + (kk / 4) * L::kKPanel + off),
                         sw128_desc(sq(st) + (kk / 4) * L::kQPanel + off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          keep(s);
          const bool edge = (a.causal && q0 < key_lo + 63) || key_lo + 64 > a.Tk;
          softmax_grad<false>(s, s, pairs + st * kBQ, a.scale_log2, edge, a.causal, a.Tk,
                              key_lo + rl, q0, col0);
          if (it > 0) named_sync(4, kConsumers);
          store_tile_bf16(p_buf, s, rl, col0);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            p_x[j * 128 + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
          fence_async_smem();
          named_arrive(5, kConsumers);
        } else {
          float dp[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            wgmma_ss<64>(dp, sw128_desc(sv + (kk / 4) * L::kKPanel + off),
                         sw128_desc(sdo(st) + (kk / 4) * L::kQPanel + off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          keep(dp);
          named_sync(5, kConsumers);
          const float2* pr = pairs + st * kBQ;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = p_x[j * 128 + tid];
            const float4 cp = *reinterpret_cast<const float4*>(pr + 8 * j + col0);
            dp[4 * j] = p4.x * (dp[4 * j] - cp.y);  // dS^T = P^T (dP^T - delta), by query
            dp[4 * j + 1] = p4.y * (dp[4 * j + 1] - cp.w);
            dp[4 * j + 2] = p4.z * (dp[4 * j + 2] - cp.y);
            dp[4 * j + 3] = p4.w * (dp[4 * j + 3] - cp.w);
          }
          store_tile_bf16(ds_buf, dp, rl, col0);
          fence_async_smem();
        }
        // dV += P^T.dO, this half's panels, while warpgroup 1 forms dS^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            wgmma_ss_n64_t<0, 1>(acc_v[p], sw128_desc(p_buf + kk * 32),
                                 sw128_desc(sdo(st) + (2 * wg + p) * L::kQPanel + kk * 2048), 1);
        wgmma_commit();
        if (wg == 0)
          named_sync(6, kConsumers);
        else
          named_arrive(6, kConsumers);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < 2; ++p)  // dK += dS^T.Q
            wgmma_ss_n64_t<0, 1>(acc_k[p], sw128_desc(ds_buf + kk * 32),
                                 sw128_desc(sq(st) + (2 * wg + p) * L::kQPanel + kk * 2048), 1);
        wgmma_commit();
        float dq[2][32];  // dQ = dS.K, this half's two panels
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64_t<1, 1>(dq[p], sw128_desc(ds_buf + kk * 2048),
                                 sw128_desc(sk + (2 * wg + p) * L::kKPanel + kk * 2048), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          keep(acc_k[p]);
          keep(acc_v[p]);
          keep(dq[p]);
        }
        if (tid == 0) mbar_arrive(empty(st));
        if (wg == 1) named_arrive(4, kConsumers);  // done with the exchange's tile
        dq_out<D, 2>(a, dq, bh * a.M + m, n, 16 * wg, tid, ready(wg) + 8 * (turn & 1),
                     handoff(wg) + 8 * (turn & 1), (turn >> 1) & 1);
        ++turn;
      }
    }
    if (tid == 0) mbar_arrive(kv_empty);  // every product reading K and V has completed
    if constexpr (L::kCols)
      dkv_out<D, kWP>(a, acc_k, acc_v, item.b, item.h, n, wg, n * L::kBK, n, 128 * wg, tid, rl,
                      col0);
    else
      dkv_out<D, kWP>(a, acc_k, acc_v, item.b, item.h, n, wg, n * L::kBK + 64 * wg, 2 * n + wg, 0,
                      tid, rl, col0);
  }
  if constexpr (L::kCols) {  // match warpgroup 1's last arrival at barrier 4
    if (wg == 0 && it > 0) named_sync(4, kConsumers);
  }
  if constexpr (!L::kCols) {  // stop this warpgroup's writer lane
    const float none[32] = {};
    dq_stage<D>(a, none, 0, -1, 0, tid, turn, gbase + (staging(wg) - base), ready(wg),
                handoff(wg), staged_meta + 2 * wg);
  }
}

// ---- the dQ epilogue ----------------------------------------------------------

// dq = the float32 sums (fragment order, as the fused pass leaves them) times
// 1/sqrt(D), rounded once to bf16 into q's strides.  One block a slab of 64
// query rows: the sums read in fragment order, the rows written from shared
// memory as 16-byte vectors.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq(const float4* __restrict__ acc, __nv_bfloat16* __restrict__ dq, int H, int S, int M,
             int64_t q_sb, int64_t q_ss, int64_t q_sh, float scale) {
  constexpr int kRow = D + 8;  // bf16 a row: 16-byte rows, no bank conflicts
  __shared__ __align__(16) __nv_bfloat16 tile[64 * kRow];
  const int64_t slab = blockIdx.x;
  const int m = static_cast<int>(slab % M);
  const int64_t bh = slab / M;
  const float4* src = acc + slab * (64 * D / 4);
  for (int e = threadIdx.x; e < D / 8 * 128; e += 256) {
    const int t = e % 128;  // chunk e / 128, the fragment of thread t
    const int row = (t / 32) * 16 + (t % 32) / 4;
    const int col = 8 * (e / 128) + 2 * (t % 4);
    const float4 v = src[e];
    *reinterpret_cast<__nv_bfloat162*>(tile + row * kRow + col) =
        __floats2bfloat162_rn(v.x * scale, v.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(tile + (row + 8) * kRow + col) =
        __floats2bfloat162_rn(v.z * scale, v.w * scale);
  }
  __syncthreads();
  const int rows = min(64, S - m * kBQ);
  __nv_bfloat16* out = dq + (bh / H) * q_sb + (bh % H) * q_sh + static_cast<int64_t>(m) * kBQ * q_ss;
  for (int e = threadIdx.x; e < rows * (D / 8); e += 256) {
    const int row = e / (D / 8);
    const int c = 8 * (e % (D / 8));
    *reinterpret_cast<uint4*>(out + row * q_ss + c) =
        *reinterpret_cast<const uint4*>(tile + row * kRow + c);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, float* dq_acc,
                   float* dkv, int* ctr, long long* waits, int B, int S, int Tk, int H, int KV,
                   const long long* st, int causal, cudaStream_t stream) {
  using DL = DeltaTile<D>;
  using FL = Fused<D>;
  CUtensorMap dm[4], fm[4];
  if (!make_map(&dm[0], q, D, H, S, B, st[0], st[1], st[2], DL::kBM) ||
      !make_map(&dm[1], dout, D, H, S, B, st[0], st[1], st[2], DL::kBM) ||
      !make_map(&dm[2], k, D, KV, Tk, B, st[3], st[4], st[5], DL::kBN) ||
      !make_map(&dm[3], v, D, KV, Tk, B, st[3], st[4], st[5], DL::kBN) ||
      !make_map(&fm[0], k, D, KV, Tk, B, st[3], st[4], st[5], FL::kBK) ||
      !make_map(&fm[1], v, D, KV, Tk, B, st[3], st[4], st[5], FL::kBK) ||
      !make_map(&fm[2], q, D, H, S, B, st[0], st[1], st[2], kBQ) ||
      !make_map(&fm[3], dout, D, H, S, B, st[0], st[1], st[2], kBQ))
    return cudaErrorInvalidValue;
  // once a device: the kernels' shared memory, and its SM count
  static std::atomic<int> sms_of[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    if ((err = cudaFuncSetAttribute(flash_bwd_delta<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, DL::kSmem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(flash_bwd_fused<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, FL::kSmem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int S_pad = flash_bwd::stat_rows(S);
  const int M = (S + kBQ - 1) / kBQ, N = (Tk + FL::kBK - 1) / FL::kBK;
  // the (lse, delta) pairs, and the counters zeroed
  flash_bwd_delta<D><<<dim3(B * H, (S + DL::kBM - 1) / DL::kBM), kThreads, DL::kSmem, stream>>>(
      dm[0], dm[1], dm[2], dm[3], lse, reinterpret_cast<float2*>(stats), ctr,
      1 + 2 * B * H * M + 2 * B * KV * N, S, Tk, S_pad, H, H / KV, kLog2e * scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  FusedArgs a;
  a.stats = reinterpret_cast<const float2*>(stats);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dq_acc = dq_acc;
  a.dkv = dkv;
  a.ctr = ctr;
  a.waits = waits;
  a.B = B;
  a.S = S;
  a.Tk = Tk;
  a.H = H;
  a.KV = KV;
  a.group = H / KV;
  a.S_pad = S_pad;
  a.M = M;
  a.N = N;
  // a sweep: the most heads of a group (a divisor of it) that keep its
  // (g, b, kv head) triples to a sixteenth of the SMs; blocks of about a
  // quarter of the SMs
  a.heads = 1;
  for (int hs = 2; hs <= a.group; ++hs)
    if (a.group % hs == 0 && hs * B * KV <= sms / 16) a.heads = hs;
  a.blocks = max(1, (a.heads * B * KV + sms / 8) / max(1, sms / 4));
  a.k_sb = st[3];
  a.k_st = st[4];
  a.k_sh = st[5];
  a.scale_log2 = kLog2e * scale;
  a.scale = scale;
  a.causal = causal;
  const long long items = static_cast<long long>(B) * H * a.N;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_bwd_fused<D><<<grid, kThreads, FL::kSmem, stream>>>(fm[0], fm[1], fm[2], fm[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq<D><<<static_cast<unsigned>(static_cast<int64_t>(B) * H * a.M), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<__nv_bfloat16*>(dq), H, S, a.M, st[0],
      st[1], st[2], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, lse, dO, dq, dk, dv as flash_attn_bwd; bf16 (dtype 1) at D 64,
// 112, 128 or 256 only, 16-byte aligned tensors with 16-byte aligned row and
// head strides.  Scratch, float32 unless said: stats (B*H, S rounded up to
// 128, 2); dq_acc (B*H, S rounded up to 64, D); dkv (GQA only, else null):
// the group sums (2, B*KV, T rounded up to 64, D); ctr, int32, 1 + B*H*M*2 +
// B*KV*N*2 of them (M = ceil(S / 64), N = ceil(T / keys a work item: 64 at
// D=256, else 128), zeroed by the delta pass; waits, int64 (3), or null.
// Refuses anything else with cudaErrorInvalidValue.  Launches on `stream`
// and returns cudaGetLastError() after the last launch.
extern "C" int flash_attn_bwd_tc(const void* q, const void* k, const void* v, const float* lse,
                                 const void* dout, void* dq, void* dk, void* dv, float* stats,
                                 float* dq_acc, float* dkv, int* ctr, long long* waits, int B,
                                 int S, int T, int H, int KV, int D, int dtype, int causal,
                                 long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 void* stream) {
  const long long st[6] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (dtype != 1 || KV <= 0 || H % KV != 0 || T <= 0 || (H != KV) != (dkv != nullptr) ||
      ctr == nullptr || dq_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv),
                        static_cast<const void*>(stats), static_cast<const void*>(dq_acc),
                        static_cast<const void*>(dkv)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
#define FLASH_BWD_ARGS \
  q, k, v, lse, dout, dq, dk, dv, stats, dq_acc, dkv, ctr, waits, B, S, T, H, KV, st, causal, s
  switch (D) {
    case 64: err = launch<64>(FLASH_BWD_ARGS); break;
    case 112: err = launch<112>(FLASH_BWD_ARGS); break;
    case 128: err = launch<128>(FLASH_BWD_ARGS); break;
    case 256: err = launch<256>(FLASH_BWD_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FLASH_BWD_ARGS
  return static_cast<int>(err);
}
