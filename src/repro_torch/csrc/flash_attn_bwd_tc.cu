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
// accumulation (P and dS are rounded to bf16 as wgmma's A operand, as the
// forward's P.V rounds P and as scaled_dot_product_attention's backward
// does); each gradient is rounded once to bf16.
//
// Deterministic: no floating-point atomics, so two calls give the same bits.
// dK and dV are summed over the query tiles inside one block, dQ over the
// key tiles inside another; with GQA each query head's dK and dV go to
// float32 partials that flash_bwd_common.cuh's bwd_group_sum adds in head
// order afterwards.
//
// Bound on this card: operations.  At gemma-2b's training shape (B=4,
// S=T=2,048, H=8, KV=1, D=256) five products (QK^T again, dV, dP, dQ, dK)
// of 2 D operations per visible (query head, key) pair are 1.72e11
// operations, 0.174 ms at the tensor cores' 989 TFLOP/s.  This schedule
// does 11 such products at D=256 (QK^T and dO.V^T in each of the three
// passes, twice in the dK/dV pass) and 9 below it.
//
// Design, three passes of one template (flash_bwd_tc<D, pass>), each a block
// of 384 threads: a producer warpgroup (setmaxnreg 24) whose one thread
// TMA-loads the block's resident tiles once and streams the other operands
// through a two-stage ring (full and empty mbarriers), and two consumer
// warpgroups of 64 resident rows each.  Tiles are the forward's: 4-D tensor
// maps (D, heads, rows, B) over the model layout, one 64-column panel (128
// bytes) a box, 128-byte swizzled, zero-filled past the edges.
//  - kDeltaPass, first: one block per (b, h, 128 queries); Q and dO
//    resident, K and V streamed 64 keys a tile (32 at D=256) up to the
//    diagonal; S = Q.K^T and dP = dO.V^T with wgmma (K-major operands,
//    float32 accumulators), delta = rowsum(P * dP) in registers (a quad's
//    shuffles at the end), written with the row's lse (times log2 e) as its
//    (lse, delta) pair.
//  - kDkvPass (dK, dV): one block per (b, query head h, 128 keys); K and V of
//    kv head h / G resident, Q and dO of head h streamed 64 queries a tile
//    (32 at D=256) from the diagonal's tile down, with the tile's (lse,
//    delta) pairs (a bulk copy).  A warpgroup takes S^T = K.Q^T and dP^T =
//    V.dO^T (64 keys are the M rows), forms P^T and dS^T in registers, and
//    adds P^T.dO into dV and dS^T.Q into dK with P^T and dS^T as bf16
//    register A operands (the accumulator layout is the A fragment layout)
//    and dO, Q read MN-major.  At D=256 dK and dV together would need 256
//    accumulators a thread, so a key tile is cut into two blocks of 128
//    output columns each (blockIdx.z), which both recompute S^T and dP^T.
//  - kDqPass, last: kDeltaPass's blocks and tiles; dS in registers, dQ +=
//    dS.K with K read MN-major.
//  - D=112 runs the D=128 tiles: the maps keep the head dim at 112, TMA
//    zero-fills columns 112..127, the contractions take 7 k-steps, and the
//    output's zero columns are not stored.
//  - tiles wholly above the diagonal for a warpgroup are skipped; masking
//    runs only on tiles that cross the diagonal or T.
// Left for later: overlapping the two products of a tile with the
// elementwise work of the next (the forward's software pipeline), delta in
// the dQ pass's blocks (one pass over the keys fewer), K/V multicast over a
// GQA cluster.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

#include "flash_bwd_common.cuh"
#include "hopper_tc.cuh"

namespace {

constexpr int kBM = 128;              // resident rows per block: two warpgroups of 64
constexpr int kStages = 2;            // ring depth of the streamed tiles
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

enum Pass : int { kDeltaPass, kDqPass, kDkvPass };

template <int D, bool kDKV>
struct BwdTile {
  static constexpr int kPanels = (D + 63) / 64;          // 128-byte panels of the head dim
  static constexpr int kBN = D == 256 ? 32 : 64;         // streamed rows per tile
  static constexpr int kSplit = kDKV && D == 256 ? 2 : 1;  // output column slices
  static constexpr int kOutPanels = kPanels / kSplit;    // output panels a block accumulates
  static constexpr int kMPanel = kBM * 128;              // bytes of one resident panel
  static constexpr int kNPanel = kBN * 128;              // bytes of one streamed panel
  static constexpr int kMBytes = kPanels * kMPanel;      // one resident tile
  static constexpr int kNBytes = kPanels * kNPanel;      // one streamed tile
  static constexpr int kPairBytes = kBN * 8;             // a streamed tile's (lse, delta)
  static constexpr int kPairOffset = 2 * kMBytes + kStages * 2 * kNBytes;
  static constexpr int kBarOffset = kPairOffset + kStages * kPairBytes;
  // + 5 mbarriers, + 1 KB to align the base to the swizzle's 1,024 bytes
  static constexpr int kSmem = kBarOffset + 64 + 1024;
};

// kDKV: resident a1 = K, a2 = V (kv head h / G), streamed b1 = Q, b2 = dO
// (head h); out1 = dK, out2 = dV (or their float32 partials `part`).  kDqPass,
// kDeltaPass: resident a1 = Q, a2 = dO, streamed b1 = K, b2 = V; out1 = dQ, or
// (kDeltaPass) the rows' (lse, delta) pairs in `stats`, from `lse`.
template <int D, int kPass>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc(const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap ta2,
             const __grid_constant__ CUtensorMap tb1, const __grid_constant__ CUtensorMap tb2,
             const float* __restrict__ lse, float2* __restrict__ stats,
             __nv_bfloat16* __restrict__ out1,
             __nv_bfloat16* __restrict__ out2, float* __restrict__ part, int S, int Tk,
             int S_pad, int H, int group, int64_t o_sb, int64_t o_ss, int64_t o_sh,
             float scale_log2, float scale, int causal) {
  constexpr bool kDKV = kPass == kDkvPass;
  using L = BwdTile<D, kDKV>;
  constexpr int BN = L::kBN;
  constexpr int kAcc1 = kDKV ? L::kOutPanels : L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sa1 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa2 = sa1 + L::kMBytes;
  const uint32_t bars = sa1 + L::kBarOffset;
  // barriers: resident full, then full and empty for each stage
  const uint32_t a_full = bars;
  auto sb1 = [&](int st) { return sa1 + 2 * L::kMBytes + st * 2 * L::kNBytes; };
  auto sb2 = [&](int st) { return sb1(st) + L::kNBytes; };
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };
  const float2* pairs = reinterpret_cast<const float2*>(
      smem_raw + (sa1 + L::kPairOffset - smem_u32(smem_raw)));

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t bh = blockIdx.x;
  // resident rows: keys in tile order (kDKV: the first tiles are the
  // heaviest), queries heaviest first (dQ)
  const int r0 = (kDKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kBM;
  // streamed rows [c_begin, c_end): the queries that see any of the keys, or
  // the keys any of the queries sees
  const int c_begin = kDKV && causal ? r0 / BN * BN : 0;
  const int c_end = kDKV ? S : (causal ? min(Tk, r0 + kBM) : Tk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int kvh = h / group;
      const int a_head = kDKV ? kvh : h;
      const int b_head = kDKV ? h : kvh;
      mbar_expect_tx(a_full, 2 * L::kMBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(sa1 + p * L::kMPanel, &ta1, a_full, 64 * p, a_head, r0, b);
        tma_load(sa2 + p * L::kMPanel, &ta2, a_full, 64 * p, a_head, r0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int c0 = c_begin + i * BN;
        if (i >= kStages) mbar_wait(empty(st), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(st), 2 * L::kNBytes + (kDKV ? L::kPairBytes : 0));
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(sb1(st) + p * L::kNPanel, &tb1, full(st), 64 * p, b_head, c0, b);
          tma_load(sb2(st) + p * L::kNPanel, &tb2, full(st), 64 * p, b_head, c0, b);
        }
        if constexpr (kDKV)
          bulk_load(sa1 + L::kPairOffset + st * L::kPairBytes, stats + bh * S_pad + c0,
                    L::kPairBytes, full(st));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // consumers: warpgroup wg owns resident rows [row_lo, row_lo + 64); this
  // thread holds rows row0 and row0 + 8 of them (the wgmma accumulator
  // layout), columns 8 j + col0 + {0, 1} of each 8-column chunk j
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row_lo = r0 + wg * 64;
  const int row0 = row_lo + (tid / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t a1w = sa1 + wg * 64 * 128;  // this warpgroup's rows in each resident panel
  const uint32_t a2w = sa2 + wg * 64 * 128;
  const int slice = kDKV ? blockIdx.z * L::kOutPanels : 0;  // first output panel

  float acc1[kAcc1][32];  // dK (kDKV) or dQ
  float acc2[kDKV ? L::kOutPanels : 1][32];  // dV
#pragma unroll
  for (int p = 0; p < kAcc1; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc1[p][i] = 0.f;
#pragma unroll
  for (int p = 0; p < (kDKV ? L::kOutPanels : 1); ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[p][i] = 0.f;
  // kDqPass, kDeltaPass: this thread's two query rows' (lse, delta); rows past S
  // have lse = +inf (P = 0); kDeltaPass sums their delta here
  float2 row_pair[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if constexpr (kPass == kDqPass) row_pair[r] = stats[bh * S_pad + row];
    if constexpr (kPass == kDeltaPass)
      row_pair[r] = make_float2(row < S ? lse[bh * S + row] * kLog2e : __int_as_float(0x7f800000),
                                0.f);
  }

  mbar_wait(a_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int c0 = c_begin + i * BN;
    mbar_wait(full(st), (i / kStages) & 1);
    // a tile whose every entry is masked for this warpgroup's rows
    const bool dead = causal && (kDKV ? c0 + BN - 1 < row_lo : c0 > row_lo + 63);
    if (!dead) {
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
        wgmma_ss<BN>(s, sw128_desc(a1w + (kk / 4) * L::kMPanel + off),
                     sw128_desc(sb1(st) + (kk / 4) * L::kNPanel + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BN>(dp, sw128_desc(a2w + (kk / 4) * L::kMPanel + off),
                     sw128_desc(sb2(st) + (kk / 4) * L::kNPanel + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(s);
      keep(dp);
      // the tile crosses the diagonal, or (dQ) T
      const bool edge = (causal && (kDKV ? c0 < row_lo + 63 : c0 + BN - 1 > row_lo)) ||
                        (!kDKV && c0 + BN > Tk);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float4 cp = make_float4(0.f, 0.f, 0.f, 0.f);  // kDKV: the two columns' pairs
        if constexpr (kDKV) cp = *reinterpret_cast<const float4*>(
            pairs + st * BN + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 pr = kDKV ? ((e & 1) ? make_float2(cp.z, cp.w) : make_float2(cp.x, cp.y))
                                 : row_pair[e >> 1];
          const int r = row0 + 8 * (e >> 1);
          const int c = c0 + 8 * j + col0 + (e & 1);
          const int key = kDKV ? r : c;
          const int query = kDKV ? c : r;
          float p = exp2f(s[4 * j + e] * scale_log2 - pr.x);
          if (edge && ((causal && key > query) || (!kDKV && key >= Tk))) p = 0.f;
          if constexpr (kPass == kDeltaPass) {
            delta[e >> 1] += p * dp[4 * j + e];
          } else {
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - pr.y);
          }
        }
      }
      if constexpr (kPass == kDeltaPass) {
        if (tid == 0) mbar_arrive(empty(st));
        continue;
      }
      uint32_t pa[kDKV ? BN / 16 : 1][4], da[BN / 16][4];  // P (kDKV) and dS, bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kDKV) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < kAcc1; ++p)  // dK += dS^T.Q, or dQ += dS.K
          wgmma_rs_n64(acc1[p], da[kk], sw128_desc(sb1(st) + (slice + p) * L::kNPanel +
                                                   kk * 16 * 128));
        if constexpr (kDKV)
#pragma unroll
          for (int p = 0; p < L::kOutPanels; ++p)  // dV += P^T.dO
            wgmma_rs_n64(acc2[p], pa[kk], sw128_desc(sb2(st) + (slice + p) * L::kNPanel +
                                                     kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kAcc1; ++p) keep(acc1[p]);
#pragma unroll
      for (int p = 0; p < (kDKV ? L::kOutPanels : 1); ++p) keep(acc2[p]);
      if constexpr (kDKV) keep(pa);
      keep(da);
    }
    if (tid == 0) mbar_arrive(empty(st));
  }

  if constexpr (kPass == kDeltaPass) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(delta[r]);
      if (col0 == 0) stats[bh * S_pad + row0 + 8 * r] = make_float2(row_pair[r].x, sum);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= (kDKV ? Tk : S)) continue;
#pragma unroll
    for (int p = 0; p < kAcc1; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (slice + p) + 8 * j;
        if (col >= D) continue;  // D=112: the zero columns are not stored
        const float x0 = acc1[p][4 * j + 2 * r] * scale;
        const float x1 = acc1[p][4 * j + 2 * r + 1] * scale;
        if (kDKV && part != nullptr) {  // GQA: this head's float32 partials, (2, B, T, H, D)
          const int64_t n = static_cast<int64_t>(gridDim.x) * Tk * D;  // B*H*T*D
          float* dst = part + ((static_cast<int64_t>(b) * Tk + row) * H + h) * D + col + col0;
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
          const int pv = kDKV ? p : 0;
          *reinterpret_cast<float2*>(dst + n) =
              make_float2(acc2[pv][4 * j + 2 * r], acc2[pv][4 * j + 2 * r + 1]);
        } else {
          __nv_bfloat16* dst = out1 + b * o_sb + row * o_ss + h * o_sh + col + col0;
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
          if constexpr (kDKV)
            *reinterpret_cast<__nv_bfloat162*>(out2 + (dst - out1)) = __floats2bfloat162_rn(
                acc2[p][4 * j + 2 * r], acc2[p][4 * j + 2 * r + 1]);
        }
      }
  }
}

template <int D, int kPass>
cudaError_t launch_pass(const CUtensorMap* maps, const float* lse, float* stats, void* out1,
                        void* out2, float* part, int B, int S, int Tk, int H, int KV,
                        const long long* ost, int causal, cudaStream_t stream) {
  using L = BwdTile<D, kPass == kDkvPass>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tc<D, kPass>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = kPass == kDkvPass ? Tk : S;
  const dim3 grid(B * H, (rows + kBM - 1) / kBM, L::kSplit);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_bwd_tc<D, kPass><<<grid, kThreads, L::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, reinterpret_cast<float2*>(stats),
      static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2), part, S, Tk,
      flash_bwd::stat_rows(S), H, H / KV, ost[0], ost[1], ost[2], kLog2e * scale, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, float* part,
                   int B, int S, int Tk, int H, int KV, const long long* st, int causal,
                   cudaStream_t stream) {
  constexpr int BN = BwdTile<D, true>::kBN;
  // resident boxes of kBM rows, streamed ones of BN
  CUtensorMap kv_maps[4], q_maps[4];
  if (!make_map(&kv_maps[0], k, D, KV, Tk, B, st[3], st[4], st[5], kBM) ||
      !make_map(&kv_maps[1], v, D, KV, Tk, B, st[3], st[4], st[5], kBM) ||
      !make_map(&kv_maps[2], q, D, H, S, B, st[0], st[1], st[2], BN) ||
      !make_map(&kv_maps[3], dout, D, H, S, B, st[0], st[1], st[2], BN) ||
      !make_map(&q_maps[0], q, D, H, S, B, st[0], st[1], st[2], kBM) ||
      !make_map(&q_maps[1], dout, D, H, S, B, st[0], st[1], st[2], kBM) ||
      !make_map(&q_maps[2], k, D, KV, Tk, B, st[3], st[4], st[5], BN) ||
      !make_map(&q_maps[3], v, D, KV, Tk, B, st[3], st[4], st[5], BN))
    return cudaErrorInvalidValue;
  // the (lse, delta) pairs; dK, dV into k's layout directly, or (GQA)
  // per-head partials; dQ
  cudaError_t err = launch_pass<D, kDeltaPass>(q_maps, lse, stats, nullptr, nullptr, nullptr,
                                               B, S, Tk, H, KV, st, causal, stream);
  if (err != cudaSuccess) return err;
  err = launch_pass<D, kDkvPass>(kv_maps, lse, stats, dk, dv, part, B, S, Tk, H, KV, st + 3,
                                 causal, stream);
  if (err != cudaSuccess) return err;
  err = launch_pass<D, kDqPass>(q_maps, lse, stats, dq, nullptr, nullptr, B, S, Tk, H, KV, st,
                                causal, stream);
  if (err != cudaSuccess || part == nullptr) return err;
  return flash_bwd::launch_group_sum<__nv_bfloat16>(part, dk, dv, B, Tk, H, KV, D, st, stream);
}

}  // namespace

// The arguments of flash_attn_bwd; takes bf16 (dtype 1) at D 64, 112, 128 or
// 256 only, 16-byte aligned tensors with 16-byte aligned row and head
// strides, and refuses anything else with cudaErrorInvalidValue.  Launches
// on `stream` and returns cudaGetLastError() after the last launch.
extern "C" int flash_attn_bwd_tc(const void* q, const void* k, const void* v, const float* lse,
                                 const void* dout, void* dq, void* dk, void* dv,
                                 float* stats, float* part, int B, int S, int T, int H, int KV,
                                 int D, int dtype, int causal, long long q_sb, long long q_ss,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 void* stream) {
  const long long st[6] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (dtype != 1 || KV <= 0 || H % KV != 0 || T <= 0 || (H != KV) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv),
                        static_cast<const void*>(stats)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
#define FLASH_BWD_ARGS q, k, v, lse, dout, dq, dk, dv, stats, part, B, S, T, H, KV, st, causal, s
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
