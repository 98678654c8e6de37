// Causal GQA flash attention, forward, on Hopper's tensor cores (sm_90a).
//
// The bf16 route of the port's flash attention at head dims 64, 112, 128 and
// 256 (phi3, qwen, pixtral 128; gemma 256; whisper 64; zamba2's shared block
// 112).  Replaces the Pallas TPU
// kernel `_flash_kernel` (src/repro/kernels/flash_attn/kernel.py:41) with the
// contract of csrc/flash_attn.cu: q (B, S, H, D), k and v (B, T, KV, D) in the
// model's layout; query head h reads kv head h / (H / KV) in place; key t is
// masked for query s when t > s (causal) and when t >= T, with -1e30; the
// softmax runs online with float32 (m, l, acc); out is acc / max(l, 1e-30),
// rounded once to bf16.  Scores q.k are exact products summed in float32.
// P is rounded to bf16 before P.V, which is what the TPU kernel's
// `dot(p, v, precision=DEFAULT)` does on its own chip (one bf16 pass); l sums
// the unrounded float32 P, as there.  Where the caller asks (training), it
// also writes each query row's log-sum-exp, m + log(l) in natural units,
// float32 (B, H, S), which the backward (flash_attn_bwd_tc.cu) rebuilds P
// from; serving passes a null pointer and pays nothing.
//
// Bound on this card: operations.  At the main path's shape (B=4, S=T=2048,
// H=40, KV=10, D=128) causal attention is 1.72e11 operations, 0.174 ms at the
// tensor cores' 989 TFLOP/s; q, k, v and O once are 0.063 ms at 3.35 TB/s.
//
// Design (one block of 384 threads per 128-query tile of one (b, h)):
//  - one producer warpgroup, cut to 24 registers a thread by setmaxnreg so
//    the consumers get 240: one thread loads the Q tile once, then the K and V
//    tiles of the loop into a ring of two stages with TMA, each K and each V
//    tile guarded by a full and an empty mbarrier.  The tensor maps view q,
//    k, v as 4-D (D, heads, rows, B) tensors; a box is one 64-column panel of
//    the head dim (128 bytes) over the tile's rows, stored with the 128-byte
//    swizzle that wgmma reads.  TMA zero-fills rows past S or T, so ragged edges need no
//    staging code; the score mask still hides keys >= T.
//  - two consumer warpgroups of 64 query rows each: S = Q.K^T with wgmma
//    (both operands K-major in shared memory, float32 accumulators), the
//    online softmax in registers (a row spans the 4 threads of a quad), then
//    O += P.V with P converted to bf16 in registers as wgmma's A operand (the
//    m64nK float32 accumulator layout is the k16 A fragment layout, so P never
//    touches shared memory) and V read MN-major from shared memory.  A
//    warpgroup issues tile i's scores before tile i-1's P.V, so its softmax
//    of tile i runs while the tensor cores do P.V of tile i-1; the two
//    warpgroups interleave on the SM besides.
//  - key tiles of 128 at D <= 128 (Q + 2 stages: 160 KB at D=128) and of 64
//    at D=256 (192 KB); masking runs only on tiles that cross the diagonal or
//    T.  Blocks run the heaviest causal tiles first, and the query heads of
//    one GQA group sit on neighbouring blocks, so their K/V tiles meet in L2.
//  - D=112 runs the D=128 tile code over two 64-column panels: the tensor
//    maps keep the head dim at 112 (224-byte heads, a multiple of TMA's 16
//    bytes), so the second panel's box reads columns 64..127 and TMA
//    zero-fills 112..127.  Q.K^T takes 7 k-steps of 16 (the zero columns
//    would add nothing), P.V's columns 112..127 come out zero and are not
//    stored; the scale is 1/sqrt(112).
//  - the host builds the tensor maps per call with cuTensorMapEncodeTiled,
//    fetched through cudaGetDriverEntryPoint (no -lcuda at link time;
//    hopper_tc.cuh).
// Left for later: overlapping one warpgroup's softmax with the other's
// wgmma (ping-pong), K/V multicast across a GQA cluster, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 128;              // queries per block: two warpgroups of 64
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr float kMasked = -1e30f;     // JAX's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int kBK = D == 256 ? 64 : 128;      // keys per tile
  static constexpr int kPanels = (D + 63) / 64;         // 128-byte panels of the head dim
  static constexpr int kQPanel = kBQ * 128;             // bytes of one Q panel
  static constexpr int kKPanel = kBK * 128;             // bytes of one K or V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKPanel;    // one K (or V) tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + 9 mbarriers, + 1 KB to align the base to the swizzle's 1,024 bytes
  static constexpr int kSmem = kBarOffset + 128 + 1024;
};


// Issue S = Q.K^T for one key tile (not waited for): D/16 k-steps over the
// 128-byte panels of this warpgroup's 64 Q rows and the tile's K rows.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[Tile<D>::kBK / 2], uint32_t qa,
                                             uint32_t ks) {
  using L = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // D=112: 7 steps, the zero-filled columns skipped
    const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
    wgmma_ss<L::kBK>(s, sw128_desc(qa + (kk / 4) * L::kQPanel + off),
                         sw128_desc(ks + (kk / 4) * L::kKPanel + off), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P.V for one key tile (not waited for): P from registers, V
// MN-major from shared memory, one 64-column panel of O per instruction.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[Tile<D>::kPanels][32],
                                         const uint32_t (&pa)[Tile<D>::kBK / 16][4],
                                         uint32_t vs) {
  using L = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk)
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      wgmma_rs_n64(acc[p], pa[kk], sw128_desc(vs + p * L::kKPanel + kk * 16 * 128));
  wgmma_commit();
}

// The online softmax of one tile of scores, in place: s becomes
// P = exp(s * scale - m_new) (base 2, the scale folded into log2 e), m and
// this thread's share of l move on, corr = exp(m_old - m_new).  Masks (key
// past the query, key >= T) only where the tile crosses them (`edge`).
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float scale_log2, bool edge,
                                               int k0, int row0, int col0, int Tk, int causal) {
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * j + col0 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if ((causal && key > row) || key >= Tk) x = kMasked;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * j + e] - m[e >> 1]);
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// P to bf16 A fragments: k-step kk's fragment is accumulator columns
// [16 kk, 16 kk + 16), registers 8 kk .. 8 kk + 7 in order.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int P>
__device__ __forceinline__ void rescale(float (&acc)[P][32], const float (&corr)[2]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int S, int Tk, int H, int group, int64_t o_sb,
             int64_t o_ss, int64_t o_sh, float scale_log2, int causal) {
  using L = Tile<D>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sq + L::kBarOffset;
  // barriers: Q full, then K full, V full, K empty and V empty for each stage
  const uint32_t q_full = bars;
  auto sk = [&](int st) { return sq + L::kQBytes + st * 2 * L::kKVBytes; };
  auto sv = [&](int st) { return sk(st) + L::kKVBytes; };
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * kStages + st); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  // keys past the tile's last query are masked for every row of it
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 2);  // one arrival per consumer warpgroup
      mbar_init(v_empty(st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= kConsumers / 32) {
    // producer: one thread keeps the ring full; the warpgroup hands its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sq + p * L::kQPanel, &tq, q_full, 64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t freed = ((i / kStages) - 1) & 1;  // the stage's previous use
        if (i >= kStages) mbar_wait(k_empty(st), freed);
        mbar_expect_tx(k_full(st), L::kKVBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sk(st) + p * L::kKPanel, &tk, k_full(st), 64 * p, kvh, i * BK, b);
        if (i >= kStages) mbar_wait(v_empty(st), freed);
        mbar_expect_tx(v_full(st), L::kKVBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sv(st) + p * L::kKPanel, &tv, v_full(st), 64 * p, kvh, i * BK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  // consumers: warpgroup wg owns query rows [row_lo, row_lo + 64) of the tile;
  // this thread holds rows row0 and row0 + 8 of them (the wgmma accumulator
  // layout), columns 8 j + 2 (lane % 4) + {0, 1} of each 8-column chunk j
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row_lo = q0 + wg * 64;
  const int row0 = row_lo + (tid / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's rows in each Q panel
  // tiles this warpgroup computes: at D=256 the last tile of a diagonal can
  // lie wholly past its rows
  const int n_live = causal ? min(n_tiles, (row_lo + 63) / BK + 1) : n_tiles;
  auto edge = [&](int k0) { return (causal && k0 + BK - 1 > row_lo) || k0 + BK > Tk; };
  auto parity = [](int i) { return static_cast<uint32_t>((i / kStages) & 1); };

  float acc[L::kPanels][32];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float corr[2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t pa[BK / 16][4];

  // Tile i's scores are issued before tile i-1's P.V, so this warpgroup's
  // softmax of tile i runs while the tensor cores do P.V of tile i-1.
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  issue_scores<D>(s, qa, sk(0));
  wgmma_wait<0>();
  keep(s);
  if (tid == 0) mbar_arrive(k_empty(0));
  online_softmax<BK>(s, m, l, corr, scale_log2, edge(0), 0, row0, col0, Tk, causal);
  pack_p<BK>(s, pa);
  for (int i = 1; i < n_live; ++i) {
    const int st = i % kStages;
    const int prev = (i - 1) % kStages;
    mbar_wait(k_full(st), parity(i));
    issue_scores<D>(s, qa, sk(st));
    mbar_wait(v_full(prev), parity(i - 1));
    issue_pv<D>(acc, pa, sv(prev));
    wgmma_wait<1>();  // the scores are in
    keep(s);
    if (tid == 0) mbar_arrive(k_empty(st));
    online_softmax<BK>(s, m, l, corr, scale_log2, edge(i * BK), i * BK, row0, col0, Tk, causal);
    wgmma_wait<0>();  // P.V of tile i-1 is in: its P and V may go
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) keep(acc[p]);
    keep(pa);
    if (tid == 0) mbar_arrive(v_empty(prev));
    rescale(acc, corr);
    pack_p<BK>(s, pa);
  }
  const int last = (n_live - 1) % kStages;
  mbar_wait(v_full(last), parity(n_live - 1));
  issue_pv<D>(acc, pa, sv(last));
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) keep(acc[p]);
  keep(pa);
  if (tid == 0) mbar_arrive(v_empty(last));
  for (int i = n_live; i < n_tiles; ++i) {  // loaded for the other warpgroup only
    const int st = i % kStages;
    mbar_wait(k_full(st), parity(i));
    if (tid == 0) mbar_arrive(k_empty(st));
    mbar_wait(v_full(st), parity(i));
    if (tid == 0) mbar_arrive(v_empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    // m is in base 2 with the scale folded in: lse = (m + log2 l) ln 2
    if (lse != nullptr && col0 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + row] = (m[r] + log2f(denom)) * kLn2;
    __nv_bfloat16* orow = o + b * o_sb + row * o_ss + h * o_sh + col0;
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * p + 8 * j < D)  // D=112: the zero columns are not stored
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * p + 8 * j) = __floats2bfloat162_rn(
              acc[p][4 * j + 2 * r] / denom, acc[p][4 * j + 2 * r + 1] / denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int KV, const long long* st, int causal,
                   cudaStream_t stream) {
  using L = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, S, B, st[0], st[1], st[2], kBQ) ||
      !make_map(&tk, k, D, KV, Tk, B, st[3], st[4], st[5], L::kBK) ||
      !make_map(&tv, v, D, KV, Tk, B, st[3], st[4], st[5], L::kBK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_tc<D><<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Tk, H, H / KV, st[0], st[1], st[2],
      kLog2e / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

}  // namespace

// The arguments of flash_attn_fwd; takes bf16 (dtype 1) at D 64, 112, 128 or
// 256 only, 16-byte aligned q, k, v with 16-byte aligned row and head
// strides, and refuses anything else with cudaErrorInvalidValue.  lse, when
// not null, receives float32 (B, H, S) log-sum-exps.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int B, int S, int T, int H, int KV, int D,
                                 int dtype, int causal,
                                 long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                 long long k_st, long long k_sh, void* stream) {
  const long long st[6] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (dtype != 1 || KV <= 0 || H % KV != 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 64: err = launch<64>(q, k, v, o, lse, B, S, T, H, KV, st, causal, s); break;
    case 112: err = launch<112>(q, k, v, o, lse, B, S, T, H, KV, st, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, lse, B, S, T, H, KV, st, causal, s); break;
    case 256: err = launch<256>(q, k, v, o, lse, B, S, T, H, KV, st, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
