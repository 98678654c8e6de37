// Causal GQA flash attention, forward, on Hopper's tensor cores (sm_90a).
//
// The bf16 route of the port's flash attention at head dims 64, 128 and 256
// (phi3, qwen, pixtral 128; gemma 256; whisper 64).  Replaces the Pallas TPU
// kernel `_flash_kernel` (src/repro/kernels/flash_attn/kernel.py:41) with the
// contract of csrc/flash_attn.cu: q (B, S, H, D), k and v (B, T, KV, D) in the
// model's layout; query head h reads kv head h / (H / KV) in place; key t is
// masked for query s when t > s (causal) and when t >= T, with -1e30; the
// softmax runs online with float32 (m, l, acc); out is acc / max(l, 1e-30),
// rounded once to bf16.  Scores q.k are exact products summed in float32.
// P is rounded to bf16 before P.V, which is what the TPU kernel's
// `dot(p, v, precision=DEFAULT)` does on its own chip (one bf16 pass); l sums
// the unrounded float32 P, as there.
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
//  - the host builds the tensor maps per call with cuTensorMapEncodeTiled,
//    fetched through cudaGetDriverEntryPoint (no -lcuda at link time).
// Left for later: overlapping one warpgroup's softmax with the other's
// wgmma (ping-pong), K/V multicast across a GQA cluster, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 128;              // queries per block: two warpgroups of 64
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr float kMasked = -1e30f;     // JAX's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kBK = D == 256 ? 64 : 128;      // keys per tile
  static constexpr int kPanels = D / 64;                // 128-byte panels of the head dim
  static constexpr int kQPanel = kBQ * 128;             // bytes of one Q panel
  static constexpr int kKPanel = kBK * 128;             // bytes of one K or V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKPanel;    // one K (or V) tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + 9 mbarriers, + 1 KB to align the base to the swizzle's 1,024 bytes
  static constexpr int kSmem = kBarOffset + 128 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
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

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row groups
// 1,024 bytes apart (SBO); the leading offset is unused by these layouts.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t{1} << 62) | (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 16) |
         ((addr >> 4) & 0x3FFFu);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers an asynchronous wgmma reads or writes: keep the compiler from
// moving their uses across the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128) += A (64 x 16, shared) * B (128 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, shared) * B (64 x 16, shared)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t a, uint64_t b,
                                             int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, a, b, accumulate);
  } else {
    wgmma_ss_n64(d, a, b, accumulate);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issue S = Q.K^T for one key tile (not waited for): D/16 k-steps over the
// 128-byte panels of this warpgroup's 64 Q rows and the tile's K rows.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[Tile<D>::kBK / 2], uint32_t qa,
                                             uint32_t ks) {
  using L = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
    wgmma_scores<L::kBK>(s, sw128_desc(qa + (kk / 4) * L::kQPanel + off),
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
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
             int Tk, int H, int group, int64_t o_sb, int64_t o_ss, int64_t o_sh,
             float scale_log2, int causal) {
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
    __nv_bfloat16* orow = o + b * o_sb + row * o_ss + h * o_sh + col0;
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * p + 8 * j) = __floats2bfloat162_rn(
            acc[p][4 * j + 2 * r] / denom, acc[p][4 * j + 2 * r + 1] / denom);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, rows, heads, D) tensor as the 4-D map (D, heads, rows, B) with
// strides in elements; boxes are one 64-column panel of `box_rows` rows of
// one head, stored with the 128-byte swizzle, zero-filled past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows, int B,
              long long s_b, long long s_row, long long s_head, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // a dimension of extent 1 may carry any stride in a contiguous tensor
  if (heads == 1) s_head = D;
  if (rows == 1) s_row = heads * s_head;
  if (B == 1) s_b = rows * s_row;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s_head) * 2, cuuint64_t(s_row) * 2,
                                 cuuint64_t(s_b) * 2};
  for (const cuuint64_t st : strides)
    if (st % 16 != 0 || st >= (cuuint64_t{1} << 40)) return false;
  const cuuint32_t box[4] = {64, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int KV, const long long* st, int causal, cudaStream_t stream) {
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Tk, H, H / KV, st[0], st[1], st[2],
      kLog2e / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

}  // namespace

// The arguments of flash_attn_fwd; takes bf16 (dtype 1) at D 64, 128 or 256
// only, 16-byte aligned q, k, v with 16-byte aligned row and head strides,
// and refuses anything else with cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int T, int H, int KV, int D, int dtype, int causal,
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
    case 64: err = launch<64>(q, k, v, o, B, S, T, H, KV, st, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, B, S, T, H, KV, st, causal, s); break;
    case 256: err = launch<256>(q, k, v, o, B, S, T, H, KV, st, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
