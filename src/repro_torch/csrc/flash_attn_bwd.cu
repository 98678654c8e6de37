// Causal GQA flash attention, backward, on the CUDA cores (sm_90a): the
// float32 route at every head dim and the bf16 route at D 16 and 32, the
// forward routes of flash_attn.cu.  bf16 at D 64, 112, 128 and 256 runs on
// the tensor cores in flash_attn_bwd_tc.cu instead.
//
// No TPU kernel to replace: the JAX package leaves its backward to XLA,
// which differentiates the einsum path (and cannot differentiate its Pallas
// forward).  The contract is ref.py's attention_bwd_lse_ref: from q (B, S,
// H, D), k and v (B, T, KV, D), the forward's log-sum-exp lse (B, H, S) and
// dO, in the model's layout: P = exp(q.k / sqrt(D) - lse) with key t masked
// for query s when t > s (causal) or t >= T, dP = dO.V^T, delta =
// rowsum(P * dP), dV = P^T.dO, dS = P * (dP - delta), dQ = dS.K / sqrt(D),
// dK = dS^T.Q / sqrt(D), every product and sum in float32, each gradient
// rounded once to the input type.  Query head h reads kv head h / (H / KV)
// in place.
//
// Deterministic: no atomics.  Every sum runs in a fixed order, and with GQA
// each query head's dK and dV go to float32 partials that
// flash_bwd_common.cuh's bwd_group_sum adds in head order.
//
// Bound on this card: operations (five products of 2 D operations per
// visible (query head, key) pair) at the CUDA cores' float32 rate
// (67 TFLOP/s).  The route exists for float32 inputs and the small bf16 head
// dims, so the design is the simple one, three passes of one kernel
// (flash_bwd_cc<T, D, pass>), each a 256-thread block a (b, h, tile of BR
// rows), the resident rows' operands staged once as float32 in shared
// memory and the other operand's tiles staged in turn:
//  - kDeltaPass: per (b, h, query tile) over the key tiles up to the diagonal,
//    delta = rowsum(P * dP) (flash_bwd_common.cuh says why not from O) into
//    the (lse, delta) pairs;
//  - kDkvPass: per (b, h, key tile) over the query tiles from the diagonal down;
//    each thread computes BR*BC/256 entries of S^T and dP^T, writes P and dS
//    to shared memory, then adds P^T.dO and dS^T.Q into the BR*D/256 (key,
//    column) entries of dV and dK it owns;
//  - kDqPass: per (b, h, query tile) as kDeltaPass, accumulating dS.K into dQ;
//  - bwd_group_sum: the fixed-order sum over each GQA group (H > KV only).
// Tiles of 64 rows at D <= 128 (165 KB of shared memory at D=128), 32 at
// D=256; rows are D+1 floats apart so a warp's column reads hit 32 banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_bwd_common.cuh"

namespace {

using flash_bwd::from_float;
using flash_bwd::to_float;

constexpr int kThreads = 256;

template <int D>
struct CcTile {
  static constexpr int kRows = D <= 128 ? 64 : 32;  // rows of every tile
  static constexpr int kStride = D + 1;
  static constexpr int kPStride = kRows + 1;
  static constexpr int kFloats = 4 * kRows * kStride + 2 * kRows * kPStride + 2 * kRows;
  static constexpr int kSmem = kFloats * static_cast<int>(sizeof(float));
};

// Rows [row0, row0 + rows) of one head's (len, D) slice, rows `row_stride`
// elements apart, into shared memory as float32 at `stride`; rows past
// `len` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row_stride, int row0,
                                      int rows, int len) {
  for (int c = threadIdx.x; c < rows * D; c += kThreads) {
    const int r = c / D;
    const int d = c % D;
    dst[r * (D + 1) + d] = row0 + r < len ? to_float(src[(row0 + r) * row_stride + d]) : 0.f;
  }
}

enum Pass : int { kDeltaPass, kDqPass, kDkvPass };

// kDkvPass: resident a1 = K, a2 = V (rows = keys), streamed b1 = Q, b2 = dO
// (rows = queries), the (lse, delta) pair by column; out dK (acc1) and dV
// (acc2).  kDqPass, kDeltaPass: resident a1 = Q, a2 = dO, streamed b1 = K,
// b2 = V, the pair by row; out dQ (acc1), or the pairs' delta (kDeltaPass,
// which reads the rows' lse and writes their pairs).
template <typename T, int D, int kPass>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_cc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse, float2* __restrict__ stats,
             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
             int S, int Tk, int S_pad, int H, int group, int64_t q_sb, int64_t q_ss, int64_t q_sh,
             int64_t k_sb, int64_t k_st, int64_t k_sh, float scale, int causal) {
  using L = CcTile<D>;
  constexpr bool kDKV = kPass == kDkvPass;
  constexpr int BR = L::kRows;
  constexpr int BC = L::kRows;
  constexpr int kScores = BR * BC / kThreads;  // S (and dP) entries a thread computes
  constexpr int kOut = BR * D / kThreads;      // output entries a thread owns
  static_assert(BR * D % kThreads == 0, "outputs divide over the threads");
  extern __shared__ float smem[];
  float* a1 = smem;
  float* a2 = a1 + BR * L::kStride;
  float* b1 = a2 + BR * L::kStride;
  float* b2 = b1 + BC * L::kStride;
  float* ps = b2 + BC * L::kStride;      // P (kDeltaPass: P * dP), (BR, BC + 1)
  float* dss = ps + BR * L::kPStride;    // dS
  float2* pair = reinterpret_cast<float2*>(dss + BR * L::kPStride);  // (lse, delta) of the tile

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t bh = blockIdx.x;
  const T* qh = q + b * q_sb + h * q_sh;
  const T* doh = dout + b * q_sb + h * q_sh;
  const T* kh = k + b * k_sb + (h / group) * k_sh;
  const T* vh = v + b * k_sb + (h / group) * k_sh;
  const int r0 = blockIdx.y * BR;  // first resident row: a key (kDkvPass) or a query
  if constexpr (kDKV) {
    stage<T, D>(a1, kh, k_st, r0, BR, Tk);
    stage<T, D>(a2, vh, k_st, r0, BR, Tk);
  } else {
    stage<T, D>(a1, qh, q_ss, r0, BR, S);
    stage<T, D>(a2, doh, q_ss, r0, BR, S);
  }
  // kDeltaPass: the rows' lse, +inf past S (so P = 0 there); row t's delta
  // accumulates in thread t
  if constexpr (kPass == kDeltaPass)
    for (int c = threadIdx.x; c < BR; c += kThreads)
      pair[c] = make_float2(r0 + c < S ? lse[bh * S + r0 + c] : __int_as_float(0x7f800000), 0.f);
  float delta = 0.f;

  float acc1[kOut], acc2[kDKV ? kOut : 1];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    acc1[i] = 0.f;
    if constexpr (kDKV) acc2[i] = 0.f;
  }
  // the streamed rows: queries from the diagonal's tile (kDkvPass), keys up to
  // the tile's last query (kDqPass, kDeltaPass)
  const int c_begin = kDKV && causal ? r0 / BC * BC : 0;
  const int c_end = kDKV ? S : (causal ? min(Tk, r0 + BR) : Tk);

  for (int c0 = c_begin; c0 < c_end; c0 += BC) {
    __syncthreads();  // the previous tile is done with b1, b2, ps, dss, pair
    if constexpr (kDKV) {
      stage<T, D>(b1, qh, q_ss, c0, BC, S);
      stage<T, D>(b2, doh, q_ss, c0, BC, S);
      for (int c = threadIdx.x; c < BC; c += kThreads) pair[c] = stats[bh * S_pad + c0 + c];
    } else {
      stage<T, D>(b1, kh, k_st, c0, BC, Tk);
      stage<T, D>(b2, vh, k_st, c0, BC, Tk);
      if constexpr (kPass == kDqPass)
        for (int c = threadIdx.x; c < BR; c += kThreads) pair[c] = stats[bh * S_pad + r0 + c];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / BC;
      const int c = e % BC;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(a1[r * L::kStride + d], b1[c * L::kStride + d], s);
        dp = fmaf(a2[r * L::kStride + d], b2[c * L::kStride + d], dp);
      }
      const int key = kDKV ? r0 + r : c0 + c;
      const int query = kDKV ? c0 + c : r0 + r;
      const float2 st = pair[kDKV ? c : r];
      // a query past S has lse = +inf, so P = 0 there
      const bool masked = (causal && key > query) || (!kDKV && key >= Tk);
      const float p = masked ? 0.f : expf(s * scale - st.x);
      if constexpr (kPass == kDeltaPass) {
        ps[r * L::kPStride + c] = p * dp;
      } else {
        ps[r * L::kPStride + c] = p;
        dss[r * L::kPStride + c] = p * (dp - st.y);
      }
    }
    __syncthreads();

    if constexpr (kPass == kDeltaPass) {
      if (threadIdx.x < BR)
        for (int c = 0; c < BC; ++c) delta += ps[threadIdx.x * L::kPStride + c];
      continue;
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / D;
      const int d = e % D;
      float x1 = acc1[i], x2 = kDKV ? acc2[i] : 0.f;
      for (int c = 0; c < BC; ++c) {
        x1 = fmaf(dss[r * L::kPStride + c], b1[c * L::kStride + d], x1);
        if constexpr (kDKV) x2 = fmaf(ps[r * L::kPStride + c], b2[c * L::kStride + d], x2);
      }
      acc1[i] = x1;
      if constexpr (kDKV) acc2[i] = x2;
    }
  }

  if constexpr (kPass == kDeltaPass) {
    if (threadIdx.x < BR)
      stats[bh * S_pad + r0 + threadIdx.x] = make_float2(pair[threadIdx.x].x, delta);
    return;
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int r = e / D;
    const int d = e % D;
    const int row = r0 + r;
    if constexpr (kDKV) {
      if (row >= Tk) continue;
      if (part != nullptr) {  // GQA: this head's float32 partial, (2, B, T, H, D)
        const int64_t n = static_cast<int64_t>(gridDim.x) * Tk * D;  // B*H*T*D
        float* dst = part + ((static_cast<int64_t>(b) * Tk + row) * H + h) * D + d;
        dst[0] = acc1[i] * scale;
        dst[n] = acc2[i];
      } else {
        dk[b * k_sb + row * k_st + h * k_sh + d] = from_float<T>(acc1[i] * scale);
        dv[b * k_sb + row * k_st + h * k_sh + d] = from_float<T>(acc2[i]);
      }
    } else {
      if (row >= S) continue;
      dq[b * q_sb + row * q_ss + h * q_sh + d] = from_float<T>(acc1[i] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, float* part,
                   int B, int S, int Tk, int H, int KV, const long long* st, int causal,
                   cudaStream_t stream) {
  using L = CcTile<D>;
  constexpr int R = L::kRows;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  auto pass = [&](auto kernel, int rows) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(B * H, (rows + R - 1) / R), kThreads, L::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, reinterpret_cast<float2*>(stats),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), part, S, Tk,
        flash_bwd::stat_rows(S), H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], scale,
        causal);
    return cudaGetLastError();
  };
  cudaError_t err;
  if ((err = pass(flash_bwd_cc<T, D, kDeltaPass>, S)) != cudaSuccess) return err;
  if ((err = pass(flash_bwd_cc<T, D, kDkvPass>, Tk)) != cudaSuccess) return err;
  if ((err = pass(flash_bwd_cc<T, D, kDqPass>, S)) != cudaSuccess) return err;
  if (part == nullptr) return cudaSuccess;
  return flash_bwd::launch_group_sum<T>(part, dk, dv, B, Tk, H, KV, D, st, stream);
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const float* lse,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* stats, float* part, int B, int S, int Tk, int H, int KV,
                     const long long* st, int causal, cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
#define FLASH_BWD_ARGS \
  q, k, v, lse, dout, dq, dk, dv, stats, part, B, S, Tk, H, KV, st, causal, s
  switch (D) {
    case 16: return launch<T, 16>(FLASH_BWD_ARGS);
    case 32: return launch<T, 32>(FLASH_BWD_ARGS);
    case 64:
      if constexpr (kF32) return launch<T, 64>(FLASH_BWD_ARGS);
      break;
    case 112:
      if constexpr (kF32) return launch<T, 112>(FLASH_BWD_ARGS);
      break;
    case 128:
      if constexpr (kF32) return launch<T, 128>(FLASH_BWD_ARGS);
      break;
    case 256:
      if constexpr (kF32) return launch<T, 256>(FLASH_BWD_ARGS);
      break;
  }
#undef FLASH_BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dO, dq share the strides (batch, seq, head) q_*; k, v, dk, dv share k_*;
// the head dim is contiguous.  lse: the forward's float32 (B, H, S)
// log-sum-exps.
// stats: float32 scratch (B*H, S rounded up to 128, 2).  part: float32
// scratch (2, B, T, H, D) when H > KV, else null (dK and dV are written
// directly).  dtype: 0 float32, 1 bfloat16 (D 16 or 32).  Launches on
// `stream` and returns cudaGetLastError() after the last launch.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const float* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              float* stats, float* part, int B, int S, int T, int H, int KV,
                              int D, int dtype, int causal, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_st, long long k_sh,
                              void* stream) {
  const long long st[6] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || T <= 0 || (H != KV) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(D, q, k, v, lse, dout, dq, dk, dv, stats, part, B, S, T, H,
                                   KV, st, causal, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(D, q, k, v, lse, dout, dq, dk, dv, stats, part, B,
                                             S, T, H, KV, st, causal, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
