// Causal GQA flash attention, forward, on the CUDA cores (sm_90a): the
// float32 route at every head dim and the bf16 route at D 16 and 32.  bf16
// at D 64, 112, 128 and 256 runs on the tensor cores in flash_attn_tc.cu
// instead.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (src/repro/kernels/flash_attn/
// kernel.py:41) together with what its wrapper (ops.py) did around it.  Same
// contract: q (B, S, H, D), k and v (B, T, KV, D) in the model's layout, float32
// or bfloat16; out (B, S, H, D) in q's type.  Scores are q.k * 1/sqrt(D) in
// float32, key t is masked for query s when t > s (causal) with -1e30, the
// softmax runs online with float32 (m, l, acc) carries, and the output is
// acc / max(l, 1e-30), rounded once to the output type.  Where the caller
// asks (training), each query row's log-sum-exp m + log(max(l, 1e-30)) is
// written too, float32 (B, H, S), for the backward (flash_attn_bwd.cu).
//
// What the wrapper used to do is gone: query head h reads kv head h / (H / KV)
// straight from k and v (no `repeat`), q, k, v are read and O is written in the
// model layout through their strides (no `moveaxis`), and ragged S and T are
// masked here (no padding copies).  Keys at or past T never enter the softmax.
//
// Bound on this card: operations, at the CUDA cores' float32 rate (67 TFLOP/s)
// for the float32 inputs it exists for.  It does its products in float32 on
// the CUDA cores, so it is exact to float32 summation order (1e-5 against the
// plain version).
//
// Design: one block of 256 threads per (64-query tile, b*h), the heaviest
// (latest) query tiles scheduled first.  The block loops over 64-key tiles up to
// the diagonal -- the TPU's sequential k grid axis and its `pl.when` skip become
// this loop -- staging each K tile, then each V tile, in one shared buffer as
// float32.  Thread (ty, tx) owns query rows ty + 16 i (i < 4): it computes a 4x4
// block of scores, the 16 threads of a row reduce its max and sum by shuffles,
// and it accumulates D/16 output columns of each of its rows in registers:
// where 64 divides D, runs of 4 neighbouring columns 64 apart (tx*4 + 64 g + e);
// otherwise (D 16, 32, 112) single columns 16 apart (tx + 16 g), which covers
// D = 16 * (D/16) exactly, 7 columns a thread at D 112 (float32 only), and
// reads nothing past D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPStride = kBK + 4;  // row stride of the probability tile
constexpr float kMasked = -1e30f;  // JAX's NEG_INF

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <int D>
constexpr int smem_bytes() {
  return (2 * kBQ * (D + 4) + kBQ * kPStride) * static_cast<int>(sizeof(float));
}

// Rows [row0, row0 + 64) of one head's (len, D) slice, whose rows lie
// `row_stride` elements apart, into shared memory as float32; rows past `len`
// are zero.  Four elements per thread and load, neighbouring threads on
// neighbouring addresses.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row_stride, int row0,
                                      int len) {
  constexpr int kQuads = D / 4;
  for (int c = threadIdx.x; c < kBQ * kQuads; c += kThreads) {
    const int r = c / kQuads;
    const int d = (c % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len) x = Io<T>::load4(src + (row0 + r) * row_stride + d);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + d) = x;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H, int group,
          int64_t q_sb, int64_t q_ss,
          int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, float scale, int causal) {
  constexpr int kStride = D + 4;                // row stride of the Q and K/V tiles
  constexpr int kCw = D % 64 == 0 ? 4 : 1;      // output columns a thread owns side by side
  constexpr int kCols = D / 16;                 // output columns a thread owns per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (64, D + 4)
  float* kvs = qs + kBQ * kStride;              // (64, D + 4): the K tile, then the V tile
  float* ps = kvs + kBK * kStride;              // (64, 68)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * k_sb + (h / group) * k_sh;
  stage<T, D>(qs, q + b * q_sb + h * q_sh, q_ss, q0, S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  // keys past the tile's last query are masked for every row of it
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with kvs and ps
    stage<T, D>(kvs, kb, k_st, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && ki > qi) x = kMasked;
        s[i][j] = x;
        if (ki < Tk) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        const float p = ki < Tk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= corr;
    }

    __syncthreads();  // every thread is done with the K tile
    stage<T, D>(kvs, vb, k_st, k0, Tk);
    __syncthreads();  // the V tile and the probabilities are in place

    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kvs + (c + cc) * kStride + tx * kCw;
        float vv[kCols];
#pragma unroll
        for (int g = 0; g < kCols / kCw; ++g) {
          if constexpr (kCw == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 64);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          } else {
            vv[g] = vrow[g * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int n = 0; n < kCols; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qi] = m[i] + logf(denom);
    T* orow = o + b * q_sb + qi * q_ss + h * q_sh + tx * kCw;
#pragma unroll
    for (int g = 0; g < kCols / kCw; ++g)
#pragma unroll
      for (int e = 0; e < kCw; ++e)
        Io<T>::store(orow + g * 16 * kCw + e, acc[i][g * kCw + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int KV, const long long* st, int causal,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  // opt in to more than 48 KB of shared memory (on the current device)
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Tk, H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5],
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

// float32 at every head dim; bf16 at D 16 and 32 only (flash_attn_tc.cu
// takes the others)
template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int S, int Tk, int H, int KV, const long long* st, int causal,
                     cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
#define FLASH_FWD_ARGS q, k, v, o, lse, B, S, Tk, H, KV, st, causal, s
  switch (D) {
    case 16: return launch<T, 16>(FLASH_FWD_ARGS);
    case 32: return launch<T, 32>(FLASH_FWD_ARGS);
    case 64:
      if constexpr (kF32) return launch<T, 64>(FLASH_FWD_ARGS);
      break;
    case 112:
      if constexpr (kF32) return launch<T, 112>(FLASH_FWD_ARGS);
      break;
    case 128:
      if constexpr (kF32) return launch<T, 128>(FLASH_FWD_ARGS);
      break;
    case 256:
      if constexpr (kF32) return launch<T, 256>(FLASH_FWD_ARGS);
      break;
  }
#undef FLASH_FWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q/o strides (batch, seq, head) and k/v strides (batch, seq, head) in elements;
// the head dim is contiguous.  dtype: 0 float32, 1 bfloat16 (D 16 or 32).  lse,
// when not null, receives float32 (B, H, S) log-sum-exps.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int S, int T, int H, int KV, int D, int dtype, int causal,
                              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                              long long k_st, long long k_sh, void* stream) {
  const long long st[6] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(D, q, k, v, o, lse, B, S, T, H, KV, st, causal, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, S, T, H, KV, st, causal, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
