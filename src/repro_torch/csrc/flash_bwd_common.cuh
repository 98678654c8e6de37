// What both flash backward routes (flash_attn_bwd.cu on the CUDA cores,
// flash_attn_bwd_tc.cu on the tensor cores) share around their kernels.
//  - The row term of the softmax backward, delta = rowsum(P * dP), is summed
//    from the backward's own P and dP (a pass before dK/dV and dQ), not taken
//    as rowsum(dO * O) from the forward's output: where a row's attention is
//    sharp, dP - delta is a small difference, and the error of an O rounded
//    to bf16, or of a P rounded to bf16 before P.V in the forward, swamps it
//    (a gemma-2b train step's query and key projection gradients fell far
//    outside chip_smoke.py's bound against the einsum path that way, and
//    inside it with this delta).  Each (b, h, query row) gets one (lse,
//    delta) pair in a (B*H, S_pad) array, S_pad = S rounded up to 128; rows
//    S..S_pad-1 get (+inf, 0), so a tile of them has P = exp(x - inf) = 0.
//  - bwd_group_sum: with GQA each query head's dK and dV come out of the
//    dK/dV kernel as float32 partials (B, T, H, D); kv head j's gradient is
//    the sum of heads j*G .. j*G+G-1 in that order, rounded once, so two
//    calls give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

// Internal to each source that includes it, so the two routes' libraries
// never share a kernel symbol.
namespace flash_bwd {
namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// out[b, t, j, :] = sum over g of part[b, t, j * G + g, :], for dK
// (blockIdx.y 0) and dV (1); one thread an element.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_group_sum(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv, int T_,
              int H, int KV, int D, int64_t sb, int64_t st, int64_t sh, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n) return;
  const int group = H / KV;
  const int d = static_cast<int>(e % D);
  int64_t rest = e / D;
  const int j = static_cast<int>(rest % KV);
  rest /= KV;
  const int t = static_cast<int>(rest % T_);
  const int64_t b = rest / T_;
  const float* src = part + static_cast<int64_t>(blockIdx.y) * (n * group) +
                     ((b * T_ + t) * H + static_cast<int64_t>(j) * group) * D + d;
  float acc = 0.f;
  for (int g = 0; g < group; ++g) acc += src[static_cast<int64_t>(g) * D];
  T* out = blockIdx.y == 0 ? dk : dv;
  out[b * sb + t * st + j * sh + d] = from_float<T>(acc);
}

// The padded row count of the (lse, delta) array.
inline int stat_rows(int S) { return (S + 127) / 128 * 128; }

// Launch bwd_group_sum into dk and dv (k's strides) from part (2, B, T, H, D).
template <typename T>
cudaError_t launch_group_sum(const float* part, void* dk, void* dv, int B, int T_, int H, int KV,
                             int D, const long long* st, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * T_ * KV * D;
  const dim3 grid(static_cast<unsigned>((n + 255) / 256), 2);
  bwd_group_sum<T><<<grid, 256, 0, stream>>>(part, static_cast<T*>(dk), static_cast<T*>(dv), T_,
                                             H, KV, D, st[3], st[4], st[5], n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_bwd
