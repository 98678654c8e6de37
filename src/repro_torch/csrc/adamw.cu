// AdamW's update of bf16 or float32 weights with float32 moments, in one
// pass over each leaf, and the global norm's sum of squares, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it.  The port's update ran it leaf by leaf as about 20 PyTorch
// passes over float32 temporaries (optim/adamw.py), some 200 bytes a
// parameter; here each element of g, m, v and p is read once and m, v and p
// are written once, in place.
//
// Bound on this card: bytes.  A bf16 weight with a bf16 gradient reads 12
// bytes and writes 10 (22 B a parameter), and the norm reads the gradient
// once more (2 B): 24 B a parameter, about 83 GB for the 3.45 B parameters
// of the benchmark's train step, 24.7 ms at 3.35 TB/s.  The arithmetic (two
// divisions and a square root an element) stays far below the FP32 rate.
//
// Design.
//   * `adamw_update_leaf<P, G>`, one launch a leaf: a grid-stride loop over
//     groups of 8 elements, read and written with 16-byte vector accesses
//     where all four pointers are 16-byte aligned (any storage offset works:
//     otherwise, and for the tail past the last whole group, element by
//     element).  The step's scalars (the clip scale, the bias corrections,
//     the scheduled step size) are read from 0-d device tensors, so nothing
//     goes to the host.
//   * The arithmetic is the leaf-by-leaf path's, one rounding at a time:
//     every operation is an IEEE `__f*_rn` intrinsic, so nvcc contracts no
//     pair into an FMA, and the constants are PyTorch's (the double 1 - b1
//     cast to float, and so on).  Given the same clip scale the result is
//     the same bits as the PyTorch passes.
//   * `adamw_sqnorm_partial<G>`, one launch a leaf: each block sums the
//     squares of a fixed set of 8-element groups (thread t of block b takes
//     groups t + 256 (b + k gridDim), in order), each square rounded to
//     float32 as `square(g.float())` is and summed in float64; the block's
//     total goes to its slot of a float64 scratch.  `adamw_sqnorm_final`
//     sums the slots in a fixed order and rounds once to float32.  No
//     atomics and no order that depends on timing or on alignment: the same
//     bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements of a group: 16 bytes of bf16
constexpr int kSumUnroll = 4;
constexpr int kFinalThreads = 1024;

using bf16_t = uint16_t;  // storage of a bfloat16

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// round to T as PyTorch's cast on the card does (nearest, ties to even)
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16_t narrow<bf16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 8 elements from (to) a 16-byte aligned address
__device__ __forceinline__ void load8(const float* src, float* x) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16_t* src, float* x) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16_t* dst, const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = static_cast<uint32_t>(narrow<bf16_t>(x[2 * k])) |
           (static_cast<uint32_t>(narrow<bf16_t>(x[2 * k + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The step's scalars.  A null pointer: no clip (scale) or a constant step
// size (step_value).
struct Hyper {
  const float* scale;
  const float* bc1;
  const float* bc2;
  const float* step;
  float step_value;
  float b1, c1, b2, c2, eps, wd;  // c1 = float(1 - b1), c2 = float(1 - b2)
  int decay;                      // weight decay applied (wd != 0)
};

struct Scalars {
  float scale, bc1, bc2, step;
  bool clip;
};

// The clipped gradient, widened: g * scale.to(G) rounded to G, as the leaf
// path's `g * scale.to(g.dtype)`, then `.float()`.
template <typename G>
__device__ __forceinline__ float clipped(float g, const Scalars& s) {
  return s.clip ? widen(narrow<G>(__fmul_rn(g, s.scale))) : g;
}

// One element, in the leaf path's order of operations:
//   m = m*b1 + (1-b1)*g;  v = v*b2 + ((1-b2)*g)*g
//   u = (m/bc1) / (sqrt(v/bc2) + eps) [+ wd*p];  p = p - u*step
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v,
                                           const Hyper& h, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (h.decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(u, s.step));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_update_leaf(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, int64_t n, int vec, Hyper h) {
  Scalars s;
  s.clip = h.scale != nullptr;
  // the scale as the leaf path multiplies by it: rounded to G first
  s.scale = s.clip ? widen(narrow<G>(__ldg(h.scale))) : 1.0f;
  s.bc1 = __ldg(h.bc1);
  s.bc2 = __ldg(h.bc2);
  s.step = h.step != nullptr ? __ldg(h.step) : h.step_value;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / kVec;
    for (int64_t j = first; j < groups; j += stride) {
      const int64_t i = j * kVec;
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + i, pp);
      load8(g + i, gg);
      load8(m + i, mm);
      load8(v + i, vv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        adamw_elem(pp[k], clipped<G>(gg[k], s), mm[k], vv[k], h, s);
      }
      store8(m + i, mm);
      store8(v + i, vv);
      store8(p + i, pp);
    }
    done = groups * kVec;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float pp = widen(p[i]), mm = m[i], vv = v[i];
    adamw_elem(pp, clipped<G>(widen(g[i]), s), mm, vv, h, s);
    m[i] = mm;
    v[i] = vv;
    p[i] = narrow<P>(pp);
  }
}

// float64 sum over a block in a fixed order: shuffles within each warp,
// then the warps' totals in order by thread 0 (valid there only)
template <int Threads>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[Threads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < Threads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// the squares of group j's elements, in order, into acc (past n: nothing)
template <typename G>
__device__ __forceinline__ void add_squares(const G* g, int64_t n, int64_t j, int vec,
                                            float* x) {
  const int64_t i = j * kVec;
  if (vec && i + kVec <= n) {
    load8(g + i, x);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) x[k] = i + k < n ? widen(g[i + k]) : 0.0f;
  }
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_sqnorm_partial(const G* __restrict__ g, int64_t n, double* __restrict__ out, int vec) {
  const int64_t groups = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j0 < groups;
       j0 += kSumUnroll * stride) {
    // kSumUnroll groups in flight, summed in the order of a plain loop
    float x[kSumUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      const int64_t j = j0 + u * stride;
      if (j < groups) {
        add_squares(g, n, j, vec, x[u]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) x[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc += static_cast<double>(__fmul_rn(x[u][k], x[u][k]));
    }
  }
  const double total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
adamw_sqnorm_final(const double* __restrict__ partials, int64_t count, float* __restrict__ out) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < count; i += kFinalThreads) acc += partials[i];
  const double total = block_sum<kFinalThreads>(acc);
  if (threadIdx.x == 0) out[0] = static_cast<float>(total);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// enough blocks for one group a thread, at most 8 an SM (the grid strides)
int update_blocks(int64_t n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / kVec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename P, typename G>
void launch_update(void* p, const void* g, float* m, float* v, int64_t n, const Hyper& h,
                   cudaStream_t stream) {
  const int vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  adamw_update_leaf<P, G><<<update_blocks(n), kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, n, vec, h);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16

// Σ g² over n leaves: grads[i] (numels[i] elements of dtypes[i]) summed by
// blocks[i] blocks (0 for an empty leaf) into consecutive slots of
// `partials` (float64, Σ blocks), then their total, rounded to float32,
// into out[0].
extern "C" int adamw_sqnorm(const int64_t* grads, const int64_t* numels, const int32_t* dtypes,
                            const int32_t* blocks, int n, double* partials, float* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t slot = 0;
  for (int i = 0; i < n; ++i) {
    if (blocks[i] == 0) continue;
    const void* g = reinterpret_cast<const void*>(grads[i]);
    const int vec = aligned16(g);
    if (dtypes[i] == 1) {
      adamw_sqnorm_partial<bf16_t><<<blocks[i], kThreads, 0, s>>>(
          static_cast<const bf16_t*>(g), numels[i], partials + slot, vec);
    } else {
      adamw_sqnorm_partial<float><<<blocks[i], kThreads, 0, s>>>(
          static_cast<const float*>(g), numels[i], partials + slot, vec);
    }
    slot += blocks[i];
  }
  adamw_sqnorm_final<<<1, kFinalThreads, 0, s>>>(partials, slot, out);
  return static_cast<int>(cudaGetLastError());
}

// One launch a leaf over n leaves: params[i] (p_dtypes[i]), grads[i]
// (g_dtypes[i]), float32 m[i] and v[i], numels[i] elements each, updated in
// place.  scale (null: no clip), bc1, bc2 and step (null: step_value) are
// 0-d float32 device tensors.
extern "C" int adamw_update(const int64_t* params, const int64_t* grads, const int64_t* ms,
                            const int64_t* vs, const int64_t* numels, const int32_t* p_dtypes,
                            const int32_t* g_dtypes, int n, const float* scale,
                            const float* bc1, const float* bc2, const float* step,
                            float step_value, float b1, float c1, float b2, float c2, float eps,
                            float wd, int decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{scale, bc1, bc2, step, step_value, b1, c1, b2, c2, eps, wd, decay};
  for (int i = 0; i < n; ++i) {
    if (numels[i] == 0) continue;
    void* p = reinterpret_cast<void*>(params[i]);
    const void* g = reinterpret_cast<const void*>(grads[i]);
    float* m = reinterpret_cast<float*>(ms[i]);
    float* v = reinterpret_cast<float*>(vs[i]);
    const int code = 2 * p_dtypes[i] + g_dtypes[i];
    if (code == 3) {
      launch_update<bf16_t, bf16_t>(p, g, m, v, numels[i], h, s);
    } else if (code == 2) {
      launch_update<bf16_t, float>(p, g, m, v, numels[i], h, s);
    } else if (code == 1) {
      launch_update<float, bf16_t>(p, g, m, v, numels[i], h, s);
    } else {
      launch_update<float, float>(p, g, m, v, numels[i], h, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
