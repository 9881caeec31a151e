// Shared pieces of the GroupNorm kernels (sm_90a, bf16 in and out, f32 inside).
//
// Layout: x and out are (N, C, H, W) contiguous bf16, the port's NCHW. Group
// (n, g) of G groups is then one contiguous slab of L = C / G * H * W
// elements starting at (n * G + g) * L: the channel -> group reduction that
// the TPU kernels ran as a group-matrix matmul over NHWC is a plain
// reduction over a slab here. Statistics are per (n, g), f32: mean and
// rstd = 1 / sqrt(var + eps) with var = mean((x - mean)^2), the two-pass form
// of `group_norm_reference` (never E[x^2] - mean^2, which cancels for
// large-mean activations).
//
// A thread loads 8 bf16 values (16 bytes) at a time where H * W % 8 == 0
// (VEC): then a vector never straddles two channels, or two slabs. Other
// shapes take the scalar loop of the same kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

using bf16 = __nv_bfloat16;

// Activation codes, as `ops.groupnorm.ACTS` lists them.
enum Act { kNone = 0, kSilu = 1, kRelu = 2, kGelu = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kSilu:  // the fast division: within 2 ulp; 0 once 1 + e^-v passes 2^126,
                 // where SiLU is within 2^-120 of 0
      return __fdividef(v, 1.0f + __expf(-v));
    case kRelu:
      return fmaxf(v, 0.0f);
    case kGelu: {  // the tanh form, jax.nn.gelu's default
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(inner));
    }
    default:
      return v;
  }
}

// Per-channel affine parameters are the model's (bf16) or f32.
__device__ __forceinline__ float load_param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

// Sum over the block in a fixed order (butterfly in each warp, then the
// warps' partials in warp order), so every thread gets the same total and a
// rerun gets the same bits. `red` holds THREADS / 32 floats.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  __syncthreads();  // `red` may be written again by the next call
  return total;
}

// (count, mean, M2 = sum((x - mean)^2)) of some values; M2 is never taken as
// a difference of sums of squares.
struct Moments {
  float n, mean, m2;
};

// The moments of a batch folded into running ones (Chan et al.); a batch
// of none leaves them as they are.
__device__ __forceinline__ Moments fold(Moments a, float nb, float mb, float m2b) {
  if (nb == 0.0f) return a;
  const float n = a.n + nb;
  const float w = nb / n;
  const float d = mb - a.mean;
  return {n, a.mean + d * w, a.m2 + m2b + d * d * a.n * w};
}

inline cudaError_t check_gn_shape(int N, int C, int HW, int G, int act) {
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || act < kNone || act > kGelu ||
      static_cast<long long>(N) * C * HW >= (1LL << 31))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace gn
