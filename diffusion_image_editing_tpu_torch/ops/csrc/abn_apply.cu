// K8: activated batch norm apply, y = act((x - mean) * rstd * |w| + b) per
// channel of an (N, C, H, W) tensor, in f32 and cast to x's type.
//
// Replaces the TPU kernel `_abn_apply_kernel` of
// diffusion_image_editing_tpu/ops/abn.py, which took (tile, C) blocks of the
// NHWC (M, C) matrix and ran only where C % 128 == 0 (the TPU's lanes). In
// NCHW each (n, c) plane of H * W elements is contiguous and has one set of
// channel scalars, so K8 takes every shape:
//
// * A block owns a run of one plane: it reads the channel's mean, rstd,
//   |w| and b once, then every thread streams 16-byte vectors (4 f32 or
//   8 bf16) of the plane, up to kUnroll of them, all loads issued before the
//   first store. Planes too long for one block are cut into chunks, one
//   block each, so the stem's 1024 planes of 50176 f32 run 13312 blocks; a
//   short plane takes a block of as few threads as it has vectors (32 at
//   least), so 2048 planes of 1 element still spread over every SM.
// * A plane whose length is no multiple of the vector, or a tensor that is
//   not 16-byte aligned, takes the same kernel with one element per unit.
// * The arithmetic is JAX's, in its order and rounded at each step
//   (__fsub_rn and friends, so nvcc contracts nothing into an FMA): the
//   plain torch version then gives the same f32 bits for identity and
//   leaky_relu. ELU uses expm1f, as jnp.expm1.
//
// Bound on the H100: bytes (x read once, y written once); about 10 f32
// operations an element are far below the compute rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace abn {

using bf16 = __nv_bfloat16;

// Activation codes, as `ops.abn.ACTS` lists them.
enum Act { kIdentity = 0, kLeakyRelu = 1, kElu = 2 };

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;

template <int ACT>
__device__ __forceinline__ float apply(float x, float m, float r, float w, float b, float slope) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), r), w), b);
  if (ACT == kLeakyRelu) return y >= 0.0f ? y : __fmul_rn(y, slope);
  if (ACT == kElu) return y >= 0.0f ? y : expm1f(y);
  return y;
}

// One unit of a plane: 16 bytes (VEC) or one element, unpacked to f32.
template <typename T, bool VEC>
struct Unit;

template <>
struct Unit<float, true> {
  using Raw = float4;
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const Raw& v, float (&f)[kN]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[kN]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Unit<bf16, true> {
  using Raw = uint4;
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const Raw& v, float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[kN]) {
    Raw v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return v;
  }
};

template <>
struct Unit<float, false> {
  using Raw = float;
  static constexpr int kN = 1;
  static __device__ __forceinline__ void unpack(const Raw& v, float (&f)[kN]) { f[0] = v; }
  static __device__ __forceinline__ Raw pack(const float (&f)[kN]) { return f[0]; }
};

template <>
struct Unit<bf16, false> {
  using Raw = bf16;
  static constexpr int kN = 1;
  static __device__ __forceinline__ void unpack(const Raw& v, float (&f)[kN]) {
    f[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[kN]) {
    return __float2bfloat16_rn(f[0]);
  }
};

// Grid: planes * chunks blocks; block b takes plane b / chunks (= n * C + c)
// and its units [chunk * blockDim.x * kUnroll, ...).
template <typename T, bool VEC, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
    abn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ rstd, const float* __restrict__ weight,
                     const float* __restrict__ bias, T* __restrict__ out, int C,
                     int units_per_plane, int chunks, float slope) {
  using U = Unit<T, VEC>;
  using Raw = typename U::Raw;
  const int plane = blockIdx.x / chunks;
  const int chunk = blockIdx.x - plane * chunks;
  const int c = plane % C;
  const float m = mean[c];
  const float r = rstd[c];
  const float w = fabsf(weight[c]);
  const float b = bias[c];
  const Raw* src = reinterpret_cast<const Raw*>(x) + static_cast<long long>(plane) * units_per_plane;
  Raw* dst = reinterpret_cast<Raw*>(out) + static_cast<long long>(plane) * units_per_plane;
  const int begin = chunk * blockDim.x * kUnroll + threadIdx.x;

  Raw v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int i = begin + k * blockDim.x;
    if (i < units_per_plane) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int i = begin + k * blockDim.x;
    if (i < units_per_plane) {
      float f[U::kN];
      U::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < U::kN; ++j) f[j] = apply<ACT>(f[j], m, r, w, b, slope);
      dst[i] = U::pack(f);
    }
  }
}

template <typename T, bool VEC, int ACT>
cudaError_t launch_typed(const void* x, const float* mean, const float* rstd, const float* weight,
                         const float* bias, void* out, int planes, int C, int HW, float slope,
                         cudaStream_t stream) {
  const int units = HW / Unit<T, VEC>::kN;
  // As many threads as the plane has units, rounded up to a warp, at most 256.
  const int threads = units >= kMaxThreads ? kMaxThreads : ((units + 31) / 32) * 32;
  const int chunks = (units + threads * kUnroll - 1) / (threads * kUnroll);
  const long long blocks = static_cast<long long>(planes) * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  abn_apply_kernel<T, VEC, ACT><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, weight, bias, static_cast<T*>(out), C, units, chunks,
      slope);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_act(const void* x, const float* mean, const float* rstd, const float* weight,
                       const float* bias, void* out, int planes, int C, int HW, float slope,
                       cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (aligned && HW % Unit<T, true>::kN == 0)
    return launch_typed<T, true, ACT>(x, mean, rstd, weight, bias, out, planes, C, HW, slope,
                                      stream);
  return launch_typed<T, false, ACT>(x, mean, rstd, weight, bias, out, planes, C, HW, slope,
                                     stream);
}

template <typename T>
cudaError_t launch(const void* x, const float* mean, const float* rstd, const float* weight,
                   const float* bias, void* out, int planes, int C, int HW, int act, float slope,
                   cudaStream_t stream) {
  switch (act) {
    case kLeakyRelu:
      return launch_act<T, kLeakyRelu>(x, mean, rstd, weight, bias, out, planes, C, HW, slope,
                                       stream);
    case kElu:
      return launch_act<T, kElu>(x, mean, rstd, weight, bias, out, planes, C, HW, slope, stream);
    default:
      return launch_act<T, kIdentity>(x, mean, rstd, weight, bias, out, planes, C, HW, slope,
                                      stream);
  }
}

}  // namespace abn

// x and out: (N, C, HW) contiguous, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// mean, rstd, weight, bias: (C,) f32. Returns a cudaError_t.
extern "C" int abn_apply(int device, const void* x, int x_bf16, const void* mean,
                         const void* rstd, const void* weight, const void* bias, void* out, int N,
                         int C, int HW, int act, float slope, void* stream) {
  using namespace abn;
  if (N < 1 || C < 1 || HW < 1 || act < kIdentity || act > kElu ||
      static_cast<long long>(N) * C * HW >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* mp = static_cast<const float*>(mean);
  auto* rp = static_cast<const float*>(rstd);
  auto* wp = static_cast<const float*>(weight);
  auto* bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch<bf16>(x, mp, rp, wp, bp, out, N * C, C, HW, act, slope, st);
  return launch<float>(x, mp, rp, wp, bp, out, N * C, C, HW, act, slope, st);
}
