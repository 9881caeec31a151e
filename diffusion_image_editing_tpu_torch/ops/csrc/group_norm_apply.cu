// K6: GroupNorm apply, act((x - mean) * rstd * scale + bias) with per-(n, g)
// mean and rstd from K5 and per-channel scale and bias; one read and one
// write of x.
//
// Replaces the TPU kernel `_apply_kernel` of
// diffusion_image_editing_tpu/ops/groupnorm.py, which took the group
// statistics broadcast to channels by the host. Here one elementwise pass:
// a thread takes 8 bf16 values (16 bytes) of one channel where
// H * W % 8 == 0, one value otherwise, and looks up its (n, g) statistics
// and its channel's affine parameters itself.
//
// Bound on the H100: bytes (one read and one write of x).

#include "group_norm_common.cuh"

namespace gn {

constexpr int kApplyThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kApplyThreads)
    gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const void* __restrict__ scale,
                    const void* __restrict__ bias, int affine_f32, bf16* __restrict__ out, int C,
                    int HW, int G, int act, long long total) {
  constexpr int kPer = VEC ? 8 : 1;
  const long long e = (static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x) * kPer;
  if (e >= total) return;
  const int nc = static_cast<int>(e / HW);  // n * C + c
  const int c = nc % C;
  const int ng = nc / C * G + c / (C / G);
  const float m = mean[ng];
  const float a = rstd[ng] * load_param(scale, c, affine_f32);
  const float b = load_param(bias, c, affine_f32);
  if constexpr (VEC) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(x + e), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = activate((f[j] - m) * a + b, act);
    *reinterpret_cast<uint4*>(out + e) = pack8(f);
  } else {
    out[e] = __float2bfloat16_rn(activate((__bfloat162float(x[e]) - m) * a + b, act));
  }
}

}  // namespace gn

// mean and rstd are (N, G) f32 (K5's outputs). Returns a cudaError_t.
extern "C" int group_norm_apply(int device, const void* x, const void* mean, const void* rstd,
                                const void* scale, const void* bias, int affine_f32, void* out,
                                int N, int C, int HW, int G, int act, void* stream) {
  using namespace gn;
  cudaError_t err = check_gn_shape(N, C, HW, G, act);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(N) * C * HW;
  const bool vec = HW % 8 == 0;
  const long long threads = vec ? total / 8 : total;
  const unsigned blocks = static_cast<unsigned>((threads + kApplyThreads - 1) / kApplyThreads);
  auto* xp = static_cast<const bf16*>(x);
  auto* mp = static_cast<const float*>(mean);
  auto* rp = static_cast<const float*>(rstd);
  auto* op = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    gn_apply_kernel<true><<<blocks, kApplyThreads, 0, st>>>(xp, mp, rp, scale, bias, affine_f32,
                                                             op, C, HW, G, act, total);
  else
    gn_apply_kernel<false><<<blocks, kApplyThreads, 0, st>>>(xp, mp, rp, scale, bias, affine_f32,
                                                              op, C, HW, G, act, total);
  return cudaGetLastError();
}
