// K4: GroupNorm + affine + activation of slabs that fit shared memory, in one
// pass: one read and one write of x.
//
// Replaces the TPU kernel `_single_block_kernel` of
// diffusion_image_editing_tpu/ops/groupnorm.py (one image resident in VMEM,
// E[x^2] - mean^2, channel -> group sums by a group-matrix matmul). Here one
// block owns one (n, g) slab, which NCHW keeps contiguous: it copies the slab
// into shared memory (16-byte loads), takes the mean and then
// mean((x - mean)^2) from there (two passes over shared memory, not over
// device memory), writes the per-(n, g) f32 mean and rstd that the backward
// uses, and writes act((x - mean) * rstd * scale + bias) as bf16.
//
// Bound on the H100: bytes (one read and one write of x). The slab limit,
// kFusedMaxBytes, lets two blocks share an SM; `ops/groupnorm.py` sends
// larger slabs to K5 + K6.

#include "group_norm_common.cuh"

namespace gn {

constexpr int kFusedThreads = 512;
constexpr int kFusedMaxBytes = 96 * 1024;  // ops/groupnorm.py FUSED_MAX_SLAB_BYTES

template <bool VEC>
__global__ void __launch_bounds__(kFusedThreads)
    gn_fused_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
                    const void* __restrict__ bias, int affine_f32, bf16* __restrict__ out,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int HW,
                    int G, float eps, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  __shared__ float red[kFusedThreads / 32];
  const int ng = blockIdx.x, g = ng % G, cg = C / G;
  const int L = cg * HW;
  const size_t base = static_cast<size_t>(ng) * L;
  const bf16* xs = x + base;
  bf16* os = out + base;

  float sum = 0.0f;
  if constexpr (VEC) {
    const uint4* x4 = reinterpret_cast<const uint4*>(xs);
    uint4* s4 = reinterpret_cast<uint4*>(s);
    for (int i = threadIdx.x; i < L / 8; i += kFusedThreads) {
      const uint4 v = x4[i];
      s4[i] = v;
      float f[8];
      unpack8(v, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
  } else {
    for (int i = threadIdx.x; i < L; i += kFusedThreads) {
      const bf16 v = xs[i];
      s[i] = v;
      sum += __bfloat162float(v);
    }
  }
  const float mean = block_sum<kFusedThreads>(sum, red) / L;

  float sq = 0.0f;
  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (int i = threadIdx.x; i < L / 8; i += kFusedThreads) {
      float f[8];
      unpack8(s4[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean;
        sq += d * d;
      }
    }
  } else {
    for (int i = threadIdx.x; i < L; i += kFusedThreads) {
      const float d = __bfloat162float(s[i]) - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum<kFusedThreads>(sq, red) / L + eps);
  if (threadIdx.x == 0) {
    mean_out[ng] = mean;
    rstd_out[ng] = rstd;
  }

  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* o4 = reinterpret_cast<uint4*>(os);
    for (int i = threadIdx.x; i < L / 8; i += kFusedThreads) {
      const int c = g * cg + i * 8 / HW;  // HW % 8 == 0: one channel per vector
      const float a = rstd * load_param(scale, c, affine_f32);
      const float b = load_param(bias, c, affine_f32);
      float f[8];
      unpack8(s4[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = activate((f[j] - mean) * a + b, act);
      o4[i] = pack8(f);
    }
  } else {
    for (int i = threadIdx.x; i < L; i += kFusedThreads) {
      const int c = g * cg + i / HW;
      const float a = rstd * load_param(scale, c, affine_f32);
      const float v = (__bfloat162float(s[i]) - mean) * a + load_param(bias, c, affine_f32);
      os[i] = __float2bfloat16_rn(activate(v, act));
    }
  }
}

template <bool VEC>
cudaError_t launch_fused(const bf16* x, const void* scale, const void* bias, int affine_f32,
                         bf16* out, float* mean, float* rstd, int N, int C, int HW, int G,
                         float eps, int act, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C / G) * HW * sizeof(bf16);
  auto kernel = gn_fused_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFusedMaxBytes);
  if (err != cudaSuccess) return err;
  kernel<<<N * G, kFusedThreads, smem, stream>>>(x, scale, bias, affine_f32, out, mean, rstd, C,
                                                 HW, G, eps, act);
  return cudaGetLastError();
}

}  // namespace gn

// mean and rstd are (N, G) f32 outputs. Returns a cudaError_t.
extern "C" int group_norm_fused(int device, const void* x, const void* scale, const void* bias,
                                int affine_f32, void* out, void* mean, void* rstd, int N, int C,
                                int HW, int G, float eps, int act, void* stream) {
  using namespace gn;
  cudaError_t err = check_gn_shape(N, C, HW, G, act);
  if (err == cudaSuccess && static_cast<long long>(C / G) * HW * 2 > kFusedMaxBytes)
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* xp = static_cast<const bf16*>(x);
  auto* op = static_cast<bf16*>(out);
  auto* mp = static_cast<float*>(mean);
  auto* rp = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  if (HW % 8 == 0)
    return launch_fused<true>(xp, scale, bias, affine_f32, op, mp, rp, N, C, HW, G, eps, act, st);
  return launch_fused<false>(xp, scale, bias, affine_f32, op, mp, rp, N, C, HW, G, eps, act, st);
}
