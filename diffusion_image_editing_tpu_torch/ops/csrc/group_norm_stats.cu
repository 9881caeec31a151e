// K5: GroupNorm statistics, per (n, g) f32 mean and rstd, for slabs of any
// size; one read of x.
//
// Replaces the TPU kernel `_stats_kernel` of
// diffusion_image_editing_tpu/ops/groupnorm.py, which summed x and x^2 per
// channel over spatial tiles in a sequential grid (E[x^2] - mean^2). On the
// H100 blocks run in parallel and in no order, and a batch-1 GroupNorm has
// only 32 slabs for 132 SMs, so each slab is cut into chunks of kChunk
// elements, one block each (the SD VAE's 512 x 512 x 128 stage: 64 chunks a
// slab, 2048 blocks). A block keeps its chunk in registers (16-byte loads)
// and takes the chunk's mean and M2 = sum((x - mean)^2) in two passes over
// them. A second, small kernel combines a slab's chunks in chunk order by
// Chan's formula; no atomics, so the result is the same bits every run.
//
// Bound on the H100: bytes (one read of x).

#include "group_norm_common.cuh"

namespace gn {

constexpr int kStatsThreads = 256;
constexpr int kStatsVecs = 8;                              // 8-value vectors a thread
constexpr int kChunk = kStatsThreads * kStatsVecs * 8;     // 16384 elements, 32 KiB
constexpr int kFinalizeThreads = 128;

template <bool VEC>
__global__ void __launch_bounds__(kStatsThreads)
    gn_partial_kernel(const bf16* __restrict__ x, float2* __restrict__ partial, int L,
                      int chunks) {
  __shared__ float red[kStatsThreads / 32];
  const int chunk = blockIdx.x, ng = blockIdx.y;
  const int start = chunk * kChunk;
  const int n = min(kChunk, L - start);
  const bf16* xs = x + static_cast<size_t>(ng) * L + start;

  float v[kStatsVecs][8];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kStatsVecs; ++k) {
    const int e = (k * kStatsThreads + threadIdx.x) * 8;
    if constexpr (VEC) {  // L % 8 == 0: a vector is wholly inside the chunk or outside it
      if (e < n) {
        unpack8(*reinterpret_cast<const uint4*>(xs + e), v[k]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[k][j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] = e + j < n ? __bfloat162float(xs[e + j]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[k][j];
  }
  const float mean = block_sum<kStatsThreads>(sum, red) / n;

  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kStatsVecs; ++k) {
    const int e = (k * kStatsThreads + threadIdx.x) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = e + j < n ? v[k][j] - mean : 0.0f;
      sq += d * d;
    }
  }
  const float m2 = block_sum<kStatsThreads>(sq, red);
  if (threadIdx.x == 0) partial[static_cast<size_t>(ng) * chunks + chunk] = make_float2(mean, m2);
}

// One thread a slab: (count, mean, M2) of its chunks folded in chunk order.
__global__ void __launch_bounds__(kFinalizeThreads)
    gn_finalize_kernel(const float2* __restrict__ partial, float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int L, int chunks, int NG, float eps) {
  const int ng = blockIdx.x * kFinalizeThreads + threadIdx.x;
  if (ng >= NG) return;
  float na = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const float nb = static_cast<float>(min(kChunk, L - c * kChunk));
    const float2 p = partial[static_cast<size_t>(ng) * chunks + c];
    const float nab = na + nb;
    const float delta = p.x - mean;
    mean += delta * (nb / nab);
    m2 += p.y + delta * delta * (na / nab) * nb;
    na = nab;
  }
  mean_out[ng] = mean;
  rstd_out[ng] = rsqrtf(m2 / static_cast<float>(L) + eps);
}

}  // namespace gn

// `partial` is scratch of at least 2 * N * G * ceil(C / G * HW / 16384)
// floats (`scratch_floats`); mean and rstd are (N, G) f32 outputs. Both
// kernels run on `stream`. Returns a cudaError_t.
extern "C" int group_norm_stats(int device, const void* x, void* partial, long long scratch_floats,
                                void* mean, void* rstd, int N, int C, int HW, int G, float eps,
                                void* stream) {
  using namespace gn;
  cudaError_t err = check_gn_shape(N, C, HW, G, kNone);
  const int L = C / G * HW, NG = N * G;
  const int chunks = (L + kChunk - 1) / kChunk;
  if (err == cudaSuccess && (NG > 65535 || scratch_floats < 2LL * NG * chunks))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* xp = static_cast<const bf16*>(x);
  auto* pp = static_cast<float2*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, NG);
  if (L % 8 == 0)
    gn_partial_kernel<true><<<grid, kStatsThreads, 0, st>>>(xp, pp, L, chunks);
  else
    gn_partial_kernel<false><<<grid, kStatsThreads, 0, st>>>(xp, pp, L, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<(NG + kFinalizeThreads - 1) / kFinalizeThreads, kFinalizeThreads, 0, st>>>(
      pp, static_cast<float*>(mean), static_cast<float*>(rstd), L, chunks, NG, eps);
  return cudaGetLastError();
}
