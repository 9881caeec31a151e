// K4: GroupNorm + affine + activation of slabs that fit shared memory, in one
// pass: one read and one write of x.
//
// Replaces the TPU kernel `_single_block_kernel` of
// diffusion_image_editing_tpu/ops/groupnorm.py (one image resident in VMEM,
// E[x^2] - mean^2, channel -> group sums by a group-matrix matmul). Here a
// thread-block cluster of k blocks owns one (n, g) slab, which NCHW keeps
// contiguous: k in {1, 2, 4, 8}, chosen by the host so that the batch-2
// UNet's 64 slabs still fill the card (`ops/groupnorm.py::
// fused_cluster_blocks`), one contiguous piece a block (`slab_pieces`:
// whole 16-byte vectors of one channel where H * W % 8 == 0). A block
// copies its piece into shared memory with one bulk copy that reports to an
// mbarrier (elements by plain loads on the scalar path) and takes the
// piece's (count, mean, M2 = sum((x - mean)^2)) there in two passes over
// shared memory. Each block stores its moments into every block's shared
// memory (distributed shared memory), and after one cluster barrier every
// block folds the k moments in rank order by Chan's formula, so all hold
// the same bits. Rank 0 writes the per-(n, g) f32 mean and rstd that the
// backward uses; each block writes act((x - mean) * rstd * scale + bias)
// of its piece as bf16. A cluster barrier costs about half a microsecond,
// so there is one blocking barrier a call, and none when k = 1 (then the
// launch has no cluster either).
//
// Bound on the H100: bytes (one read and one write of x). A piece holds at
// most kFusedMaxPieceBytes, so that two blocks share an SM's shared memory;
// the host picks k so that every piece fits, and sends slabs above its
// route limit to K5 + K6 (`ops/groupnorm.py::uses_fused_kernel`).

#include "group_norm_common.cuh"
#include "sm90_async.cuh"

namespace gn {

constexpr int kFusedThreads = 256;
constexpr int kFusedMaxPieceBytes = 96 * 1024;  // ops/groupnorm.py FUSED_MAX_PIECE_BYTES
constexpr int kMaxCluster = 8;

// grid (k, N * G); with CLUSTER, clusters of (k, 1, 1): block `rank` of
// cluster ng takes piece `rank` of slab ng.
template <bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kFusedThreads)
    gn_fused_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
                    const void* __restrict__ bias, int affine_f32, bf16* __restrict__ out,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int HW,
                    int G, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  __shared__ float red[kFusedThreads / 32];
  __shared__ float4 part[kMaxCluster];  // (count, mean, M2) of each block, stored by it
  __shared__ __align__(8) uint64_t landed;
  if constexpr (CLUSTER) sm90::cluster_arrive_relaxed();  // waited on before the stores

  const int k = static_cast<int>(gridDim.x);
  const int rank = CLUSTER ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int ng = blockIdx.y, g = ng % G, cg = C / G;
  const int L = cg * HW;
  constexpr int kAtom = VEC ? 8 : 1;  // pieces are whole atoms (slab_pieces)
  const long long atoms = L / kAtom;
  const int start = static_cast<int>(rank * atoms / k) * kAtom;
  const int n = static_cast<int>((rank + 1) * atoms / k) * kAtom - start;
  const size_t base = static_cast<size_t>(ng) * L + start;

  if constexpr (VEC) {
    if (threadIdx.x == 0) {
      sm90::mbar_init(&landed, 1);
      sm90::fence_mbar_init();
      const uint32_t bytes = static_cast<uint32_t>(n) * sizeof(bf16);
      sm90::expect_bytes(&landed, bytes);
      sm90::bulk_load(s, x + base, bytes, &landed);
    }
    __syncthreads();  // the mbarrier is initialised before anyone waits on it
    sm90::mbar_wait(&landed, 0);
  } else {
    for (int i = threadIdx.x; i < n; i += kFusedThreads) s[i] = x[base + i];
    __syncthreads();
  }

  // The piece's mean, then its M2, from shared memory.
  float sum = 0.0f;
  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (int i = threadIdx.x; i < n / 8; i += kFusedThreads) {
      float f[8];
      unpack8(s4[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kFusedThreads) sum += __bfloat162float(s[i]);
  }
  const float piece_mean = block_sum<kFusedThreads>(sum, red) / n;
  float sq = 0.0f;
  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (int i = threadIdx.x; i < n / 8; i += kFusedThreads) {
      float f[8];
      unpack8(s4[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - piece_mean;
        sq += d * d;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kFusedThreads) {
      const float d = __bfloat162float(s[i]) - piece_mean;
      sq += d * d;
    }
  }
  const float piece_m2 = block_sum<kFusedThreads>(sq, red);

  // The slab's: every block's moments folded in rank order.
  Moments m = {static_cast<float>(n), piece_mean, piece_m2};
  if constexpr (CLUSTER) {
    sm90::cluster_wait();  // every block of the cluster has started
    if (threadIdx.x < k)
      sm90::st_cluster(sm90::map_rank(sm90::smem_addr(&part[rank]), threadIdx.x),
                       make_float4(m.n, m.mean, m.m2, 0.0f));
    sm90::cluster_arrive();
    sm90::cluster_wait();  // after this no block touches another's shared memory
    m = {0.0f, 0.0f, 0.0f};
    for (int r = 0; r < k; ++r) {
      const float4 p = part[r];
      m = fold(m, p.x, p.y, p.z);
    }
  }
  const float mean = m.mean;
  const float rstd = rsqrtf(m.m2 / L + eps);
  if (rank == 0 && threadIdx.x == 0) {
    mean_out[ng] = mean;
    rstd_out[ng] = rstd;
  }

  bf16* os = out + base;
  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* o4 = reinterpret_cast<uint4*>(os);
    for (int i = threadIdx.x; i < n / 8; i += kFusedThreads) {
      const int c = g * cg + (start + i * 8) / HW;  // HW % 8 == 0: one channel per vector
      const float a = rstd * load_param(scale, c, affine_f32);
      const float b = load_param(bias, c, affine_f32);
      float f[8];
      unpack8(s4[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = activate((f[j] - mean) * a + b, act);
      o4[i] = pack8(f);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kFusedThreads) {
      const int c = g * cg + (start + i) / HW;
      const float a = rstd * load_param(scale, c, affine_f32);
      const float v = (__bfloat162float(s[i]) - mean) * a + load_param(bias, c, affine_f32);
      os[i] = __float2bfloat16_rn(activate(v, act));
    }
  }
}

template <bool VEC, bool CLUSTER>
cudaError_t launch_fused(const bf16* x, const void* scale, const void* bias, int affine_f32,
                         bf16* out, float* mean, float* rstd, int N, int C, int HW, int G, int k,
                         float eps, int act, cudaStream_t stream) {
  const long long atoms = static_cast<long long>(C / G) * HW / (VEC ? 8 : 1);
  auto kernel = gn_fused_kernel<VEC, CLUSTER>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFusedMaxPieceBytes);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>((atoms + k - 1) / k) * (VEC ? 8 : 1) * sizeof(bf16);
  err = sm90::launch_clustered(kernel, CLUSTER, k, N * G, kFusedThreads, smem, stream, x, scale,
                               bias, affine_f32, out, mean, rstd, C, HW, G, eps, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gn

// mean and rstd are (N, G) f32 outputs; `cluster` blocks split each slab
// (1, 2, 4 or 8, at most the slab's atoms: 16-byte vectors where
// HW % 8 == 0, else elements; no piece above kFusedMaxPieceBytes). Returns
// a cudaError_t.
extern "C" int group_norm_fused(int device, const void* x, const void* scale, const void* bias,
                                int affine_f32, void* out, void* mean, void* rstd, int N, int C,
                                int HW, int G, int cluster, float eps, int act, void* stream) {
  using namespace gn;
  cudaError_t err = check_gn_shape(N, C, HW, G, act);
  const bool vec = HW % 8 == 0;
  const long long atoms = static_cast<long long>(C / G) * HW / (vec ? 8 : 1);
  if (err == cudaSuccess &&
      (static_cast<long long>(N) * G > 65535 ||
       (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || cluster > atoms ||
       (atoms + cluster - 1) / cluster * (vec ? 16 : 2) > kFusedMaxPieceBytes))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* xp = static_cast<const bf16*>(x);
  auto* op = static_cast<bf16*>(out);
  auto* mp = static_cast<float*>(mean);
  auto* rp = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = vec ? (cluster > 1 ? launch_fused<true, true> : launch_fused<true, false>)
                    : (cluster > 1 ? launch_fused<false, true> : launch_fused<false, false>);
  return launch(xp, scale, bias, affine_f32, op, mp, rp, N, C, HW, G, cluster, eps, act, st);
}
