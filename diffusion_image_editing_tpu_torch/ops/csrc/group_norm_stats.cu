// K5: GroupNorm statistics, per (n, g) f32 mean and rstd, for slabs of any
// size; one read of x, one launch, no scratch. With `out_m2` the second
// output is the slab's M2 = sum((x - mean)^2) instead of rstd: the moments
// that a GroupNorm whose rows are split over ranks folds across them
// (`ops/split.py::combine_moments`).
//
// Replaces the TPU kernel `_stats_kernel` of
// diffusion_image_editing_tpu/ops/groupnorm.py, which summed x and x^2 per
// channel over spatial tiles in a sequential grid (E[x^2] - mean^2). On the
// H100 a batch-1 GroupNorm has only 32 slabs for 132 SMs, so each slab is
// split over a thread-block cluster of k blocks (k in {1, 2, 4, 8}, chosen
// by the host from the shape: `ops/groupnorm.py::stats_cluster_blocks`),
// one contiguous piece a block (`slab_pieces`: whole 16-byte vectors where
// the slab is a multiple of 8 elements, so every piece starts on a 16-byte
// boundary). A block streams its piece with kStatsUnroll 16-byte loads in
// flight a thread and keeps nothing but a running (count, mean, M2) a
// thread, each batch of loaded values folded in by Chan's formula (M2 =
// sum((x - mean)^2), never E[x^2] - mean^2). The block combines its
// threads' moments in a fixed butterfly, the cluster its blocks' in rank
// order through distributed shared memory: each block stores its moments
// into rank 0's shared memory, and rank 0 folds them and writes mean and
// rstd (k = 1 launches no cluster and takes no cluster barrier, each of
// which costs about half a microsecond). No atomics: a rerun gives the same
// bits.
//
// Bound on the H100: bytes (one read of x).

#include "group_norm_common.cuh"
#include "sm90_async.cuh"

namespace gn {

constexpr int kStatsThreads = 512;
constexpr int kStatsUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kMaxCluster = 8;

// The moments of R * 8 values folded into `a`.
template <int R>
__device__ __forceinline__ Moments fold_values(Moments a, const float (&f)[R][8]) {
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) s += f[r][j];
  const float mb = s * (1.0f / (R * 8));
  float m2b = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[r][j] - mb;
      m2b += d * d;
    }
  return fold(a, static_cast<float>(R * 8), mb, m2b);
}

// merge(a, b) and merge(b, a) give the same bits (no contraction into an
// FMA whose operands would depend on the order), so a butterfly leaves the
// same moments in every lane.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.0f) return a;
  const float d = b.mean - a.mean;
  const float mean = __fdiv_rn(__fadd_rn(__fmul_rn(a.n, a.mean), __fmul_rn(b.n, b.mean)), n);
  const float m2 = __fadd_rn(__fadd_rn(a.m2, b.m2),
                             __fmul_rn(__fmul_rn(d, d), __fdiv_rn(__fmul_rn(a.n, b.n), n)));
  return {n, mean, m2};
}

template <int WIDTH>  // lanes 0 .. WIDTH - 1 of each group of WIDTH
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    const Moments b = {__shfl_xor_sync(0xffffffffu, m.n, o),
                       __shfl_xor_sync(0xffffffffu, m.mean, o),
                       __shfl_xor_sync(0xffffffffu, m.m2, o)};
    m = merge(m, b);
  }
  return m;
}

// grid (k, N * G); with CLUSTER, clusters of (k, 1, 1): block `rank` of
// cluster ng takes piece `rank` of slab ng.
template <bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kStatsThreads)
    gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int L, float eps, int out_m2) {
  __shared__ float4 warp_part[kStatsThreads / 32];
  __shared__ float4 rank_part[kMaxCluster];  // read in rank 0 only
  if constexpr (CLUSTER) sm90::cluster_arrive_relaxed();  // waited on before rank 0's is written

  const int k = static_cast<int>(gridDim.x);
  const int rank = CLUSTER ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int ng = blockIdx.y;
  constexpr int kAtom = VEC ? 8 : 1;  // pieces are whole atoms (slab_pieces)
  const long long atoms = L / kAtom;
  const int a0 = static_cast<int>(rank * atoms / k);
  const int a1 = static_cast<int>((rank + 1) * atoms / k);
  const bf16* xs = x + static_cast<size_t>(ng) * L + static_cast<size_t>(a0) * kAtom;

  Moments m = {0.0f, 0.0f, 0.0f};
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    const int nv = a1 - a0;
    for (int v0 = threadIdx.x; v0 < nv; v0 += kStatsUnroll * kStatsThreads) {
      uint4 raw[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (v0 + u * kStatsThreads < nv) raw[u] = xv[v0 + u * kStatsThreads];
      if (v0 + (kStatsUnroll - 1) * kStatsThreads < nv) {
        float f[kStatsUnroll][8];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) unpack8(raw[u], f[u]);
        m = fold_values(m, f);
      } else {  // the piece's last round
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u)
          if (v0 + u * kStatsThreads < nv) {
            float f[1][8];
            unpack8(raw[u], f[0]);
            m = fold_values(m, f);
          }
      }
    }
  } else {
    const int ne = a1 - a0;
    for (int i = threadIdx.x; i < ne; i += kStatsThreads)
      m = fold(m, 1.0f, __bfloat162float(xs[i]), 0.0f);
  }

  // The block: a butterfly in each warp, then the warps' moments in warp 0.
  m = warp_merge<32>(m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_part[warp] = make_float4(m.n, m.mean, m.m2, 0.0f);
  __syncthreads();
  if (warp == 0) {
    const float4 p = lane < kStatsThreads / 32 ? warp_part[lane] : make_float4(0, 0, 0, 0);
    m = warp_merge<kStatsThreads / 32>(Moments{p.x, p.y, p.z});
  }

  // The cluster: every block's moments into rank 0's shared memory, then
  // rank 0 folds them in rank order.
  if constexpr (CLUSTER) {
    sm90::cluster_wait();  // every block of the cluster has started
    if (threadIdx.x == 0)
      sm90::st_cluster(sm90::map_rank(sm90::smem_addr(&rank_part[rank]), 0),
                       make_float4(m.n, m.mean, m.m2, 0.0f));
    sm90::cluster_arrive();
    sm90::cluster_wait();
    if (rank == 0 && threadIdx.x == 0) {
      m = {0.0f, 0.0f, 0.0f};
      for (int r = 0; r < k; ++r) {
        const float4 p = rank_part[r];
        m = fold(m, p.x, p.y, p.z);
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    mean_out[ng] = m.mean;
    rstd_out[ng] = out_m2 ? m.m2 : rsqrtf(m.m2 / static_cast<float>(L) + eps);
  }
}

template <bool VEC, bool CLUSTER>
cudaError_t launch_stats(const bf16* x, float* mean, float* rstd, int NG, int L, int k, float eps,
                         int out_m2, cudaStream_t stream) {
  return sm90::launch_clustered(gn_stats_kernel<VEC, CLUSTER>, CLUSTER, k, NG, kStatsThreads, 0,
                                stream, x, mean, rstd, L, eps, out_m2);
}

}  // namespace gn

// mean and rstd are (N, G) f32 outputs (rstd is M2 when out_m2 != 0);
// `cluster` blocks split each slab (1, 2, 4 or 8, at most the slab's atoms:
// 16-byte vectors where C / G * HW % 8 == 0, else elements). Returns a
// cudaError_t.
extern "C" int group_norm_stats(int device, const void* x, void* mean, void* rstd, int N, int C,
                                int HW, int G, int cluster, float eps, int out_m2,
                                void* stream) {
  using namespace gn;
  cudaError_t err = check_gn_shape(N, C, HW, G, kNone);
  const int L = C / G * HW, NG = N * G;
  const bool vec = L % 8 == 0;
  if (err == cudaSuccess &&
      (NG > 65535 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
       cluster > (vec ? L / 8 : L)))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* xp = static_cast<const bf16*>(x);
  auto* mp = static_cast<float*>(mean);
  auto* rp = static_cast<float*>(rstd);
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = vec ? (cluster > 1 ? launch_stats<true, true> : launch_stats<true, false>)
                    : (cluster > 1 ? launch_stats<false, true> : launch_stats<false, false>);
  err = launch(xp, mp, rp, NG, L, cluster, eps, out_m2, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
