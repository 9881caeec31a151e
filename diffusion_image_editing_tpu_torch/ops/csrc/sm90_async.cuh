// Hopper (sm_90) primitives shared by the kernels that use them: the
// mbarrier, the 1-D bulk copy that reports to one, and the thread-block
// cluster's barrier and distributed shared memory.
//
// Users: the attention kernels (through flash_attn_common.cuh), K7
// (affine_silu_conv3x3.cu) and the GroupNorm kernels K4 and K5.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- mbarrier and bulk copy.

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// Until the phase of the given parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// This thread's arrival on `bar`, which is then to wait for `bytes` more.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` contiguous bytes global -> shared by the bulk-copy engine; `bar`
// counts them as they land. dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Makes initialised mbarriers visible to the bulk copies (the async proxy).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// --- Thread-block clusters. Every thread of every block of the cluster
// takes part in each barrier, in arrive / wait pairs.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// An arrival that orders nothing: used at the start of a kernel, so that
// the wait before the first access of another block's shared memory finds
// every block of the cluster started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// Release: this thread's writes (to its own or another block's shared
// memory) are seen by the threads that return from the matching wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Launches `kernel` on a grid of (gx, gy) blocks of `threads`, as clusters of
// (cluster, 1, 1) blocks when cluster > 1 (block x of a cluster has rank
// x % cluster); returns cudaLaunchKernelEx's error.
template <typename... Params, typename... Args>
cudaError_t launch_grid(void (*kernel)(Params...), int cluster, int gx, int gy, int threads,
                        size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launches `kernel` on a grid of (k, rows) blocks of `threads`; with
// `clustered`, as clusters of (k, 1, 1), so that row r's k blocks are one
// cluster and block i of it has rank i.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), bool clustered, int k, int rows,
                             int threads, size_t smem, cudaStream_t stream, Args... args) {
  return launch_grid(kernel, clustered ? k : 1, k, rows, threads, smem, stream, args...);
}

}  // namespace sm90
