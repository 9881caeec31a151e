// K3: flash-attention backward, dK and dV.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// diffusion_image_editing_tpu/ops/attention.py. Both designs work in the
// transposed frame, rows = keys, and walk the queries in tiles:
//   P^T  = exp(K Q^T * scale - lse)   (lse per column)
//   dP^T = V dO^T,  dS^T = P^T * (dP^T - delta)
//   dV += P^T dO
//   dK += dS^T Q                      (times scale once, at the end)
// Bound on the H100: tensor-core operations (8 * Sq * Sk * D per head). P^T
// and dS^T go from the accumulators straight into the next products; dK and
// dV stay in registers. The dK/dV rows belong to one block (or one cluster)
// alone: no atomics, a deterministic sum.
//
// * `flash_bwd_dkv_kernel` (FA_NARROW_DIMS: padded head dims up to 160): a
//   block owns 16 * RG key rows, a warp 16 whole rows, and walks the queries
//   in BQ-row tiles, double-buffered by cp.async; mma.sync m16n8k16.
// * `wide::flash_bwd_dkv_wide_kernel` (FA_BWD_DKV_WIDE_SLICES: the VAE's
//   single 512-wide head). Its parent, the narrow design with the head dim
//   cut in four warp slices, streamed all of Q and dO from L2 into every
//   32-key block and summed its split-K partials through shared memory
//   behind three barriers a 16-query tile; it ran at 11 % of the operations
//   bound. dK and dV of 64 keys x 512 columns in f32 would fill a whole
//   register file, so a cluster of two blocks owns 64 keys: rank 0 holds dV
//   and rank 1 dK, of all 512 columns, each warpgroup 256 of them. A split
//   by columns instead (each block half of dK and dV) made every tile's S^T
//   and dP^T a sum over both blocks, and distributed shared memory, which
//   moves about 17 bytes a clock an SM, then bound the kernel; here only
//   rank 0's S^T (8 KiB a 32-query tile) crosses, one way. Q and dO tiles
//   arrive by TMA; the products are wgmma, P^T and dS^T fed from registers,
//   and so is K (or V), the same for every tile, so that each k16 step of
//   S^T (or dP^T) reads only its 1 KiB of Q (or dO) from shared memory.
//   PERF.md records the stages measured on the way.

#include <cooperative_groups.h>

#include "flash_attn_common.cuh"

namespace fa {

template <int DP, int RG, int BQ>
constexpr size_t dkv_smem() {
  return (2 * 16 * RG + 4 * BQ) * (DP + kPadH) * sizeof(bf16);  // K, V, then Q and dO twice
}

template <int DP, int RG, int BQ>
__global__ void __launch_bounds__(32 * RG)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                         int D, float scale) {
  constexpr int LD = DP + kPadH, BK = 16 * RG;
  constexpr int NT_S = BQ / 8, NT_O = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;       // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;  // [2][BQ][LD]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32;
  const int t4 = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;

  load_rows_async<BK, DP, LD>(sK, k, b, h, H, Sk, D, k0);
  load_rows_async<BK, DP, LD>(sV, v, b, h, H, Sk, D, k0);
  load_rows_async<BQ, DP, LD>(sQ, q, b, h, H, Sq, D, 0);
  load_rows_async<BQ, DP, LD>(sdO, dout, b, h, H, Sq, D, 0);
  cp_async_commit();

  float acc_k[NT_O][4], acc_v[NT_O][4];
  zero(acc_k);
  zero(acc_v);
  const bf16* wK = sK + 16 * warp * LD;
  const bf16* wV = sV + 16 * warp * LD;
  const float* lse_bh = lse + static_cast<size_t>(bh) * Sq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * Sq;
  const int n_tiles = (Sq + BQ - 1) / BQ;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {
      load_rows_async<BQ, DP, LD>(sQ + (stage ^ 1) * BQ * LD, q, b, h, H, Sq, D, (i + 1) * BQ);
      load_rows_async<BQ, DP, LD>(sdO + (stage ^ 1) * BQ * LD, dout, b, h, H, Sq, D,
                                  (i + 1) * BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + stage * BQ * LD;
    const bf16* cdO = sdO + stage * BQ * LD;

    // This thread's query columns and their row statistics; columns past Sq
    // get P = 0, so they add nothing to dK or dV.
    const int col0 = i * BQ + 2 * t4;
    float lse2[NT_S][2], dlt[NT_S][2];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + n * 8 + c;
        lse2[n][c] = col < Sq ? lse_bh[col] * kLog2e : INFINITY;
        dlt[n][c] = col < Sq ? delta_bh[col] : 0.0f;
      }
    }

    float st[NT_S][4], dpt[NT_S][4];
    zero(st);
    zero(dpt);
    warp_mma_abt<DP / 16, NT_S>(st, wK, LD, cQ, LD);
    warp_mma_abt<DP / 16, NT_S>(dpt, wV, LD, cdO, LD);
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(st[n][e] * scale_log2 - lse2[n][e & 1]);  // 0 past Sq
        st[n][e] = p;                                  // P^T
        dpt[n][e] = p * (dpt[n][e] - dlt[n][e & 1]);   // dS^T
      }
    }
    warp_mma_pb<BQ / 16, NT_O>(acc_v, st, cdO, LD);
    warp_mma_pb<BQ / 16, NT_O>(acc_k, dpt, cQ, LD);
    __syncthreads();  // this stage is read; the next iteration's prefetch may overwrite it
  }
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.0f, 1.0f};
  store_acc(dk, acc_k, mul_k, b, h, H, Sk, D, k0 + 16 * warp, 0);
  store_acc(dv, acc_v, mul_v, b, h, H, Sk, D, k0 + 16 * warp, 0);
}

template <int DP, int RG, int BQ>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int H,
                       int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<DP, RG, BQ>();
  auto kernel = flash_bwd_dkv_kernel<DP, RG, BQ>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * RG, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, D,
                                          scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide design (FA_BWD_DKV_WIDE_SLICES: the VAE's head dim 512).
// ---------------------------------------------------------------------------

namespace wide {

namespace cg = cooperative_groups;

constexpr int BK = 64;                      // key rows of a cluster: one wgmma M
constexpr int BQ = 32;                      // queries a tile
constexpr int kThreads = 256;               // two warpgroups of 256 columns
constexpr int kStages = 2;                  // slots of each tile ring
constexpr int kBox = BQ * 128;              // one 64-column box of a tile
constexpr int kFullBytes = BK * 512 * 2;    // all columns of K (or V)
constexpr int kTileBytes = 8 * kBox;        // all columns of a Q (or dO) tile
constexpr int kXFloats = BK * BQ;           // one S^T (or dP^T) tile
constexpr uint32_t kXBytes = kXFloats * sizeof(float);
// Floats of a tile's lse (or delta) box: a bulk copy starts at a 16-byte
// boundary, so the box starts at the one at or below the tile's first query.
constexpr int kStatBox = BQ + 4;
constexpr int kStatStride = 64;  // floats between boxes: each starts 128-byte aligned
constexpr size_t kSmem = kFullBytes + 2 * kStages * kTileBytes
                         + 2 * kXBytes                          // the warpgroups' shares
                         + 2 * kXBytes                          // S^T, sent to rank 1
                         + kStages * 2 * 2 * kStatStride * sizeof(float)  // lse and delta
                         + (2 + 2 * 2 * kStages + 2 + 2) * 8;   // mbarriers

// The shared::cluster address of `local` (an address in this block's
// shared memory) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
// One arrival on another block's barrier (a shared::cluster address).
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A 64 x 32 f32 tile lies in shared memory as float4s, thread tid's four
// (its values 4 j .. 4 j + 3) at j * 128 + tid: each warpgroup's threads
// hold the same elements. `put` stores this thread's 16; `add` returns c
// plus the 16 at this thread's places of src; `send` stores float4s
// j0 .. j0 + 1 of this thread's into another block's copy at `dst` (a
// shared::cluster address), counted on that block's barrier `bar` as they
// land.
__device__ __forceinline__ void put(float* dst, int tid, const float (&c)[16]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d4[j * 128 + tid] = make_float4(c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3]);
}
__device__ __forceinline__ void add(float (&out)[16], const float (&c)[16], const float* src,
                                    int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 o = s4[j * 128 + tid];
    out[4 * j] = c[4 * j] + o.x;
    out[4 * j + 1] = c[4 * j + 1] + o.y;
    out[4 * j + 2] = c[4 * j + 2] + o.z;
    out[4 * j + 3] = c[4 * j + 3] + o.w;
  }
}
template <int J0>
__device__ __forceinline__ void send(uint32_t dst, int tid, const float (&c)[16], uint32_t bar) {
#pragma unroll
  for (int j = J0; j < J0 + 2; ++j)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(dst + (j * 128 + tid) * 16),
        "f"(c[4 * j]), "f"(c[4 * j + 1]), "f"(c[4 * j + 2]), "f"(c[4 * j + 3]), "r"(bar)
        : "memory");
}

// One cluster: 64 key rows of head (b, h), all 512 columns. Rank 0 owns dV,
// rank 1 dK, each warpgroup wg the 256 columns from 256 wg (128 registers a
// thread). Rank 0 computes S^T = K Q^T, its warpgroups a 256-column share
// each, summed through shared memory (a + b == b + a: both hold the same
// bits), and P^T = exp(S^T * scale - lse) for dV += P^T dO; it sends S^T to
// rank 1, which computes dP^T = V dO^T the same way, P^T from the S^T it
// received, and dS^T = P^T * (dP^T - delta) for dK += dS^T Q. The blocks
// depend on each other one way only: rank 0 never waits for rank 1 but for
// a free slot to send into, two tiles deep. Each warpgroup's products read
// only its columns of K (or V), Q and dO, so it asks for them itself by
// TMA (four 64-column boxes of each, 128-byte swizzle) behind its own
// mbarriers, into two rings: the share's operand (rank 0: Q, rank 1: dO),
// free once the share is done, and the other (dO or Q) with the tile's lse
// and delta, free once the tile is done; each ring's next tile is asked
// for as soon as a slot frees, a tile ahead of its use. Shared memory: K
// (rank 0) or V (rank 1) [8][BK][64]; the two rings, kStages slots of
// [8][BQ][64] each; the warpgroups' shares [2 wg][kXFloats]; S^T for tiles
// i % 2 [2][kXFloats] (on rank 1, written by rank 0); each warpgroup's lse
// and delta of the second ring's tiles [kStages][2 wg][2][kStatStride]; the
// mbarriers.
//
// The share product's left operand, K or V, is the same for every tile: a
// warpgroup keeps its 64 x 256 in registers as wgmma A fragments (64 a
// thread), so that each k16 step of the share reads only the 1 KiB of its
// B tile from shared memory (with both operands there, the steps read 3
// KiB each and were bound by shared-memory bandwidth).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_lse,
                              const __grid_constant__ CUtensorMap tm_delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq,
                              int Sk, int D, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sA = smem_addr(smem), sR = sA + kFullBytes, sP = sR + kStages * kTileBytes;
  float* sX = reinterpret_cast<float*>(smem + kFullBytes + 2 * kStages * kTileBytes);
  float* sS = sX + 2 * kXFloats;
  float* sStat = sS + 2 * kXFloats;
  // [2 warpgroups]: this warpgroup's columns of K (or V) have landed; then
  // [kStages][2 warpgroups]: its columns of a first-ring tile have; then
  // the same for the second ring, with the tile's lse and delta; then [2
  // slots] (rank 1): S^T of a tile has; then [2 slots] (rank 0): rank 1 has
  // read S^T of a tile.
  uint64_t* full_a = reinterpret_cast<uint64_t*>(sStat + kStages * 2 * 2 * kStatStride);
  uint64_t* full_r = full_a + 2;
  uint64_t* full_p = full_r + 2 * kStages;
  uint64_t* full_s = full_p + 2 * kStages;
  uint64_t* free_s = full_s + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // 0: dV, 1: dK
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x / 2) * BK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, t4 = tid % 4;
  const int col0 = 256 * wg;  // this warpgroup's first column
  const float c = scale * kLog2e;
  const int n_tiles = (Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + 4 * kStages + 2; ++i) mbar_init(&full_a[i], 1);
    for (int i = 0; i < 2; ++i) mbar_init(&free_s[i], 2);  // rank 1's two warpgroups
    if (rank == 1)
      for (int t = 0; t < 2 && t < n_tiles; ++t) expect_bytes(&full_s[t], kXBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Both blocks have started (each signals into the other's shared memory)
  // and the barriers are initialised.
  cluster.sync();

  const uint32_t a_wg = sA + 4 * wg * BK * 128;
  if (tid == 0) {
    expect_bytes(&full_a[wg], 4 * BK * 128);
    for (int j = 0; j < 4; ++j)
      tma_box(a_wg + j * BK * 128, rank == 0 ? tm_k : tm_v, col0 + 64 * j, h, k0, b,
              &full_a[wg]);
  }
  // lse, then delta, of tile t's queries for this warpgroup, with the
  // second ring's slot, each from element (bh Sq + t BQ) rounded down to a
  // multiple of 4.
  auto stat = [&](int t) { return sStat + ((t % kStages) * 2 + wg) * 2 * kStatStride; };
  // This warpgroup's boxes 4 wg .. 4 wg + 3 of tile t in either ring.
  auto r_addr = [&](int t) {
    uint32_t a = sR + (t % kStages) * kTileBytes + 4 * wg * kBox;
    asm volatile("" : "+r"(a));
    return a;
  };
  auto p_addr = [&](int t) {
    uint32_t a = sP + (t % kStages) * kTileBytes + 4 * wg * kBox;
    asm volatile("" : "+r"(a));
    return a;
  };
  const CUtensorMap& tm_r = rank == 0 ? tm_q : tm_do;  // the share's operand
  const CUtensorMap& tm_p = rank == 0 ? tm_do : tm_q;  // the other
  auto load_r = [&](int t) {
    if (tid == 0 && t < n_tiles) {
      uint64_t* bar = &full_r[2 * (t % kStages) + wg];
      expect_bytes(bar, 4 * kBox);
      for (int j = 0; j < 4; ++j)
        tma_box(r_addr(t) + j * kBox, tm_r, col0 + 64 * j, h, t * BQ, b, bar);
    }
  };
  auto load_p = [&](int t) {
    if (tid == 0 && t < n_tiles) {
      const int slot = t % kStages;
      uint64_t* bar = &full_p[2 * slot + wg];
      expect_bytes(bar, 4 * kBox + 2 * kStatBox * 4);
      for (int j = 0; j < 4; ++j)
        tma_box(p_addr(t) + j * kBox, tm_p, col0 + 64 * j, h, t * BQ, b, bar);
      const int x = (bh * Sq + t * BQ) & ~3;
      tma_row(smem_addr(stat(t)), tm_lse, x, bar);
      tma_row(smem_addr(stat(t) + kStatStride), tm_delta, x, bar);
    }
  };
  for (int t = 0; t < kStages; ++t) {
    load_r(t);
    load_p(t);
  }

  float acc[128];  // dV (rank 0) or dK (rank 1) of this warpgroup's columns
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float* x_mine = sX + wg * kXFloats;
  const float* x_other = sX + (1 - wg) * kXFloats;
  const uint32_t s_peer = cluster_addr(smem_addr(sS), 1);
  const uint32_t full_s_peer = cluster_addr(smem_addr(full_s), 1);
  const uint32_t free_s_peer = cluster_addr(smem_addr(free_s), 0);
  mbar_wait(&full_a[wg], 0);

  uint32_t afr[16][4];  // this warp's rows of K (rank 0) or V (rank 1), as A fragments
  load_fragments<BK>(afr, a_wg, warp, tid % 32);

  for (int i = 0; i < n_tiles; ++i) {
    // This block's product over this warpgroup's 256 columns: S^T = K Q^T
    // (rank 0) or dP^T = V dO^T (rank 1). Its operand's slot is then free
    // for tile i + kStages.
    float x[16];
    {
      uint32_t b_t = r_addr(i);
      mbar_wait(&full_r[2 * (i % kStages) + wg], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_rs32(x, afr[kk], desc(b_t + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(x);
    }
    load_r(i + kStages);

    // The block's total: (own + other warpgroup's share), a + b == b + a,
    // so both hold the same bits.
    put(x_mine, tid, x);
    warpgroups_sync();
    add(x, x, x_other, tid);
    warpgroups_sync();  // both have read: the next tile may overwrite x_mine
    const int cs = i & 1;
    mbar_wait(&full_p[2 * (i % kStages) + wg], (i / kStages) & 1);
    const int off = (bh * Sq + i * BQ) & 3;
    const float* lse_t = stat(i) + off;  // delta kStatStride on
    // Two neighbouring floats: one 8-byte load where the offset leaves them aligned.
    auto pair = [&](const float* a) {
      return off & 1 ? make_float2(a[0], a[1]) : *reinterpret_cast<const float2*>(a);
    };
    const float4* s_in = reinterpret_cast<const float4*>(sS + cs * kXFloats);
    if (rank == 0) {
      // Rank 1 has read slot cs two tiles ago; each warpgroup sends half.
      if (i >= 2) mbar_wait(&free_s[cs], ((i >> 1) - 1) & 1);
      if (wg == 0)
        send<0>(s_peer + cs * kXBytes, tid, x, full_s_peer + cs * 8);
      else
        send<2>(s_peer + cs * kXBytes, tid, x, full_s_peer + cs * 8);
    } else {
      mbar_wait(&full_s[cs], (i >> 1) & 1);
      if (threadIdx.x == 0 && i + 2 < n_tiles) expect_bytes(&full_s[cs], kXBytes);
    }
    // P^T (and dS^T) for this thread's query columns 8 j + 2 t4 + e % 2,
    // rounded to bf16 A fragments: the accumulator tile of 8 columns j is
    // half of the A fragment of k16 step j / 2. Columns past Sq get P = 0
    // (their Q and dO rows are zeros, but their lse is another row's).
    uint32_t af[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 8 * j + 2 * t4, col = i * BQ + q;  // 4-byte aligned only
      const float2 l2 = pair(lse_t + q);
      const float lse2[2] = {col < Sq ? l2.x * kLog2e : INFINITY,
                             col + 1 < Sq ? l2.y * kLog2e : INFINITY};
      float a[4];
      if (rank == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = ex2(x[4 * j + e] * c - lse2[e & 1]);
      } else {
        const float2 d2 = pair(lse_t + kStatStride + q);
        const float dlt[2] = {d2.x, d2.y};
        const float4 s4 = s_in[j * 128 + tid];
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = ex2(s[e] * c - lse2[e & 1]) * (x[4 * j + e] - dlt[e & 1]);
      }
      af[j / 2][2 * (j % 2)] = pack_bf16(a[0], a[1]);
      af[j / 2][2 * (j % 2) + 1] = pack_bf16(a[2], a[3]);
    }
    // dV += P^T dO or dK += dS^T Q over this warpgroup's 256 columns.
    const uint32_t other = p_addr(i);
    wgmma_fence();
    wgmma_pv(acc, af[0], desc(other, kBox, 1024));
    wgmma_pv(acc, af[1], desc(other + 16 * 128, kBox, 1024));
    wgmma_commit();
    // Rank 1's warpgroup has read S^T of slot cs (its fragments are built).
    if (rank == 1 && tid == 0) arrive_remote(free_s_peer + cs * 8);
    wgmma_wait<0>();
    fence_operands(acc);
    load_p(i + kStages);
  }

  const float mul[2] = {rank == 0 ? 1.0f : scale, rank == 0 ? 1.0f : scale};
  float (&acc4)[32][4] = *reinterpret_cast<float(*)[32][4]>(acc);
  store_acc(rank == 0 ? dv : dk, acc4, mul, b, h, H, Sk, D, k0 + 16 * warp, col0);
  cluster.sync();  // no signal into the other block is still on its way
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int H,
                   int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  const long long n_stats = static_cast<long long>(B) * H * Sq;
  cudaError_t err = n_stats > INT32_MAX ? cudaErrorInvalidValue : cudaSuccess;
  if (err == cudaSuccess) err = encode_map(&tm_q, q, B, Sq, H, D, BQ);
  if (err == cudaSuccess) err = encode_map(&tm_do, dout, B, Sq, H, D, BQ);
  if (err == cudaSuccess) err = encode_map(&tm_k, k, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = encode_map(&tm_v, v, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = encode_row_map(&tm_lse, lse, n_stats, kStatBox);
  if (err == cudaSuccess) err = encode_row_map(&tm_delta, delta, n_stats, kStatBox);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dkv_wide_kernel, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(2 * ((Sk + BK - 1) / BK), B * H);
  flash_bwd_dkv_wide_kernel<<<grid, kThreads, kSmem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_lse,
                                                               tm_delta, dk, dv, H, Sq, Sk, D,
                                                               scale);
  return cudaGetLastError();
}

}  // namespace wide

}  // namespace fa

// The wide slices (a quarter of the padded head dim) that take
// wide::flash_bwd_dkv_wide_kernel, built for four slices of 128 (512) only;
// it replaced the narrow kernel's four-warp-slice instantiation, which read
// slower at the VAE's shape (PERF.md). ops/attention.py lists the same
// widths.
#define FA_BWD_DKV_WIDE_SLICES(X) X(128)

// Returns a cudaError_t.
extern "C" int flash_attn_bwd_dkv(int device, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                                  float scale, void* stream) {
  using namespace fa;
  cudaError_t err = check_shape(B, H, Sq, Sk, D);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* dop = static_cast<const bf16*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  // Up to 160: one warp per 16 key rows, 4 warps, 32-query tiles. Wider:
  // FA_BWD_DKV_WIDE_SLICES, the warpgroup design.
  switch (round_up(D, 16)) {
#define FA_CASE(DP)                                                                         \
  case DP:                                                                                  \
    return launch_dkv<DP, 4, 32>(qp, kp, vp, dop, lp, dp, dkp, dvp, B, H, Sq, Sk, D, scale, \
                                 st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS) \
  case DS: return wide::launch(qp, kp, vp, dop, lp, dp, dkp, dvp, B, H, Sq, Sk, D, scale, st);
    FA_BWD_DKV_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
