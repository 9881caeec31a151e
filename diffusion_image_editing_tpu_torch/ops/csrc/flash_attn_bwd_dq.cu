// K2: flash-attention backward, dQ.
//
// Replaces the TPU kernel `_bwd_dq_kernel` of
// diffusion_image_editing_tpu/ops/attention.py. A block owns query rows of
// one (batch, head) and walks the keys in tiles, recomputing the
// probabilities from the forward's log-sum-exp instead of storing them:
//   P  = exp(S * scale - lse)        S  = Q K^T
//   dP = dO V^T
//   dS = P * (dP - delta)            delta = rowsum(dO * O), given
//   dQ += dS K                       (times scale once, at the end)
// Bound on the H100: tensor-core operations (6 * Sq * Sk * D per head). dS
// goes from the accumulators straight into the dS K product; dQ stays in
// registers. The dQ rows belong to one block (or one cluster) alone: no
// atomics, a deterministic sum.
//
// * `flash_bwd_dq_kernel` (FA_NARROW_DIMS: padded head dims up to 160): a
//   block owns 16 * RG query rows, a warp 16 whole rows, and walks the keys
//   in BK-row tiles, double-buffered by cp.async; mma.sync m16n8k16.
// * `wide::flash_bwd_dq_wide_kernel` (FA_BWD_DQ_WIDE_SLICES: the VAE's
//   single 512-wide head). Its parent, the narrow design with the head dim
//   cut in four warp slices, streamed all of K and V from L2 into every
//   32-row block (1 GiB a call at 4096 tokens) and summed every 16-key
//   tile's S and dP split-K through shared memory behind two barriers; it
//   ran at 10 % of the operations bound. Here a block owns 64 query rows
//   (one wgmma M) and the keys are split over a cluster of two blocks,
//   whose dQ partials are added through distributed shared memory at the
//   end. Two warpgroups each own 256 of the 512 columns and hold that
//   slice of dQ (128 registers a thread); each computes its share of S and
//   of dP over its columns by wgmma (m64n32k16). Once a 32-key tile the
//   shares meet in shared memory: each warpgroup finishes half of the
//   tile's dS and the two swap their halves as bf16 wgmma A fragments; dQ
//   += dS K is wgmma m64n256k16 with dS from registers and K read
//   transposed. Q, the same for every tile, is held in registers as wgmma
//   A fragments (64 a thread), so that each step of S reads only its 1 KiB
//   of K from shared memory; dO, K and V arrive by TMA in the 128-byte
//   swizzle, each warpgroup asking for its own column half, K and V
//   through one ring of four slots. What binds it (PERF.md, which records
//   the stages measured on the way): shared-memory bandwidth (dP's steps
//   read dO from there, 3 KiB each), the K/V loads from L2 (each block
//   reads half of K and V) and the exchange; the registers are full (254),
//   so no product can stay in flight across the exchange.

#include <cooperative_groups.h>

#include "flash_attn_common.cuh"

namespace fa {

template <int DP, int RG, int BK>
constexpr size_t dq_smem() {
  return (2 * 16 * RG + 4 * BK) * (DP + kPadH) * sizeof(bf16);  // Q, dO, then K and V twice
}

template <int DP, int RG, int BK>
__global__ void __launch_bounds__(32 * RG)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Sq, int Sk, int D, float scale) {
  constexpr int LD = DP + kPadH, BQ = 16 * RG;
  constexpr int NT_S = BK / 8, NT_O = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;     // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;

  load_rows_async<BQ, DP, LD>(sQ, q, b, h, H, Sq, D, q0);
  load_rows_async<BQ, DP, LD>(sdO, dout, b, h, H, Sq, D, q0);
  load_rows_async<BK, DP, LD>(sK, k, b, h, H, Sk, D, 0);
  load_rows_async<BK, DP, LD>(sV, v, b, h, H, Sk, D, 0);
  cp_async_commit();

  // Rows past Sq have Q = dO = 0, hence dP = 0 and, with delta 0, dS = 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    const bool valid = row < Sq;
    lse2[r] = valid ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : 0.0f;
    dlt[r] = valid ? delta[static_cast<size_t>(bh) * Sq + row] : 0.0f;
  }

  float acc[NT_O][4];
  zero(acc);
  const bf16* wQ = sQ + 16 * warp * LD;
  const bf16* wdO = sdO + 16 * warp * LD;
  const int n_tiles = (Sk + BK - 1) / BK;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_rows_async<BK, DP, LD>(sK + (stage ^ 1) * BK * LD, k, b, h, H, Sk, D, (j + 1) * BK);
      load_rows_async<BK, DP, LD>(sV + (stage ^ 1) * BK * LD, v, b, h, H, Sk, D, (j + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * BK * LD;
    const bf16* cV = sV + stage * BK * LD;

    float s[NT_S][4], dp[NT_S][4];
    zero(s);
    zero(dp);
    warp_mma_abt<DP / 16, NT_S>(s, wQ, LD, cK, LD);
    warp_mma_abt<DP / 16, NT_S>(dp, wdO, LD, cV, LD);

    const int key0 = j * BK + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (key0 + n * 8 + (e & 1) < Sk) ? exp2f(s[n][e] * scale_log2 - lse2[e / 2]) : 0.0f;
        s[n][e] = p * (dp[n][e] - dlt[e / 2]);  // dS
      }
    }
    warp_mma_pb<BK / 16, NT_O>(acc, s, cK, LD);
    __syncthreads();  // this stage is read; the next iteration's prefetch may overwrite it
  }
  const float mul[2] = {scale, scale};
  store_acc(dq, acc, mul, b, h, H, Sq, D, q0 + 16 * warp, 0);
}

template <int DP, int RG, int BK>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, bf16* dq, int B, int H, int Sq,
                      int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<DP, RG, BK>();
  auto kernel = flash_bwd_dq_kernel<DP, RG, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * RG, smem, stream>>>(q, k, v, dout, lse, delta, dq, H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide design (FA_BWD_DQ_WIDE_SLICES: the VAE's head dim 512).
// ---------------------------------------------------------------------------

namespace wide {

namespace cg = cooperative_groups;

constexpr int BM = 64;                  // query rows a block: one wgmma M
constexpr int BK = 32;                  // keys a tile
constexpr int kThreads = 256;           // two warpgroups of 256 columns
constexpr int kHalf = 4 * BM * 128;     // a warpgroup's 256 columns of Q or dO
constexpr int kHalfTile = 4 * BK * 128;  // its 256 columns of a K or V tile
constexpr int kShareBytes = 2 * 4 * 128 * 16;  // shares of half a tile: [2 wg][S, S, dP, dP][128]
constexpr int kFragBytes = 2 * 128 * 16;       // half a tile's dS fragments: [2 wg][128]
constexpr size_t kSmem = 2 * kHalf                 // dO
                         + 2 * 4 * kHalfTile       // the K/V rings: 2 warpgroups x 4 slots
                         + kShareBytes + kFragBytes
                         + 12 * 8;                 // mbarriers

// One tile's dS from the two warpgroups' shares of S and dP, each
// warpgroup finishing half of it: warpgroup W the accumulator tiles 2 W
// and 2 W + 1 (keys 8 j + 2 t4 + e % 2 of tile j; together k16 step W of
// the dQ product). A thread's 16 values sit at the same places of both
// warpgroups' accumulators, so thread tid of one warpgroup pairs with
// thread tid of the other. Each stores the other's half of its shares
// (four float4s a thread, float4 (W, n) at (4 W + n) * 128 + tid of x),
// reads the other's shares of its own half, adds them (own + other, one
// sum: a + b == b + a), takes P and dS, rounds them to its bf16 A
// fragment, and the two swap fragments (one uint4 a thread, after the
// shares). Keys past Sk (the ragged tile; their K rows are zeros) get dS
// = 0: their P may overflow, and inf * 0 is NaN. Each of the two barriers
// also tells a warpgroup that the other has read what it stored before
// the last one, so none is needed before the next tile's stores. (Both
// warpgroups finishing all of dS moved 32 KiB of shares a tile, not 20,
// and took 16 exponentials a thread, not 8: 6 % slower, PERF.md.)
template <int W>
__device__ __forceinline__ void ds_exchange(uint32_t (&af)[2][4], const float (&s)[16],
                                            const float (&dp)[16], float* x, int tid,
                                            const float (&lse2)[2], const float (&dlt)[2], float c,
                                            int key0, bool ragged, int Sk) {
  float4* shares = reinterpret_cast<float4*>(x);
  uint4* frags = reinterpret_cast<uint4*>(x + kShareBytes / 4);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = 2 * (1 - W) + jj;
    shares[(W * 4 + jj) * 128 + tid] =
        make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    shares[(W * 4 + 2 + jj) * 128 + tid] =
        make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]);
  }
  warpgroups_sync();
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = 2 * W + jj;
    const float4 os = shares[((1 - W) * 4 + jj) * 128 + tid];
    const float4 od = shares[((1 - W) * 4 + 2 + jj) * 128 + tid];
    const float osv[4] = {os.x, os.y, os.z, os.w}, odv[4] = {od.x, od.y, od.z, od.w};
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2((s[4 * j + e] + osv[e]) * c - lse2[e / 2]);
      a[e] = p * ((dp[4 * j + e] + odv[e]) - dlt[e / 2]);
      if (ragged && key0 + 8 * j + (e & 1) >= Sk) a[e] = 0.0f;
    }
    af[W][2 * jj] = pack_bf16(a[0], a[1]);
    af[W][2 * jj + 1] = pack_bf16(a[2], a[3]);
  }
  frags[W * 128 + tid] = make_uint4(af[W][0], af[W][1], af[W][2], af[W][3]);
  warpgroups_sync();
  const uint4 o = frags[(1 - W) * 128 + tid];
  af[1 - W][0] = o.x;
  af[1 - W][1] = o.y;
  af[1 - W][2] = o.z;
  af[1 - W][3] = o.w;
}

// One block: BM query rows of head (b, h), half of the key tiles (cluster
// rank 0 the first half, 1 the rest). Warpgroup wg owns columns [256 wg,
// 256 wg + 256) and reads only those of Q, dO, K and V, so it asks for
// them itself (four 64-column boxes each), behind its own mbarriers, and
// never waits for the other warpgroup but at the exchange of the shares.
// Shared memory: dO [2 wg][4][BM][64]; a ring of K and V tiles [2 wg][4
// slots][4][BK][64], all in the 128-byte swizzle; the exchange of
// `ds_exchange`; the mbarriers. The slots of a warpgroup's ring swap roles
// every two tiles: tile i + 2's K goes into tile i's V slot as soon as dP
// is done with it, and its V into tile i's K slot once the dQ product is,
// so that each is asked for about one and a half tiles ahead of its use
// (a K slot kept for K waits for the dQ product; 5 % slower, PERF.md). Q
// arrives first in the slots of the first two V tiles (its 32 KiB are
// theirs exactly) and goes from there into registers.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sdO = smem_addr(smem), sRing = sdO + 2 * kHalf;
  float* sX = reinterpret_cast<float*>(smem + 2 * kHalf + 8 * kHalfTile);
  // [2 wg]: Q has landed, then dO; [2 wg][4 slots]: a K or V tile.
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + 2 * kHalf + 8 * kHalfTile + kShareBytes +
                                                 kFragBytes);
  uint64_t* full_do = full_q + 2;
  uint64_t* full = full_q + 4;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // which half of the keys
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x / 2) * BM;
  const int n_all = (Sk + BK - 1) / BK, n_first = (n_all + 1) / 2;
  const int tile0 = rank == 0 ? 0 : n_first;
  const int n_tiles = rank == 0 ? n_first : n_all - n_first;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int col0 = 256 * wg;  // this warpgroup's first column
  const float c = scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 12; ++i) mbar_init(&full_q[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t do_wg = sdO + wg * kHalf;
  const uint32_t ring = sRing + wg * 4 * kHalfTile;  // this warpgroup's four slots
  // The slots of tile t's K and V; Q's staging: slots 2 and 3, V's first.
  auto ks = [](int t) { return (t & 1) + 2 * ((t >> 1) & 1); };
  auto vs = [](int t) { return (t & 1) + 2 * (1 - ((t >> 1) & 1)); };
  const uint32_t q_stage = ring + 2 * kHalfTile;
  // This warpgroup's four boxes of `rows` rows from row0 into dst; one
  // thread asks, the barrier flips when the bytes land.
  auto load_half = [&](uint32_t dst, const CUtensorMap& map, int rows, int row0, uint64_t* bar) {
    expect_bytes(bar, 4 * rows * 128);
#pragma unroll
    for (int j = 0; j < 4; ++j) tma_box(dst + j * rows * 128, map, col0 + 64 * j, h, row0, b, bar);
  };
  auto load_k = [&](int t) {
    if (tid == 0)
      load_half(ring + ks(t) * kHalfTile, tm_k, BK, (tile0 + t) * BK, &full[4 * wg + ks(t)]);
  };
  auto load_v = [&](int t) {
    if (tid == 0)
      load_half(ring + vs(t) * kHalfTile, tm_v, BK, (tile0 + t) * BK, &full[4 * wg + vs(t)]);
  };
  if (tid == 0) {
    load_half(q_stage, tm_q, BM, q0, &full_q[wg]);
    load_half(do_wg, tm_do, BM, q0, &full_do[wg]);
  }
  for (int t = 0; t < 2 && t < n_tiles; ++t) load_k(t);

  // Rows g and g + 8 of this warp's 16. Rows past Sq have Q = dO = 0 (the
  // boxes read zeros there), hence S = dP = 0 and, with delta 0, dS = 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    const bool valid = row < Sq;
    lse2[r] = valid ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : 0.0f;
    dlt[r] = valid ? delta[static_cast<size_t>(bh) * Sq + row] : 0.0f;
  }

  uint32_t qf[16][4];  // this warp's rows of Q, this warpgroup's columns, as A fragments
  mbar_wait(&full_q[wg], 0);
  load_fragments<BM>(qf, q_stage, warp, lane);
  // Every thread of the warpgroup has read its fragments out of the
  // staging slots before the first V tiles are asked for into them.
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  if (tid == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int t = 0; t < 2 && t < n_tiles; ++t) load_v(t);
  mbar_wait(&full_do[wg], 0);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  // Addresses made anew each tile: hoisted out of the loop, the
  // descriptors would hold registers the products need.
  auto k_addr = [&](int i) {
    uint32_t a = ring + ks(i) * kHalfTile;
    asm volatile("" : "+r"(a));
    return a;
  };
  auto v_addr = [&](int i) {
    uint32_t a = ring + vs(i) * kHalfTile;
    asm volatile("" : "+r"(a));
    return a;
  };

  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t parity = (i >> 1) & 1;  // each slot takes a tile every two
    // This warpgroup's shares of S = Q K^T (Q from registers) and dP = dO
    // V^T over its 256 columns; the first k16 step of each overwrites.
    float s[16], dp[16];
    mbar_wait(&full[4 * wg + ks(i)], parity);
    const uint32_t ka = k_addr(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_rs32(s, qf[kk], desc(ka + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    mbar_wait(&full[4 * wg + vs(i)], parity);
    const uint32_t va = v_addr(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_s(dp, desc(do_wg + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024),
              desc(va + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    if (i + 2 < n_tiles) load_k(i + 2);  // into this V slot, which is read

    const int key0 = (tile0 + i) * BK + 2 * t4;
    const bool ragged = (tile0 + i + 1) * BK > Sk;
    uint32_t af[2][4];
    if (wg == 0)
      ds_exchange<0>(af, s, dp, sX, tid, lse2, dlt, c, key0, ragged, Sk);
    else
      ds_exchange<1>(af, s, dp, sX, tid, lse2, dlt, c, key0, ragged, Sk);
    // dQ += dS K over this warpgroup's 256 columns, K read transposed.
    wgmma_fence();
    wgmma_pv(acc, af[0], desc(ka, BK * 128, 1024));
    wgmma_pv(acc, af[1], desc(ka + 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (i + 2 < n_tiles) load_v(i + 2);  // into this K slot, which is read
  }

  // The two halves of the keys meet. Warpgroup `rank` of each block
  // finishes its columns with the other block's sums for them; the other
  // warpgroup leaves its sums in shared memory, over dO, for the other
  // block. Both warpgroups are past their last read of dO, and its boxes
  // have landed.
  warpgroups_sync();
  float4* dump = reinterpret_cast<float4*>(smem);
  const bool finish = wg == rank;
  if (!finish) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      dump[j * 128 + tid] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
  cluster.sync();
  if (finish) {
    const float4* peer = cluster.map_shared_rank(dump, rank ^ 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 x = peer[j * 128 + tid];
      acc[4 * j] += x.x;  // a + b == b + a: one sum whichever rank finishes
      acc[4 * j + 1] += x.y;
      acc[4 * j + 2] += x.z;
      acc[4 * j + 3] += x.w;
    }
    const float mul[2] = {scale, scale};
    float (&acc4)[32][4] = *reinterpret_cast<float(*)[32][4]>(acc);
    store_acc(dq, acc4, mul, b, h, H, Sq, D, q0 + 16 * warp, col0);
  }
  cluster.sync();  // the other block has read this one's shared memory
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, bf16* dq, int B, int H, int Sq, int Sk,
                   int D, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_map(&tm_q, q, B, Sq, H, D, BM);
  if (err == cudaSuccess) err = encode_map(&tm_do, dout, B, Sq, H, D, BM);
  if (err == cudaSuccess) err = encode_map(&tm_k, k, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = encode_map(&tm_v, v, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dq_wide_kernel, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(2 * ((Sq + BM - 1) / BM), B * H);
  flash_bwd_dq_wide_kernel<<<grid, kThreads, kSmem, stream>>>(tm_q, tm_k, tm_v, tm_do, lse, delta,
                                                              dq, H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace wide

}  // namespace fa

// The wide slices (a quarter of the padded head dim) that take
// wide::flash_bwd_dq_wide_kernel, built for four slices of 128 (512) only;
// it replaced the narrow kernel's four-warp-slice instantiation, which read
// slower at the VAE's shape (PERF.md). ops/attention.py lists the same
// widths.
#define FA_BWD_DQ_WIDE_SLICES(X) X(128)

// Returns a cudaError_t.
extern "C" int flash_attn_bwd_dq(int device, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int B, int H, int Sq, int Sk, int D, float scale,
                                 void* stream) {
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
  auto* dqp = static_cast<bf16*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  // Up to 160: one warp per 16 rows, 4 warps, 32-key tiles. Wider:
  // FA_BWD_DQ_WIDE_SLICES, the warpgroup design.
  switch (round_up(D, 16)) {
#define FA_CASE(DP)                                                                          \
  case DP:                                                                                   \
    return launch_dq<DP, 4, 32>(qp, kp, vp, dop, lp, dp, dqp, B, H, Sq, Sk, D, scale, st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS) \
  case DS: return wide::launch(qp, kp, vp, dop, lp, dp, dqp, B, H, Sq, Sk, D, scale, st);
    FA_BWD_DQ_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
