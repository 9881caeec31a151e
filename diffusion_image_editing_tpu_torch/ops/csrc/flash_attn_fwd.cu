// K1: flash-attention forward, O = softmax(Q K^T * scale) V and, when asked,
// the per-row log-sum-exp.
//
// Replaces the TPU kernels `_resident_kernel` and `_streaming_kernel` of
// diffusion_image_editing_tpu/ops/attention.py: on this card the two compute
// the same function, so one kernel serves every attention of the SD path,
// the ragged 77-token cross-attention and the 64-token mid block included.
//
// Bound on the H100: tensor-core operations at the 4096-token shapes
// (4 * Sq * Sk * D per head), bytes at the short ones; at the UNet's head
// dim 40 and the LDM UNet's 32 the Sq * Sk exponentials (16 a clock an SM on
// the special-function unit) take longer than the products. Four designs, by
// width (the dispatch at the end):
//
// * `flash_fwd_kernel` (the narrow widths no other design takes: the tiny
//   test configs' 16 and 64, and every narrow width at a scale <= 0): a block owns
//   16 * RG query rows, a warp 16 of them, and walks the keys in BK-row
//   tiles, double-buffered by cp.async so the next tile's load overlaps
//   this tile's products: S = Q K^T, an online softmax per row in f32 and
//   base 2, then O = alpha * O + P V with P rounded to bf16 and fed from
//   registers. O stays in registers until the end.
// * `flash_fwd_rows128_kernel` (FA_FWD_ROWS128_DIMS: the SD UNet's head dims
//   40 and 80 and the LDM UNet's 32): the same arithmetic, cut down to
//   what the short head leaves room for. Its parent above spent a third of
//   its time streaming K/V (a knock-out that loaded them once ran 0.235 ms
//   of 0.350), so a block owns 128 rows, which halves the K/V traffic from
//   L2, and K/V tiles arrive through a 3-slot cp.async ring with one
//   barrier a tile. Q's A fragments are loaded once into registers. A warp
//   owns MF fragments of 16 rows (1 at head dims 32 and 40; 2 at 80, where
//   each K and V fragment then feeds two products). A logit costs one FFMA
//   and one `ex2.approx` (max taken on the raw products, scale folded into
//   the FFMA); the key mask runs on the ragged last tile only. Where the head
//   dim is 8 short of its padded width (40 in 48, 72 in 80) the row sum
//   comes from the PV product: V's first padding column holds 1.0, so that
//   accumulator column carries sum(bf16(P)), rescaled by alpha with the
//   rest, and O is normalised by the same rounded P that multiplied V. The
//   log-sum-exp, when asked, still takes the f32 sum of P: the rounded sum
//   is up to 2^-9 off in a row of few keys (1.1e-3 in the lse at 77 keys,
//   over LSE_TOL), so that instantiation adds P up as well, and O is the
//   same to the bit with or without it. What bounds it is the per-tile
//   chain of each warp (products, max and shuffles, exponentials, pack,
//   rescale, barrier), not one unit: knocking out the exponentials saves
//   nothing, and wgmma in place of mma.sync read no faster (PERF.md). So
//   where the row blocks leave SMs idle (fewer than 132) and there are 8
//   key tiles or more, the keys are split over a cluster of two blocks,
//   which doubles the warps in flight; rank 1 hands its sums to rank 0
//   through distributed shared memory. At padded 32, where there are more
//   than 64 keys, the tiles hold 128 keys: a 64-key tile there left each
//   warp too little work between two barriers.
// * `wg::flash_fwd_wg_kernel` (FA_FWD_WG_DIMS: the SD UNet's 160 at 256 and
//   64 tokens). There a logit costs 320 multiply-adds against one
//   exponential, so products and bytes bind, and a 16-row warp's O (80
//   registers) left the parent design four warps a block and 107 KB of
//   shared memory. A block is one warpgroup of 64 query rows: S = Q K^T by
//   wgmma m64n64k16 (ten k16 steps, Q and K from shared memory, Q loaded
//   once), P from registers into wgmma m64n160k16 with V read transposed
//   from shared memory, O in 80 registers a thread. Q, K and V arrive by
//   TMA in boxes of 32 columns in the 64-byte swizzle, so 160 columns are
//   five whole swizzle atoms, into a two-slot K/V ring that one thread
//   refills as soon as the products are done with a slot: no barrier of the
//   block's threads in the loop, and two blocks an SM, so one block's
//   softmax runs under the other's products. O leaves through shared memory
//   and TMA (four-byte stores straight from the accumulators took 37 % of
//   the time at batch 16). Where the row blocks leave SMs idle and there
//   are two key tiles, the keys are split over a cluster of two blocks, each
//   finishing half of the columns with the other's partial sums.
// * `wide::flash_fwd_wide_kernel` (FA_FWD_WIDE_SLICES: the VAE's single
//   512-wide head at 4096 and 256 tokens). There a logit costs 1024
//   multiply-adds against one exponential, so the tensor products bind
//   (4 * Sq * Sk * 512); and a 64 x 512 f32 O does not fit one warpgroup's
//   registers. A block owns 64 query rows; two warpgroups each own 256 of
//   the 512 columns, hold that slice of O (128 registers a thread) and
//   compute their half of S = Q K^T by wgmma (m64n32k16, Q and K from
//   shared memory); the halves are added through shared memory behind one
//   named barrier a 32-key tile, and both warpgroups run the same softmax;
//   P V is wgmma m64n256k16 with P from registers and V read transposed
//   from shared memory. 64 blocks would fill half the card, so the keys
//   are split over a cluster of two blocks, each combining its columns with
//   the other's partial sums through distributed shared memory at the end
//   (the lse is the f32 sum of P, O the same to the bit with or without
//   it). Streaming K and V from L2 was the parent design's bound (1 GiB a
//   call; a knock-out that loaded them once ran 56 % faster), and a
//   cp.async version of this design still spent 39 % on it: Q, K and V
//   arrive by TMA, a warpgroup asking for its own column half of each
//   32-key tile (its products read no other), two slots deep, so no load
//   waits on the other warpgroup. There is no producer warpgroup: with one,
//   ptxas held every thread to the launch bound's 168 registers,
//   `setmaxnreg` notwithstanding, and serialized the products (C7512).

#include <cooperative_groups.h>

#include "flash_attn_common.cuh"

namespace fa {

namespace cg = cooperative_groups;

template <int DP, int RG, int BK>
constexpr size_t fwd_smem() {
  return (16 * RG + 4 * BK) * (DP + kPadH) * sizeof(bf16);  // Q, then K and V twice
}

template <int DP, int RG, int BK>
__global__ void __launch_bounds__(32 * RG)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int H, int Sq, int Sk, int D, float scale) {
  constexpr int LD = DP + kPadH, BQ = 16 * RG;
  constexpr int NT_S = BK / 8, NT_O = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;      // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int rg = threadIdx.x / 32;
  const int t4 = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;

  load_rows_async<BQ, DP, LD>(sQ, q, b, h, H, Sq, D, q0);
  load_rows_async<BK, DP, LD>(sK, k, b, h, H, Sk, D, 0);
  load_rows_async<BK, DP, LD>(sV, v, b, h, H, Sk, D, 0);
  cp_async_commit();

  float acc[NT_O][4];
  zero(acc);
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, base-2 logits
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const bf16* wQ = sQ + 16 * rg * LD;
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

    float s[NT_S][4];
    zero(s);
    warp_mma_abt<DP / 16, NT_S>(s, wQ, LD, cK, LD);

    // Online softmax over this tile; keys >= Sk are masked. Every tile holds
    // at least one real key, so the new row maximum is finite.
    const int key0 = j * BK + 2 * t4;
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (key0 + n * 8 + (e & 1) < Sk) ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        m_new[e / 2] = fmaxf(m_new[e / 2], x);
      }
    }
    float alpha[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      alpha[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_new[e / 2]);
        s[n][e] = p;
        row_sum[e / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    warp_mma_pb<BK / 16, NT_O>(acc, s, cV, LD);
    __syncthreads();  // this stage is read; the next iteration's prefetch may overwrite it
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.0f / l_run[r];
    const int row = q0 + 16 * rg + threadIdx.x % 32 / 4 + 8 * r;
    if (lse != nullptr && t4 == 0 && row < Sq)
      lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
  }
  store_acc(o, acc, inv, b, h, H, Sq, D, q0 + 16 * rg, 0);
}

constexpr int kRows128Rows = 128, kRows128Stages = 3;

template <int DP, int BK>
constexpr size_t fwd_rows128_smem() {
  return (kRows128Rows + 2 * kRows128Stages * BK) * (DP + kPadH) * sizeof(bf16);
}

// Rows [row0, row0 + BK) of head (b, h) into a [BK][LD] slot, data columns
// only (the slot's padding columns are set once and never loaded); rows >= S
// are zero. The chunk count is the padded width's, a constant: a division
// by the head dim would cost a few dozen instructions a copy.
template <int BK, int DP, int LD>
__device__ inline void load_kv_async(bf16* dst, const bf16* src, int b, int h, int H, int S,
                                     int D, int row0) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < BK * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8, s = row0 + r;
    if (c >= D) continue;
    const bool valid = s < S;
    const bf16* p = valid ? src + ((static_cast<size_t>(b) * S + s) * H + h) * D + c : src;
    cp_async16(dst + r * LD + c, p, valid);
  }
}

// MF: 16-row fragments a warp (8 / MF warps). Each K and V fragment read
// from shared memory then feeds MF products. With CS > 1, a cluster of CS
// blocks shares the rows, rank r taking the r-th of CS runs of key tiles;
// the other ranks hand their sums to rank 0 at the end.
template <int DP, int BK, int MF, bool PV_SUM, bool WITH_LSE, int CS>
__global__ void __launch_bounds__(32 * 8 / MF)
    flash_fwd_rows128_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale) {
  constexpr int LD = DP + kPadH, BQ = kRows128Rows, KS = DP / 16;
  constexpr int NT_S = BK / 8, NT_O = DP / 8, SLOT = BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;                 // [kRows128Stages][BK][LD]
  bf16* sV = sK + kRows128Stages * SLOT;   // [kRows128Stages][BK][LD]

  const int rank = CS > 1 ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x / CS * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int row_w = 16 * MF * warp;  // this warp's first row in the block
  // At padded 32 a warp whose rows all lie past Sq (the LDM UNet's 64
  // tokens fill half a block) computes nothing; it still loads its share of
  // each tile and meets each barrier. At the other widths no sequence of the
  // path is that short, and the check cost about 1 % (PERF.md).
  const bool idle = DP == 32 && q0 + row_w >= Sq;
  const float c = scale * kLog2e;
  const int n_all = (Sk + BK - 1) / BK;  // at least CS when CS > 1
  const int tile0 = rank * n_all / CS;
  const int n_tiles = (rank + 1) * n_all / CS - tile0;

  // Padding columns of every K and V slot: zero, but V's column D is 1.0
  // when PV_SUM (D == DP - 8), the column that sums P.
  for (int i = threadIdx.x; i < 2 * kRows128Stages * BK; i += blockDim.x) {
    bf16* row = sK + i * LD;
    for (int col = D; col < DP; ++col)
      row[col] = __float2bfloat16(PV_SUM && col == D && i >= kRows128Stages * BK ? 1.0f : 0.0f);
  }
  load_rows_async<BQ, DP, LD>(sQ, q, b, h, H, Sq, D, q0);
  load_kv_async<BK, DP, LD>(sK, k, b, h, H, Sk, D, tile0 * BK);
  load_kv_async<BK, DP, LD>(sV, v, b, h, H, Sk, D, tile0 * BK);
  cp_async_commit();
  if (n_tiles > 1) {
    load_kv_async<BK, DP, LD>(sK + SLOT, k, b, h, H, Sk, D, (tile0 + 1) * BK);
    load_kv_async<BK, DP, LD>(sV + SLOT, v, b, h, H, Sk, D, (tile0 + 1) * BK);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[MF][KS][4];  // this warp's rows of Q as mma A fragments
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    const bf16* a_lane = sQ + (row_w + 16 * mf + lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[mf][kk], a_lane + kk * 16);
  }
  float acc[MF][NT_O][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) zero(acc[mf]);
  float m_run[MF][2], l_run[MF][2];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    m_run[mf][0] = m_run[mf][1] = -INFINITY;
    l_run[mf][0] = l_run[mf][1] = 0.0f;
  }
  const int b_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 2 < n_tiles) {  // the slot of tile j - 1, which every warp has finished
      const int slot = (j + 2) % kRows128Stages;
      load_kv_async<BK, DP, LD>(sK + slot * SLOT, k, b, h, H, Sk, D, (tile0 + j + 2) * BK);
      load_kv_async<BK, DP, LD>(sV + slot * SLOT, v, b, h, H, Sk, D, (tile0 + j + 2) * BK);
    }
    cp_async_commit();
    if (idle) {
      cp_async_wait<1>();
      __syncthreads();
      continue;
    }
    const bf16* cK = sK + (j % kRows128Stages) * SLOT;
    const bf16* cV = sV + (j % kRows128Stages) * SLOT;

    float s[MF][NT_S][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) zero(s[mf]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT_S; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + b_off + n * 8 * LD + kk * 16);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          mma_16816(s[mf][n], qf[mf][kk], bf[0], bf[1]);
          mma_16816(s[mf][n + 1], qf[mf][kk], bf[2], bf[3]);
        }
      }
    }
    if ((tile0 + j + 1) * BK > Sk) {  // the ragged tile: keys >= Sk count nothing
      const int key0 = (tile0 + j) * BK + 2 * t4;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int n = 0; n < NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + n * 8 + (e & 1) >= Sk) s[mf][n][e] = -INFINITY;
    }
    // Online softmax in base 2. The maximum is taken on the raw products
    // (scale > 0) and scaled once; every tile holds a real key, so it is
    // finite. P goes to bf16 A fragments for P V.
    uint32_t pa[MF][BK / 16][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      float m_new[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        m_new[0] = fmaxf(m_new[0], fmaxf(s[mf][n][0], s[mf][n][1]));
        m_new[1] = fmaxf(m_new[1], fmaxf(s[mf][n][2], s[mf][n][3]));
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
        m_new[r] = fmaxf(m_run[mf][r], m_new[r] * c);
        alpha[r] = ex2(m_run[mf][r] - m_new[r]);
        m_run[mf][r] = m_new[r];
        neg_m[r] = -m_new[r];
      }
      float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mf][n][e] = ex2(fmaf(s[mf][n][e], c, neg_m[e / 2]));
          if constexpr (!PV_SUM || WITH_LSE) row_sum[e / 2] += s[mf][n][e];
        }
        pa[mf][n / 2][2 * (n % 2)] = pack_bf16(s[mf][n][0], s[mf][n][1]);
        pa[mf][n / 2][2 * (n % 2) + 1] = pack_bf16(s[mf][n][2], s[mf][n][3]);
      }
      if constexpr (!PV_SUM || WITH_LSE) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[mf][r] = l_run[mf][r] * alpha[r] + row_sum[r];
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[mf][n][0] *= alpha[0];
        acc[mf][n][1] *= alpha[0];
        acc[mf][n][2] *= alpha[1];
        acc[mf][n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + v_off + kk * 16 * LD + n * 8);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          mma_16816(acc[mf][n], pa[mf][kk], bv[0], bv[1]);
          mma_16816(acc[mf][n + 1], pa[mf][kk], bv[2], bv[3]);
        }
      }
    }
    cp_async_wait<1>();  // tile j + 1 has landed (this thread's copies) ...
    __syncthreads();     // ... for every thread, and every warp is done with tile j
  }

#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[mf][r] += __shfl_xor_sync(0xffffffffu, l_run[mf][r], 1);
      l_run[mf][r] += __shfl_xor_sync(0xffffffffu, l_run[mf][r], 2);
    }
  if constexpr (CS > 1) {
    // The runs of keys meet in rank 0. The other ranks leave their sums,
    // row maxima and row sums in their shared memory (over Q and K, which
    // no product reads any more: every warp has passed the loop's last
    // barrier), and rank 0 rescales all to the joint maximum, adding them
    // in rank order. Each run holds a key, so the joint maximum of a real
    // row is finite.
    float4* dump = reinterpret_cast<float4*>(smem);
    float4* stats = dump + MF * NT_O * blockDim.x;
    cg::cluster_group cluster = cg::this_cluster();
    if (rank != 0) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
        for (int n = 0; n < NT_O; ++n)
          dump[(mf * NT_O + n) * blockDim.x + threadIdx.x] =
              make_float4(acc[mf][n][0], acc[mf][n][1], acc[mf][n][2], acc[mf][n][3]);
        stats[mf * blockDim.x + threadIdx.x] =
            make_float4(m_run[mf][0], m_run[mf][1], l_run[mf][0], l_run[mf][1]);
      }
      cluster.sync();
      cluster.sync();  // rank 0 has read them
      return;
    }
    cluster.sync();
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      float4 ps[CS - 1];
      float m[2] = {m_run[mf][0], m_run[mf][1]};
#pragma unroll
      for (int p = 1; p < CS; ++p) {
        ps[p - 1] = cluster.map_shared_rank(stats, p)[mf * blockDim.x + threadIdx.x];
        m[0] = fmaxf(m[0], ps[p - 1].x);
        m[1] = fmaxf(m[1], ps[p - 1].y);
      }
      const float a_own[2] = {ex2(m_run[mf][0] - m[0]), ex2(m_run[mf][1] - m[1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[mf][r] = m[r];
        l_run[mf][r] *= a_own[r];
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][n][e] *= a_own[e / 2];
#pragma unroll
      for (int p = 1; p < CS; ++p) {
        const float a_peer[2] = {ex2(ps[p - 1].x - m[0]), ex2(ps[p - 1].y - m[1])};
        l_run[mf][0] += ps[p - 1].z * a_peer[0];
        l_run[mf][1] += ps[p - 1].w * a_peer[1];
        const float4* peer = cluster.map_shared_rank(dump, p);
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          const float4 x = peer[(mf * NT_O + n) * blockDim.x + threadIdx.x];
          const float px[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][n][e] += px[e] * a_peer[e / 2];
        }
      }
    }
    cluster.sync();  // the other ranks' shared memory is read
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mf][r];
      const int row = q0 + row_w + 16 * mf + lane / 4 + 8 * r;
      if (WITH_LSE && t4 == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = (m_run[mf][r] + log2f(l)) * kLn2;
      if constexpr (PV_SUM)  // column D = DP - 8, held by the quad's first thread
        l = __shfl_sync(0xffffffffu, acc[mf][NT_O - 1][2 * r], lane & ~3);
      inv[r] = 1.0f / l;
    }
    store_acc(o, acc[mf], inv, b, h, H, Sq, D, q0 + row_w + 16 * mf, 0);
  }
}

// Fewer blocks than this (one an SM of the H100 SXM) split the keys over a
// cluster of kSplitCluster blocks, where there are kSplitMinTiles key tiles
// or more: with fewer, the combine costs more than the split saves (the
// 77-key cross-attention, PERF.md).
constexpr int kSplitBelow = 132, kSplitMinTiles = 8, kSplitCluster = 2;

template <int DP, int MF, int BK, int CS>
cudaError_t launch_fwd_rows128_as(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                  float* lse, int B, int H, int Sq, int Sk, int D, float scale,
                                  cudaStream_t stream) {
  constexpr size_t smem = fwd_rows128_smem<DP, BK>();
  static_assert(CS == 1 || (MF * (DP / 8) + MF) * (256 / MF) * 16 <= smem,
                "a rank's sums fit the shared memory they are left in");
  auto kernel =
      D == DP - 8 ? (lse ? flash_fwd_rows128_kernel<DP, BK, MF, true, true, CS>
                         : flash_fwd_rows128_kernel<DP, BK, MF, true, false, CS>)
                  : (lse ? flash_fwd_rows128_kernel<DP, BK, MF, false, true, CS>
                         : flash_fwd_rows128_kernel<DP, BK, MF, false, false, CS>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (Sq + kRows128Rows - 1) / kRows128Rows;
  return sm90::launch_grid(kernel, CS, CS * row_blocks, B * H, 32 * 8 / MF, smem, stream, q, k,
                           v, o, lse, H, Sq, Sk, D, scale);
}

template <int DP, int MF, int BK>
cudaError_t launch_fwd_rows128_bk(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                                  int B, int H, int Sq, int Sk, int D, float scale,
                                  cudaStream_t stream) {
  const int row_blocks = (Sq + kRows128Rows - 1) / kRows128Rows;
  if (row_blocks * B * H < kSplitBelow && Sk > (kSplitMinTiles - 1) * BK)
    return launch_fwd_rows128_as<DP, MF, BK, kSplitCluster>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                                            scale, stream);
  return launch_fwd_rows128_as<DP, MF, BK, 1>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, stream);
}

// Key tiles of 64, or at padded 32 of 128 where there are more than 64 keys:
// there a 64-key tile leaves each warp too little work between barriers
// (the LDM UNet's 1024 tokens read 0.0177 ms against 0.0199, PERF.md).
template <int DP, int MF>
cudaError_t launch_fwd_rows128(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                               int B, int H, int Sq, int Sk, int D, float scale,
                               cudaStream_t stream) {
  if constexpr (DP == 32) {
    if (Sk > 64)
      return launch_fwd_rows128_bk<DP, MF, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, stream);
  }
  return launch_fwd_rows128_bk<DP, MF, 64>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, stream);
}

// ---------------------------------------------------------------------------
// The wide design (FA_FWD_WIDE_SLICES: the VAE's head dim 512): warpgroups,
// wgmma, TMA, and the keys split over a cluster of two.
// ---------------------------------------------------------------------------

namespace wide {

namespace cg = cooperative_groups;

constexpr int BM = 64;              // query rows a block: one wgmma M
constexpr int BK = 32;              // keys a tile
constexpr int DP = 512;             // padded head dim
constexpr int kThreads = 256;       // two warpgroups
constexpr int kQBytes = BM * DP * 2;
constexpr int kTileBytes = BK * DP * 2;
constexpr int kXFloats = BM * BK;   // one warpgroup's partial S
constexpr size_t kSmem = kQBytes + 4 * kTileBytes + 4 * kXFloats * sizeof(float) + 9 * 8;

// This warpgroup's half of S = Q K^T: 16 k16 steps over its 256 columns, Q
// and K K-major at q_wg and k_wg. The first step overwrites S.
__device__ __forceinline__ void qk_product(float (&s)[16], uint32_t q_wg, uint32_t k_wg) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_s(s, desc(q_wg + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024),
            desc(k_wg + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// One tile's softmax. The two warpgroups' halves of S meet in `x` (this
// tile's exchange buffer: one half each): each thread's 16 values sit at the
// same places of both accumulators, and a + b == b + a, so both warpgroups
// hold one S. Then the online softmax in base 2; keys >= Sk (the ragged
// tile) count nothing. Every tile holds a real key, so the new row maximum
// is finite. P goes to bf16 A fragments; alpha rescales the old rows.
__device__ __forceinline__ void softmax_tile(float (&s)[16], float* x, int wg, int tid, int key0,
                                             int Sk, bool ragged, float c, float (&m_run)[2],
                                             float (&l_run)[2], uint32_t (&pa)[2][4],
                                             float (&alpha)[2]) {
  float4* mine = reinterpret_cast<float4*>(x + wg * kXFloats);
  const float4* other = reinterpret_cast<const float4*>(x + (1 - wg) * kXFloats);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mine[j * 128 + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  warpgroups_sync();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 o = other[j * 128 + tid];
    s[4 * j] += o.x;
    s[4 * j + 1] += o.y;
    s[4 * j + 2] += o.z;
    s[4 * j + 3] += o.w;
  }
  float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * c;
      if (ragged && key0 + 8 * j + (e & 1) >= Sk) v = -INFINITY;
      s[4 * j + e] = v;
      m_new[e / 2] = fmaxf(m_new[e / 2], v);
    }
  }
  float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    alpha[r] = ex2(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[4 * j + e] - m_new[e / 2]);
      s[4 * j + e] = p;
      row_sum[e / 2] += p;
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
}

__device__ __forceinline__ void rescale(float (&acc)[128], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// One block: BM query rows of head (b, h), half of the key tiles (cluster
// rank 0 the first half, 1 the rest). Two warpgroups, each owning 256 of
// the 512 columns, compute and also load: a producer warpgroup would leave
// them 168 registers a thread (ptxas holds the kernel to its launch bound,
// setmaxnreg or not), too few for 128 accumulators and the products in
// flight. Shared memory: Q [8][BM][64], K and V two slots each of
// [8][BK][64], all in 64-column blocks in the 128-byte swizzle; the partial
// S exchange, two buffers of two warpgroups; the mbarriers.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kQBytes, sV = sK + 2 * kTileBytes;
  float* sX = reinterpret_cast<float*>(smem + kQBytes + 4 * kTileBytes);
  // [2 warpgroups][2 slots]: this warpgroup's half of a K or V slot has
  // landed; then Q has landed.
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sX + 4 * kXFloats);
  uint64_t* full_v = full_k + 4;
  uint64_t* full_q = full_k + 8;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // which half of the keys
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x / 2) * BM;
  const int n_all = (Sk + BK - 1) / BK, n_first = (n_all + 1) / 2;
  const int tile0 = rank == 0 ? 0 : n_first;
  const int n_tiles = rank == 0 ? n_first : n_all - n_first;
  const int wg = threadIdx.x / 128;  // columns [256 wg, 256 wg + 256)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const float c = scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 9; ++i) mbar_init(&full_k[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(full_q, kQBytes);
    for (int j = 0; j < 8; ++j) tma_box(sQ + j * BM * 128, tm_q, 64 * j, h, q0, b, full_q);
  }
  __syncthreads();
  // Each warpgroup's products read only its own 256 columns of Q, K and V,
  // so it asks for its halves of the K and V tiles itself, into slot t % 2,
  // as soon as its own products are done with the slot: no wait on the other
  // warpgroup. One thread asks; the slot's barrier flips when the bytes land.
  uint64_t* my_k = full_k + 2 * wg;
  uint64_t* my_v = full_v + 2 * wg;
  auto load_half = [&](uint32_t slot_base, const CUtensorMap& map, uint64_t* bar, int t) {
    if (tid == 0) {
      expect_bytes(bar, kTileBytes / 2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tma_box(slot_base + (4 * wg + j) * BK * 128, map, 256 * wg + 64 * j, h, (tile0 + t) * BK,
                b, bar);
    }
  };
  auto load_k = [&](int t) {
    load_half(sK + (t & 1) * kTileBytes, tm_k, &my_k[t & 1], t);
  };
  auto load_v = [&](int t) {
    load_half(sV + (t & 1) * kTileBytes, tm_v, &my_v[t & 1], t);
  };
  for (int t = 0; t < 2 && t < n_tiles; ++t) {
    load_k(t);
    load_v(t);
  }
  mbar_wait(full_q, 0);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp, base 2
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const uint32_t q_wg = sQ + 4 * wg * BM * 128;
  // Addresses made anew each tile: hoisted out of the loop, the 36
  // descriptors would hold 72 registers and starve the products.
  auto k_addr = [&](int i) {
    uint32_t a = sK + (i & 1) * kTileBytes + 4 * wg * BK * 128;
    asm volatile("" : "+r"(a));
    return a;
  };
  auto v_addr = [&](int i) {
    uint32_t a = sV + (i & 1) * kTileBytes + 4 * wg * BK * 128;
    asm volatile("" : "+r"(a));
    return a;
  };


  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    float s[16];
    mbar_wait(&my_k[slot], parity);
    wgmma_fence();
    qk_product(s, q_wg, k_addr(i));
    wgmma_commit();
    wgmma_wait<0>();  // S, and the last tile's P V, are done
    fence_operands(s);
    fence_operands(acc);
    // This K slot takes tile i + 2, tile i - 1's V slot tile i + 1.
    if (i + 2 < n_tiles) load_k(i + 2);
    if (i >= 1 && i + 1 < n_tiles) load_v(i + 1);
    uint32_t pa[2][4];
    float alpha[2];
    softmax_tile(s, sX + 2 * slot * kXFloats, wg, tid, (tile0 + i) * BK + 2 * t4, Sk,
                 (tile0 + i + 1) * BK > Sk, c, m_run, l_run, pa, alpha);
    rescale(acc, alpha);
    // O += P V over this warpgroup's 256 columns, left in flight under the
    // next tile's Q K^T.
    mbar_wait(&my_v[slot], parity);
    wgmma_fence();
    const uint32_t va = v_addr(i);
    wgmma_pv(acc, pa[0], desc(va, BK * 128, 1024));
    wgmma_pv(acc, pa[1], desc(va + 16 * 128, BK * 128, 1024));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // The two halves of the keys meet. Warpgroup `rank` of each block
  // finishes its columns with the other block's sums for them; the other
  // warpgroup leaves its sums, row maxima and row sums in shared memory
  // (over Q and K, which no product reads any more) for the other block.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float4* dump = reinterpret_cast<float4*>(smem);
  float4* stats = reinterpret_cast<float4*>(smem + kQBytes);
  const bool finish = wg == rank;
  if (!finish) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      dump[j * 128 + tid] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    stats[tid] = make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
  }
  cluster.sync();
  if (finish) {
    const float4* peer = cluster.map_shared_rank(dump, rank ^ 1);
    const float4 ps = cluster.map_shared_rank(stats, rank ^ 1)[tid];
    const float pm[2] = {ps.x, ps.y}, pl[2] = {ps.z, ps.w};
    float a_own[2], a_peer[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // Rank 0's half holds at least one key, so m is finite.
      const float m = fmaxf(m_run[r], pm[r]);
      a_own[r] = ex2(m_run[r] - m);
      a_peer[r] = ex2(pm[r] - m);
      const float l = rank == 0 ? l_run[r] * a_own[r] + pl[r] * a_peer[r]
                                : pl[r] * a_peer[r] + l_run[r] * a_own[r];
      inv[r] = 1.0f / l;
      const int row = q0 + 16 * warp + lane / 4 + 8 * r;
      if (lse != nullptr && rank == 0 && t4 == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = (m + log2f(l)) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 x = peer[j * 128 + tid];
      const float px[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mine_part = acc[4 * j + e] * a_own[e / 2];
        const float peer_part = px[e] * a_peer[e / 2];
        acc[4 * j + e] = rank == 0 ? mine_part + peer_part : peer_part + mine_part;
      }
    }
    float (&acc4)[32][4] = *reinterpret_cast<float(*)[32][4]>(acc);
    store_acc(o, acc4, inv, b, h, H, Sq, D, q0 + 16 * warp, 256 * wg);
  }
  cluster.sync();  // the other block has read this one's shared memory
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
                   int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_map(&tm_q, q, B, Sq, H, D, BM);
  if (err == cudaSuccess) err = encode_map(&tm_k, k, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = encode_map(&tm_v, v, B, Sk, H, D, BK);
  if (err == cudaSuccess) err = set_smem(flash_fwd_wide_kernel, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(2 * ((Sq + BM - 1) / BM), B * H);
  flash_fwd_wide_kernel<<<grid, kThreads, kSmem, stream>>>(tm_q, tm_k, tm_v, o, lse, H, Sq, Sk, D,
                                                           scale);
  return cudaGetLastError();
}

}  // namespace wide

// ---------------------------------------------------------------------------
// The warpgroup design at padded 160 (FA_FWD_WG_DIMS: the SD UNet's 16 x 16
// and 8 x 8 levels): wgmma from shared memory, TMA, and the keys split over a
// cluster of two where the grid is short.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 64;                    // query rows a block: one wgmma M
constexpr int BK = 64;                    // keys a tile (32 read slower, PERF.md)
constexpr int DP = 160;                   // padded head dim
constexpr int kBoxCols = 32;              // a 64-byte row: the 64-byte swizzle's width
constexpr int kBoxes = DP / kBoxCols;     // five boxes a row block
constexpr int kQBox = BM * kBoxCols * 2;  // bytes of one box of Q (or O)
constexpr int kKVBox = BK * kBoxCols * 2;  // ... of K or V
constexpr int kQBytes = kBoxes * kQBox, kKVBytes = kBoxes * kKVBox;
constexpr int kThreads = 128;             // one warpgroup
// Q, K and V two slots each, the split's row statistics (a float4 a
// thread), the mbarriers: two blocks fit an SM.
constexpr size_t kSmem = kQBytes + 4 * kKVBytes + kThreads * 16 + 5 * 8;
constexpr int kSms = 132;                 // H100 SXM: fewer blocks than this split the keys

// Q, K and V lie in shared memory as five boxes of 32 columns (a 64-byte row
// each, the 64-byte swizzle), so 160 columns are whole swizzle atoms: a
// k16 step of Q K^T is 32 bytes into a box (boxes `box` bytes apart), and
// V's 160 columns are five MN-major atoms `kKVBox` apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int box, int kk) {
  return desc(tile + (kk / 2) * box + (kk % 2) * 32, 16, 512, 2);
}

template <int J0>  // the peer finishes accumulator columns [8 J0, 8 J0 + 80)
__device__ __forceinline__ void dump_half(float4* dump, const float (&acc)[80], int tid) {
#pragma unroll
  for (int j = 0; j < 10; ++j)
    dump[j * kThreads + tid] = make_float4(acc[4 * (J0 + j)], acc[4 * (J0 + j) + 1],
                                           acc[4 * (J0 + j) + 2], acc[4 * (J0 + j) + 3]);
}

// This block's half of the columns, [8 J0, 8 J0 + 80): its own sums and the
// peer's, each rescaled to the joint row maximum, then normalised and stored.
template <int J0>
__device__ __forceinline__ void finish_half(const float (&acc)[80], const float4* peer,
                                            const float (&a_own)[2], const float (&a_peer)[2],
                                            const float (&inv)[2], int tid, bf16* o, int b, int h,
                                            int H, int Sq, int D, int row0) {
  float half[10][4];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const float4 x = peer[j * kThreads + tid];
    const float px[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      half[j][e] = acc[4 * (J0 + j) + e] * a_own[e / 2] + px[e] * a_peer[e / 2];
  }
  store_acc(o, half, inv, b, h, H, Sq, D, row0, 8 * J0);
}

// One block: BM query rows of head (b, h) and all the keys, or with SPLIT
// half of the key tiles (cluster rank 0 the first half, 1 the rest). One
// warpgroup computes and loads: thread 0 asks for each K and V tile by TMA
// into a two-slot ring as soon as the products are done with the slot, so
// no barrier of the block's threads runs in the loop. Two blocks share an
// SM, so one block's softmax runs under the other's products.
template <bool SPLIT, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o, bf16* __restrict__ o,
                        float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kQBytes, sV = sK + 2 * kKVBytes;
  float4* stats = reinterpret_cast<float4*>(smem + kQBytes + 4 * kKVBytes);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(stats + kThreads);  // [2 slots]
  uint64_t* full_v = full_k + 2;                                   // [2 slots]
  uint64_t* full_q = full_k + 4;

  const int rank = SPLIT ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (SPLIT ? blockIdx.x / 2 : blockIdx.x) * BM;
  const int n_all = (Sk + BK - 1) / BK, n_first = SPLIT ? (n_all + 1) / 2 : n_all;
  const int tile0 = rank == 0 ? 0 : n_first;
  const int n_tiles = rank == 0 ? n_first : n_all - n_first;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const float c = scale * kLog2e;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&full_k[i], 1);
    sm90::fence_mbar_init();
    expect_bytes(full_q, kQBytes);
    for (int j = 0; j < kBoxes; ++j) tma_box(sQ + j * kQBox, tm_q, kBoxCols * j, h, q0, b, full_q);
  }
  __syncthreads();
  auto load = [&](uint32_t slot_base, const CUtensorMap& map, uint64_t* bar, int t) {
    expect_bytes(bar, kKVBytes);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_box(slot_base + j * kKVBox, map, kBoxCols * j, h, (tile0 + t) * BK, b, bar);
  };
  auto load_k = [&](int t) { load(sK + (t & 1) * kKVBytes, tm_k, &full_k[t & 1], t); };
  auto load_v = [&](int t) { load(sV + (t & 1) * kKVBytes, tm_v, &full_v[t & 1], t); };
  if (tid == 0) {
    for (int t = 0; t < 2 && t < n_tiles; ++t) {
      load_k(t);
      load_v(t);
    }
  }

  float acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp, base 2
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  // Addresses made anew each tile, so the descriptors are not held in
  // registers across the loop.
  auto slot_addr = [&](uint32_t base, int i) {
    uint32_t a = base + (i & 1) * kKVBytes;
    asm volatile("" : "+r"(a));
    return a;
  };
  mbar_wait(full_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    float s[BK / 2];
    mbar_wait(&full_k[slot], parity);
    wgmma_fence();
    const uint32_t ka = slot_addr(sK, i);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_s64(s, kmajor(sQ, kQBox, kk), kmajor(ka, kKVBox, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S, and the last tile's P V, are done
    fence_operands(s);
    fence_operands(acc);
    // This K slot takes tile i + 2, tile i - 1's V slot tile i + 1.
    if (tid == 0) {
      if (i + 2 < n_tiles) load_k(i + 2);
      if (i >= 1 && i + 1 < n_tiles) load_v(i + 1);
    }

    if ((tile0 + i + 1) * BK > Sk) {  // the ragged tile: keys >= Sk count nothing
      const int key0 = (tile0 + i) * BK + 2 * t4;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + (e & 1) >= Sk) s[4 * j + e] = -INFINITY;
    }
    // Online softmax in base 2, the maximum taken on the raw products (scale
    // > 0) and scaled once; every tile holds a real key, so it is finite.
    float m_new[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * j], s[4 * j + 1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float alpha[2], neg_m[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      m_new[r] = fmaxf(m_run[r], m_new[r] * c);
      alpha[r] = ex2(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      neg_m[r] = -m_new[r];
    }
    uint32_t pa[BK / 16][4];  // P as the A fragments of the k16 steps of P V
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, neg_m[e / 2]));
        row_sum[e / 2] += s[4 * j + e];
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int j = 0; j < 20; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // O += P V, left in flight under the next tile's Q K^T.
    mbar_wait(&full_v[slot], parity);
    wgmma_fence();
    const uint32_t va = slot_addr(sV, i);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_pv160(acc, pa[t], desc(va + t * 16 * 64, kKVBox, 512, 2));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = q0 + 16 * warp;
  if constexpr (!SPLIT) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.0f / l_run[r];
      const int row = row0 + lane / 4 + 8 * r;
      if (WITH_LSE && t4 == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
    }
    // O goes over Q (no product reads it any more) in Q's layout, then out
    // by TMA, box by box: rows past Sq and columns past D are dropped. Four-
    // byte stores straight from the accumulators took 37 % of the time at
    // (16, 256, 8, 160) (PERF.md). Within a box, 16-byte chunk k of row r
    // lies at r * 64 + (k ^ (r / 2 % 4)) * 16: the 64-byte swizzle.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
      for (int j = 0; j < 20; ++j) {
        const uint32_t at = (j / 4) * kQBox + row * 64 +
                            (((j % 4) ^ ((row >> 1) & 3)) << 4) + 4 * t4;
        *reinterpret_cast<__nv_bfloat162*>(smem + at) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < kBoxes; ++j)
        tma_store(tm_o, sQ + j * kQBox, kBoxCols * j, h, q0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    // The two halves of the keys meet. Each block finishes half of the
    // columns (rank 0 the first 80) with the other block's sums for them;
    // it leaves the other half over Q, which no product reads any more, and
    // its row maxima and row sums beside.
    float4* dump = reinterpret_cast<float4*>(smem);
    if (rank == 0)
      dump_half<10>(dump, acc, tid);
    else
      dump_half<0>(dump, acc, tid);
    stats[tid] = make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float4* peer = cluster.map_shared_rank(dump, rank ^ 1);
    const float4 ps = cluster.map_shared_rank(stats, rank ^ 1)[tid];
    const float pm[2] = {ps.x, ps.y}, pl[2] = {ps.z, ps.w};
    float a_own[2], a_peer[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // Each half holds at least one key, so m is finite.
      const float m = fmaxf(m_run[r], pm[r]);
      a_own[r] = ex2(m_run[r] - m);
      a_peer[r] = ex2(pm[r] - m);
      const float l = l_run[r] * a_own[r] + pl[r] * a_peer[r];
      inv[r] = 1.0f / l;
      const int row = row0 + lane / 4 + 8 * r;
      if (WITH_LSE && rank == 0 && t4 == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = (m + log2f(l)) * kLn2;
    }
    if (rank == 0)
      finish_half<0>(acc, peer, a_own, a_peer, inv, tid, o, b, h, H, Sq, D, row0);
    else
      finish_half<10>(acc, peer, a_own, a_peer, inv, tid, o, b, h, H, Sq, D, row0);
    cluster.sync();  // the other block has read this one's shared memory
  }
}

template <bool SPLIT, bool WITH_LSE>
cudaError_t launch_as(const CUtensorMap (&maps)[4], bf16* o, float* lse, int B, int H, int Sq,
                      int Sk, int D, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_wg_kernel<SPLIT, WITH_LSE>;
  cudaError_t err = set_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (Sq + BM - 1) / BM;
  return sm90::launch_grid(kernel, SPLIT ? 2 : 1, (SPLIT ? 2 : 1) * row_blocks, B * H, kThreads,
                           kSmem, stream, maps[0], maps[1], maps[2], maps[3], o, lse, H, Sq, Sk,
                           D, scale);
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
                   int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];  // Q, K, V, O
  const auto sw = CU_TENSOR_MAP_SWIZZLE_64B;
  cudaError_t err = encode_map(&maps[0], q, B, Sq, H, D, BM, kBoxCols, sw);
  if (err == cudaSuccess) err = encode_map(&maps[1], k, B, Sk, H, D, BK, kBoxCols, sw);
  if (err == cudaSuccess) err = encode_map(&maps[2], v, B, Sk, H, D, BK, kBoxCols, sw);
  if (err == cudaSuccess) err = encode_map(&maps[3], o, B, Sq, H, D, BM, kBoxCols, sw);
  if (err != cudaSuccess) return err;
  // The keys are split over a cluster of two where the blocks leave SMs
  // idle and there are two key tiles to split.
  if ((Sq + BM - 1) / BM * B * H < kSms && Sk > BK)
    return lse ? launch_as<true, true>(maps, o, lse, B, H, Sq, Sk, D, scale, stream)
               : launch_as<true, false>(maps, o, lse, B, H, Sq, Sk, D, scale, stream);
  return lse ? launch_as<false, true>(maps, o, lse, B, H, Sq, Sk, D, scale, stream)
             : launch_as<false, false>(maps, o, lse, B, H, Sq, Sk, D, scale, stream);
}

}  // namespace wg

template <int DP, int RG, int BK>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                       int H, int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DP, RG, BK>();
  auto kernel = flash_fwd_kernel<DP, RG, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * RG, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace fa

// The padded head dims that take flash_fwd_rows128_kernel, each with its
// 16-row fragments a warp, where scripts/torch_bench_attention.py reads it
// faster than flash_fwd_kernel at every shape of the path (PERF.md);
// ops/attention.py lists the same widths.
#define FA_FWD_ROWS128_DIMS(X) X(32, 1) X(48, 1) X(80, 2)

// The padded head dims that take wg::flash_fwd_wg_kernel (built for 160
// only), where the bench script reads it faster than flash_fwd_kernel at
// every shape of the path; ops/attention.py lists the same widths.
#define FA_FWD_WG_DIMS(X) X(160)

// The wide slices (a quarter of the padded head dim) that take
// wide::flash_fwd_wide_kernel, built for four slices of 128 (512) only; it
// replaced flash_fwd_kernel's four-slice instantiation, which read 3.3x
// slower at the VAE's shape (PERF.md). ops/attention.py lists the same
// widths.
#define FA_FWD_WIDE_SLICES(X) X(128)

// lse may be null (primal-only call). Returns a cudaError_t.
extern "C" int flash_attn_fwd(int device, const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int H, int Sq, int Sk, int D, float scale,
                              void* stream) {
  using namespace fa;
  cudaError_t err = check_shape(B, H, Sq, Sk, D);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  // FA_FWD_ROWS128_DIMS: 128-row blocks; FA_FWD_WG_DIMS: the warpgroup
  // design at 160 (both take their row maximum on the unscaled products,
  // so a scale <= 0 goes to flash_fwd_kernel). Other widths up to 160: one
  // warp per 16 rows, 4 warps, 64-key tiles. Wider: FA_FWD_WIDE_SLICES, the
  // warpgroup design at 512.
  if (scale > 0.0f) {
    switch (round_up(D, 16)) {
#define FA_CASE(DP, MF) \
  case DP: return launch_fwd_rows128<DP, MF>(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
      FA_FWD_ROWS128_DIMS(FA_CASE)
#undef FA_CASE
#define FA_CASE(DP) \
  case DP: return wg::launch(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
      FA_FWD_WG_DIMS(FA_CASE)
#undef FA_CASE
      default: break;
    }
  }
  switch (round_up(D, 16)) {
#define FA_CASE(DP) \
  case DP: return launch_fwd<DP, 4, 64>(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS) \
  case DS: return wide::launch(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
    FA_FWD_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
