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
// dim 40 the Sq * Sk exponentials (16 a clock an SM on the special-function
// unit) take longer than the products. Two designs, one per width (the
// dispatch at the end):
//
// * `flash_fwd_kernel` (every width but those of FA_FWD_ROWS128_DIMS): a
//   block owns 16 * RG query rows and walks the keys in BK-row tiles,
//   double-buffered by cp.async so the next tile's load overlaps this
//   tile's products: S = Q K^T (split-K across the SLICES warps of a row
//   group for wide heads), an online softmax per row in f32 and base 2,
//   then O = alpha * O + P V with P rounded to bf16 and fed from registers.
//   O stays in registers until the end.
// * `flash_fwd_rows128_kernel` (FA_FWD_ROWS128_DIMS: the UNet's head dims
//   40 and 80 at 4096 and 1024 tokens): the same arithmetic, cut down to
//   what the short head leaves room for. Its parent above spent a third of
//   its time streaming K/V (a knock-out that loaded them once ran 0.235 ms
//   of 0.350), so a block owns 128 rows, which halves the K/V traffic from
//   L2, and K/V tiles arrive through a 3-slot cp.async ring with one
//   barrier a tile. Q's A fragments are loaded once into registers. A warp
//   owns MF fragments of 16 rows (1 at head dim 40; 2 at 80, where each K
//   and V fragment then feeds two products). A logit costs one FFMA and
//   one `ex2.approx` (max taken on the raw products, scale folded into the
//   FFMA); the key mask runs on the ragged last tile only. Where the head
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
//   nothing, and wgmma in place of mma.sync read no faster (PERF.md).

#include "flash_attn_common.cuh"

namespace fa {

template <int DS, int SLICES, int RG, int BK>
constexpr size_t fwd_smem() {
  constexpr size_t ld = DS * SLICES + kPadH;
  return (16 * RG + 4 * BK) * ld * sizeof(bf16)  // Q, then K and V twice
         + (SLICES > 1 ? RG * SLICES * 16 * (BK + 8) * sizeof(float) : 0);  // split-K S
}

template <int DS, int SLICES, int RG, int BK>
__global__ void __launch_bounds__(32 * SLICES * RG)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int H, int Sq, int Sk, int D, float scale) {
  constexpr int DP = DS * SLICES, LD = DP + kPadH, BQ = 16 * RG, LDR = BK + 8;
  constexpr int NT_S = BK / 8, NT_O = DS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;      // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]
  float* sRed = reinterpret_cast<float*>(sV + 2 * BK * LD);  // [RG][SLICES][16][LDR]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, rg = warp / SLICES, sl = warp % SLICES;
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
  const bf16* wQ = sQ + 16 * rg * LD + sl * DS;
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
    const bf16* cK = sK + stage * BK * LD + sl * DS;
    const bf16* cV = sV + stage * BK * LD + sl * DS;

    float s[NT_S][4];
    zero(s);
    warp_mma_abt<DS / 16, NT_S>(s, wQ, LD, cK, LD);
    if constexpr (SLICES > 1) {
      store_partial(sRed + (rg * SLICES + sl) * 16 * LDR, LDR, s);
      __syncthreads();
      load_total<NT_S, SLICES>(s, sRed + rg * SLICES * 16 * LDR, LDR);
    }

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
    if (lse != nullptr && sl == 0 && t4 == 0 && row < Sq)
      lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
  }
  store_acc(o, acc, inv, b, h, H, Sq, D, q0 + 16 * rg, sl * DS);
}

// 2^x on the special-function unit; flushes subnormal results to 0 (a
// probability below 2^-126 of the row maximum adds nothing in bf16 or f32).
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
// from shared memory then feeds MF products.
template <int DP, int BK, int MF, bool PV_SUM, bool WITH_LSE>
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

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int row_w = 16 * MF * warp;  // this warp's first row in the block
  const float c = scale * kLog2e;
  const int n_tiles = (Sk + BK - 1) / BK;

  // Padding columns of every K and V slot: zero, but V's column D is 1.0
  // when PV_SUM (D == DP - 8), the column that sums P.
  for (int i = threadIdx.x; i < 2 * kRows128Stages * BK; i += blockDim.x) {
    bf16* row = sK + i * LD;
    for (int col = D; col < DP; ++col)
      row[col] = __float2bfloat16(PV_SUM && col == D && i >= kRows128Stages * BK ? 1.0f : 0.0f);
  }
  load_rows_async<BQ, DP, LD>(sQ, q, b, h, H, Sq, D, q0);
  load_kv_async<BK, DP, LD>(sK, k, b, h, H, Sk, D, 0);
  load_kv_async<BK, DP, LD>(sV, v, b, h, H, Sk, D, 0);
  cp_async_commit();
  if (n_tiles > 1) {
    load_kv_async<BK, DP, LD>(sK + SLOT, k, b, h, H, Sk, D, BK);
    load_kv_async<BK, DP, LD>(sV + SLOT, v, b, h, H, Sk, D, BK);
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
      load_kv_async<BK, DP, LD>(sK + slot * SLOT, k, b, h, H, Sk, D, (j + 2) * BK);
      load_kv_async<BK, DP, LD>(sV + slot * SLOT, v, b, h, H, Sk, D, (j + 2) * BK);
    }
    cp_async_commit();
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
    if (j == n_tiles - 1 && Sk % BK != 0) {  // the ragged tile: keys >= Sk count nothing
      const int key0 = j * BK + 2 * t4;
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
  for (int mf = 0; mf < MF; ++mf) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = 0.0f;
      if constexpr (!PV_SUM || WITH_LSE) {
        l = l_run[mf][r] + __shfl_xor_sync(0xffffffffu, l_run[mf][r], 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
      }
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

template <int DP, int MF>
cudaError_t launch_fwd_rows128(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                               int B, int H, int Sq, int Sk, int D, float scale,
                               cudaStream_t stream) {
  constexpr int BK = 64;
  constexpr size_t smem = fwd_rows128_smem<DP, BK>();
  auto kernel = D == DP - 8 ? (lse ? flash_fwd_rows128_kernel<DP, BK, MF, true, true>
                                   : flash_fwd_rows128_kernel<DP, BK, MF, true, false>)
                            : (lse ? flash_fwd_rows128_kernel<DP, BK, MF, false, true>
                                   : flash_fwd_rows128_kernel<DP, BK, MF, false, false>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kRows128Rows - 1) / kRows128Rows, B * H);
  kernel<<<grid, 32 * 8 / MF, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

template <int DS, int SLICES, int RG, int BK>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                       int H, int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DS, SLICES, RG, BK>();
  auto kernel = flash_fwd_kernel<DS, SLICES, RG, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * SLICES * RG, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace fa

// The padded head dims that take flash_fwd_rows128_kernel, each with its
// 16-row fragments a warp, where scripts/torch_bench_attention.py reads it
// faster than flash_fwd_kernel (PERF.md); ops/attention.py lists the same
// widths.
#define FA_FWD_ROWS128_DIMS(X) X(48, 1) X(80, 2)

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
  // FA_FWD_ROWS128_DIMS: 128-row blocks (their row maximum is taken on the
  // unscaled products, so a scale <= 0 goes to flash_fwd_kernel). Other
  // widths up to 160: one warp per 16 rows, 4 warps, 64-key tiles. Wider:
  // the head dim in 4 slices, 2 row groups (8 warps, 32 rows), 32-key tiles.
  if (scale > 0.0f) {
    switch (round_up(D, 16)) {
#define FA_CASE(DP, MF) \
  case DP: return launch_fwd_rows128<DP, MF>(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
      FA_FWD_ROWS128_DIMS(FA_CASE)
#undef FA_CASE
      default: break;
    }
  }
  switch (round_up(D, 16)) {
#define FA_CASE(DP) \
  case DP: return launch_fwd<DP, 1, 4, 64>(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS) \
  case DS: return launch_fwd<DS, 4, 2, 32>(qp, kp, vp, op, lp, B, H, Sq, Sk, D, scale, st);
    FA_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
