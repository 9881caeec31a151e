// K3: flash-attention backward, dK and dV.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// diffusion_image_editing_tpu/ops/attention.py. A block owns 16 * RG key rows
// of one (batch, head) and walks the queries in BQ-row tiles, double-buffered
// by cp.async. It works in the transposed frame, rows = keys:
//   P^T  = exp(K Q^T * scale - lse)   (lse per column)
//   dP^T = V dO^T,  dS^T = P^T * (dP^T - delta)
//   dV += P^T dO
//   dK += dS^T Q                      (times scale once, at the end)
// Bound on the H100: tensor-core operations (8 * Sq * Sk * D per head). P^T
// and dS^T go from the accumulators straight into the next products; dK and
// dV stay in registers. The dK/dV rows belong to this block alone: no
// atomics, a deterministic sum.

#include "flash_attn_common.cuh"

namespace fa {

template <int DS, int SLICES, int RG, int BQ>
constexpr size_t dkv_smem() {
  constexpr size_t ld = DS * SLICES + kPadH;
  return (2 * 16 * RG + 4 * BQ) * ld * sizeof(bf16)  // K, V, then Q and dO twice
         + (SLICES > 1 ? 2 * RG * SLICES * 16 * (BQ + 8) * sizeof(float) : 0);  // S^T, dP^T
}

template <int DS, int SLICES, int RG, int BQ>
__global__ void __launch_bounds__(32 * SLICES * RG)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                         int D, float scale) {
  constexpr int DP = DS * SLICES, LD = DP + kPadH, BK = 16 * RG, LDR = BQ + 8;
  constexpr int NT_S = BQ / 8, NT_O = DS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;       // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;  // [2][BQ][LD]
  float* sRedS = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // [RG][SLICES][16][LDR]
  float* sRedP = sRedS + RG * SLICES * 16 * LDR;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, rg = warp / SLICES, sl = warp % SLICES;
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
  const bf16* wK = sK + 16 * rg * LD + sl * DS;
  const bf16* wV = sV + 16 * rg * LD + sl * DS;
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
    const bf16* cQ = sQ + stage * BQ * LD + sl * DS;
    const bf16* cdO = sdO + stage * BQ * LD + sl * DS;

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
    warp_mma_abt<DS / 16, NT_S>(st, wK, LD, cQ, LD);
    warp_mma_abt<DS / 16, NT_S>(dpt, wV, LD, cdO, LD);
    if constexpr (SLICES > 1) {
      const int mine = (rg * SLICES + sl) * 16 * LDR, group = rg * SLICES * 16 * LDR;
      store_partial(sRedS + mine, LDR, st);
      store_partial(sRedP + mine, LDR, dpt);
      __syncthreads();
      load_total<NT_S, SLICES>(st, sRedS + group, LDR);
      load_total<NT_S, SLICES>(dpt, sRedP + group, LDR);
    }
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
  store_acc(dk, acc_k, mul_k, b, h, H, Sk, D, k0 + 16 * rg, sl * DS);
  store_acc(dv, acc_v, mul_v, b, h, H, Sk, D, k0 + 16 * rg, sl * DS);
}

template <int DS, int SLICES, int RG, int BQ>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int H,
                       int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<DS, SLICES, RG, BQ>();
  auto kernel = flash_bwd_dkv_kernel<DS, SLICES, RG, BQ>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * SLICES * RG, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk,
                                                   D, scale);
  return cudaGetLastError();
}

}  // namespace fa

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
  // Up to 160: one warp per 16 key rows, 4 warps, 32-query tiles. Wider: the
  // head dim in 4 slices, 2 row groups (8 warps, 32 key rows), 16-query tiles.
  switch (round_up(D, 16)) {
#define FA_CASE(DP)                                                                         \
  case DP:                                                                                  \
    return launch_dkv<DP, 1, 4, 32>(qp, kp, vp, dop, lp, dp, dkp, dvp, B, H, Sq, Sk, D,    \
                                    scale, st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS)                                                                         \
  case DS:                                                                                  \
    return launch_dkv<DS, 4, 2, 16>(qp, kp, vp, dop, lp, dp, dkp, dvp, B, H, Sq, Sk, D,    \
                                    scale, st);
    FA_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
