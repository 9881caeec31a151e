// K2: flash-attention backward, dQ.
//
// Replaces the TPU kernel `_bwd_dq_kernel` of
// diffusion_image_editing_tpu/ops/attention.py. A block owns 16 * RG query
// rows of one (batch, head) and walks the keys in BK-row tiles,
// double-buffered by cp.async, recomputing the probabilities from the
// forward's log-sum-exp instead of storing them:
//   P  = exp(S * scale - lse)        S  = Q K^T
//   dP = dO V^T
//   dS = P * (dP - delta)            delta = rowsum(dO * O), given
//   dQ += dS K                       (times scale once, at the end)
// Bound on the H100: tensor-core operations (6 * Sq * Sk * D per head). S and
// dP are split-K over the head-dim slices for wide heads; dS goes from the
// accumulators straight into the dS K product; dQ stays in registers. The dQ
// rows belong to this block alone: no atomics, a deterministic sum.

#include "flash_attn_common.cuh"

namespace fa {

template <int DS, int SLICES, int RG, int BK>
constexpr size_t dq_smem() {
  constexpr size_t ld = DS * SLICES + kPadH;
  return (2 * 16 * RG + 4 * BK) * ld * sizeof(bf16)  // Q, dO, then K and V twice
         + (SLICES > 1 ? 2 * RG * SLICES * 16 * (BK + 8) * sizeof(float) : 0);  // S, dP
}

template <int DS, int SLICES, int RG, int BK>
__global__ void __launch_bounds__(32 * SLICES * RG)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Sq, int Sk, int D, float scale) {
  constexpr int DP = DS * SLICES, LD = DP + kPadH, BQ = 16 * RG, LDR = BK + 8;
  constexpr int NT_S = BK / 8, NT_O = DS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;     // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]
  float* sRedS = reinterpret_cast<float*>(sV + 2 * BK * LD);  // [RG][SLICES][16][LDR]
  float* sRedP = sRedS + RG * SLICES * 16 * LDR;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, rg = warp / SLICES, sl = warp % SLICES;
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
    const int row = q0 + 16 * rg + g + 8 * r;
    const bool valid = row < Sq;
    lse2[r] = valid ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : 0.0f;
    dlt[r] = valid ? delta[static_cast<size_t>(bh) * Sq + row] : 0.0f;
  }

  float acc[NT_O][4];
  zero(acc);
  const bf16* wQ = sQ + 16 * rg * LD + sl * DS;
  const bf16* wdO = sdO + 16 * rg * LD + sl * DS;
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

    float s[NT_S][4], dp[NT_S][4];
    zero(s);
    zero(dp);
    warp_mma_abt<DS / 16, NT_S>(s, wQ, LD, cK, LD);
    warp_mma_abt<DS / 16, NT_S>(dp, wdO, LD, cV, LD);
    if constexpr (SLICES > 1) {
      const int mine = (rg * SLICES + sl) * 16 * LDR, group = rg * SLICES * 16 * LDR;
      store_partial(sRedS + mine, LDR, s);
      store_partial(sRedP + mine, LDR, dp);
      __syncthreads();
      load_total<NT_S, SLICES>(s, sRedS + group, LDR);
      load_total<NT_S, SLICES>(dp, sRedP + group, LDR);
    }

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
  store_acc(dq, acc, mul, b, h, H, Sq, D, q0 + 16 * rg, sl * DS);
}

template <int DS, int SLICES, int RG, int BK>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, bf16* dq, int B, int H, int Sq,
                      int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<DS, SLICES, RG, BK>();
  auto kernel = flash_bwd_dq_kernel<DS, SLICES, RG, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 16 * RG - 1) / (16 * RG), B * H);
  kernel<<<grid, 32 * SLICES * RG, smem, stream>>>(q, k, v, dout, lse, delta, dq, H, Sq, Sk, D,
                                                   scale);
  return cudaGetLastError();
}

}  // namespace fa

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
  // Up to 160: one warp per 16 rows, 4 warps, 32-key tiles. Wider: the head
  // dim in 4 slices, 2 row groups (8 warps, 32 rows), 16-key tiles.
  switch (round_up(D, 16)) {
#define FA_CASE(DP)                                                                          \
  case DP:                                                                                   \
    return launch_dq<DP, 1, 4, 32>(qp, kp, vp, dop, lp, dp, dqp, B, H, Sq, Sk, D, scale, st);
    FA_NARROW_DIMS(FA_CASE)
#undef FA_CASE
    default: break;
  }
  switch (round_up(D, 64) / 4) {
#define FA_CASE(DS)                                                                          \
  case DS:                                                                                   \
    return launch_dq<DS, 4, 2, 16>(qp, kp, vp, dop, lp, dp, dqp, B, H, Sq, Sk, D, scale, st);
    FA_WIDE_SLICES(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}
