// K1: flash-attention forward, O = softmax(Q K^T * scale) V and, when asked,
// the per-row log-sum-exp.
//
// Replaces the TPU kernels `_resident_kernel` and `_streaming_kernel` of
// diffusion_image_editing_tpu/ops/attention.py: on this card the two compute
// the same function, so one kernel serves every attention of the SD path,
// the ragged 77-token cross-attention and the 64-token mid block included.
//
// Bound on the H100: tensor-core operations at the 4096-token shapes
// (4 * Sq * Sk * D per head), bytes at the short ones. A block owns 16 * RG
// query rows and walks the keys in BK-row tiles, double-buffered by cp.async
// so the next tile's load overlaps this tile's products: S = Q K^T (split-K
// across the SLICES warps of a row group for wide heads), an online softmax
// per row in f32 and base 2, then O = alpha * O + P V with P rounded to bf16
// and fed from registers. O stays in registers until the end.

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
  // Up to 160: one warp per 16 rows, 4 warps, 64-key tiles. Wider: the head
  // dim in 4 slices, 2 row groups (8 warps, 32 rows), 32-key tiles.
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
