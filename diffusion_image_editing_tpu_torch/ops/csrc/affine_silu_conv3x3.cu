// K7: y = conv3x3(silu(x * A + B), w) + bias, stride 1, zero padding 1, with
// A and B per (batch, input channel): a GroupNorm(+shift) + SiLU prologue
// fused into the convolution that follows it.
//
// Replaces the TPU kernel `_fused_kernel` of
// diffusion_image_editing_tpu/ops/fused_conv.py (nine shifted matmuls over a
// VMEM-resident NHWC image, f32 accumulation over Cin tiles).
//
// Layout: x (N, Cin, H, W) and y (N, Cout, H, W) bf16, w (Cout, Cin, 3, 3)
// bf16 (PyTorch's OIHW), A and B (N, Cin) f32, bias (Cout) bf16 or f32.
//
// An implicit GEMM per image: M = H * W output pixels, N = Cout, K = 9 * Cin.
// A block owns BM consecutive pixels of one image and BN output channels,
// and walks Cin in chunks of KC channels. For each chunk it
//   * stages the activated input patch in shared memory, pixel-major with the
//     chunk's channels contiguous (so a row of the GEMM's A operand, one
//     pixel under one tap, is 16 channels = 32 bytes at any shift): every
//     value is loaded as bf16, turned into x * A + B in f32, passed through
//     SiLU and rounded to bf16 on its way in. The halo (rows and columns
//     outside the image) stays zero: the conv pads AFTER the activation, and
//     silu(0 * A + B) != 0;
//   * stages the chunk's weights as [tap][cout][channel] (16-byte loads of
//     OIHW's contiguous Cin x 9 runs, scattered in shared memory);
//   * runs the nine taps as nine k16 steps of mma.sync m16n8k16 (bf16 in, f32
//     accumulators in registers; fragments by ldmatrix, a tap is an offset of
//     the patch address).
// The epilogue adds bias, rounds to bf16, stages the tile through shared
// memory and writes NCHW rows of pixels with 16-byte stores.
//
// Where the grid would hold too few blocks to fill the card (the UNet's 8 x 8
// and 16 x 16 stages, with Cin up to 2560: 20 to 40 blocks for 132 SMs), the
// Cin chunks are split `splits` ways over blockIdx.z: each split writes its
// f32 partial sums, and a second kernel adds the splits in split order, adds
// bias and rounds to bf16 (deterministic; no atomics). `ops/fused_conv.py`
// chooses `splits`.
//
// Bound on the H100: tensor-core operations at most of the SD shapes
// (2 * M * Cout * 9 * Cin), bytes where the weights dominate (8 x 8 x 1280).
// This first version keeps one buffer per chunk (loads do not overlap the
// products inside a block; two blocks share an SM) and recomputes the
// prologue in every block of the same pixels; wgmma and TMA come later.

#include "flash_attn_common.cuh"

namespace fc {

using fa::bf16;

constexpr int BM = 128;            // output pixels a block
constexpr int BN = 128;            // output channels a block
constexpr int KC = 16;             // input channels a chunk (one k16 step per tap)
constexpr int LDA = KC + 8;        // bf16 per staged row: 48 bytes, ldmatrix without conflicts
constexpr int LDO = BM + 8;        // epilogue tile pitch
constexpr int kThreads = 256;      // 8 warps: 4 along M x 2 along N, 32 x 64 each
constexpr int kMinHW = 4, kMaxHW = 64;
constexpr int kWeightVecs = KC * 9 / 8;  // 16-byte vectors of one cout's chunk of weights

__host__ __device__ constexpr int patch_rows(int W) { return (BM - 1) / W + 4; }

__host__ __device__ constexpr size_t smem_bytes(int W) {
  return (static_cast<size_t>(9) * BN * LDA + static_cast<size_t>(patch_rows(W)) * (W + 2) * LDA) *
         sizeof(bf16);
}

__device__ __forceinline__ float load_param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__global__ void __launch_bounds__(kThreads, 2)
    fused_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ A,
                      const float* __restrict__ B, const bf16* __restrict__ w,
                      const void* __restrict__ bias, int bias_f32, bf16* __restrict__ y,
                      float* __restrict__ partial, int Cin, int Cout, int H, int W,
                      int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);  // [9][BN][LDA], then the epilogue's [BN][LDO]
  bf16* sA = sB + 9 * BN * LDA;               // [rows][W + 2][LDA]

  const int HW = H * W, PW = W + 2;
  const int n = blockIdx.z / splits, split = blockIdx.z % splits;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int chunks_per_split = ((Cin + KC - 1) / KC + splits - 1) / splits;
  const int c_begin = split * chunks_per_split * KC;
  const int c_end = min(Cin, c_begin + chunks_per_split * KC);
  const int y_first = p0 / W;
  const int rows = (min(p0 + BM, HW) - 1) / W - y_first + 3;  // patch rows: y_first - 1 ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  // Zero the patch once: the halo is never written again.
  {
    uint4* p = reinterpret_cast<uint4*>(sA);
    const int n16 = rows * PW * LDA * static_cast<int>(sizeof(bf16)) / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
  }

  // This lane's ldmatrix row of the A operand for each m16 tile, at tap (0, 0).
  // Pixels past the image's end read a real pixel; their rows are dropped.
  int a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = min(p0 + wm * 32 + mt * 16 + lane % 16, HW - 1);
    a_off[mt] = ((p / W - y_first) * PW + p % W) * LDA + (lane / 16) * 8;
  }
  const int b_off = (wn * 64 + lane % 8 + (lane / 16) * 8) * LDA + ((lane / 8) % 2) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) fa::zero(acc[mt]);

  for (int c0 = c_begin; c0 < c_end; c0 += KC) {
    __syncthreads();  // the previous chunk's products are done with sA and sB

    // Activated patch: one warp per (channel, patch row), lanes along the row.
    for (int r = warp; r < KC * rows; r += kThreads / 32) {
      const int cl = r / rows, pr = r % rows, yy = y_first - 1 + pr, c = c0 + cl;
      if (yy < 0 || yy >= H) continue;  // halo row: stays zero
      bf16* dst = sA + (pr * PW + 1) * LDA + cl;
      if (c < Cin) {
        const float a = A[n * Cin + c], b = B[n * Cin + c];
        const bf16* src = x + (static_cast<size_t>(n * Cin + c) * H + yy) * W;
        for (int xx = lane; xx < W; xx += 32) {
          const float v = __bfloat162float(src[xx]) * a + b;
          dst[xx * LDA] = __float2bfloat16_rn(v / (1.0f + __expf(-v)));
        }
      } else {
        for (int xx = lane; xx < W; xx += 32) dst[xx * LDA] = __float2bfloat16_rn(0.0f);
      }
    }

    // Weights: cout co's channels c0 .. c0 + KC - 1 are KC * 9 contiguous
    // values of OIHW; scatter them to [tap][cout][channel].
    const int valid_vecs = min(KC, Cin - c0) * 9 / 8;  // Cin % 8 == 0
    for (int i = threadIdx.x; i < BN * kWeightVecs; i += kThreads) {
      const int col = i / kWeightVecs, v = i % kWeightVecs, co = co0 + col;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (co < Cout && v < valid_vecs)
        q = *reinterpret_cast<const uint4*>(w + (static_cast<size_t>(co) * Cin + c0) * 9 + v * 8);
      const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = v * 8 + j;
        sB[((e % 9) * BN + col) * LDA + e / 9] = h[j];
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * PW + tap % 3) * LDA;
      uint32_t af[2][4];
      fa::ldmatrix_x4(af[0], sA + a_off[0] + toff);
      fa::ldmatrix_x4(af[1], sA + a_off[1] + toff);
      const bf16* bt = sB + tap * BN * LDA + b_off;
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bf[4];
        fa::ldmatrix_x4(bf, bt + nt * 8 * LDA);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fa::mma_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
          fa::mma_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  const int g = lane / 4, t = lane % 4;
  if (partial != nullptr) {
    // Split: this split's f32 sums, [split][n][cout][pixel]; 8 lanes write 32
    // contiguous bytes of one cout.
    float* out = partial + static_cast<size_t>(blockIdx.z) * Cout * HW;  // z = n * splits + split
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = co0 + wn * 64 + nt * 8 + 2 * t + (e & 1);
          const int p = p0 + wm * 32 + mt * 16 + g + 8 * (e >> 1);
          if (co < Cout && p < HW) out[static_cast<size_t>(co) * HW + p] = acc[mt][nt][e];
        }
      }
    }
    return;
  }

  // Epilogue: + bias, bf16, staged as [cout][pixel] for row-wise stores.
  __syncthreads();
  bf16* sOut = sB;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = wn * 64 + nt * 8 + 2 * t;
    const float b0 = co0 + col < Cout ? load_param(bias, co0 + col, bias_f32) : 0.0f;
    const float b1 = co0 + col + 1 < Cout ? load_param(bias, co0 + col + 1, bias_f32) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = wm * 32 + mt * 16 + g;
      sOut[col * LDO + m] = __float2bfloat16_rn(acc[mt][nt][0] + b0);
      sOut[(col + 1) * LDO + m] = __float2bfloat16_rn(acc[mt][nt][1] + b1);
      sOut[col * LDO + m + 8] = __float2bfloat16_rn(acc[mt][nt][2] + b0);
      sOut[(col + 1) * LDO + m + 8] = __float2bfloat16_rn(acc[mt][nt][3] + b1);
    }
  }
  __syncthreads();
  const int valid_m = min(BM, HW - p0);
  if (HW % 8 == 0) {  // then p0 and valid_m are multiples of 8 too
    for (int i = threadIdx.x; i < BN * (BM / 8); i += kThreads) {
      const int col = i / (BM / 8), v = i % (BM / 8), co = co0 + col;
      if (co >= Cout || v * 8 >= valid_m) continue;
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(n * Cout + co) * HW + p0 + v * 8) =
          *reinterpret_cast<const uint4*>(sOut + col * LDO + v * 8);
    }
  } else {
    for (int i = threadIdx.x; i < BN * BM; i += kThreads) {
      const int col = i / BM, m = i % BM, co = co0 + col;
      if (co >= Cout || m >= valid_m) continue;
      y[static_cast<size_t>(n * Cout + co) * HW + p0 + m] = sOut[col * LDO + m];
    }
  }
}

// y = bf16(bias + the splits' partial sums, added in split order).
__global__ void __launch_bounds__(256)
    fused_conv_reduce_kernel(const float* __restrict__ partial, const void* __restrict__ bias,
                             int bias_f32, bf16* __restrict__ y, int splits, int Cout, int HW,
                             long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const long long per_image = static_cast<long long>(Cout) * HW;
  const long long n = e / per_image, rest = e % per_image;
  const float* src = partial + n * splits * per_image + rest;
  float sum = load_param(bias, static_cast<int>(rest / HW), bias_f32);
  for (int s = 0; s < splits; ++s) sum += src[s * per_image];
  y[e] = __float2bfloat16_rn(sum);
}

}  // namespace fc

// Takes 4 <= H, W <= 64 and Cin % 8 == 0 (16-byte rows of weights); any
// other shape returns cudaErrorInvalidValue. With splits > 1, `partial` is
// scratch of at least N * splits * Cout * H * W floats (`scratch_floats`).
// Returns a cudaError_t.
extern "C" int affine_silu_conv3x3(int device, const void* x, const void* a, const void* b,
                                   const void* w, const void* bias, int bias_f32, void* y,
                                   void* partial, long long scratch_floats, int splits, int N,
                                   int Cin, int Cout, int H, int W, void* stream) {
  using namespace fc;
  const long long out_elems = static_cast<long long>(N) * Cout * H * W;
  if (N < 1 || Cin < 8 || Cin % 8 != 0 || Cout < 1 || H < kMinHW || H > kMaxHW ||
      W < kMinHW || W > kMaxHW || splits < 1 || static_cast<long long>(N) * splits > 65535 ||
      static_cast<long long>(N) * Cin * H * W >= (1LL << 31) || out_elems >= (1LL << 31) ||
      static_cast<long long>(Cout) * Cin * 9 >= (1LL << 31) ||
      (splits > 1 && (partial == nullptr || scratch_floats < out_elems * splits)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(W);
  err = cudaFuncSetAttribute(fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN, N * splits);
  fused_conv_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(w), bias, bias_f32, static_cast<bf16*>(y), part, Cin, Cout, H, W,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  fused_conv_reduce_kernel<<<static_cast<unsigned>((out_elems + 255) / 256), 256, 0, st>>>(
      part, bias, bias_f32, static_cast<bf16*>(y), splits, Cout, H * W, out_elems);
  return cudaGetLastError();
}
