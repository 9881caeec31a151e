// Shared pieces of the flash-attention kernels (sm_90a, bf16 in, f32 accumulate).
//
// Layout: q/k/v/o and their gradients are (B, S, H, D) contiguous bf16, the
// layout of `ops.attention.attention`, read in place (no head split copy).
// Row statistics (lse, delta) are (B*H, S) f32.
//
// The backward kernels and the forward's narrow designs share one shape of
// work (the forward's 512-wide design, flash_attn_fwd.cu, uses warpgroups
// and wgmma instead). A block owns 16 * RG rows (of
// queries, or of keys for dK/dV) of one (batch, head) and walks the other
// sequence in tiles held in shared memory, double-buffered by cp.async. Its
// warps form RG row groups of SLICES warps; each warp of a row group owns 16
// rows and one DS-wide slice of the head dim, and keeps that slice of its
// output accumulator in registers (mma.sync m16n8k16, bf16 in, f32 out):
//   * SLICES = 1 for padded head dims up to 160 (the UNet's 40/80/160): a
//     warp owns whole rows;
//   * SLICES = 4 for wider heads (the VAE's 512): a 16 x 512 f32 accumulator
//     would not fit one warp's registers, so the head dim is cut in four. A
//     product over the head dim (Q K^T, dO V^T) is then split-K: each warp
//     adds its slice's share, the shares meet in shared memory, and every
//     warp of the row group reads back the same total.
// The head dim is zero-padded in shared memory (exact: a zero column adds 0
// to each product and gives a zero output column); ragged sequence ends are
// zero-filled on load and masked where they would count.
//
// Fragment layouts are the PTX ISA's for mma.m16n8k16: with g = lane / 4 and
// t = lane % 4, an A register holds two neighbouring columns (2t, 2t + 1) of
// row g or g + 8, and an accumulator tile holds (row g, cols 2t, 2t + 1) then
// (row g + 8, same cols). The accumulator tiles of 16 columns are the A
// fragment of the next product over those columns, so P and dS go from one
// product into the next without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kPadH = 8;  // bf16 row padding, elements: rows stay 16-byte aligned and
                          // the 8 rows of an ldmatrix fall in distinct banks
constexpr int kMaxHeadDim = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The padded head dims each kernel is built for, those of the models the port
// runs: SD-1.5's UNet (40, 80, 160 -> 48, 80, 160) and VAE (512, four slices
// of 128), and the tiny test configs (16, 32). Head dims round up to the
// next of these (narrow: a multiple of 16; wide: a quarter of a multiple of
// 64); any other is refused. ops/attention.py lists the same widths.
#define FA_NARROW_DIMS(X) X(16) X(32) X(48) X(80) X(160)
#define FA_WIDE_SLICES(X) X(128)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src unread).
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of head (b, h) of a (B, S, H, D) tensor into a
// [ROWS][LD] tile of DP columns, asynchronously, by the whole block; rows >= S
// and columns >= D are zero (D % 8 == 0: a 16-byte chunk is data or padding).
template <int ROWS, int DP, int LD>
__device__ inline void load_rows_async(bf16* dst, const bf16* src, int b, int h, int H, int S,
                                       int D, int row0) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8, s = row0 + r;
    const bool valid = s < S && c < D;
    const bf16* p = valid ? src + ((static_cast<size_t>(b) * S + s) * H + h) * D + c : src;
    cp_async16(dst + r * LD + c, p, valid);
  }
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8, and register j receives matrix j.
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8].
__device__ inline void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of two bf16, `lo` in the low half (the lower column).
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ inline void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
}

// One warp: acc[16][8 NT] += A[16][16 KS] * B[8 NT][16 KS]^T, with A and B
// row-major bf16 in shared memory (the contraction runs along their rows).
template <int KS, int NT>
__device__ inline void warp_mma_abt(float (&acc)[NT][4], const bf16* a, int lda, const bf16* b,
                                    int ldb) {
  static_assert(NT % 2 == 0, "n8 tiles go in pairs");
  const int lane = threadIdx.x % 32;
  const bf16* a_lane = a + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* b_lane = b + (lane % 8 + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a_lane + kk * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b_lane + n * 8 * ldb + kk * 16);
      mma_16816(acc[n], af, bf[0], bf[1]);
      mma_16816(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// One warp: acc[16][8 NT] += P[16][16 KS] * B[16 KS][8 NT], with P an
// accumulator (p[n] holds columns 8n..8n+7) rounded to bf16 here, and B
// row-major bf16 in shared memory, read transposed by ldmatrix.
template <int KS, int NT>
__device__ inline void warp_mma_pb(float (&acc)[NT][4], const float (&p)[2 * KS][4], const bf16* b,
                                   int ldb) {
  static_assert(NT % 2 == 0, "n8 tiles go in pairs");
  const int lane = threadIdx.x % 32;
  const bf16* b_lane = b + (lane % 8 + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, b_lane + kk * 16 * ldb + n * 8);
      mma_16816(acc[n], a, bv[0], bv[1]);
      mma_16816(acc[n + 1], a, bv[2], bv[3]);
    }
  }
}

// Split-K over the head dim, in two halves around a __syncthreads: each warp
// stores its partial 16 x 8NT tile, then every warp of the row group loads
// the sum of the PARTS partials, in the same order, so all hold one total.
template <int NT>
__device__ inline void store_partial(float* red, int ldr, const float (&c)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(red + g * ldr + n * 8 + 2 * t) = make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(red + (g + 8) * ldr + n * 8 + 2 * t) =
        make_float2(c[n][2], c[n][3]);
  }
}

template <int NT, int PARTS>
__device__ inline void load_total(float (&c)[NT][4], const float* red, int ldr) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  zero(c);
#pragma unroll
  for (int part = 0; part < PARTS; ++part) {
    const float* base = red + part * 16 * ldr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 lo = *reinterpret_cast<const float2*>(base + g * ldr + n * 8 + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(base + (g + 8) * ldr + n * 8 + 2 * t);
      c[n][0] += lo.x;
      c[n][1] += lo.y;
      c[n][2] += hi.x;
      c[n][3] += hi.y;
    }
  }
}

// One warp's accumulator (rows row0 + [0, 16), columns col0 + [0, 8 NT)) times
// `mul` (per row half: rows g and g + 8), rounded to bf16, into head (b, h)
// of a (B, S, H, D) tensor; rows >= S and columns >= D are dropped.
template <int NT>
__device__ inline void store_acc(bf16* dst, const float (&c)[NT][4], const float (&mul)[2], int b,
                                 int h, int H, int S, int D, int row0, int col0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    bf16* out = dst + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = col0 + n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(c[n][2 * r] * mul[r], c[n][2 * r + 1] * mul[r]);
    }
  }
}

// --- wgmma and mbarrier (sm_90a), for the kernels that use them (the
// forward's wide design, K7).

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still in flight
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading an accumulator before the wait above it.
template <int N>
__device__ inline void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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

// Checks shared by the three entry points; 0 when the shape is taken.
inline cudaError_t check_shape(int B, int H, int Sq, int Sk, int D) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 8 || D % 8 != 0 || D > kMaxHeadDim ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace fa
