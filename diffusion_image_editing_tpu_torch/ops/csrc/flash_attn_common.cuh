// Shared pieces of the flash-attention kernels (sm_90a, bf16 in, f32 accumulate).
//
// Layout: q/k/v/o and their gradients are (B, S, H, D) contiguous bf16, the
// layout of `ops.attention.attention`, read in place (no head split copy).
// Row statistics (lse, delta) are (B*H, S) f32.
//
// The narrow designs of all three kernels share one shape of work (the
// 512-wide designs, and K1's at 160, use warpgroups, wgmma and TMA instead,
// from the helpers at the end of this file). A block owns 16 * RG rows (of queries, or of
// keys for dK/dV) of one (batch, head) and walks the other sequence in
// tiles held in shared memory, double-buffered by cp.async. Each warp owns
// 16 whole rows of the padded head dim (up to 160: the UNet's 40/80/160)
// and keeps its output accumulator in registers (mma.sync m16n8k16, bf16
// in, f32 out).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kPadH = 8;  // bf16 row padding, elements: rows stay 16-byte aligned and
                          // the 8 rows of an ldmatrix fall in distinct banks
constexpr int kMaxHeadDim = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The padded head dims each kernel is built for, those of the models the port
// runs: SD-1.5's UNet (40, 80, 160 -> 48, 80, 160), the LDM UNet (32), the
// VAEs' and the DDPM UNet's single head (512, four slices of 128), and the
// tiny test configs (16, 32, and TINY_UNET2D's single head, 64). Head dims
// round up to the next of these (narrow: a multiple of 16; wide: a quarter of
// a multiple of 64); any other is refused. ops/attention.py lists the same
// widths.
#define FA_NARROW_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(160)
#define FA_WIDE_SLICES(X) X(128)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

using sm90::smem_addr;

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
// wide designs of K1-K3, K1's at 160).

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

using sm90::mbar_init;  // sm90_async.cuh
using sm90::mbar_wait;

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

// 2^x on the special-function unit; flushes subnormal results to 0 (a
// probability below 2^-126 of the row maximum adds nothing in bf16 or f32).
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- For the 512-wide designs of K1 (flash_attn_fwd.cu), K2
// (flash_attn_bwd_dq.cu) and K3 (flash_attn_bwd_dkv.cu), and K1's at 160:
// tensor maps, TMA boxes, wgmma from shared memory and from registers.

// One box of a (B, S, H, D) tensor's map, columns [c, c + 64) of rows
// [row, row + rows) of head (b, h), into shared memory at dst in the
// 128-byte swizzle, by the tensor memory accelerator; `bar` counts its
// bytes. Rows and columns outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, int c, int h,
                                        int row, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(h), "r"(row), "r"(b), "r"(smem_addr(bar))
      : "memory");
}
// The reverse of tma_box: one box of the map's tensor from shared memory at
// src, written by the tensor memory accelerator (a bulk group of this
// thread's); rows and columns outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int c, int h,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
          "l"(reinterpret_cast<uint64_t>(&map)),
      "r"(c), "r"(h), "r"(row), "r"(b), "r"(src)
      : "memory");
}
// `box` floats of a 1-D f32 map from element x (x * 4 a multiple of 16: the
// copy faults otherwise), into shared memory at dst; past the end, zeros.
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap& map, int x,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(smem_addr(bar))
      : "memory");
}
using sm90::expect_bytes;

__device__ __forceinline__ void warpgroups_sync() {  // both warpgroups, not the cluster
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Shared-memory matrix descriptor in the 128-byte swizzle (1024-byte atoms):
// `lbo` and `sbo` in bytes. K-major (Q, K): sbo = 1024 between 8-row groups,
// lbo unused; the k16 step kk starts 32 kk bytes into the atom's rows.
// MN-major (V): lbo between 64-column atoms, sbo = 1024 between 8-key groups.
// `layout` 2 is the 64-byte swizzle (512-byte atoms of 32 columns): sbo =
// 512 between 8-row groups, lbo between 32-column atoms of an MN-major V.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint32_t layout = 1) {
  return ((addr >> 4) & 0x3fff) | (uint64_t((lbo >> 4) & 0x3fff) << 16) |
         (uint64_t((sbo >> 4) & 0x3fff) << 32) | (uint64_t(layout) << 62);
}

#define FA_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// C[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory
// (K1: S = Q K^T; K2: dP = dO V^T).
__device__ __forceinline__ void wgmma_s(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory
// (K1's 160-wide design: S = Q K^T).
__device__ __forceinline__ void wgmma_s64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[64 x 32] (+)= A[64 x 16] B[32 x 16]^T: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B K-major in shared memory (K2: S = Q
// K^T; K3: S^T = K Q^T, dP^T = V dO^T).
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// This warp's A fragments of a [4][ROWS][64] tile of 64-column boxes in the
// 128-byte swizzle at `tile` (ROWS = 64, one wgmma M), one k16 step kk of
// its 256 columns each: ldmatrix matrices (rows 0-7, 8-15) x (columns 0-7,
// 8-15) of the step are the fragment's four registers. Within a box,
// 16-byte chunk c of row r lies at r * 128 + (c ^ r % 8) * 16.
template <int ROWS>
__device__ __forceinline__ void load_fragments(uint32_t (&a)[16][4], uint32_t tile, int warp,
                                               int lane) {
  const int row = 16 * warp + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int chunk = 2 * (kk % 4) + lane / 16;
    const uint32_t addr = tile + (kk / 4) * ROWS * 128 + row * 128 + ((chunk ^ (row % 8)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

// C[64 x 256] += A[64 x 16] B[16 x 256]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (trans-b)
// (K1: O += P V; K3: dV += P^T dO, dK += dS^T Q).
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56),
        FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88), FA_D8(96), FA_D8(104), FA_D8(112), FA_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// C[64 x 160] += A[64 x 16] B[16 x 160]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (trans-b)
// (K1's 160-wide design: O += P V).
__device__ __forceinline__ void wgmma_pv160(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56),
        FA_D8(64), FA_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points, so the
// library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                              reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  *out = encode;
  return cudaSuccess;
}

// The map of a (B, S, H, D) bf16 tensor in boxes of `cols` columns x `rows`
// rows of one head, in `swizzle` (a row of the box is its width: 64 columns
// in the 128-byte swizzle, 32 in the 64-byte one); outside the tensor a box
// reads zeros.
inline cudaError_t encode_map(CUtensorMap* map, const bf16* x, int B, int S, int H, int D,
                              int rows, int cols = 64,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};  // bytes, dims 1-3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of n contiguous floats (K3's lse and delta) in boxes of `box`.
inline cudaError_t encode_row_map(CUtensorMap* map, const float* x, long long n, int box) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};  // unread for one dimension
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(x),
                              dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace fa
