// K7: y = conv3x3(silu(x * A + B), w) + bias, stride 1, zero padding 1, with
// A and B per (batch, input channel): a GroupNorm(+shift) + SiLU prologue
// fused into the convolution that follows it.
//
// Replaces the TPU kernel `_fused_kernel` of
// diffusion_image_editing_tpu/ops/fused_conv.py (nine shifted matmuls over a
// VMEM-resident NHWC image, f32 accumulation over Cin tiles).
//
// Layout: x (N, Cin, H, W) and y (N, Cout, H, W) bf16; A and B (N, Cin) f32;
// bias (Cout) bf16 or f32; the weights packed by `ops/fused_conv.py` as
// wp (9, chunks, Cout, KC) bf16: per tap and chunk of KC = 64 input channels
// (Cin zero-padded to whole chunks) every output channel's row of 128 bytes,
// its 16-byte pieces already in the order they take in shared memory.
//
// Bound on the H100: tensor-core operations at most of the SD shapes
// (2 * N * H * W * Cout * 9 * Cin), bytes where the weights dominate
// (8 x 8 x 1280). What the design does about it:
//   * An implicit GEMM with the batch folded into M: M = N * H * W output
//     pixels, N = Cout, K = 9 * Cin. A block owns BM = 128 consecutive pixels
//     (of one image or, where H * W < 128, of several) and BN = 128 or 160
//     output channels (160 where it pads Cout no more: 320, 640 and 1280
//     then fill 128 blocks at the UNet's shapes), and walks Cin in chunks of
//     KC channels, nine taps a chunk; one (tap, chunk) is a step.
//   * Products by wgmma: two warpgroups of 64 pixels each start, a step, four
//     asynchronous m64nBNk16 products into f32 accumulators in registers. The
//     A operand comes from registers: a warp's fragment is what ldmatrix
//     gives for its 16 pixels, so a tap is an address offset into the
//     pixel-major patch and ragged tiles (rows of a padded patch, several
//     images) need no shared-memory descriptor, which would want one stride
//     between 8-row groups. The B operand is the step's weight tile in shared
//     memory, K-major in the 128-byte swizzle, named by a descriptor. A
//     warpgroup waits for its own step s - 1 before it loads step s's
//     fragments; the other warpgroup's products fill the gap.
//   * Weights: a step's tile of BN rows is one contiguous block of the packed
//     weights. One thread asks for it with one bulk copy (cp.async.bulk)
//     into a ring of NS slots, three steps ahead; an mbarrier a slot flips
//     when the bytes have landed. No thread spends instructions on copying,
//     and no 16-byte request goes through the load/store units.
//   * The activated patch: the pixels a block's taps touch, pixel-major with
//     the chunk's 64 channels contiguous. It cannot be copied asynchronously:
//     each value passes x * A + B, SiLU and a transpose from NCHW. A thread
//     owns a unit of 8 channels x 8 pixels of a patch row. It loads the next
//     chunk's unit with eight 16-byte loads along W under a chunk's first
//     step, keeps it in registers, and under each of the other eight steps
//     activates one pixel's 8 channels and stores them as 16 bytes (8 lanes
//     write 128 contiguous bytes). SiLU costs one special-function operation
//     a value (tanh.approx), since that unit's rate, not the arithmetic, is
//     what the patch would otherwise wait for. Two patch buffers alternate.
//     The halo (rows and columns outside an image, between folded images
//     too) is zeroed once and never written: the conv pads AFTER the
//     activation, and silu(0 * A + B) != 0.
//   * Under a spatial split (the rows of every map over ranks) x holds a
//     rank's H rows with a neighbour's row above and below, H + 2 rows an
//     image, and `halo` says which of the two are image rows (kTopReal,
//     kBottomReal) and which the image's edge. A real halo row is loaded
//     and activated like any other patch row; an edge stays zero. The
//     flags hold for every image of a launch, so each patch row of a block
//     is real or halo for all its chunks and "zeroed once" still holds. H
//     may then be as small as one row.
//   * One __syncthreads a step, after the step's products are started and so
//     under them, frees step s - 1's weight slot and, every ninth step, hands
//     over a patch buffer.
//   * Where the grid would not fill the card (the 32, 16 and 8 px stages at
//     batch 2), Cin's chunks are split `splits` ways over blockIdx.z: each
//     split writes f32 partial sums and a second kernel adds them in split
//     order, adds bias and rounds (deterministic; no atomics).
//     `ops/fused_conv.py` chooses BN (`tile_cout`) and `splits` (`cin_splits`).
//   * The epilogue stages the f32 tile through shared memory as
//     [cout][pixel] and writes NCHW rows with 16-byte stores.

#include "flash_attn_common.cuh"

namespace fc {

using fa::bf16;
using fa::fence_operands;
using fa::mbar_init;
using fa::mbar_wait;
using fa::wgmma_commit;
using fa::wgmma_fence;
using fa::wgmma_wait;

constexpr int BM = 128;            // output pixels a block
constexpr int KC = 64;             // input channels a chunk: 128 bytes a weight row
constexpr int NS = 4;              // weight ring slots
constexpr int AHEAD = NS - 1;      // steps a weight tile is asked for ahead of its products
constexpr int LDA = KC + 8;        // patch pitch, bf16: 144 bytes, ldmatrix without conflicts
constexpr int LDO = BM + 4;        // epilogue tile pitch, f32
constexpr int kThreads = 256;      // two warpgroups, 64 pixels each
constexpr int kMinHW = 4, kMaxHW = 64;
// Bits of `halo`: x holds H + 2 rows an image; the row above / below the
// image's H rows is an image row (else the image's edge, zero padding).
constexpr int kHaloRows = 1, kTopReal = 2, kBottomReal = 4;
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90

__host__ __device__ constexpr int slot_elems(int BN) { return BN * KC; }

__device__ __forceinline__ float load_param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// The padded row of global pixel gp: every image has H + 2 rows, the first
// and last of them halo.
__host__ __device__ inline int padded_row(int gp, int HW, int H, int W) {
  return (gp / HW) * (H + 2) + (gp % HW) / W + 1;
}

// Whether the last of `splits` runs of ceil(chunks / splits) chunks is empty.
__host__ __device__ inline bool empty_split(int Cin, int splits) {
  const int chunks = (Cin + KC - 1) / KC, per_split = (chunks + splits - 1) / splits;
  return (splits - 1) * per_split >= chunks;
}

// One unit of the activated patch: 8 channels x 8 pixels of a patch row.
struct Unit {
  const bf16* src;   // x at (image, channel 8 cg of chunk 0, row, pixel 8 xo)
  int coef;          // offset into A and B of (image, channel 8 cg of chunk 0)
  int dst;           // patch offset of (row, pixel 8 xo, channel 8 cg), in bf16
  int cols;          // pixels of the unit inside the row (0: no unit, or a halo row)
  int c;             // channel 8 cg
};

__device__ __forceinline__ Unit make_unit(int u, int units, const bf16* x, int Cin, int H, int W,
                                          int row_lo, int halo) {
  const int XO = (W + 7) / 8, PW = W + 2;
  const int cg = u % 8, xo = (u / 8) % XO, pr = u / (8 * XO);
  const int rg = row_lo + pr, n = rg / (H + 2), yy = rg % (H + 2) - 1;
  const bool rows = halo & kHaloRows;  // x holds the halo rows: row yy of x is yy + 1
  const bool real = (yy >= 0 && yy < H) || (yy < 0 && (halo & kTopReal)) ||
                    (yy >= H && (halo & kBottomReal));
  const int XH = rows ? H + 2 : H, xr = rows ? yy + 1 : max(yy, 0);
  Unit t;
  t.c = cg * 8;
  t.cols = (u < units && real) ? min(8, W - xo * 8) : 0;
  t.src = x + (static_cast<size_t>(n * Cin + t.c) * XH + xr) * W + xo * 8;
  t.coef = n * Cin + t.c;
  t.dst = (pr * PW + 1 + xo * 8) * LDA + t.c;
  return t;
}

struct UnitRegs {
  uint32_t raw[8][4];  // [channel][pixel pair]
  float a[8], b[8];
};

// Chunk c0's values of a unit, and its coefficients; XHW is x's channel
// stride. Channels past Cin give zeros with a = b = 0 (silu(0) = 0: what
// the zero-padded weights expect).
__device__ __forceinline__ void unit_load(UnitRegs& r, const Unit& t, const float* A,
                                          const float* B, int c0, int Cin, int XHW, bool vec) {
  if (t.cols == 0) return;
  if (c0 + t.c >= Cin) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r.raw[k][0] = r.raw[k][1] = r.raw[k][2] = r.raw[k][3] = 0u;
      r.a[k] = r.b[k] = 0.0f;
    }
    return;
  }
  const bf16* src = t.src + static_cast<size_t>(c0) * XHW;
  if (vec) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 q = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(k) * XHW);
      r.raw[k][0] = q.x, r.raw[k][1] = q.y, r.raw[k][2] = q.z, r.raw[k][3] = q.w;
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = 2 * j < t.cols ? s[static_cast<size_t>(k) * XHW + 2 * j] : 0u;
        const uint32_t hi = 2 * j + 1 < t.cols ? s[static_cast<size_t>(k) * XHW + 2 * j + 1] : 0u;
        r.raw[k][j] = lo | (hi << 16);
      }
    }
  }
  const int off = t.coef + c0;
  const float4 a0 = *reinterpret_cast<const float4*>(A + off);
  const float4 a1 = *reinterpret_cast<const float4*>(A + off + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(B + off);
  const float4 b1 = *reinterpret_cast<const float4*>(B + off + 4);
  r.a[0] = a0.x, r.a[1] = a0.y, r.a[2] = a0.z, r.a[3] = a0.w;
  r.a[4] = a1.x, r.a[5] = a1.y, r.a[6] = a1.z, r.a[7] = a1.w;
  r.b[0] = b0.x, r.b[1] = b0.y, r.b[2] = b0.z, r.b[3] = b0.w;
  r.b[4] = b1.x, r.b[5] = b1.y, r.b[6] = b1.z, r.b[7] = b1.w;
}

// silu(x a + b) as h + h tanh(h) with h = (x a + b) / 2: one special-function
// operation a value (tanh.approx: relative error 2^-11, under bf16's rounding).
__device__ __forceinline__ float silu_affine(uint32_t pair, int half, float a, float b) {
  const float xv = __uint_as_float(half ? (pair & 0xffff0000u) : (pair << 16));
  const float h = 0.5f * fmaf(xv, a, b);
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

// Pixel J of the unit: its 8 channels activated, rounded and stored as 16 bytes.
template <int J>
__device__ __forceinline__ void unit_store(const UnitRegs& r, const Unit& t, bf16* patch) {
  if (J >= t.cols) return;
  uint4 q;
  q.x = fa::pack_bf16(silu_affine(r.raw[0][J / 2], J % 2, r.a[0], r.b[0]),
                      silu_affine(r.raw[1][J / 2], J % 2, r.a[1], r.b[1]));
  q.y = fa::pack_bf16(silu_affine(r.raw[2][J / 2], J % 2, r.a[2], r.b[2]),
                      silu_affine(r.raw[3][J / 2], J % 2, r.a[3], r.b[3]));
  q.z = fa::pack_bf16(silu_affine(r.raw[4][J / 2], J % 2, r.a[4], r.b[4]),
                      silu_affine(r.raw[5][J / 2], J % 2, r.a[5], r.b[5]));
  q.w = fa::pack_bf16(silu_affine(r.raw[6][J / 2], J % 2, r.a[6], r.b[6]),
                      silu_affine(r.raw[7][J / 2], J % 2, r.a[7], r.b[7]));
  *reinterpret_cast<uint4*>(patch + t.dst + J * LDA) = q;
}

__device__ __forceinline__ void unit_store_all(const UnitRegs& r, const Unit& t, bf16* patch) {
  unit_store<0>(r, t, patch);
  unit_store<1>(r, t, patch);
  unit_store<2>(r, t, patch);
  unit_store<3>(r, t, patch);
  unit_store<4>(r, t, patch);
  unit_store<5>(r, t, patch);
  unit_store<6>(r, t, patch);
  unit_store<7>(r, t, patch);
}

// --- wgmma (sm_90a): D[64 x BN] += A[64 x 16] * B[BN x 16]^T for one warpgroup,
// asynchronous. A comes from registers: a warp's four registers are the
// 16-row fragment that ldmatrix_x4 gives (the m16n8k16 A fragment), warp w of
// the warpgroup holding rows 16 w .. 16 w + 15. B comes from shared memory
// through a descriptor. d[4 j + r] is column 8 j + 2 (lane % 4) + r % 2 of
// row 16 w + lane / 4 + 8 (r / 2). With scale_d == 0 the product replaces D:
// the accumulators are then written by wgmma alone, which ptxas needs in
// order to keep the products of a step in flight together.

// Descriptor of a K-major tile of rows of 64 bf16 (128 bytes) in the
// 128-byte swizzle, 1024-byte aligned: 8-row groups 1024 bytes apart. The
// k16 step kk starts 32 kk bytes into the row.
__device__ __forceinline__ uint64_t weight_desc(const bf16* tile, int kk) {
  const uint64_t addr = (fa::smem_addr(tile) + 32 * kk) >> 4;
  return (addr & 0x3fff) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

#define FC_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  static_assert(BN == 128 || BN == 160, "the cout tiles this kernel is built for");
  if constexpr (BN == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : FC_D8(0), FC_D8(8), FC_D8(16), FC_D8(24), FC_D8(32), FC_D8(40), FC_D8(48), FC_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : FC_D8(0), FC_D8(8), FC_D8(16), FC_D8(24), FC_D8(32), FC_D8(40), FC_D8(48), FC_D8(56),
        FC_D8(64), FC_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
}

// --- The bulk copy that reports to an mbarrier (sm90_async.cuh).

// Weight tile of step (tap, chunk), rows co0 .. co0 + rows of it, into a ring
// slot: one bulk copy of rows * 128 contiguous bytes (the packed weights hold
// the tile as it lies in shared memory, swizzle included), asked for by one
// thread; `bar` flips when the bytes have landed. Rows past Cout are not
// copied: what the slot holds there only reaches output columns past Cout.
__device__ __forceinline__ void load_weights(bf16* slot, uint64_t* bar, const bf16* wp, int tap,
                                             int chunk, int chunks, int co0, int rows, int Cout) {
  const bf16* src = wp + ((static_cast<size_t>(tap) * chunks + chunk) * Cout + co0) * KC;
  const unsigned bytes = rows * KC * static_cast<unsigned>(sizeof(bf16));
  sm90::expect_bytes(bar, bytes);
  sm90::bulk_load(slot, src, bytes, bar);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ A,
                      const float* __restrict__ B, const bf16* __restrict__ wp,
                      const void* __restrict__ bias, int bias_f32, bf16* __restrict__ y,
                      float* __restrict__ partial, int N, int Cin, int CinPad, int Cout, int H,
                      int W, int halo, int splits, int patch_elems) {
  constexpr int NT = BN / 8;    // n8 column groups of a thread's accumulator
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);        // [NS][BN][KC], swizzled
  bf16* patch0 = ring + NS * slot_elems(BN);          // 2 x [rows][W + 2][LDA]
  uint64_t* full = reinterpret_cast<uint64_t*>(patch0 + 2 * patch_elems);  // [NS]: a slot's
                                                                           // weights have landed

  const int HW = H * W, PW = W + 2, M = N * HW;
  const int XHW = ((halo & kHaloRows) ? H + 2 : H) * W;  // x's channel stride
  const int gp0 = blockIdx.x * BM, co0 = blockIdx.y * BN, split = blockIdx.z;
  const int chunks = CinPad / KC;
  const int per_split = (chunks + splits - 1) / splits;
  const int c_begin = split * per_split, c_end = min(chunks, c_begin + per_split);
  const int nsteps = max(0, c_end - c_begin) * 9;
  const int row_lo = padded_row(gp0, HW, H, W) - 1;
  const int rows = padded_row(min(gp0 + BM, M) - 1, HW, H, W) + 2 - row_lo;
  const int units = rows * ((W + 7) / 8) * 8;
  const bool vec = W % 8 == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Zero both patch buffers once: the halo is never written again.
  {
    uint4* p = reinterpret_cast<uint4*>(patch0);
    const int n16 = 2 * patch_elems * static_cast<int>(sizeof(bf16)) / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
  }

  const int w_rows = min(BN, Cout - co0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
    // ... and the bulk copies, which run in the asynchronous proxy, see them.
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // The first AHEAD weight tiles.
#pragma unroll
    for (int s = 0; s < AHEAD; ++s)
      if (s < nsteps)
        load_weights(ring + s * slot_elems(BN), &full[s], wp, s % 9, c_begin + s / 9, chunks, co0,
                     w_rows, Cout);
  }
  __syncthreads();

  // The first chunk's patch, every unit loaded and stored at once.
  const Unit mine = make_unit(threadIdx.x, units, x, Cin, H, W, row_lo, halo);
  UnitRegs regs;
  if (nsteps > 0) {
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const Unit t = make_unit(u, units, x, Cin, H, W, row_lo, halo);
      unit_load(regs, t, A, B, c_begin * KC, Cin, XHW, vec);
      unit_store_all(regs, t, patch0);
    }
  }

  // This lane's ldmatrix row of the A operand (warp w holds rows 16 w .. 16 w
  // + 15 of the tile), at tap (0, 0) and channel 0. Pixels past the end read a
  // real pixel; their rows are dropped.
  int a_off;
  {
    const int gp = min(gp0 + warp * 16 + lane % 16, M - 1);
    a_off = ((padded_row(gp, HW, H, W) - 1 - row_lo) * PW + (gp % HW) % W) * LDA + (lane / 16) * 8;
  }

  float acc[BN / 2];  // set, not added to, by the block's first product

  __syncthreads();  // the first patch is in place

  for (int ci = c_begin; ci < c_end; ++ci) {
    const int s0 = (ci - c_begin) * 9;
    bf16* pa = patch0 + ((ci - c_begin) & 1) * patch_elems;        // this chunk's patch
    bf16* pnext = patch0 + (((ci - c_begin) & 1) ^ 1) * patch_elems;  // the next chunk's
    const bool more = ci + 1 < c_end;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int s = s0 + tap;
      const bf16* bt = ring + (s % NS) * slot_elems(BN);
      const int toff = ((tap / 3) * PW + tap % 3) * LDA;
      uint64_t desc[KC / 16];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) desc[kk] = weight_desc(bt, kk);
      uint32_t af[KC / 16][4];
      mbar_wait(&full[s % NS], (s / NS) & 1);  // step s's weights have landed
      wgmma_wait<0>();  // step s - 1's products are done: the A registers are free
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) fa::ldmatrix_x4(af[kk], pa + a_off + toff + kk * 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) wgmma_rs<BN>(acc, af[kk], desc[kk], s > 0 || kk > 0);
      wgmma_commit();

      // Under the products: the next chunk's patch, and the hand-over of
      // step s + 1's weights.
      if (tap == 0 && more) unit_load(regs, mine, A, B, (ci + 1) * KC, Cin, XHW, vec);
      if (more) {
        if (tap == 1) unit_store<0>(regs, mine, pnext);
        if (tap == 2) unit_store<1>(regs, mine, pnext);
        if (tap == 3) unit_store<2>(regs, mine, pnext);
        if (tap == 4) unit_store<3>(regs, mine, pnext);
        if (tap == 5) unit_store<4>(regs, mine, pnext);
        if (tap == 6) unit_store<5>(regs, mine, pnext);
        if (tap == 7) unit_store<6>(regs, mine, pnext);
        if (tap == 8) {
          unit_store<7>(regs, mine, pnext);
          // Patches of more than kThreads units (narrow maps folded over many
          // images): the rest, not prefetched.
          for (int u = threadIdx.x + kThreads; u < units; u += kThreads) {
            const Unit t = make_unit(u, units, x, Cin, H, W, row_lo, halo);
            UnitRegs extra;
            unit_load(extra, t, A, B, (ci + 1) * KC, Cin, XHW, vec);
            unit_store_all(extra, t, pnext);
          }
        }
      }
      // Every warp is past its wait for step s - 1, whose slot is free, and
      // after a chunk's last tap the next patch is in place.
      __syncthreads();
      if (threadIdx.x == 0 && s + AHEAD < nsteps)
        load_weights(ring + ((s + AHEAD) % NS) * slot_elems(BN), &full[(s + AHEAD) % NS], wp,
                     (tap + AHEAD) % 9, ci + (tap + AHEAD) / 9, chunks, co0, w_rows, Cout);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Epilogue: the f32 tile as [cout][pixel] in shared memory (over the ring
  // and the patches), then rows of pixels to y (+ bias, bf16) or to this
  // split's partial sums.
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t4, m = warp * 16 + g;
    sOut[col * LDO + m] = acc[4 * nt];
    sOut[(col + 1) * LDO + m] = acc[4 * nt + 1];
    sOut[col * LDO + m + 8] = acc[4 * nt + 2];
    sOut[(col + 1) * LDO + m + 8] = acc[4 * nt + 3];
  }
  __syncthreads();
  const int valid_m = min(BM, M - gp0);
  const size_t total = static_cast<size_t>(M) * Cout;  // elements of y
  float* part = partial == nullptr ? nullptr : partial + static_cast<size_t>(split) * total;
  if (HW % 8 == 0) {  // then 8 pixels from a multiple of 8 lie in one image's row of y
    for (int i = threadIdx.x; i < BN * (BM / 8); i += kThreads) {
      const int col = i / (BM / 8), v = i % (BM / 8), co = co0 + col;
      if (co >= Cout || v * 8 >= valid_m) continue;
      const int gp = gp0 + v * 8;
      const size_t at = (static_cast<size_t>(gp / HW) * Cout + co) * HW + gp % HW;
      const float4 lo = *reinterpret_cast<const float4*>(sOut + col * LDO + v * 8);
      const float4 hi = *reinterpret_cast<const float4*>(sOut + col * LDO + v * 8 + 4);
      if (part != nullptr) {
        *reinterpret_cast<float4*>(part + at) = lo;
        *reinterpret_cast<float4*>(part + at + 4) = hi;
      } else {
        const float bv = load_param(bias, co, bias_f32);
        uint4 q;
        q.x = fa::pack_bf16(lo.x + bv, lo.y + bv);
        q.y = fa::pack_bf16(lo.z + bv, lo.w + bv);
        q.z = fa::pack_bf16(hi.x + bv, hi.y + bv);
        q.w = fa::pack_bf16(hi.z + bv, hi.w + bv);
        *reinterpret_cast<uint4*>(y + at) = q;
      }
    }
  } else {
    for (int i = threadIdx.x; i < BN * BM; i += kThreads) {
      const int col = i / BM, m = i % BM, co = co0 + col;
      if (co >= Cout || m >= valid_m) continue;
      const int gp = gp0 + m;
      const size_t at = (static_cast<size_t>(gp / HW) * Cout + co) * HW + gp % HW;
      const float v = sOut[col * LDO + m];
      if (part != nullptr)
        part[at] = v;
      else
        y[at] = __float2bfloat16_rn(v + load_param(bias, co, bias_f32));
    }
  }
}

// y = bf16(bias + the splits' partial sums, added in split order), VEC
// neighbouring pixels of one (image, cout) a thread.
template <int VEC>
__global__ void __launch_bounds__(256)
    fused_conv_reduce_kernel(const float* __restrict__ partial, const void* __restrict__ bias,
                             int bias_f32, bf16* __restrict__ y, int splits, int Cout, int HW,
                             long long total) {
  const long long e = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * VEC;
  if (e >= total) return;
  const float bv = load_param(bias, static_cast<int>((e / HW) % Cout), bias_f32);
  float sum[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum[i] = bv;
  for (int s = 0; s < splits; ++s) {
    const float* src = partial + s * total + e;
    if (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      sum[0] += q.x, sum[1] += q.y, sum[2] += q.z, sum[3] += q.w;
    } else {
      sum[0] += src[0];
    }
  }
  if (VEC == 4) {
    uint2 q;
    q.x = fa::pack_bf16(sum[0], sum[1]);
    q.y = fa::pack_bf16(sum[2], sum[3]);
    *reinterpret_cast<uint2*>(y + e) = q;
  } else {
    y[e] = __float2bfloat16_rn(sum[0]);
  }
}

template <int BN>
cudaError_t launch(const bf16* x, const float* a, const float* b, const bf16* wp, const void* bias,
                   int bias_f32, bf16* y, float* part, int splits, int N, int Cin, int CinPad,
                   int Cout, int H, int W, int halo, cudaStream_t st) {
  const int HW = H * W, M = N * HW, tiles = (M + BM - 1) / BM;
  int rows = 0;  // the tallest patch of any block
  for (int t = 0; t < tiles; ++t)
    rows = max(rows, padded_row(min((t + 1) * BM, M) - 1, HW, H, W) + 3 -
                         padded_row(t * BM, HW, H, W));
  const int patch_elems = rows * (W + 2) * LDA;
  const size_t loop_smem = (NS * slot_elems(BN) + 2 * patch_elems) * sizeof(bf16) +
                           NS * sizeof(uint64_t);  // ring, patches, mbarriers
  const size_t smem = max(loop_smem, static_cast<size_t>(BN) * LDO * sizeof(float));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (Cout + BN - 1) / BN, splits);
  fused_conv_kernel<BN><<<grid, kThreads, smem, st>>>(x, a, b, wp, bias, bias_f32, y, part, N, Cin,
                                                      CinPad, Cout, H, W, halo, splits,
                                                      patch_elems);
  return cudaGetLastError();
}

}  // namespace fc

// Takes 4 <= H, W <= 64 (1 <= H with halo rows), Cin % 8 == 0, CinPad a
// multiple of 64 that holds Cin, BN of 128 or 160, 1 <= splits <= the chunks
// of Cin and `halo` 0 or kHaloRows with any of kTopReal and kBottomReal;
// anything else returns cudaErrorInvalidValue. x holds H + 2 rows an image
// with kHaloRows, H without; y has H. With splits > 1, `partial` is scratch
// of at least splits * N * Cout * H * W floats (`scratch_floats`). Returns a
// cudaError_t.
extern "C" int affine_silu_conv3x3(int device, const void* x, const void* a, const void* b,
                                   const void* wp, const void* bias, int bias_f32, void* y,
                                   void* partial, long long scratch_floats, int splits, int BN,
                                   int N, int Cin, int CinPad, int Cout, int H, int W, int halo,
                                   void* stream) {
  using namespace fc;
  const long long out_elems = static_cast<long long>(N) * Cout * H * W;
  const bool rows = halo & kHaloRows;
  if (N < 1 || Cin < 8 || Cin % 8 != 0 || CinPad != (Cin + KC - 1) / KC * KC || Cout < 1 ||
      (halo & ~(kHaloRows | kTopReal | kBottomReal)) != 0 || (halo != 0 && !rows) ||
      H < (rows ? 1 : kMinHW) || H > kMaxHW || W < kMinHW || W > kMaxHW ||
      (BN != 128 && BN != 160) ||
      splits < 1 || splits > (Cin + KC - 1) / KC || empty_split(Cin, splits) ||
      (Cout + BN - 1) / BN > 65535 ||
      static_cast<long long>(N) * Cin * (H + 2) * W >= (1LL << 31) ||
      out_elems >= (1LL << 31) ||
      static_cast<long long>(Cout) * CinPad * 9 >= (1LL << 31) ||
      (splits > 1 && (partial == nullptr || scratch_floats < out_elems * splits)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto run = BN == 160 ? launch<160> : launch<128>;
  err = run(static_cast<const bf16*>(x), static_cast<const float*>(a),
            static_cast<const float*>(b), static_cast<const bf16*>(wp), bias, bias_f32,
            static_cast<bf16*>(y), part, splits, N, Cin, CinPad, Cout, H, W, halo, st);
  if (err != cudaSuccess || part == nullptr) return err;
  const int HW = H * W;
  if (HW % 4 == 0)
    fused_conv_reduce_kernel<4><<<static_cast<unsigned>((out_elems / 4 + 255) / 256), 256, 0, st>>>(
        part, bias, bias_f32, static_cast<bf16*>(y), splits, Cout, HW, out_elems);
  else
    fused_conv_reduce_kernel<1><<<static_cast<unsigned>((out_elems + 255) / 256), 256, 0, st>>>(
        part, bias, bias_f32, static_cast<bf16*>(y), splits, Cout, HW, out_elems);
  return cudaGetLastError();
}
