// Flash attention forward in float32 on the tensor cores, in split TF32
// (sm_90a): every float32 head dim, and bfloat16 above 1,920.
//
// Replaces: ealdm_tpu/ops/attention.py `_flash_kernel` (via `_flash_forward`,
// public `flash_attention`) and `_flash_packed_kernel` (via
// `_flash_packed_forward`, public `flash_attention_packed`) for float32 at
// any head dim and for the bfloat16 head dims past the deep wgmma kernel's
// 1,920 (ops/attention.py routes them here; the entry refuses bfloat16 at or
// below 1,920). Q, K and V are addressed by (batch, head, row) strides with
// a contiguous head dimension, so [B,H,N,D], the head-strided view of a
// [B,N,H*D] projection and the packed layout all load without a copy.
//
// Math: both products on the tensor cores with mma.sync m16n8k8 TF32 (or
// wgmma m64nNk8 TF32, in the instances that take it), in split TF32. Each
// float32 operand x is split into hi = x cut to TF32 and lo = x - hi, and a
// product is hi*lo + lo*hi + hi*hi, accumulated in fp32 (lo*lo, about 2^-20
// of the product, is dropped): S = Q K^T and O = P V each err by about 1e-6
// of their scale, against about 1e-3 for one TF32 term, which the float32
// limit of 1e-4 refuses. bfloat16 inputs are exact in TF32, so S is one term and P V two (P's hi and lo
// against V). The scale is folded with log2(e) into the softmax's exponent
// (one FMA before ex2.approx), the running max, sum and O are fp32, as in
// the Pallas kernel; keys >= Nk are masked to -inf, rows >= Nq are not
// stored, output columns >= D are never written.
//
// Bound on this card: the tensor cores. Split TF32 is 3 x 4*B*H*Nq*Nk*D
// operations at 495 TFLOP/s (TF32, dense), above the bytes at every shape
// the float32 passes run. mma.sync issues a 16x8x8 product a warp, and the
// splits run on the ALU as fragments are loaded: per three products, two
// shared-memory loads and four ALU operations. The split is therefore two
// instructions an element: hi = x with its 13 low bits cleared (LOP3), lo =
// x - hi (FADD), of which the tensor core reads the top 11 bits. cvt.rna
// on both (the split of CUTLASS's 3xTF32) took 1.2-1.4x the kernel's time
// (`probe_flash f32`); the error stays about 1e-6.
//
// Design:
//  * A block is WR x WC warps: WR groups of 16 query rows, and WC warps a
//    group, each owning a slice of DW columns (DW = 32 to 160). The
//    block's CW = WC * DW columns are one strip of O (grid z; d > CW takes
//    more strips, each recomputing S) and one pass of S's depth (d > CW
//    takes more passes).
//  * S: each warp multiplies its depth slice of Q (fragments held in
//    registers for the whole key loop when d fits one pass, else reloaded
//    each pass; at d = 513 .. 640 read from a tile of Q in shared memory,
//    which frees the registers of O's 160 columns) by the same slice of the
//    K tile, so the WC warps of a row
//    group hold partial sums of S. They add them through shared memory in
//    rank order (named barrier per row group): every warp of the group then
//    holds the same S and runs the same online softmax.
//  * P V: the fp32 P stays in registers. The m16n8 C layout of S is not
//    the k8 A layout of TF32, so the keys of a k-step are taken in the order
//    2t, 2t + 1 -> t, t + 4: P's fragments are S's registers as they are,
//    and V's B fragments are read from [key][d] rows at keys 2t and 2t + 1
//    by LDS (no transpose: wgmma's transpose bits are for 16-bit types only).
//  * Tiles of BK keys x CW columns of K (one a pass) and V (the block's
//    strip) stream through a ring of cp.async stages, zero-filled past Nk
//    and D. Rows are padded by 16 bytes: the 8 rows of a K fragment and the
//    4 key pairs of a V fragment fall in distinct banks.
//  * The splits happen as fragments are loaded, in registers: Q's once a
//    k-step for all key n-tiles, K's and V's at each load, P's once a tile.
//    Staging hi and lo tiles instead would double the shared memory that
//    bounds the tile sizes. The three terms of a group of four n-tiles are
//    issued in rounds (every hi*lo, then every lo*hi, then every hi*hi), so
//    no product waits on the one before it.
//  * wgmma (one depth pass, a warpgroup of four 16-row groups: d = 33 ..
//    128 and 161 .. 256): S takes K's tile as wgmma's B, staged in its
//    128-byte swizzle by the copies, with its lo staged beside it by every
//    thread (Q's hi and lo are A fragments in registers: the tensor core
//    reads a float32's TF32 top, so hi is the float as it is); P V takes V
//    transposed into hi and lo tiles by every thread, each k-step's keys in
//    P's order. Either staging is one pass a tile where mma.sync has each
//    warp load and split the whole tile. `probe_flash f32` chose: S and P V
//    at d = 33 .. 64, P V alone at 65 .. 128 and 161 .. 256 (S's K lo pass
//    and barrier cost more than they save there, and at DW = 128 Q's hi and
//    lo fragments spill), mma.sync at d <= 32 (P V spills) and 129 .. 160.
//    d > 256 cannot take it: a 64-row warpgroup's Q and O at d = 512 are
//    256 KiB, the SM's register file, and Q's hi and lo tiles 256 KiB of
//    shared memory.
//  * Key split: where the row blocks (times strips) would leave SMs idle,
//    grid z also splits the key tiles over KS blocks
//    (`ealdm_flash_attention_sm90_f32_splits`, from the occupancy). Each
//    writes its unnormalised O and its (max, sum) per row to the caller's
//    fp32 scratch, and `flash_tf32x3_combine_kernel` rescales each part by
//    2^((m_i - m) * scale * log2 e) and divides by the combined sum.
#include <type_traits>

#include "flash_sm90_common.cuh"

namespace {

// Probe builds (kernels/probe_flash.py) compile this file with one TF32 term
// (FLASH_PROBE_TERMS=1: hi*hi only), with parts left out (FLASH_PROBE_SKIP:
// 1 the softmax, 2 the products, 4 the copies), or with every instance that
// can have them taking the same products on wgmma (FLASH_PROBE_WGMMA: 0
// none, 1 S, 2 P V, 3 both; see Config::kWg), to time what paces the
// kernel. A normal build leaves out nothing, and each instance takes its own
// products (Config's WG).
#ifndef FLASH_PROBE_TERMS
#define FLASH_PROBE_TERMS 3
#endif
#ifndef FLASH_PROBE_SKIP
#define FLASH_PROBE_SKIP 0
#endif
#ifndef FLASH_PROBE_WGMMA
#define FLASH_PROBE_WGMMA -1
#endif
constexpr bool kRunSoftmax = !(FLASH_PROBE_SKIP & 1), kRunProducts = !(FLASH_PROBE_SKIP & 2),
               kCopy = !(FLASH_PROBE_SKIP & 4);
constexpr bool kThreeTerms = FLASH_PROBE_TERMS == 3;

constexpr int kGroup = 4;  // n-tiles whose products a round of terms interleaves

constexpr int kMaxSplits = 16;       // key-split blocks a row block
constexpr int kSmemPerSM = 233472;   // an SM's shared memory, 1 KiB of it reserved a block

// A launch configuration: WR row groups of 16 query rows, WC warps a group
// owning DW columns each, key tiles of BK, at least MINB blocks an SM; QS:
// Q's tile is kept in shared memory (one depth pass only), not in registers;
// WG: the products on wgmma (1 S, 2 P V, 3 both; one depth pass only).
template <typename T_, int DW_, int WR_, int WC_, int BK_, int MINB_, bool QS_ = false,
          int WG_ = 0>
struct Config {
  using T = T_;
  static constexpr int DW = DW_, WR = WR_, WC = WC_, BK = BK_, kMinBlocks = MINB_;
  static constexpr bool QS = QS_;
  static constexpr int kRows = 16 * WR, kThreads = 32 * WR * WC, CW = WC * DW;
  static constexpr int LD = CW + 16 / static_cast<int>(sizeof(T));  // a staged row, padded
  static constexpr int kTileBytes = BK * LD * static_cast<int>(sizeof(T));
  static constexpr int kSxPitch = (BK + 31) / 32 * 32 + 8;  // float2 stores in distinct banks
  static constexpr int kSxBytes = WC > 1 ? WR * WC * 16 * kSxPitch * 4 : 0;
  static constexpr int kQBytes = QS ? kRows * LD * static_cast<int>(sizeof(T)) : 0;
  // wgmma, where a warpgroup can be four row groups of one depth slice
  // (float32, WR = 4, Q in registers): S on m64nBKk8 with K's tile staged
  // in wgmma's layout (128-byte swizzle) and its lo in a second tile; P V on
  // m64nDWk8 with V transposed into hi and lo tiles (TF32 has no transpose
  // bit). Warp w is row group w % 4 of warpgroup (depth slice) w / 4.
  static constexpr bool kCanWg = std::is_same_v<T, float> && WR == 4 && !QS;
  static_assert(WG_ == 0 || kCanWg, "wgmma needs float32 warpgroups of 64 rows");
  static constexpr int kWgBits = kCanWg ? (FLASH_PROBE_WGMMA < 0 ? WG_ : FLASH_PROBE_WGMMA) : 0;
  static constexpr bool kWg = kWgBits != 0, kWgS = kWgBits & 1, kWgPV = kWgBits & 2;
  static constexpr int kDenseTile = BK * CW * 4;  // a float32 tile in wgmma's layout
  static constexpr int kSlotBytes = kWg ? (kTileBytes + 1023) / 1024 * 1024 : kTileBytes;
  static constexpr int kLoBytes = kWgS ? kDenseTile : 0, kVtBytes = kWgPV ? 2 * kDenseTile : 0;
  static constexpr int kAlign = kWg ? 1024 : 0;  // the swizzle's period, for the base
  static constexpr int kFit = (kSmemPerSM / kMinBlocks - 1024 - kSxBytes - kQBytes - kLoBytes -
                               kVtBytes - kAlign) / kSlotBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem =
      kAlign + kStages * kSlotBytes + kLoBytes + kVtBytes + kSxBytes + kQBytes;
  static_assert(DW % 8 == 0 && BK % 8 == 0 && WR * WC <= 16, "DW, BK, warps");
  static_assert(CW * sizeof(T) % 128 == 0, "whole 128-byte lines before a row's pad");
  static_assert(kStages >= 2 && kSmem <= kSmemBytes, "two stages fit shared memory");
  static_assert(WC == 1 || WR <= 15, "a named barrier a row group");
};

// ---------------------------------------------------------------- helpers
// 16-byte global -> shared copy; `valid` false zero-fills the 16 bytes and
// reads nothing (src-size 0), so `src` only has to be a mapped address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// x = hi + lo (+ under 2^-21 x): hi is x with its 13 low bits cleared, lo =
// x - hi exactly, of which the tensor core reads the top 11 bits
__device__ __forceinline__ float lo_of(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(lo_of(x));
}

// d += a * b on a 16x8x8 tile: TF32 A (row) and B (col), fp32 C/D.
// Fragments (PTX ISA, mma.m16n8k8 .tf32), lane = 4g + t: A a0 (row g, col
// t), a1 (row g + 8, col t), a2 (row g, col t + 4), a3 (row g + 8, col
// t + 4); B b0 (row t, col g), b1 (row t + 4, col g); C c0, c1 (row g, cols
// 2t, 2t + 1), c2, c3 (row g + 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a B fragment's two floats, split: hi and lo TF32 (bfloat16 is exact in
// TF32: its hi is the value and lo is never read)
template <typename T>
__device__ __forceinline__ void load_split(const T* p0, const T* p1, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const float x0 = ld_f32(p0), x1 = ld_f32(p1);
  if constexpr (std::is_same_v<T, bf16>) {
    hi[0] = __float_as_uint(x0);
    hi[1] = __float_as_uint(x1);
  } else {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
}

// acc[n0 + j] += a * b_j for the n-tiles j < kGroup of a group (those below
// N), in split TF32: the terms in rounds over the group (hi*lo, lo*hi,
// hi*hi), so consecutive products go to different accumulators. `b_lo`:
// the B side has a lo (float32); `a_lo`: the A side has one (float32, and
// bfloat16's P).
template <bool b_lo, bool a_lo, int N>
__device__ __forceinline__ void mma_group(float (&acc)[N][4], int n0, const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[kGroup][2],
                                          const uint32_t (&bl)[kGroup][2]) {
  if constexpr (!kRunProducts) return;
  if constexpr (b_lo && kThreeTerms) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (n0 + j < N) mma_tf32(acc[n0 + j], ah, bl[j][0], bl[j][1]);
  }
  if constexpr (a_lo && kThreeTerms) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (n0 + j < N) mma_tf32(acc[n0 + j], al, bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (n0 + j < N) mma_tf32(acc[n0 + j], ah, bh[j][0], bh[j][1]);
}

// d += a * b on wgmma m64nNk8 TF32 (N = 32, 64, 80, 128: 2 * the floats of
// d), a from registers (mma.m16n8k8's A layout over each warp's 16 rows) and
// b from shared memory (K-major, 128-byte swizzle), fp32 accumulate. The
// tensor core reads a float32's top 19 bits: hi is the float as it is.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// ---------------------------------------------------------------- kernel
// Thread (warp w = WC * wr + wc, lane 4g + t) holds rows 16wr + g and
// 16wr + g + 8 of the block, S's keys 8j + 2t, 8j + 2t + 1 of the tile and
// O's columns CW * strip + DW * wc + 8j + 2t, + 1.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
flash_tf32x3_kernel(const typename C::T* __restrict__ q, const typename C::T* __restrict__ k,
                    const typename C::T* __restrict__ v, typename C::T* __restrict__ o,
                    float* __restrict__ part, float2* __restrict__ ml, int H, int Nq, int Nk,
                    int D, int splits, Strides qs, Strides ks, Strides vs, Strides os,
                    float scale_log2) {
  using T = typename C::T;
  constexpr int DW = C::DW, BK = C::BK, CW = C::CW, LD = C::LD, ST = C::kStages;
  constexpr int NT = C::kThreads, WC = C::WC, PITCH = C::kSxPitch;
  constexpr int NS = BK / 8;  // S's n-tiles = P V's k-steps
  constexpr int NO = DW / 8;  // O's n-tiles = S's k-steps of a warp's depth slice
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if constexpr (C::kWg) base += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  // ring [ST] slots of [BK][LD] (K in wgmma's layout where S is on wgmma);
  // K's lo [CW / 32][BK][32]; V^T's hi and lo [BK / 32][CW][32]; S's partials
  // [WR][WC][16][PITCH]; Q [kRows][LD]
  auto slot = [&](int i) { return reinterpret_cast<T*>(base + (i % ST) * C::kSlotBytes); };
  float* klo = reinterpret_cast<float*>(base + ST * C::kSlotBytes);
  float* vt = reinterpret_cast<float*>(base + ST * C::kSlotBytes + C::kLoBytes);
  float* sx = reinterpret_cast<float*>(base + ST * C::kSlotBytes + C::kLoBytes + C::kVtBytes);
  T* qs_tile = reinterpret_cast<T*>(base + ST * C::kSlotBytes + C::kLoBytes + C::kVtBytes +
                                    C::kSxBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = C::kWg ? warp % C::WR : warp / WC, wc = C::kWg ? warp / C::WR : warp % WC;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int npass = (D + CW - 1) / CW;  // depth passes of S = strips of O
  const int strip = blockIdx.z % npass, split_id = blockIdx.z / npass;
  const int row0 = blockIdx.x * C::kRows;
  const int r0 = row0 + 16 * wr + g, r1 = r0 + 8;
  const int ntiles = (Nk + BK - 1) / BK;
  const int t_begin = split_id * ntiles / splits, t_end = (split_id + 1) * ntiles / splits;
  const int per_tile = npass + 1;  // K chunks of each pass, then the strip's V
  const int nchunks = (t_end - t_begin) * per_tile;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;

  // chunk i of the loop into ring slot i % ST (an empty group past the end,
  // so every thread's group count stays uniform)
  auto issue = [&](int i) {
    if (kCopy && i < nchunks) {
      const int tile = t_begin + i / per_tile, sub = i % per_tile;
      const bool is_v = sub == npass;
      const T* src = is_v ? vp : kp;
      const long long sn = is_v ? vs.n : ks.n;
      const int c0 = (is_v ? strip : sub) * CW;
      // LPR lanes a row on consecutive 16-byte pieces, RPW rows a warp
      constexpr int E = 16 / sizeof(T), PER_ROW = CW / E;
      constexpr int LPR = PER_ROW < 32 ? PER_ROW : 32, RPW = 32 / LPR, STEP = NT / 32 * RPW;
      static_assert(PER_ROW >= 32 || 32 % PER_ROW == 0, "a row's pieces divide a warp");
      const int r = warp * RPW + lane / LPR;
      const T* row = src + (tile * BK + r) * sn + c0;
      const uint32_t dst = smem_u32(slot(i));
      const bool dense = C::kWgS && !is_v;  // [CW / 32][BK][32], 16-byte pieces swizzled
#pragma unroll 1
      for (int j = r; j < BK; j += STEP) {
        const bool key_ok = tile * BK + j < Nk;
#pragma unroll
        for (int pc = lane % LPR; pc < PER_ROW; pc += LPR) {
          const bool ok = key_ok && c0 + pc * E < D;
          cp_async16(dense ? dst + pc / 8 * BK * 128 + j * 128 + ((pc % 8) ^ (j % 8)) * 16
                           : dst + (j * LD + pc * E) * static_cast<uint32_t>(sizeof(T)),
                     ok ? row + pc * E : src, ok);
        }
        row += STEP * sn;
      }
    }
    cp_async_commit();
  };

  // Q's A-fragments of this warp's depth slice in pass `pass`, unscaled;
  // rows >= Nq and columns >= D are zeros (D is a multiple of 8, so a
  // k-step's columns are all data or all pad)
  float qf[NO][4];
  auto load_q = [&](int pass) {
    const int c0 = pass * CW + wc * DW + t;
#pragma unroll
    for (int kk = 0; kk < NO; ++kk) {
      const int c = c0 + 8 * kk;
      const bool ok = c < D;
      qf[kk][0] = ok && r0 < Nq ? ld_f32(qp + r0 * qs.n + c) : 0.f;
      qf[kk][1] = ok && r1 < Nq ? ld_f32(qp + r1 * qs.n + c) : 0.f;
      qf[kk][2] = ok && r0 < Nq ? ld_f32(qp + r0 * qs.n + c + 4) : 0.f;
      qf[kk][3] = ok && r1 < Nq ? ld_f32(qp + r1 * qs.n + c + 4) : 0.f;
    }
  };

  float acc[NO][4];
  float sc[NS][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8 (raw scores)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of their sums

  // S (+)= Q K^T over this warp's depth slice of the chunk
  auto scores = [&](const T* tile_k) {
    const T* kb = tile_k + g * LD + wc * DW + t;
#pragma unroll
    for (int kk = 0; kk < NO; ++kk) {
      uint32_t ah[4], al[4];
      float from_smem[4];
      if constexpr (C::QS) {  // Q's fragment from its tile in shared memory
        const T* qr = qs_tile + (16 * wr + g) * LD + wc * DW + 8 * kk + t;
        from_smem[0] = ld_f32(qr);
        from_smem[1] = ld_f32(qr + 8 * LD);
        from_smem[2] = ld_f32(qr + 4);
        from_smem[3] = ld_f32(qr + 8 * LD + 4);
      }
      const float (&qk)[4] = C::QS ? from_smem : qf[kk];
      if constexpr (kBf16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[e] = __float_as_uint(qk[e]);
      } else {
        split4(qk, ah, al);
      }
#pragma unroll
      for (int n0 = 0; n0 < NS; n0 += kGroup) {
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const T* kr = kb + (n0 + j) * 8 * LD + 8 * kk;
          if (n0 + j < NS) load_split(kr, kr + 4, bh[j], bl[j]);
        }
        mma_group<!kBf16, !kBf16>(sc, n0, ah, al, bh, bl);  // bfloat16: Q and K exact
      }
    }
  };

  // wgmma builds: S (+)= Q K^T over this warpgroup's depth slice, from K's
  // tile and its lo, which every thread first stages
  auto scores_wg = [&](const T* tile_k) {
    if constexpr (C::kWgS) {
      const float4* src = reinterpret_cast<const float4*>(tile_k);
      for (int idx = tid; idx < BK * CW / 4; idx += NT) {
        const float4 x = src[idx];
        reinterpret_cast<float4*>(klo)[idx] =
            make_float4(lo_of(x.x), lo_of(x.y), lo_of(x.z), lo_of(x.w));
      }
      fence_proxy_async();
      __syncthreads();
      uint32_t ah[NO][4], al[NO][4];
#pragma unroll
      for (int kk = 0; kk < NO; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[kk][e] = __float_as_uint(qf[kk][e]);
          al[kk][e] = __float_as_uint(lo_of(qf[kk][e]));
        }
      auto& s = reinterpret_cast<float (&)[NS * 4]>(sc);
      const uint32_t kh = smem_u32(tile_k), kl = smem_u32(klo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NO; ++kk) {
        const int c = wc * DW + 8 * kk;
        const uint32_t off = c / 32 * BK * 128 + c % 32 * 4;
        if constexpr (kThreeTerms) {
          wgmma_tf32(s, al[kk], smem_desc<64>(kh + off, 16));
          wgmma_tf32(s, ah[kk], smem_desc<64>(kl + off, 16));
        }
        wgmma_tf32(s, ah[kk], smem_desc<64>(kh + off, 16));
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(ah);
      pin(al);
    }
  };

  // the WC partial sums of the row group's S, added in rank order
  auto exchange = [&]() {
    float* mine = sx + ((wr * WC + wc) * 16) * PITCH;
    float* group = sx + (wr * WC * 16) * PITCH;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      *reinterpret_cast<float2*>(mine + g * PITCH + 8 * nt + 2 * t) =
          make_float2(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * PITCH + 8 * nt + 2 * t) =
          make_float2(sc[nt][2], sc[nt][3]);
    }
    bar_sync(1 + wr, 32 * WC);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const float* p = group + g * PITCH + 8 * nt + 2 * t;
      float2 x = *reinterpret_cast<const float2*>(p);
      float2 y = *reinterpret_cast<const float2*>(p + 8 * PITCH);
#pragma unroll
      for (int c = 1; c < WC; ++c) {
        const float2 xc = *reinterpret_cast<const float2*>(p + c * 16 * PITCH);
        const float2 yc = *reinterpret_cast<const float2*>(p + c * 16 * PITCH + 8 * PITCH);
        x.x += xc.x, x.y += xc.y, y.x += yc.x, y.y += yc.y;
      }
      sc[nt][0] = x.x, sc[nt][1] = x.y, sc[nt][2] = y.x, sc[nt][3] = y.y;
    }
  };

  // online softmax of the tile in base 2, p = 2^(s*c - m*c) with c = scale *
  // log2(e), written over S; O rescaled
  auto softmax = [&](int key0) {
    if (key0 + BK > Nk) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * nt + 2 * t + (e & 1) >= Nk) sc[nt][e] = -INFINITY;
    }
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      x0 = fmaxf(x0, fmaxf(sc[nt][0], sc[nt][1]));
      x1 = fmaxf(x1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    x0 = quad_max(x0);
    x1 = quad_max(x1);
    const float alpha0 = ex2((m0 - x0) * scale_log2), alpha1 = ex2((m1 - x1) * scale_log2);
    m0 = x0;
    m1 = x1;
    const float mc0 = x0 * scale_log2, mc1 = x1 * scale_log2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      sc[nt][0] = ex2(fmaf(sc[nt][0], scale_log2, -mc0));
      sc[nt][1] = ex2(fmaf(sc[nt][1], scale_log2, -mc0));
      sc[nt][2] = ex2(fmaf(sc[nt][2], scale_log2, -mc1));
      sc[nt][3] = ex2(fmaf(sc[nt][3], scale_log2, -mc1));
      s0 += sc[nt][0] + sc[nt][1];
      s1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
  };

  // O += P V over this warp's columns of the strip. k-step ks takes keys
  // 8ks + 2t as its column t and 8ks + 2t + 1 as its column t + 4, so P's
  // A-fragment is (c0, c2, c1, c3) of S's n-tile ks.
  auto accumulate = [&](const T* tile_v) {
    const T* vb = tile_v + 2 * t * LD + wc * DW + g;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
      uint32_t ph[4], pl[4];
      split4(pa, ph, pl);
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += kGroup) {
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const T* vr = vb + 8 * kk * LD + 8 * (n0 + j);
          if (n0 + j < NO) load_split(vr, vr + LD, bh[j], bl[j]);
        }
        mma_group<!kBf16, true>(acc, n0, ph, pl, bh, bl);  // bfloat16: V exact
      }
    }
  };

  // wgmma builds: O += P V over this warpgroup's columns. Every thread
  // first stages V^T's hi and lo from the ring's [key][d] tile, each k-step's
  // keys in P's order (2t, 2t + 1 -> t, t + 4).
  auto accumulate_wg = [&](const T* tile_v) {
    if constexpr (C::kWgPV) {
      for (int idx = tid; idx < CW * (BK / 8); idx += NT) {
        const int n = idx % CW, kg = idx / CW;
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = ld_f32(tile_v + (8 * kg + u) * LD + n);
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          const int off = kg / 4 * CW * 32 + n * 32 + (((2 * kg + odd) % 8) ^ (n % 8)) * 4;
          const float4 hi = make_float4(x[odd], x[2 + odd], x[4 + odd], x[6 + odd]);
          *reinterpret_cast<float4*>(vt + off) = hi;
          *reinterpret_cast<float4*>(vt + BK * CW + off) =
              make_float4(lo_of(hi.x), lo_of(hi.y), lo_of(hi.z), lo_of(hi.w));
        }
      }
      fence_proxy_async();
      __syncthreads();
      uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
        split4(pa, ph[kk], pl[kk]);
      }
      auto& out = reinterpret_cast<float (&)[NO * 4]>(acc);
      const uint32_t vh = smem_u32(vt), vl = smem_u32(vt + BK * CW);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const uint32_t off = kk / 4 * CW * 128 + wc * DW * 128 + kk % 4 * 32;
        if constexpr (kThreeTerms) {
          wgmma_tf32(out, pl[kk], smem_desc<64>(vh + off, 16));
          wgmma_tf32(out, ph[kk], smem_desc<64>(vl + off, 16));
        }
        wgmma_tf32(out, ph[kk], smem_desc<64>(vh + off, 16));
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(ph);
      pin(pl);
    }
  };

  if constexpr (C::QS) {  // Q's tile, zero past Nq and D: its own group, before the ring's
    constexpr int E = 16 / sizeof(T), PER_ROW = CW / E;
    for (int idx = tid; idx < C::kRows * PER_ROW; idx += NT) {
      const int j = idx / PER_ROW, pc = idx % PER_ROW, row = row0 + j;
      const bool ok = row < Nq && pc * E < D;
      cp_async16(smem_u32(qs_tile + j * LD + pc * E), ok ? qp + row * qs.n + pc * E : qp, ok);
    }
    cp_async_commit();
  } else if (npass == 1) {
    load_q(0);
  }
#pragma unroll 1
  for (int s = 0; s < ST - 1; ++s) issue(s);
#pragma unroll 1
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<ST - 2>();  // this thread's copies of chunk i have landed
    if constexpr (C::kWg) fence_proxy_async();  // ... and are visible to wgmma
    __syncthreads();          // ... every thread's; slot (i - 1) % ST is consumed
    issue(i + ST - 1);
    const T* tile = slot(i);
    const int sub = i % per_tile;
    if (sub < npass) {
      if constexpr (!C::QS)
        if (npass > 1) load_q(sub);
      if (sub == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      if constexpr (C::kWgS)
        scores_wg(tile);
      else
        scores(tile);
      if (sub == npass - 1) {
        if constexpr (WC > 1) exchange();
        if constexpr (kRunSoftmax) softmax((t_begin + i / per_tile) * BK);
      }
    } else if constexpr (C::kWgPV) {
      accumulate_wg(tile);
    } else {
      accumulate(tile);
    }
  }
  cp_async_wait<0>();

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const int col0 = strip * CW + wc * DW + 2 * t;
  if (splits == 1) {
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    T* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = col0 + 8 * j;
      if (col >= D) break;  // pad columns are not stored
      if (r0 < Nq) st_pair(op + r0 * os.n + col, acc[j][0] * inv0, acc[j][1] * inv0);
      if (r1 < Nq) st_pair(op + r1 * os.n + col, acc[j][2] * inv1, acc[j][3] * inv1);
    }
  } else {
    // partial (unnormalised O, max, sum) of rows [split][b*H + h][row]
    const long long rows = (static_cast<long long>(split_id) * gridDim.y + bh) * Nq;
    float* pp = part + rows * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = col0 + 8 * j;
      if (col >= D) break;
      if (r0 < Nq) st_pair(pp + static_cast<long long>(r0) * D + col, acc[j][0], acc[j][1]);
      if (r1 < Nq) st_pair(pp + static_cast<long long>(r1) * D + col, acc[j][2], acc[j][3]);
    }
    if (strip == 0 && wc == 0 && t == 0) {
      if (r0 < Nq) ml[rows + r0] = make_float2(m0, sum0);
      if (r1 < Nq) ml[rows + r1] = make_float2(m1, sum1);
    }
  }
}

// The key split's second pass: row (blockIdx.x, batch-head blockIdx.y) is
// sum_i w_i O_i / sum_i w_i l_i with w_i = 2^((m_i - max_i m_i) * c).
template <typename T>
__global__ void __launch_bounds__(128)
flash_tf32x3_combine_kernel(const float* __restrict__ part, const float2* __restrict__ ml,
                            T* __restrict__ o, int H, int Nq, int D, int splits, Strides os,
                            float scale_log2) {
  __shared__ float w[kMaxSplits];
  __shared__ float inv;
  const int row = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(gridDim.y) * Nq;  // rows a split
  const long long base = static_cast<long long>(bh) * Nq + row;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float2 x = lane < splits ? ml[lane * stride + base] : make_float2(-INFINITY, 0.f);
    float m = x.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float wi = lane < splits ? ex2((x.x - m) * scale_log2) : 0.f;
    if (lane < splits) w[lane] = wi;
    float l = wi * x.y;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) inv = 1.f / l;
  }
  __syncthreads();
  T* op = o + b * os.b + h * os.h + row * os.n;
  for (int col = 4 * threadIdx.x; col < D; col += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < splits; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(part + (i * stride + base) * D + col);
      a.x = fmaf(w[i], p.x, a.x);
      a.y = fmaf(w[i], p.y, a.y);
      a.z = fmaf(w[i], p.z, a.z);
      a.w = fmaf(w[i], p.w, a.w);
    }
    st_pair(op + col, a.x * inv, a.y * inv);
    st_pair(op + col + 2, a.z * inv, a.w * inv);
  }
}

// ---------------------------------------------------------------- host
struct Args {
  const void *q, *k, *v;
  void* o;
  float* part;
  float2* ml;
  int splits, B, H, Nq, Nk, D;
  Strides qs, ks, vs, os;
  float scale_log2;
  cudaStream_t stream;
};

// The instances. Which head dim runs which is ops/attention.py's
// `tf32x3_tiling` (BK, WC, DW), which the entry points take: float32 d <=
// 32, 64 and 128 on one warp a row group (64 rows; three, two and two
// blocks an SM; d = 33 .. 64 with both products on wgmma, d = 65 .. 128 with
// P V on wgmma); d <= 160 on two warps of 80 columns and d <= 256 on two of
// 128 (64 rows; P V on wgmma at 161 .. 256); d <= 512, and every d above
// 640 in strips and passes of 512, on four of 128 (32 rows); d <= 640 on
// four of 160 with Q's tile in shared memory and 24-key tiles (32 rows);
// bfloat16 above 1,920 in strips and passes of 1,024 on eight of 128 (16
// rows). Each SM sub-partition's 16,384 registers hold its warps: with 8
// warps an SM a thread may keep 255, with 12 only 168. A warp keeps DW/2
// registers of O and, unless QS, DW/2 of Q: ptxas takes about 242 at DW =
// 128, spills 68 bytes at 160 (20 at 168), and six warps of 112 spill at
// 168 registers; with Q in shared memory 160 columns take 186
// (`probe_flash f32`, PERF.md).
using F32Narrow = Config<float, 32, 4, 1, 64, 3>;
using F32Mid = Config<float, 64, 4, 1, 64, 2, false, 3>;
using F32Base = Config<float, 128, 4, 1, 32, 2, false, 2>;
using F32Two80 = Config<float, 80, 4, 2, 32, 1>;
using F32Two = Config<float, 128, 4, 2, 32, 1, false, 2>;
using F32Four = Config<float, 128, 2, 4, 32, 1>;
using F32Wide = Config<float, 160, 2, 4, 24, 1, true>;
using Bf16Eight = Config<bf16, 128, 1, 8, 32, 1>;

template <class C>
cudaError_t prepare() {  // once per instance: the shared memory it asks for
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_tf32x3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  return ready;
}

template <class C>
int blocks_per_split(const Args& a) {
  return (a.Nq + C::kRows - 1) / C::kRows * a.B * a.H * ((a.D + C::CW - 1) / C::CW);
}

// KS: 1 where the blocks fill every SM's resident slots, else as many
// splits as fit them (at most the key tiles and kMaxSplits). < 0: an error.
template <class C>
int splits_for(const Args& a) {
  cudaError_t e = prepare<C>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_tf32x3_kernel<C>,
                                                         C::kThreads, C::kSmem)) != cudaSuccess)
    return -static_cast<int>(e);
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long blocks = blocks_per_split<C>(a);
  if (blocks >= slots) return 1;
  const long long ntiles = (a.Nk + C::BK - 1) / C::BK;
  long long n = slots / blocks;
  if (n > ntiles) n = ntiles;
  return static_cast<int>(n < kMaxSplits ? n : kMaxSplits);
}

template <class C>
cudaError_t launch(const Args& a) {
  using T = typename C::T;
  cudaError_t e = prepare<C>();
  if (e != cudaSuccess) return e;
  const int strips = (a.D + C::CW - 1) / C::CW;
  const int ntiles = (a.Nk + C::BK - 1) / C::BK;
  if (((C::QS || C::kWg) && a.D > C::CW) || a.splits < 1 || a.splits > kMaxSplits ||
      a.splits > ntiles || (a.splits > 1 && (a.part == nullptr || a.ml == nullptr)) ||
      static_cast<long long>(strips) * a.splits > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((a.Nq + C::kRows - 1) / C::kRows, a.B * a.H, strips * a.splits);
  flash_tf32x3_kernel<C><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.part, a.ml, a.H, a.Nq, a.Nk, a.D, a.splits, a.qs, a.ks, a.vs,
      a.os, a.scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess || a.splits == 1) return e;
  flash_tf32x3_combine_kernel<T><<<dim3(a.Nq, a.B * a.H), 128, 0, a.stream>>>(
      a.part, a.ml, static_cast<T*>(a.o), a.H, a.Nq, a.D, a.splits, a.os, a.scale_log2);
  return cudaGetLastError();
}

template <class C>
bool tiles(int bk, int wc, int dw) {
  return C::BK == bk && C::WC == wc && C::DW == dw;
}

// 0 .. 7: the instance above of this dtype and tiling (BK, WC, DW); -1: no
// such instance, or bfloat16 at d <= 1,920 (not routed here). `launch`
// refuses a d wider than an instance that takes one depth pass only.
int config_of(int dtype, int bk, int wc, int dw, int D) {
  if (dtype == 1) return D > 1920 && tiles<Bf16Eight>(bk, wc, dw) ? 7 : -1;
  if (dtype != 0) return -1;
  if (tiles<F32Narrow>(bk, wc, dw)) return 0;
  if (tiles<F32Mid>(bk, wc, dw)) return 1;
  if (tiles<F32Base>(bk, wc, dw)) return 2;
  if (tiles<F32Two80>(bk, wc, dw)) return 3;
  if (tiles<F32Two>(bk, wc, dw)) return 4;
  if (tiles<F32Four>(bk, wc, dw)) return 5;
  return tiles<F32Wide>(bk, wc, dw) ? 6 : -1;
}

// The arguments the entry points share; false if they are refused: a shape
// out of range, or a base or stride the 16-byte copies cannot take.
bool make_args(Args& a, int dtype, int B, int H, int Nq, int Nk, int D, const void* const* ptrs,
               const long long* st) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D < 8 || D % 8) return false;
  const int elems = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const int sizes[4][3] = {{B, H, Nq}, {B, H, Nk}, {B, H, Nk}, {B, H, Nq}};
  for (int t = 0; t < 4; ++t) {
    if (ptrs && reinterpret_cast<uintptr_t>(ptrs[t]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (sizes[t][j] > 1 && st[3 * t + j] % elems) return false;
  }
  a.B = B, a.H = H, a.Nq = Nq, a.Nk = Nk, a.D = D;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.os = Strides{st[9], st[10], st[11]};
  return true;
}

}  // namespace

// The key split KS that `ealdm_flash_attention_sm90_f32` should be given
// for this shape and tiling (1: none), or -(cudaError_t) when refused or on
// an error. dtype: 0 float32, 1 bfloat16.
extern "C" int ealdm_flash_attention_sm90_f32_splits(int dtype, int bk, int wc, int dw, int B,
                                                     int H, int Nq, int Nk, int D) {
  Args a{};
  const long long st[12] = {};
  const int config = config_of(dtype, bk, wc, dw, D);
  if (config < 0 || !make_args(a, dtype, B, H, Nq, Nk, D, nullptr, st))
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (config) {
    case 0: return splits_for<F32Narrow>(a);
    case 1: return splits_for<F32Mid>(a);
    case 2: return splits_for<F32Base>(a);
    case 3: return splits_for<F32Two80>(a);
    case 4: return splits_for<F32Two>(a);
    case 5: return splits_for<F32Four>(a);
    case 6: return splits_for<F32Wide>(a);
    default: return splits_for<Bf16Eight>(a);
  }
}

// dtype 0 = float32 (any D that is a multiple of 8), 1 = bfloat16 (D above
// 1,920 only: ops/attention.py routes the rest to the wgmma kernels, and
// they are refused here). (bk, wc, dw): the tiling of one instance
// (`tf32x3_tiling` in ops/attention.py), else refused. `splits` is KS (1 ..
// 16, at most the key tiles of the instance); with KS > 1, `part` holds KS
// * B * H * Nq * D floats and `ml` KS * B * H * Nq float pairs, written and
// then read by the combine kernel. 16-byte aligned bases and (batch, head, row) strides that are
// multiples of 16 bytes, in elements. Returns the cudaError_t (0: launched).
extern "C" int ealdm_flash_attention_sm90_f32(
    const void* q, const void* k, const void* v, void* o, void* part, void* ml, int splits,
    int dtype, int bk, int wc, int dw, int B, int H, int Nq, int Nk, int D, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn, long long v_sb,
    long long v_sh, long long v_sn, long long o_sb, long long o_sh, long long o_sn,
    float scale, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  Args a{};
  const int config = config_of(dtype, bk, wc, dw, D);
  if (config < 0 || !make_args(a, dtype, B, H, Nq, Nk, D, ptrs, st))
    return (int)cudaErrorInvalidValue;
  a.q = q, a.k = k, a.v = v, a.o = o;
  a.part = static_cast<float*>(part);
  a.ml = static_cast<float2*>(ml);
  a.splits = splits;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return (int)launch<F32Narrow>(a);
    case 1: return (int)launch<F32Mid>(a);
    case 2: return (int)launch<F32Base>(a);
    case 3: return (int)launch<F32Two80>(a);
    case 4: return (int)launch<F32Two>(a);
    case 5: return (int)launch<F32Four>(a);
    case 6: return (int)launch<F32Wide>(a);
    default: return (int)launch<Bf16Eight>(a);
  }
}
