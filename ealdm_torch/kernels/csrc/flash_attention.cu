// Flash attention forward (online softmax) for sm_90a.
//
// Replaces: ealdm_tpu/ops/attention.py `_flash_kernel` (via `_flash_forward`,
// public `flash_attention`) and `_flash_packed_kernel` (via
// `_flash_packed_forward`, public `flash_attention_packed`). Every kernel here
// addresses q/k/v/o by (batch, head, row) strides with a contiguous head
// dimension, so [B,H,N,D], the head-strided view of a [B,N,H*D] projection
// (row stride H*D, head stride D) and the packed layout are all read without
// a copy.
//
// Math (as the Pallas kernel): scores, running max and sum, and the output
// accumulator are fp32; the output is stored in the input type. A ragged key
// count is masked inside the kernel (scores of keys >= Nk are -inf); query
// rows >= Nq are not stored. Every key tile holds at least one valid key, so
// the running max is finite after the first tile.
//
// bfloat16 `flash_mma_narrow_kernel` runs D <= 32 (D = 40 .. 1,920 run the
// wgmma kernels of flash_attention_sm90.cu, _wide.cu and _deep.cu, which
// ops/attention.py calls instead): both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). The scale is applied to the
// fp32 scores, folded with log2(e) into one FMA before ex2.approx; P is
// rounded to bf16 for P*V (as the TPU's MXU rounds it), the row sums use the
// fp32 P. K/V tiles are staged in shared memory as bf16 by 16-byte cp.async
// copies (keys >= Nk zero-filled), double buffered so the next tile's copy
// overlaps this tile's math. Shared-memory rows are padded by 16 bytes, so
// the 8 rows an ldmatrix phase reads fall in 8 distinct 16-byte bank groups.
//
// D is a multiple of 8 from 8 to 32 in bfloat16 (the repo's configurations
// run 24 and 32 here); float32 runs flash_tf32x3_kernel
// (flash_attention_sm90_f32.cu). The kernel is a template over a padded
// width DP >= D: D = 24 is not a multiple of mma's k-step of 16. The pad
// columns of the K and V tiles are zero-filled by the same cp.async
// (src-size 0) and the Q fragments read zeros there, so q.k^T is unchanged;
// output columns past D are never written. D is a multiple of 8, so a
// 16-byte chunk is all data or all pad.
//
//  * D <= 32, DP = round_up(D, 16) (the UNet's heads: 32 in the flagship
//    and the inpainting model, 24 in lsun_churches; the wgmma kernel is
//    slower at 256 query rows, PERF.md). Bound on this card at d = 32: the
//    softmax's exponentials, not the tensor cores.
//    A score costs 4*D tensor-core operations but one ex2 on the SFU, which
//    issues 16 a clock per SM: 4.18e12/s at the H100 SXM's 1980 MHz maximum
//    SM clock against 989e12 op/s, so below D = 59 exp time exceeds the
//    operation time ([48,8,1024,32]: 0.096 ms against 0.052; at
//    [48,16,256,32] the bytes bind, 0.0150 ms).
//    Design: a block of 4 warps owns 64 query rows, 16 per warp; Q's
//    A-fragments are loaded once from global memory into registers (DP/16
//    k-steps). Per 64-key tile a warp runs S = Q*K^T (8 n-tiles x DP/16
//    k-steps, K from ldmatrix) into 32 fp32 registers, the online softmax
//    over its quad (shfl_xor 1, 2), packs P to bf16 A-fragments in registers
//    (the m16n8 C layout is the m16n8k16 A layout) and runs O += P*V (V from
//    ldmatrix.trans) into DP/2 fp32 registers. 4 * 64 * (DP + 8) * 2 bytes
//    of shared memory a block (20 KiB at DP = 32). At DP = 32 a thread
//    takes 83 registers, so 5 blocks share an SM where the earlier kernel
//    written for d = 32 alone took 78 and 6: about 4% slower (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, n;
};

// =============================================================== bfloat16
// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid` false zero-fills the 16 bytes and
// reads nothing (src-size 0), so `src` only has to be a mapped address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a * b on a 16x8x16 tile: bf16 A (row) and B (col), fp32 C/D.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, `lo` in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// ---------------------------------------------------------------- D <= 32
constexpr int kNRows = 64;     // query rows a block: 4 warps x 16
constexpr int kNKeys = 64;     // keys a tile
constexpr int kNThreads = 128;

template <int DP>
constexpr size_t narrow_smem_bytes() {  // K and V, two buffers each
  return sizeof(bf16) * 4 * kNKeys * (DP + 8);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4*g + t. A (16x16):
// a0 (row g, cols 2t..2t+1), a1 (row g+8), a2 (row g, cols 2t+8..), a3
// (row g+8, cols 2t+8..). B (16x8): b0 (rows 2t..2t+1, col g), b1 (rows
// 2t+8..). C (16x8): c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8).
template <int DP>
__global__ void __launch_bounds__(kNThreads)
flash_mma_narrow_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                        int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale_log2) {
  static_assert(DP == 16 || DP == 32, "DP: 16 or 32");
  constexpr int LD = DP + 8;      // smem row: DP/8 + 1 chunks of 16 bytes (odd)
  constexpr int KSTEPS = DP / 16;  // k-steps of Q*K^T
  constexpr int CHUNKS = DP / 8;   // 16-byte chunks a padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][kNKeys][LD]
  bf16* Vs = Ks + 2 * kNKeys * LD;               // [2][kNKeys][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int dchunks = D / 8;  // chunks that hold data; the rest are zero pad
  const bf16* kp = k + b * ks.b + h * ks.h;
  const bf16* vp = v + b * vs.b + h * vs.h;

  // a tile is 64 keys x CHUNKS chunks of 16 bytes, for K and for V
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kNKeys;
    bf16* Kb = Ks + buf * kNKeys * LD;
    bf16* Vb = Vs + buf * kNKeys * LD;
#pragma unroll
    for (int c = tid; c < kNKeys * CHUNKS; c += kNThreads) {
      const int j = c / CHUNKS, ch = c % CHUNKS;
      const bool key_ok = k0 + j < Nk, ok = key_ok && ch < dchunks;
      const long long src = (key_ok ? k0 + j : 0);
      const int col = ch < dchunks ? ch * 8 : 0;
      cp_async16(smem_u32(Kb + j * LD + ch * 8), kp + src * ks.n + col, ok);
      cp_async16(smem_u32(Vb + j * LD + ch * 8), vp + src * vs.n + col, ok);
    }
    cp_async_commit();
  };
  const int ntiles = (Nk + kNKeys - 1) / kNKeys;
  load_tile(0, 0);

  // Q's A-fragments, KSTEPS k-steps, straight from global memory; rows >= Nq
  // and pad columns are zeros
  const int r0 = blockIdx.x * kNRows + warp * 16 + g, r1 = r0 + 8;
  const bf16* qp = q + b * qs.b + h * qs.h;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 16 * kk + 8 * half + 2 * t;
      const bool cok = 16 * kk + 8 * half < D;
      qa[kk][2 * half] = r0 < Nq && cok
          ? *reinterpret_cast<const uint32_t*>(qp + r0 * qs.n + col) : 0u;
      qa[kk][2 * half + 1] = r1 < Nq && cok
          ? *reinterpret_cast<const uint32_t*>(qp + r1 * qs.n + col) : 0u;
    }
  }

  float acc[CHUNKS][4];  // O: 16 rows x CHUNKS n-tiles of 8 columns
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g+8 (raw scores)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait_all();  // this tile has landed
    __syncthreads();      // ... for every thread; the other buffer is free
    if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
    const bf16* Kt = Ks + buf * kNKeys * LD;
    const bf16* Vt = Vs + buf * kNKeys * LD;

    // S = Q K^T: 16 rows x 64 keys in 8 n-tiles. One ldmatrix.x4 gives a
    // key octet's B-fragments for two k-steps (4 chunks of d), an .x2 those
    // of a last odd k-step.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* krow = Kt + (nt * 8 + (lane & 7)) * LD;
#pragma unroll
      for (int kp2 = 0; kp2 < KSTEPS / 2; ++kp2) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(krow + 32 * kp2 + (lane >> 3) * 8));
        mma_bf16(s[nt], qa[2 * kp2], kb[0], kb[1]);
        mma_bf16(s[nt], qa[2 * kp2 + 1], kb[2], kb[3]);
      }
      if constexpr (KSTEPS % 2) {
        uint32_t kb[2];
        ldsm_x2(kb, smem_u32(krow + 16 * (KSTEPS - 1) + ((lane >> 3) & 1) * 8));
        mma_bf16(s[nt], qa[KSTEPS - 1], kb[0], kb[1]);
      }
    }
    const int k0 = tile * kNKeys;
    if (k0 + kNKeys > Nk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * t + (e & 1) >= Nk) s[nt][e] = -INFINITY;
    }

    // online softmax in base 2: p = 2^(s*c - m*c), c = scale * log2(e)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = ex2((m0 - mx0) * scale_log2);
    const float alpha1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int dt = 0; dt < CHUNKS; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
    // P as A-fragments of the 4 k-steps of P*V: n-tiles 2kk and 2kk+1 of S
    // are the column halves of k-step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = ex2(fmaf(s[nt][0], scale_log2, -mc0));
      const float p1 = ex2(fmaf(s[nt][1], scale_log2, -mc0));
      const float p2 = ex2(fmaf(s[nt][2], scale_log2, -mc1));
      const float p3 = ex2(fmaf(s[nt][3], scale_log2, -mc1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: one ldmatrix.x4.trans gives the B-fragments of two n-tiles
    // (keys 16kk..16kk+15, d 16dp..16dp+15)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_u32(Vt + key * LD + 16 * dp + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  bf16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int dt = 0; dt < CHUNKS; ++dt) {
    if (dt * 8 >= D) break;  // pad columns are not stored
    const int col = dt * 8 + 2 * t;
    if (r0 < Nq)
      *reinterpret_cast<uint32_t*>(op + r0 * os.n + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < Nq)
      *reinterpret_cast<uint32_t*>(op + r1 * os.n + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------- launch
template <int DP>
cudaError_t launch_narrow(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                          int H, int Nq, int Nk, int D, Strides qs, Strides ks,
                          Strides vs, Strides os, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = narrow_smem_bytes<DP>();
  auto kern = flash_mma_narrow_kernel<DP>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Nq + kNRows - 1) / kNRows, B * H);
  kern<<<grid, kNThreads, smem, stream>>>(q, k, v, o, H, Nq, Nk, D, qs, ks, vs, os,
                                          scale_log2);
  return cudaSuccess;
}

// D <= 32. The caller guarantees 16-byte aligned bases and strides that
// are multiples of 8 elements (the cp.async and 4-byte fragment accesses).
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        int B, int H, int Nq, int Nk, int D, Strides qs,
                        Strides ks, Strides vs, Strides os, float scale,
                        cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
#define EALDM_FLASH_ARGS q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, os, scale_log2, stream
  cudaError_t e;
  switch (D) {
    case 8: case 16: e = launch_narrow<16>(EALDM_FLASH_ARGS); break;
    case 24: case 32: e = launch_narrow<32>(EALDM_FLASH_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef EALDM_FLASH_ARGS
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16 with D = 8 .. 32; ops/attention.py routes every other
// head dim and float32 to the kernels of flash_attention_sm90*.cu, and they
// are refused here. Strides are in elements. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ealdm_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Nq, int Nk, int D, long long q_sb, long long q_sh,
    long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D < 8 || D % 8 != 0 ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn},
      os{o_sb, o_sh, o_sn};
  return (int)launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H, Nq, Nk,
                          D, qs, ks, vs, os, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ealdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
