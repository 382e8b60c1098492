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
// Any D that is a multiple of 8: in bfloat16 from 8 to 32 (the repo's
// configurations run 24 and 32 here), in float32 from 8 to 512. The
// bfloat16 kernel is a template over a padded width DP >= D: D = 24 is not
// a multiple of mma's k-step of 16. The pad columns of the
// Q, K and V tiles are zero-filled by the same cp.async (src-size 0) and the
// Q fragments read zeros there, so q.k^T is unchanged; output columns past D
// are never written. D is a multiple of 8, so a 16-byte chunk is all data or
// all pad.
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
//
// float32 keeps the first port's FMA kernel `flash_wide_kernel` (D split
// over the threads, up to 2 columns a thread, fp32 tiles in shared memory)
// for every D up to 512. It is the card's float32 reference; the main path
// runs bfloat16. Above 512 in float32 and above 1,920 in bfloat16,
// `flash_deep_kernel` runs (FMA, fp32 math, any D: 1,024-column strips
// across blocks, the depth in chunks). On the H100 (probe_flash.py f32,
// PERF.md) the deep kernel takes 1.6-2.2x the wide kernel's time at D <= 160
// over 1,024 rows and about the same at 384 and 512, but 0.84x at 576 and
// 0.34x at 640, where the wide kernel's 16-row blocks kept D in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// The float32 D above which flash_deep_kernel runs. probe_flash.py builds
// copies with 0 (the deep kernel at every D) and 640 (flash_wide_kernel up
// to 640, its 16-row blocks above 512) to time the two kernels.
#ifndef FLASH_PROBE_DEEP_ABOVE
#define FLASH_PROBE_DEEP_ABOVE 512
#endif

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, n;
};

// ================================================================ float32
// BQ rows, BK = 32 keys, NT = 8 * BQ threads (4 rows a warp); thread t owns
// columns t, t + NT, ..., COLS of them (columns >= D idle).
template <int BQ>
size_t wide_smem_bytes(int D) {
  constexpr int BK = 32;
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BK * BQ + 2 * BQ);
}

template <int BQ, int NT, int COLS>
__global__ void __launch_bounds__(NT)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H,
                  int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs,
                  Strides os, float scale) {
  constexpr int BK = 32;  // one key per lane
  static_assert(BQ == 4 * (NT / 32), "4 rows per warp");
  const int KP = D + 1;  // padded K row: lane j hits bank (j + k) % 32

  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D]  q * scale
  float* Ks = Qs + BQ * D;          // [BK][KP]
  float* Vs = Ks + BK * KP;         // [BK][D]
  float* Pt = Vs + BK * D;          // [BK][BQ] probabilities, transposed
  float* alpha_s = Pt + BK * BQ;    // [BQ]
  float* l_s = alpha_s + BQ;        // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    const int row = row0 + i;
    Qs[idx] = row < Nq ? q[b * qs.b + h * qs.h + (long long)row * qs.n + d] * scale
                       : 0.f;
  }
  float acc[BQ][COLS];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  // running max / sum of this warp's 4 rows (same value in every lane)
  float m_r[4], l_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m_r[r] = -INFINITY; l_r[r] = 0.f; }

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // previous tile's P and V are consumed; Q is staged
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Nk) {
        kv = kp[(long long)key * ks.n + d];
        vv = vp[(long long)key * vs.n + d];
      }
      Ks[j * KP + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores of rows 4*warp .. 4*warp+3 against key `lane`
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* krow = Ks + lane * KP;
    const float* q0 = Qs + (4 * warp) * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2],
                  k_3 = krow[d + 3];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(q0 + r * D + d);
        s[r] = fmaf(qq.x, k_0, s[r]);
        s[r] = fmaf(qq.y, k_1, s[r]);
        s[r] = fmaf(qq.z, k_2, s[r]);
        s[r] = fmaf(qq.w, k_3, s[r]);
      }
    }
    const bool valid = k0 + lane < Nk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sv = valid ? s[r] : -INFINITY;
      float mt = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_r[r], mt);
      const float p = expf(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + ps;
      m_r[r] = m_new;
      Pt[lane * BQ + 4 * warp + r] = p;
      if (lane == 0) alpha_s[4 * warp + r] = alpha;
    }
    __syncthreads();

    // acc[i][c] = acc[i][c] * alpha[i] + sum_j P[i][j] * V[j][col c]
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      const float a = alpha_s[i];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float vv[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = tid + c * NT;
        vv[c] = col < D ? Vs[j * D + col] : 0.f;
      }
#pragma unroll
      for (int i4 = 0; i4 < BQ / 4; ++i4) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * BQ + 4 * i4);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          acc[4 * i4 + 0][c] = fmaf(p4.x, vv[c], acc[4 * i4 + 0][c]);
          acc[4 * i4 + 1][c] = fmaf(p4.y, vv[c], acc[4 * i4 + 1][c]);
          acc[4 * i4 + 2][c] = fmaf(p4.z, vv[c], acc[4 * i4 + 2][c]);
          acc[4 * i4 + 3][c] = fmaf(p4.w, vv[c], acc[4 * i4 + 3][c]);
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l_s[4 * warp + r] = l_r[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    const int row = row0 + i;
    if (row >= Nq) break;
    const float inv = 1.f / l_s[i];
    float* op = o + b * os.b + h * os.h + (long long)row * os.n;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (tid + c * NT < D) op[tid + c * NT] = acc[i][c] * inv;
  }
}

// ====================================================== float32 D > 512, bfloat16 D > 1,920
// float32 above 512 and bfloat16 above the deep wgmma kernel's 1,920
// (flash_attention_sm90_deep.cu; JAX's kernel takes any D): math in fp32,
// and P stays fp32, so bfloat16 results are only closer to the plain
// version. No configuration's path reaches such a
// head in bf16: the kernel is right and simple, not fast. It is the float32 kernel above
// with nothing of size D in shared memory, so any D runs in 43 KiB. A block
// owns 16 query rows and a strip of up to 1,024 output columns (grid z: one
// strip up to D = 1,024); each thread keeps its 8 columns of the strip
// (one a 128-column chunk) for all 16 rows in registers. For each 32-key
// tile the scores are summed over the depth in chunks of 128 columns (the
// chunk of Q, scaled, and of K staged as fp32; Q is re-read from the L2 for
// each tile); the online softmax is the float32 kernel's; then the tile's V
// is staged chunk by chunk and each chunk updates one of the thread's
// columns. Bound: operations (FMA at 67 TFLOP/s in float32), and in
// practice the shared-memory reads of the products.
template <typename T> __device__ __forceinline__ float ld_f32(const T* p);
template <> __device__ __forceinline__ float ld_f32<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld_f32<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ void st_f32(T* p, float x);
template <> __device__ __forceinline__ void st_f32<float>(float* p, float x) { *p = x; }
template <> __device__ __forceinline__ void st_f32<bf16>(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int kDRows = 16;      // query rows a block: 4 warps x 4
constexpr int kDKeys = 32;      // keys a tile, one a lane
constexpr int kDThreads = 128;  // = kDChunk: thread t owns column t of each chunk
constexpr int kDChunk = 128;    // depth (and output) columns a pass stages
constexpr int kDCols = 8;       // chunks a strip: output columns a thread
constexpr int kDStrip = kDChunk * kDCols;  // output columns a block

constexpr size_t deep_smem_bytes() {
  return sizeof(float) * ((size_t)kDRows * kDChunk + (size_t)kDKeys * (kDChunk + 1) +
                          (size_t)kDKeys * kDChunk + (size_t)kDKeys * kDRows + 2 * kDRows);
}

template <typename T>
__global__ void __launch_bounds__(kDThreads)
flash_deep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int Nq, int Nk,
                  int D, Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int BQ = kDRows, BK = kDKeys, NT = kDThreads, DC = kDChunk, KP = DC + 1;
  constexpr int COLS = kDCols, STRIP = kDStrip;
  static_assert(NT == DC, "a thread owns one column of each chunk");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][DC] a depth chunk of q * scale
  float* Ks = Qs + BQ * DC;       // [BK][KP] the same chunk of the key tile
  float* Vs = Ks + BK * KP;       // [BK][DC] a column chunk of the tile's V
  float* Pt = Vs + BK * DC;       // [BK][BQ] probabilities, transposed
  float* alpha_s = Pt + BK * BQ;  // [BQ]
  float* l_s = alpha_s + BQ;      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BQ, col0 = blockIdx.z * STRIP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;

  float acc[BQ][COLS];
#pragma unroll
  for (int i = 0; i < BQ; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  float m_r[4], l_r[4];  // running max / sum of this warp's 4 rows
#pragma unroll
  for (int r = 0; r < 4; ++r) { m_r[r] = -INFINITY; l_r[r] = 0.f; }

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    // scores of rows 4*warp .. 4*warp+3 against key `lane`, over the depth
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0);
      __syncthreads();  // the last chunk's Q/K (and the last tile's P, V) are consumed
      for (int idx = tid; idx < BQ * DC; idx += NT) {
        const int i = idx / DC, d = idx % DC, row = row0 + i;
        Qs[idx] = row < Nq && d < dc ? ld_f32(qp + (long long)row * qs.n + d0 + d) * scale
                                     : 0.f;
      }
      for (int idx = tid; idx < BK * DC; idx += NT) {
        const int j = idx / DC, d = idx % DC, key = k0 + j;
        Ks[j * KP + d] = key < Nk && d < dc ? ld_f32(kp + (long long)key * ks.n + d0 + d)
                                            : 0.f;
      }
      __syncthreads();
      const float* krow = Ks + lane * KP;  // lane j reads bank (j + d) % 32
      const float* q0 = Qs + 4 * warp * DC;
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {  // columns past dc are zeros on both sides
        const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2], k_3 = krow[d + 3];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 qq = *reinterpret_cast<const float4*>(q0 + r * DC + d);
          s[r] = fmaf(qq.x, k_0, s[r]);
          s[r] = fmaf(qq.y, k_1, s[r]);
          s[r] = fmaf(qq.z, k_2, s[r]);
          s[r] = fmaf(qq.w, k_3, s[r]);
        }
      }
    }
    const bool valid = k0 + lane < Nk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sv = valid ? s[r] : -INFINITY;
      float mt = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_r[r], mt);
      const float p = expf(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + ps;
      m_r[r] = m_new;
      Pt[lane * BQ + 4 * warp + r] = p;
      if (lane == 0) alpha_s[4 * warp + r] = alpha;
    }
    __syncthreads();  // P and alpha are in place

#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      const float a = alpha_s[i];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= a;
    }
    // acc[i][c] += sum_j P[i][j] * V[j][col0 + c*DC + tid], a chunk at a time
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int c0 = col0 + c * DC;
      if (c0 >= D) break;  // the same for every thread
      if (c) __syncthreads();  // the last chunk's V is consumed
      for (int idx = tid; idx < BK * DC; idx += NT) {
        const int j = idx / DC, col = c0 + idx % DC, key = k0 + j;
        Vs[idx] = key < Nk && col < D ? ld_f32(vp + (long long)key * vs.n + col) : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < BK; ++j) {
        const float vv = Vs[j * DC + tid];
#pragma unroll
        for (int i4 = 0; i4 < BQ / 4; ++i4) {
          const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * BQ + 4 * i4);
          acc[4 * i4 + 0][c] = fmaf(p4.x, vv, acc[4 * i4 + 0][c]);
          acc[4 * i4 + 1][c] = fmaf(p4.y, vv, acc[4 * i4 + 1][c]);
          acc[4 * i4 + 2][c] = fmaf(p4.z, vv, acc[4 * i4 + 2][c]);
          acc[4 * i4 + 3][c] = fmaf(p4.w, vv, acc[4 * i4 + 3][c]);
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) l_s[4 * warp + r] = l_r[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    const int row = row0 + i;
    if (row >= Nq) break;
    const float inv = 1.f / l_s[i];
    T* op = o + b * os.b + h * os.h + (long long)row * os.n;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = col0 + c * DC + tid;
      if (col < D) st_f32(op + col, acc[i][c] * inv);
    }
  }
}

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
// D is a multiple of 8 from 8 to FLASH_PROBE_DEEP_ABOVE (the entry point
// routes the rest).
template <int BQ, int NT, int COLS>
cudaError_t launch_wide_f32(const float* q, const float* k, const float* v, float* o,
                            int B, int H, int Nq, int Nk, int D, Strides qs,
                            Strides ks, Strides vs, Strides os, float scale,
                            cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<BQ>(D);
  auto kern = flash_wide_kernel<BQ, NT, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(q, k, v, o, H, Nq, Nk, D, qs, ks, vs, os, scale);
  return cudaSuccess;
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o,
                       int B, int H, int Nq, int Nk, int D, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if (D <= 256) {
    e = launch_wide_f32<32, 256, 1>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, os, scale,
                                    stream);
  } else if (D <= 512) {
    e = launch_wide_f32<32, 256, 2>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, os, scale,
                                    stream);
  } else {
#if FLASH_PROBE_DEEP_ABOVE > 512  // 16 rows a block keep the fp32 tiles within shared memory
    e = launch_wide_f32<16, 128, 5>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, os, scale,
                                    stream);
#else
    return cudaErrorInvalidValue;
#endif
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_deep(const T* q, const T* k, const T* v, T* o, int B, int H, int Nq,
                        int Nk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = deep_smem_bytes();
  auto kern = flash_deep_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int strips = (D + kDStrip - 1) / kDStrip;
  if (strips > 65535) return cudaErrorInvalidValue;
  dim3 grid((Nq + kDRows - 1) / kDRows, B * H, strips);
  kern<<<grid, kDThreads, smem, stream>>>(q, k, v, o, H, Nq, Nk, D, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

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

// dtype: 0 = float32 (any D that is a multiple of 8: flash_deep_kernel
// above 512), 1 = bfloat16 (D = 8 .. 32, and flash_deep_kernel above 1,920;
// ops/attention.py routes the D between to the wgmma kernels, and they are
// refused here). Strides are in elements. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ealdm_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Nq, int Nk, int D, long long q_sb, long long q_sh,
    long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D < 8 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn},
      os{o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > FLASH_PROBE_DEEP_ABOVE && dtype == 0)
    return (int)launch_deep(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<float*>(o), B, H, Nq,
                            Nk, D, qs, ks, vs, os, scale, s);
  if (D > 1920 && dtype == 1)
    return (int)launch_deep(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H, Nq,
                            Nk, D, qs, ks, vs, os, scale, s);
  if (dtype == 0)
    return (int)launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o), B,
                           H, Nq, Nk, D, qs, ks, vs, os, scale, s);
  if (dtype == 1)
    return (int)launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H,
                            Nq, Nk, D, qs, ks, vs, os, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ealdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
