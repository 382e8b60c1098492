// Fused GroupNorm(+pre-bias)(+SiLU) for sm_90a.
//
// Replaces: ealdm_tpu/ops/group_norm_pallas.py `_single_kernel` (:103) and
// `_chunked_kernel` (:123) (via `group_norm_hwnc`), wrapped by
// ealdm_tpu/ops/norms.py `_group_norm_pallas`. Computes, per (sample n, group g):
//   v = x + pre_bias[n, c]            (optional; the ResBlock timestep bias)
//   y = (v - mean) * rsqrt(var + eps) * scale[c] + bias[c]
//   y = y * sigmoid(y)                (optional)
// with fp32 statistics, scale/bias in fp32, y stored in the input type.
//
// Bound on this card: bytes. A call reads x once and writes y once with a few
// operations per element: 50 MB for the UNet's commonest [48,256,32,32] bf16
// site (0.015 ms at 3.35 TB/s), 805 MB for the VAE's [24,128,256,256].
//
// Two layouts, each with a one-read and a two-read path:
//
// * channels_last, dense per sample ([N, H*W, C] in memory: every tensor the
//   model's convolutions hand the norms). A sample is one contiguous block of
//   H*W rows of C channels. Thread t owns the 16-byte vectors t, t + NW, ...
//   of its rows; NW is a multiple of C/V (V channels a vector), so each
//   thread keeps the same V channels throughout and loads their pre-bias,
//   scale and bias once. NW is the block's thread count when that count can
//   be a multiple of both 32 and C/V within 512 threads; otherwise (C/V =
//   84, 140, 168, 196 ...: the pixel UNet's 672 to 1568 channels) the block
//   rounds NW up to a multiple of 32 and the extra threads take part in the
//   reductions only (`work_threads`). Statistics are per-channel partials combined into
//   per-group totals (a vector may span two groups when C/G < V) in a fixed
//   order, never atomics. Values are shifted by the sample's first value of
//   each group before they are summed (d = v - v[row 0, first channel of g]),
//   so fp32 sums of data far from 0 keep their digits.
//   - `gn_cluster_kernel`, samples whose ceil(H*W / 8) rows fit kSliceBytes
//     (1.5 MiB bf16: every UNet site): a cluster of 8 CTAs owns a sample,
//     each CTA a contiguous slice of its rows, brought into shared memory in
//     the input type by 1-D bulk copies (`cp.async.bulk`) completing on
//     mbarriers, in pieces so the statistics start on the first. Each CTA
//     takes its slice's per-group mean and then M2 = sum (d - mean)^2 (two
//     passes over shared memory); the 8 (count, mean, M2) are merged by
//     Chan's formula through distributed shared memory in a fixed shuffle
//     tree, after one cluster barrier. The CTA then normalises from shared
//     memory and writes 16-byte stores: one read and one write of device
//     memory. The grid holds as many clusters as fit on the card at once
//     (balanced over the samples); each loops over its samples and refills
//     every piece with the next sample's rows once the piece is normalised.
//   - larger samples (the VAE's top levels) take two kernels and read x
//     twice. `gn_tile_stats_kernel` computes the same per-tile (mean, M2)
//     over contiguous row tiles staged the same way and writes them to an
//     fp32 scratch; `gn_tile_apply_kernel` merges its sample's tiles by
//     Chan's formula (fixed order: lane ranges, then a shuffle tree) and
//     streams its rows through registers with 16-byte loads and stores,
//     walking the samples and tiles in reverse so its first reads find the
//     last tiles of the stats kernel still in L2. Two kernels, not one
//     cluster that reads twice: a 16 MiB sample does not fit a cluster's
//     shared memory, the second read would not come from L2 either way, and
//     independent tiles keep every SM busy without co-scheduling clusters.
//   Why not the bound: every CTA of the one-read kernel reads, reduces and
//   writes in step with the others, so the reductions, the cluster barrier
//   and the merge between the last read and the first write leave device
//   memory idle; and at 64 KiB slices 3 CTAs fit an SM, which holds 45
//   clusters, not the UNet's 48 samples (PERF.md has the phase times).
// * NCHW-contiguous (public NCHW callers, tests): PR 1's kernels, kept for
//   this layout only. A group is one contiguous run of C/G * H*W elements.
//   `gn_single_kernel`: one block a group of up to 32768 elements, held in
//   shared memory as fp32, two passes (the mean of v - K, K the group's
//   first value, then E[(v - mean)^2]). `gn_partial_kernel` +
//   `gn_apply_kernel` above that: chunk sums of (v - K) and (v - K)^2 to an
//   fp32 scratch, combined in double, var = max(E[(v-K)^2] - E[v-K]^2, 0).
//
// Built with -DGN_TRACE, the one-read kernel also records per-CTA phase
// timestamps (`ealdm_torch/kernels/trace_group_norm.py` reads them).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace coop = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float silu_f(float y) { return __fdividef(y, 1.f + __expf(-y)); }

__device__ __forceinline__ float affine_act(float v, float mean, float rstd,
                                            float sc, float bi, int silu) {
  float y = (v - mean) * rstd * sc + bi;
  if (silu) y = silu_f(y);
  return y;
}

// ---------------------------------------------------------------- channels_last

// A 16-byte vector of T as V floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k in the low half
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&b);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

constexpr int kClusterCtas = 8;          // portable cluster size
constexpr int kSliceBytes = 192 * 1024;  // a one-read CTA's rows, input type
constexpr int kTileBytes = 64 * 1024;    // a stats tile of the two-read path
constexpr int kApplyTiles = 8;           // stats tiles per apply CTA, at most
constexpr int kApplyUnroll = 8;          // 16-byte vectors in flight per apply thread
constexpr int kChunks = 4;               // bulk copies (mbarriers) per slice
constexpr int kMaxSmem = 232448;         // dynamic shared memory a block can use

// Shared memory of the staging kernels, in bytes from the base: kChunks
// mbarriers, `part` (mean and M2 per group), `coef` (mean and rstd per
// group), `red` (one fp32 per channel and row lane) and the staged rows.
struct SmemLayout {
  int part, coef, red, buf, total;
};

__host__ __device__ inline SmemLayout smem_layout(int G, int nt, int vec, int slice_bytes) {
  SmemLayout s;
  s.part = kChunks * 8;
  s.coef = s.part + 2 * G * 4;
  s.red = s.coef + 2 * G * 4;
  s.buf = (s.red + nt * vec * 4 + 127) / 128 * 128;
  s.total = s.buf + slice_bytes;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // acquire
}

#ifdef GN_TRACE
// Per CTA of the one-read kernel's first sample: 16 %globaltimer stamps
// (ns), taken by thread 0 after a __syncthreads.
constexpr int kTraceCtas = 4096;
__device__ unsigned long long g_trace[16 * kTraceCtas];
__device__ __forceinline__ void mark(int k) {
  __syncthreads();
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && cta < kTraceCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[cta * 16 + k] = t;
  }
}
#define MARK(first, k) \
  if (first) mark(k)
#else
#define MARK(first, k)
#endif

// A CTA's `rows` rows of `row_bytes` (a multiple of 16) staged in up to
// kChunks pieces of whole rows (the last may be shorter), piece k completing
// on mbarrier k. Whole rows keep a piece's first vector on channel 0, so a
// thread that walks a piece from its own index meets its own channels.
struct Staging {
  int bytes, chunk;
  __device__ Staging(int rows, int row_bytes)
      : bytes(rows * row_bytes), chunk((rows + kChunks - 1) / kChunks * row_bytes) {}
  __device__ int pieces() const { return chunk ? (bytes + chunk - 1) / chunk : 0; }
  __device__ int piece_vecs() const { return max(chunk / 16, 1); }
};

// Thread 0: the kChunks mbarriers, one arrival (its own) a phase.
__device__ void init_bars(uint64_t* bars) {
  for (int k = 0; k < kChunks; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(&bars[k])), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Thread 0: start the 1-D bulk copy of piece k of the rows at `src` into
// `dst`, completing the next phase of bars[k].
__device__ void load_piece(void* dst, const void* src, const Staging& s, int k,
                           uint64_t* bars) {
  const int off = k * s.chunk, n = min(s.chunk, s.bytes - off);
  const uint32_t bar = smem_u32(&bars[k]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(n) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(static_cast<char*>(dst) + off)),
         "l"(static_cast<const char*>(src) + off), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The threads that own vectors: the largest multiple of C / V in the block
// (the block is a multiple of 32 threads).
__device__ __forceinline__ int work_threads(int C, int V) {
  const int tpr = C / V;
  return blockDim.x / tpr * tpr;
}

// out[g] = the sum over the block of every thread's per-channel values
// `val` that belong to group g, in a fixed order. red: blockDim.x * V floats
// ([row lane][C]); the first work_threads(C, V) threads' rows are summed.
template <int V>
__device__ void group_sums(const float (&val)[V], float* red, float* out, int C, int G) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(&red[t * V + i]) =
        make_float4(val[i], val[i + 1], val[i + 2], val[i + 3]);
  __syncthreads();
  const int cg = C / G, lanes = work_threads(C, V) * V / C;
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < G; g += blockDim.x / 32) {
    float acc = 0.f;
    for (int e = lane; e < lanes * cg; e += 32) {
      const int r = e / cg;
      acc += red[r * C + g * cg + (e - r * cg)];
    }
    acc = warp_sum(acc);
    if (lane == 0) out[g] = acc;
  }
  __syncthreads();
}

// The thread's V channels c0 .. c0 + V - 1: off = pre-bias - shift, the
// shift being v at row 0 and the first channel of the channel's group, so
// that d = x + off is the shifted value. (Each channel's off rounds once;
// with x far from 0 that moves d by at most half an ulp of the shift.)
template <typename T, int V>
__device__ __forceinline__ void channel_offsets(const T* xs, const T* pre_n, long long psc,
                                                int c0, int cg, float (&off)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = c0 + i, cf = c / cg * cg;
    const float pc = pre_n ? to_f32(pre_n[c * psc]) : 0.f;
    const float pf = pre_n ? to_f32(pre_n[cf * psc]) : 0.f;
    off[i] = pc - (to_f32(xs[cf]) + pf);
  }
}

// Per-group mean and M2 of the shifted values over the `rows` staged rows
// (`nvec` vectors at `buf`, arriving in pieces of `piece_vecs` that complete
// phase `parity` of `bars`): part[g] = mean, part[G + g] = M2, both over
// rows * C/G values (0 and 0 for no rows). Two passes over shared memory:
// the mean, then sum (d - mean)^2.
template <typename T>
__device__ void slice_stats(const uint4* buf, int nvec, int rows, int piece_vecs,
                            uint64_t* bars, int parity, const float (&off)[Vec<T>::V],
                            int c0, int C, int G, float* red, float* part, bool trace) {
  constexpr int V = Vec<T>::V;
  const int cg = C / G;
  const int nw = work_threads(C, V), t0 = threadIdx.x < nw ? threadIdx.x : nvec;
  float s[V] = {};
  int ready = 0;  // pieces known to have arrived
  for (int v = t0; v < nvec; v += nw) {
    while (v >= ready * piece_vecs) {
      while (!mbar_try_wait(smem_u32(&bars[ready]), parity)) {
      }
      ++ready;
    }
    float f[V];
    Vec<T>::unpack(buf[v], f);
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += f[i] + off[i];
  }
  MARK(trace, 6);
  group_sums<V>(s, red, part, C, G);
  MARK(trace, 7);
  const float cnt = (float)rows * cg;
  float om[V];  // off - mean: e = x + om (its rounding moves M2 by a part in 1e9)
#pragma unroll
  for (int i = 0; i < V; ++i) om[i] = off[i] - (rows ? part[(c0 + i) / cg] / cnt : 0.f);
  float q[V] = {};
  for (int v = t0; v < nvec; v += nw) {
    float f[V];
    Vec<T>::unpack(buf[v], f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float e = f[i] + om[i];
      q[i] = fmaf(e, e, q[i]);
    }
  }
  MARK(trace, 8);
  group_sums<V>(q, red, part + G, C, G);
  MARK(trace, 9);
  for (int g = threadIdx.x; g < G; g += blockDim.x) part[g] = rows ? part[g] / cnt : 0.f;
}

// Chan's merge of (nb, meanb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float meanb, float m2b) {
  if (nb == 0.f) return;
  const float tot = n + nb, f = nb / tot, delta = meanb - mean;
  mean += delta * f;
  m2 += m2b + delta * delta * n * f;
  n = tot;
}

// y for the thread's V channels from the staged or loaded vector `u`.
template <typename T>
__device__ __forceinline__ uint4 normalize(const uint4& u, const float (&off)[Vec<T>::V],
                                           const float (&mean)[Vec<T>::V],
                                           const float (&a)[Vec<T>::V],
                                           const float (&b)[Vec<T>::V], int silu) {
  constexpr int V = Vec<T>::V;
  float f[V];
  Vec<T>::unpack(u, f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float y = fmaf((f[i] + off[i]) - mean[i], a[i], b[i]);
    f[i] = silu ? silu_f(y) : y;
  }
  return Vec<T>::pack(f);
}

// Per-channel mean (shifted), a = rstd * scale and b = bias of the thread's
// channels from coef (mean at [g], rstd at [G + g]).
template <int V>
__device__ __forceinline__ void channel_affine(const float* coef, const float* scale,
                                               const float* bias, int c0, int cg, int G,
                                               float (&mean)[V], float (&a)[V],
                                               float (&b)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = c0 + i, g = c / cg;
    mean[i] = coef[g];
    a[i] = coef[G + g] * scale[c];
    b[i] = bias[c];
  }
}

// Persistent: cluster c (blockIdx.y) takes samples c, c + gridDim.y, ...
// Each CTA stages its slice of the first, and refills each piece with the
// next sample's as soon as the piece is normalised, so the next sample's
// reads overlap this one's normalisation and writes.
template <typename T>
__global__ void __launch_bounds__(512, 2)
gn_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const T* __restrict__ pre, long long psn, long long psc, int N, int C,
                  int HW, int G, float eps, int silu) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = (int)cluster.block_rank(), cgc = C / G, t = threadIdx.x;
  const SmemLayout L = smem_layout(G, blockDim.x, V, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* coef = reinterpret_cast<float*>(smem + L.coef);
  float* red = reinterpret_cast<float*>(smem + L.red);
  unsigned char* stage = smem + L.buf;
  const uint4* buf = reinterpret_cast<const uint4*>(stage);

  const int rpc = (HW + kClusterCtas - 1) / kClusterCtas;
  const int r0 = min(rank * rpc, HW), rows = min(rpc, HW - r0);
  const int nvec = rows * C / V;
  const Staging st(rows, C * (int)sizeof(T));
  const long long sample = (long long)HW * C;
  const int first = blockIdx.y, samples = (N - first + gridDim.y - 1) / gridDim.y;
  const int c0 = t % (C / V) * V;
  // the offsets are read before the rows are requested, so that they do not
  // queue behind them (the next sample's, once its rows are on their way,
  // wait for them no longer than the rows themselves)
  float off[V];
  channel_offsets<T, V>(x + first * sample, pre ? pre + first * psn : nullptr, psc, c0, cgc,
                        off);
  __syncthreads();
  if (t == 0) {
    init_bars(bars);
    for (int k = 0; k < st.pieces(); ++k)
      load_piece(stage, x + first * sample + (long long)r0 * C, st, k, bars);
  }
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < samples; ++i) {
    MARK(i == 0, 0);
    const int n = first + i * gridDim.y;
    const T* xs = x + n * sample;
    slice_stats<T>(buf, nvec, rows, st.piece_vecs(), bars, i & 1, off, c0, C, G, red, part,
                   i == 0);
    MARK(i == 0, 1);
    cluster_arrive();  // every CTA's part is written
    cluster_wait();
    MARK(i == 0, 2);
    // per group, 8 lanes read the 8 CTAs' (mean, M2) and merge them by a
    // fixed shuffle tree: every CTA of the cluster gets the same result
    for (int base = 0; base < G * kClusterCtas; base += blockDim.x) {
      const int g = (base + t) / kClusterCtas, k = (base + t) % kClusterCtas;
      const int rk = max(0, min(rpc, HW - k * rpc));
      float cnt = 0.f, mean = 0.f, m2 = 0.f;
      if (g < G && rk > 0) {
        const float* pk = cluster.map_shared_rank(part, k);
        cnt = (float)rk * cgc;
        mean = pk[g];
        m2 = pk[G + g];
      }
#pragma unroll
      for (int o = kClusterCtas / 2; o > 0; o >>= 1) {
        const float nb = __shfl_down_sync(0xffffffffu, cnt, o);
        const float mb = __shfl_down_sync(0xffffffffu, mean, o);
        const float qb = __shfl_down_sync(0xffffffffu, m2, o);
        if (k < o) chan_merge(cnt, mean, m2, nb, mb, qb);
      }
      if (g < G && k == 0) {
        coef[g] = mean;
        coef[G + g] = rsqrtf(m2 / ((float)HW * cgc) + eps);
      }
    }
    cluster_arrive();  // done reading the other CTAs' part
    const bool refill = i + 1 < samples;
    __syncthreads();
    MARK(i == 0, 3);
    float mean[V], a[V], b[V];
    channel_affine<V>(coef, scale, bias, c0, cgc, G, mean, a, b);
    uint4* out = reinterpret_cast<uint4*>(y + n * sample + (long long)r0 * C);
    const int nw = work_threads(C, V);
    for (int k = 0; k < st.pieces(); ++k) {
      const int end = t < nw ? min((k + 1) * st.piece_vecs(), nvec) : 0;
      for (int v = k * st.piece_vecs() + t; v < end; v += nw)
        out[v] = normalize<T>(buf[v], off, mean, a, b, silu);
      if (refill) {
        __syncthreads();  // piece k is read
        if (t == 0) load_piece(stage, xs + gridDim.y * sample + (long long)r0 * C, st, k, bars);
      }
    }
    MARK(i == 0, 4);
    if (refill)
      channel_offsets<T, V>(xs + gridDim.y * sample, pre ? pre + (n + gridDim.y) * psn : nullptr,
                            psc, c0, cgc, off);
    cluster_wait();  // no CTA writes part, or leaves, while another reads it
    MARK(i == 0, 5);
  }
}

template <typename T>
__global__ void __launch_bounds__(512, 2)
gn_tile_stats_kernel(const T* __restrict__ x, const T* __restrict__ pre, long long psn,
                     long long psc, int C, int HW, int G, int tile_rows,
                     float* __restrict__ partial) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.y, tile = blockIdx.x, cgc = C / G;
  const SmemLayout L = smem_layout(G, blockDim.x, V, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int r0 = tile * tile_rows, rows = min(tile_rows, HW - r0);
  const long long base = (long long)n * HW * C;
  const Staging st(rows, C * (int)sizeof(T));
  const int c0 = threadIdx.x % (C / V) * V;
  float off[V];  // read before the rows are requested, not behind them
  channel_offsets<T, V>(x + base, pre ? pre + n * psn : nullptr, psc, c0, cgc, off);
  __syncthreads();
  if (threadIdx.x == 0) {
    init_bars(bars);
    for (int k = 0; k < st.pieces(); ++k)
      load_piece(smem + L.buf, x + base + (long long)r0 * C, st, k, bars);
  }
  __syncthreads();
  slice_stats<T>(reinterpret_cast<const uint4*>(smem + L.buf), rows * C / V, rows,
                 st.piece_vecs(), bars, 0, off, c0, C, G, red, part, false);
  __syncthreads();
  float* out = partial + ((long long)n * gridDim.x + tile) * 2 * G;
  for (int i = threadIdx.x; i < 2 * G; i += blockDim.x) out[i] = part[i];
}

template <typename T>
__global__ void __launch_bounds__(512)
gn_tile_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ pre, long long psn, long long psc, int C,
                     int HW, int G, float eps, int silu, int tile_rows, int tiles,
                     int rows_per, const float* __restrict__ partial) {
  constexpr int V = Vec<T>::V;
  extern __shared__ float coef[];  // mean at [g], rstd at [G + g]
  // reverse order: the stats kernel's last tiles are the likeliest in L2
  const int n = gridDim.y - 1 - blockIdx.y, blk = gridDim.x - 1 - blockIdx.x;
  const int cgc = C / G, t = threadIdx.x, lane = t % 32;

  // merge the sample's tiles per group: each lane a contiguous range of
  // tiles in order, then a fixed shuffle tree; every CTA of the sample does
  // the same arithmetic, so all agree
  const float* ps = partial + (long long)n * tiles * 2 * G;
  const int per = (tiles + 31) / 32;
  for (int g = t / 32; g < G; g += blockDim.x / 32) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = lane * per; k < min(tiles, (lane + 1) * per); ++k) {
      const int rk = min(tile_rows, HW - k * tile_rows);
      chan_merge(cnt, mean, m2, (float)rk * cgc, ps[k * 2 * G + g], ps[k * 2 * G + G + g]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off);
      const float qb = __shfl_down_sync(0xffffffffu, m2, off);
      if (lane < off) chan_merge(cnt, mean, m2, nb, mb, qb);
    }
    if (lane == 0) {
      coef[g] = mean;
      coef[G + g] = rsqrtf(m2 / ((float)HW * cgc) + eps);
    }
  }
  __syncthreads();

  const long long base = (long long)n * HW * C;
  const int c0 = t % (C / V) * V;
  float off[V], mean[V], a[V], b[V];
  channel_offsets<T, V>(x + base, pre ? pre + n * psn : nullptr, psc, c0, cgc, off);
  channel_affine<V>(coef, scale, bias, c0, cgc, G, mean, a, b);
  const int r0 = blk * rows_per;
  const int nvec = min(rows_per, HW - r0) * C / V;
  const uint4* src = reinterpret_cast<const uint4*>(x + base + (long long)r0 * C);
  uint4* dst = reinterpret_cast<uint4*>(y + base + (long long)r0 * C);
  const int nw = work_threads(C, V);
  for (int v0 = t < nw ? t : nvec; v0 < nvec; v0 += kApplyUnroll * nw) {
    uint4 u[kApplyUnroll];
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      const int v = v0 + k * nw;
      if (v < nvec) u[k] = __ldg(src + v);
    }
#pragma unroll
    for (int k = 0; k < kApplyUnroll; ++k) {
      const int v = v0 + k * nw;
      if (v < nvec) dst[v] = normalize<T>(u[k], off, mean, a, b, silu);
    }
  }
}

// Threads per block for C channels of V per vector, about `want`: a
// multiple of 32 and of C / V where one up to 512 exists; else a multiple
// of C / V (the work threads) rounded up to 32. 0 if C / V exceeds 512.
int cl_threads(int C, int V, int want) {
  const int tpr = C / V;
  int l = tpr;
  while (l % 32) l += tpr;  // lcm(tpr, 32)
  if (l <= 512) return l * (l < want ? want / l : 1);
  if (tpr > 512) return 0;
  return (tpr * std::max(1, want / tpr) + 31) / 32 * 32;
}

bool bad_cl_shape(int N, int C, int HW, int G, int V) {
  return N <= 0 || N > 65535 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
         C % V != 0 || cl_threads(C, V, 256) == 0 || (long long)HW * C >= (1LL << 31);
}

// Clusters of `kern` the card holds at once for the launch `cfg` (its
// shared memory and threads); the query takes microseconds, so each answer
// is kept. 0 if the query fails.
template <typename K>
int resident_clusters(K kern, const cudaLaunchConfig_t& cfg) {
  static std::mutex mu;
  static std::map<std::tuple<int, size_t, unsigned>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(dev, cfg.dynamicSmemBytes, cfg.blockDim.x);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    it = known.emplace(key, n).first;
  }
  return it->second;
}

// The one-read launch: cluster dims, threads (512 for slices over half of
// kSliceBytes, which leave an SM one CTA, else 256) and shared memory.
template <typename T>
cudaError_t cluster_config(int N, int C, int HW, int G, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  constexpr int V = Vec<T>::V;
  const int rpc = (HW + kClusterCtas - 1) / kClusterCtas;
  const long long slice = (long long)rpc * C * sizeof(T);
  const int nt = cl_threads(C, V, slice > kSliceBytes / 2 ? 512 : 256);
  const SmemLayout L = smem_layout(G, nt, V, (int)slice);
  if (slice > kSliceBytes || L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = gn_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L.total);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kClusterCtas, N);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* y, const float* scale, const float* bias,
                           const void* pre, long long psn, long long psc, int N, int C,
                           int HW, int G, float eps, int silu, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<T>(N, C, HW, G, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  // as many clusters as fit at once, each looping over an equal share of
  // the samples
  auto kern = gn_cluster_kernel<T>;
  const int resident = resident_clusters(kern, cfg);
  if (resident > 0 && resident < N) {
    const int rounds = (N + resident - 1) / resident;
    cfg.gridDim.y = (N + rounds - 1) / rounds;
  }
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                         static_cast<T*>(y), scale, bias, static_cast<const T*>(pre), psn,
                         psc, N, C, HW, G, eps, silu);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles(const void* x, void* y, const float* scale, const float* bias,
                         const void* pre, float* scratch, long long psn, long long psc,
                         int N, int C, int HW, int G, float eps, int silu, int tile_rows,
                         cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const int nt = cl_threads(C, V, 256);
  const long long tile = (long long)tile_rows * C * sizeof(T);
  const SmemLayout L = smem_layout(G, nt, V, (int)tile);
  if (tile_rows <= 0 || tile > kTileBytes || L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int tiles = (HW + tile_rows - 1) / tile_rows;
  auto stats = gn_tile_stats_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L.total);
  if (e != cudaSuccess) return e;
  stats<<<dim3(tiles, N), nt, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pre), psn, psc, C, HW, G, tile_rows,
      scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // an apply CTA takes up to kApplyTiles tiles, fewer when that would leave
  // fewer than 4 CTAs an SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_cta = std::max(1, std::min(kApplyTiles, N * tiles / (4 * sms)));
  const int rows_per = tile_rows * per_cta;
  gn_tile_apply_kernel<T><<<dim3((HW + rows_per - 1) / rows_per, N), nt,
                            2 * G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, static_cast<const T*>(pre),
      psn, psc, C, HW, G, eps, silu, tile_rows, tiles, rows_per, scratch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- NCHW

constexpr int NT = 256;
constexpr int SINGLE_MAX_ELEMS = 32768;

// Sum over the block; every thread gets the result.
template <typename A>
__device__ A block_sum(A val, A* red) {
  __syncthreads();  // `red` may still be read from a previous call
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) val += __shfl_xor_sync(0xffffffffu, val, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = val;
  __syncthreads();
  A tot = 0;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) tot += red[w];
  return tot;
}

// Element i of group (n, g) of a dense NCHW tensor is at (n * C + c0) * HW + i.
template <typename T>
__device__ __forceinline__ float load_v(const T* x, const T* pre, long long psn,
                                        long long psc, long long base, int n, int c,
                                        int i) {
  float v = to_f32(x[base + i]);
  if (pre) v += to_f32(pre[n * psn + c * psc]);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT)
gn_single_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const T* __restrict__ pre, long long psn, long long psc, int C, int HW,
                 int G, float eps, int silu) {
  extern __shared__ float buf[];  // the group, [cg * HW] fp32
  __shared__ float red[NT / 32];
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G, c0 = g * cg, cnt = cg * HW;
  const long long base = ((long long)n * C + c0) * HW;

  const float shift = load_v(x, pre, psn, psc, base, n, c0, 0);
  float sum = 0.f;
  for (int i = threadIdx.x; i < cnt; i += NT) {
    const float v = load_v(x, pre, psn, psc, base, n, c0 + i / HW, i);
    buf[i] = v;
    sum += v - shift;
  }
  const float mean = shift + block_sum(sum, red) / cnt;
  float sq = 0.f;
  for (int i = threadIdx.x; i < cnt; i += NT) {
    const float d = buf[i] - mean;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / cnt;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < cnt; i += NT) {
    const int c = c0 + i / HW;
    y[base + i] = from_f32<T>(affine_act(buf[i], mean, rstd, scale[c], bias[c], silu));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gn_partial_kernel(const T* __restrict__ x, const T* __restrict__ pre, long long psn,
                  long long psc, int C, int HW, int G, int chunk, int chunks,
                  float* __restrict__ partial) {
  __shared__ float red[NT / 32];
  const int ng = blockIdx.y;
  const int n = ng / G, g = ng % G;
  const int cg = C / G, c0 = g * cg, cnt = cg * HW;
  const long long base = ((long long)n * C + c0) * HW;
  const int start = blockIdx.x * chunk, end = min(start + chunk, cnt);
  const float shift = load_v(x, pre, psn, psc, base, n, c0, 0);
  float s1 = 0.f, s2 = 0.f;
  for (int i = start + threadIdx.x; i < end; i += NT) {
    const float d = load_v(x, pre, psn, psc, base, n, c0 + i / HW, i) - shift;
    s1 += d;
    s2 += d * d;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    float* out = partial + 2 * ((long long)ng * chunks + blockIdx.x);
    out[0] = s1;
    out[1] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const T* __restrict__ pre, long long psn, long long psc, int C, int HW,
                int G, float eps, int silu, int chunk, int chunks,
                const float* __restrict__ partial) {
  __shared__ double red[NT / 32];
  const int ng = blockIdx.y;
  const int n = ng / G, g = ng % G;
  const int cg = C / G, c0 = g * cg, cnt = cg * HW;
  const long long base = ((long long)n * C + c0) * HW;
  double s1 = 0.0, s2 = 0.0;
  for (int j = threadIdx.x; j < chunks; j += NT) {
    const float* pp = partial + 2 * ((long long)ng * chunks + j);
    s1 += pp[0];
    s2 += pp[1];
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const double m1 = s1 / cnt;
  const float var = (float)fmax(s2 / cnt - m1 * m1, 0.0);
  const float shift = load_v(x, pre, psn, psc, base, n, c0, 0);
  const float mean = shift + (float)m1;
  const float rstd = rsqrtf(var + eps);
  const int start = blockIdx.x * chunk, end = min(start + chunk, cnt);
  for (int i = start + threadIdx.x; i < end; i += NT) {
    const int c = c0 + i / HW;
    const float v = load_v(x, pre, psn, psc, base, n, c, i);
    y[base + i] = from_f32<T>(affine_act(v, mean, rstd, scale[c], bias[c], silu));
  }
}

template <typename T>
cudaError_t launch_single(const void* x, void* y, const float* scale, const float* bias,
                          const void* pre, long long psn, long long psc, int N, int C,
                          int HW, int G, float eps, int silu, cudaStream_t stream) {
  const int cnt = (C / G) * HW;
  const size_t smem = sizeof(float) * (size_t)cnt;
  auto kern = gn_single_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * SINGLE_MAX_ELEMS));
    if (e != cudaSuccess) return e;
  }
  kern<<<N * G, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias,
      static_cast<const T*>(pre), psn, psc, C, HW, G, eps, silu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_two_pass(const void* x, void* y, const float* scale, const float* bias,
                            const void* pre, float* scratch, long long psn, long long psc,
                            int N, int C, int HW, int G, float eps, int silu, int chunk,
                            int chunks, cudaStream_t stream) {
  dim3 grid(chunks, N * G);
  gn_partial_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pre), psn, psc, C, HW, G, chunk,
      chunks, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_apply_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias,
      static_cast<const T*>(pre), psn, psc, C, HW, G, eps, silu, chunk, chunks, scratch);
  return cudaGetLastError();
}

bool bad_shape(int N, int C, int HW, int G) {
  return N <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0;
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; x and y dense in the
// entry point's layout, y not overlapping x; scale/bias fp32 [C]; pre [N, C]
// in the input type with element strides psn (0 broadcasts one row) and psc,
// or null. Returns the cudaError_t of the launch.

// channels_last, one read: a cluster of 8 CTAs a sample, ceil(HW / 8) rows
// of C channels at most kSliceBytes a CTA; 16-byte aligned x, y, C * size a
// multiple of 16.
extern "C" int ealdm_group_norm_cl(const void* x, void* y, const void* scale,
                                   const void* bias, const void* pre, int dtype, int N,
                                   int C, int HW, int G, long long psn, long long psc,
                                   float eps, int silu, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !bad_cl_shape(N, C, HW, G, Vec<float>::V))
    return (int)launch_cluster<float>(x, y, sc, bi, pre, psn, psc, N, C, HW, G, eps, silu, s);
  if (dtype == 1 && !bad_cl_shape(N, C, HW, G, Vec<__nv_bfloat16>::V))
    return (int)launch_cluster<__nv_bfloat16>(x, y, sc, bi, pre, psn, psc, N, C, HW, G, eps,
                                              silu, s);
  return (int)cudaErrorInvalidValue;
}

// channels_last, two reads: tiles of `tile_rows` rows (at most kTileBytes);
// scratch holds N * ceil(HW / tile_rows) * 2 * G floats.
extern "C" int ealdm_group_norm_cl_two_read(const void* x, void* y, const void* scale,
                                            const void* bias, const void* pre,
                                            void* scratch, int dtype, int N, int C, int HW,
                                            int G, long long psn, long long psc, float eps,
                                            int silu, int tile_rows, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !bad_cl_shape(N, C, HW, G, Vec<float>::V))
    return (int)launch_tiles<float>(x, y, sc, bi, pre, sp, psn, psc, N, C, HW, G, eps, silu,
                                    tile_rows, s);
  if (dtype == 1 && !bad_cl_shape(N, C, HW, G, Vec<__nv_bfloat16>::V))
    return (int)launch_tiles<__nv_bfloat16>(x, y, sc, bi, pre, sp, psn, psc, N, C, HW, G, eps,
                                            silu, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}

// NCHW, one block a group of up to 32768 elements.
extern "C" int ealdm_group_norm(const void* x, void* y, const void* scale,
                                const void* bias, const void* pre, int dtype,
                                int N, int C, int HW, int G, long long psn,
                                long long psc, float eps, int silu, void* stream) {
  if (bad_shape(N, C, HW, G) || (C / G) * HW > SINGLE_MAX_ELEMS)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_single<float>(x, y, sc, bi, pre, psn, psc, N, C, HW, G, eps, silu, s);
  if (dtype == 1)
    return (int)launch_single<__nv_bfloat16>(x, y, sc, bi, pre, psn, psc, N, C, HW, G, eps,
                                             silu, s);
  return (int)cudaErrorInvalidValue;
}

// NCHW, two kernels; scratch holds 2 * N * G * chunks floats, and
// chunks * chunk covers the group's (C / G) * HW elements.
extern "C" int ealdm_group_norm_two_pass(
    const void* x, void* y, const void* scale, const void* bias, const void* pre,
    void* scratch, int dtype, int N, int C, int HW, int G, long long psn, long long psc,
    float eps, int silu, int chunk, int chunks, void* stream) {
  if (bad_shape(N, C, HW, G) || chunk <= 0 || chunks <= 0 ||
      (long long)chunk * chunks < (long long)(C / G) * HW || N * G > 65535)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_two_pass<float>(x, y, sc, bi, pre, sp, psn, psc, N, C, HW, G, eps,
                                       silu, chunk, chunks, s);
  if (dtype == 1)
    return (int)launch_two_pass<__nv_bfloat16>(x, y, sc, bi, pre, sp, psn, psc, N, C, HW, G,
                                               eps, silu, chunk, chunks, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef GN_TRACE
// The trace's stamps, then cleared: 16 per CTA (blockIdx.y * gridDim.x +
// blockIdx.x) of the one-read launches since the last call, for their first
// sample, in ns; 0 where not taken.
extern "C" int ealdm_group_norm_trace(unsigned long long* host, int ctas) {
  cudaError_t e = cudaMemcpyFromSymbol(
      host, g_trace, sizeof(unsigned long long) * 16 * std::min(ctas, kTraceCtas));
  void* addr = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&addr, g_trace);
  if (e == cudaSuccess) e = cudaMemset(addr, 0, sizeof(g_trace));
  return (int)e;
}

// The one-read launch of a bfloat16 [N, C, H*W] sample: CTAs an SM holds
// * 1000 + clusters the card holds at once.
extern "C" int ealdm_group_norm_cl_residency(int N, int C, int HW, int G) {
  typedef __nv_bfloat16 T;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_config<T>(N, C, HW, G, nullptr, cfg, attr) != cudaSuccess) return -1;
  auto kern = gn_cluster_kernel<T>;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, (int)cfg.blockDim.x,
                                                cfg.dynamicSmemBytes);
  return blocks * 1000 + resident_clusters(kern, cfg);
}
#endif

extern "C" const char* ealdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
