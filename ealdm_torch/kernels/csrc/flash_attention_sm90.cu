// Flash attention forward in bfloat16 for head dims up to 128, written for
// Hopper (sm_90a): wgmma products, TMA copies and a warp-specialised K/V ring.
//
// Replaces: ealdm_tpu/ops/attention.py `_flash_kernel` (via `_flash_forward`,
// public `flash_attention`) and `_flash_packed_kernel` (via
// `_flash_packed_forward`, public `flash_attention_packed`) for the bfloat16
// head dims that `ops/attention.py` routes here (`WGMMA_HEAD_DIMS`); the rest
// run flash_attention.cu's kernels. Q, K and V are addressed by (batch, head,
// row) strides with a contiguous head dimension, so [B,H,N,D], the
// head-strided view of a [B,N,H*D] projection and the packed layout all load
// without a copy.
//
// Math (as flash_attention.cu's bfloat16 kernels and the Pallas kernel):
// fp32 scores, running max and sum and fp32 accumulator; the scale folded
// with log2(e) into one FMA before ex2.approx; P rounded to bf16 for P*V, the
// row sums from the fp32 P; keys >= Nk masked to -inf, query rows >= Nq not
// stored, output columns >= D never written. Any D that is a multiple of 8 up
// to 128, computed at DP = round_up(D, 32) (the pad columns are zeros).
//
// Bound on this card: below D ~ 59 the softmax's exponentials (one ex2 a
// score on the SFU, 16 a clock per SM, against 4*D tensor-core operations a
// score), above it the tensor cores; at 256 keys the bytes. Design:
//  * A block is a producer warpgroup and 2 or 3 consumer warpgroups of 64
//    query rows each (`route`), one block an SM. The producer drops to 40
//    registers (`setmaxnreg.dec`) and one of its threads issues every copy;
//    the consumers raise theirs (which does not widen what ptxas compiles
//    them to: `Config`).
//  * Copies are TMA (`cp.async.bulk.tensor.4d`) from 4-D tensor maps over
//    (D, N, H, B) with the caller's strides, built on the host for each
//    launch and passed as __grid_constant__ parameters. A tile is stored as
//    strips of W = 64 or 32 columns, rows of 2W bytes with TMA's 2W-byte
//    swizzle (wgmma's canonical layout), one box a strip; the pad columns
//    D..DP-1 and the rows past N are TMA's zero fill. Q is loaded once; K/V
//    tiles of BK = 64 keys (128 in short key loops) go through a ring of
//    stages with full (TMA bytes) and empty (consumer warps) mbarriers. A
//    box moves row by row: with 32-byte rows the copies alone took about as
//    long as the whole kernel (PERF.md).
//  * S = Q K^T is wgmma m64nBKk16 with Q and K from shared memory, both
//    K-major, DP/16 k-steps. The online softmax runs on the accumulator
//    layout (a row spans the 4 threads of a quad). P is packed to bf16
//    A-fragments in registers, and O = O * alpha + P V is wgmma m64nDPk16
//    with V from shared memory, MN-major (the transpose bit), BK/16 k-steps.
//  * A consumer issues tile j's S and tile j - 1's P V together and runs
//    tile j's softmax while P V is on the tensor cores. With 64-key tiles P
//    is double buffered, so the packing of the new P never writes registers
//    that an in-flight P V reads; with 128-key tiles it is packed at the
//    next tile's start. The consumers take turns issuing their products
//    (named barriers), which staggers their softmaxes.
#include <type_traits>

#include "flash_sm90_common.cuh"

namespace {

// Probe builds (kernels/probe_flash.py) compile this file with parts of the
// loop left out (FLASH_PROBE_SKIP: 1 the softmax, 2 the products, 4 the V
// copies), another strip width (FLASH_PROBE_STRIP), consumer count
// (FLASH_PROBE_CONSUMERS) or most K/V stages (FLASH_PROBE_STAGES), to time
// what paces the kernel. A normal build leaves out nothing.
#ifndef FLASH_PROBE_SKIP
#define FLASH_PROBE_SKIP 0
#endif
constexpr bool kRunSoftmax = !(FLASH_PROBE_SKIP & 1), kRunProducts = !(FLASH_PROBE_SKIP & 2),
               kCopyV = !(FLASH_PROBE_SKIP & 4);
#ifndef FLASH_PROBE_STAGES
#define FLASH_PROBE_STAGES 4
#endif
constexpr int kMaxStages = FLASH_PROBE_STAGES;

// A launch configuration: NC consumer warpgroups of 64 query rows each
// beside the producer warpgroup, one block an SM (two with one consumer at
// DP <= 64); K/V tiles of BK keys; DB: P double buffered in registers, else
// packed at the next tile's start (which a 128-key tile needs: its S and
// two P buffers do not fit the registers).
template <int DP_, int NC_, int BK_ = 64, bool DB_ = true>
struct Config {
  static constexpr int DP = DP_, NC = NC_, BK = BK_;
  static constexpr bool DB = DB_;
  // A tile is stored as DP / W strips of W columns, rows of 2W bytes with
  // TMA's 2W-byte swizzle (wgmma's canonical layout of that swizzle): the
  // widest of 64 and 32 that divides DP. TMA moves a box row by row, so
  // wider rows move a tile in fewer requests.
#ifdef FLASH_PROBE_STRIP
  static constexpr int W = FLASH_PROBE_STRIP;
#else
  static constexpr int W = DP % 64 == 0 ? 64 : 32;
#endif
  static constexpr int CH = DP / W;        // strips of a row
  static constexpr int kRowBytes = 2 * W;  // a strip's row
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kRows = 64 * NC;
  static constexpr int kBlocksPerSM = NC == 1 && DP <= 64 ? 2 : 1;  // 3 stages fit twice
  // registers at launch (65,536 over the SM's threads), which setmaxnreg
  // moves from the producer (40) to the consumers. ptxas (CUDA 12.9)
  // compiles the consumers' code within the launch count all the same, so
  // that count is their budget: 168 with 2 consumers, 128 with 3 or 1.
  static constexpr int kLaunchRegs = 65536 / (kThreads * kBlocksPerSM) / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kFreed = (kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * NC) / 8 * 8;
  static constexpr int kConsumerRegs = kFreed < 240 ? kFreed : 240;
  // K/V stages: as many as fit beside Q, at most kMaxStages (a stage is
  // freed two tiles after its K is read)
  static constexpr int kQBytes = CH * kRows * kRowBytes;
  static constexpr int kStageBytes = 2 * CH * BK * kRowBytes;
  static constexpr int kFit = (kSmemBytes / kBlocksPerSM - 2048 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(DP % 32 == 0 && DP % W == 0 && DP <= 128 && NC >= 1 && NC <= 3, "DP, NC");
  static_assert(kStages >= 3 && (BK == 64 || BK == 128), "3 K/V stages of 64 or 128 keys");
};

template <class C>
struct alignas(1024) Smem {  // every strip 1024-byte aligned (the swizzle's period)
  bf16 q[C::CH][C::kRows][C::W];
  bf16 k[C::kStages][C::CH][C::BK][C::W];
  bf16 v[C::kStages][C::CH][C::BK][C::W];
  uint64_t q_full, k_full[C::kStages], v_full[C::kStages], empty[C::kStages];
};


// ---------------------------------------------------------------- kernel
// Fragment of a consumer thread (warp w of its warpgroup, lane 4g + t):
// rows 16w + g and 16w + g + 8 of the warpgroup's 64; S holds keys 8j + 2t,
// 8j + 2t + 1 of the tile for j < BK / 8, O columns 8j + 2t, 8j + 2t + 1.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kBlocksPerSM)
flash_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                          int H, int Nq, int Nk, int D, Strides os, float scale_log2) {
  constexpr int DP = C::DP, CH = C::CH, BK = C::BK, NC = C::NC, ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& s = *reinterpret_cast<Smem<C>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * C::kRows;
  const int ntiles = (Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.empty[i], 4 * NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(&s.q_full, C::kQBytes);
#pragma unroll 1
      for (int c = 0; c < CH; ++c) tma_load(s.q[c], &tm_q, &s.q_full, C::W * c, row0, h, b);
#pragma unroll 1
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % ST;
        // the stage's previous tile (j - ST) must be released
        if (j >= ST) mbar_wait(&s.empty[st], (j / ST - 1) & 1);
        mbar_expect_tx(&s.k_full[st], C::kStageBytes / 2);
#pragma unroll 1
        for (int c = 0; c < CH; ++c)
          tma_load(s.k[st][c], &tm_k, &s.k_full[st], C::W * c, j * BK, h, b);
        mbar_expect_tx(&s.v_full[st], kCopyV ? C::kStageBytes / 2 : 0);
#pragma unroll 1
        for (int c = 0; c < CH && kCopyV; ++c)
          tma_load(s.v[st][c], &tm_v, &s.v_full[st], C::W * c, j * BK, h, b);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::kConsumerRegs));
    const int cons = wg - 1;  // rows 64 * cons .. of the block
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float acc[DP / 2];           // O: 64 rows x DP
    float sc[BK / 2];            // S, then P in fp32: 64 rows x BK keys
    // P in bf16, the A-fragments of P V's k-steps. Double buffered (tile j's
    // in pa[j % 2]), the packing of a new P never writes the registers an
    // in-flight P V reads, so it runs among the exponentials; single, it
    // waits for the next tile's start.
    uint32_t pa[C::DB ? 2 : 1][BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8 (raw scores)
    float l0 = 0.f, l1 = 0.f;              // this thread's part of their sums
    float alpha0 = 0.f, alpha1 = 0.f;      // O's rescale before the next P V

    // Descriptors: the start address is the low field, so a strip or k-step
    // further is the base descriptor plus its offset / 16.
    constexpr int W = C::W, RB = C::kRowBytes;
    const uint64_t q_desc = smem_desc<W>(smem_u32(s.q[0][64 * cons]), 16);
    const uint64_t k_desc = smem_desc<W>(smem_u32(s.k[0][0]), 16);
    const uint64_t v_desc = smem_desc<W>(smem_u32(s.v[0][0]), BK * RB);
    auto issue_s = [&](int st) {  // S = Q K^T, DP / 16 k-steps of 32 bytes
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int strip = kk / (W / 16), within = kk % (W / 16) * 32;
        wgmma_ss(sc, q_desc + (strip * C::kRows * RB + within) / 16,
                 k_desc + ((st * CH + strip) * BK * RB + within) / 16, kk > 0);
      }
      wgmma_commit();
    };
    // O = O * alpha + P V, 16 keys a k-step
    auto issue_pv = [&](int st, const uint32_t (&p)[BK / 16][4]) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, p[kk], v_desc + (st * CH * BK + 16 * kk) * RB / 16);
      wgmma_commit();
    };
    // online softmax of this tile in base 2, p = 2^(s*c - m*c) with c =
    // scale * log2(e), written over S; sets O's rescale. The maxima and sums
    // run four chains a row.
    auto softmax = [&](int tile) {
      const int k0 = tile * BK;
      if (k0 + BK > Nk) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= Nk) sc[4 * j + e] = -INFINITY;
      }
      float x0[4], x1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x0[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
        x1[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
      }
#pragma unroll
      for (int j = 4; j < BK / 8; ++j) {
        x0[j % 4] = fmaxf(x0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1[j % 4] = fmaxf(x1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mx0 = quad_max(fmaxf(fmaxf(m0, fmaxf(x0[0], x0[1])), fmaxf(x0[2], x0[3])));
      const float mx1 = quad_max(fmaxf(fmaxf(m1, fmaxf(x1[0], x1[1])), fmaxf(x1[2], x1[3])));
      alpha0 = ex2((m0 - mx0) * scale_log2);
      alpha1 = ex2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
#pragma unroll
      for (int j = 0; j < 4; ++j) x0[j] = x1[j] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -mc0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mc0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mc1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mc1));
        x0[j % 4] += sc[4 * j] + sc[4 * j + 1];
        x1[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * alpha0 + ((x0[0] + x0[1]) + (x0[2] + x0[3]));
      l1 = l1 * alpha1 + ((x1[0] + x1[1]) + (x1[2] + x1[3]));
    };
    // P's A-fragments: key columns 16kk .. 16kk + 15 are S's n-tiles 2kk, 2kk + 1
    auto pack = [&](uint32_t (&p)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // Turns: consumer c issues its products after consumer c - 1 has
    // issued theirs (named barrier 1 + c, 256 threads: its 128 wait, the
    // other's 128 arrive), which staggers the consumers' softmaxes. Each
    // issues ntiles + 1 times; the last consumer's last arrival has no taker.
    auto turn_begin = [&]() {
      if constexpr (NC > 1) bar_sync(1 + cons, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NC > 1)
        if (!(last && cons == NC - 1)) bar_arrive(1 + (cons + 1) % NC, 256);
    };
    if constexpr (NC > 1)
      if (cons == NC - 1) bar_arrive(1, 256);  // consumer 0 goes first

    mbar_wait(&s.q_full, 0);
    mbar_wait(&s.k_full[0], 0);
    turn_begin();
    issue_s(0);
    turn_end(false);
    wgmma_wait<0>();
    pin(sc);
    softmax(0);
    if constexpr (C::DB) pack(pa[0]);
    // Tile j (B = j % 2): issue S of tile j; wait for P V of tile j - 2 (the
    // older of the two groups in flight) and free its stage; issue P V of
    // tile j - 1; wait for S and run tile j's softmax while that P V is on the
    // tensor cores. Each wait stands right after an issue: the compiler
    // schedules a wait as early as it can, and a wait for P V placed after the
    // softmax would be hoisted above the exponentials.
    auto step = [&](int j, auto buf) {
      constexpr int B = decltype(buf)::value;
      const int st = j % ST, prev = (j - 1) % ST;
      mbar_wait(&s.k_full[st], (j / ST) & 1);
      mbar_wait(&s.v_full[prev], ((j - 1) / ST) & 1);
      turn_begin();
      if constexpr (C::DB) {
        if constexpr (kRunProducts) issue_s(st);
        wgmma_wait<1>();  // P V of tile j - 2 is done
      } else {
        wgmma_wait<0>();  // P V of tile j - 2 is done: P's registers are free
        pack(pa[0]);      // tile j - 1's P, before S of tile j takes its registers
        if constexpr (kRunProducts) issue_s(st);
      }
      pin(acc);
      if (j >= 2 && lane == 0) mbar_arrive(&s.empty[(j - 2) % ST]);  // tile j - 2 is consumed
      if constexpr (kRunProducts) issue_pv(prev, pa[C::DB ? B ^ 1 : 0]);
      turn_end(false);
      wgmma_wait<1>();  // S of tile j has landed
      pin(sc);
      if constexpr (kRunSoftmax) softmax(j);
      if constexpr (C::DB) pack(pa[B]);
    };
    int j = 1;
    for (; j + 1 < ntiles; j += 2) {
      step(j, std::integral_constant<int, 1>{});
      step(j + 1, std::integral_constant<int, 0>{});
    }
    if (j < ntiles) step(j, std::integral_constant<int, 1>{});
    const int last = (ntiles - 1) % ST;
    mbar_wait(&s.v_full[last], ((ntiles - 1) / ST) & 1);
    turn_begin();
    wgmma_wait<0>();
    pin(acc);
    if constexpr (C::DB) {
      if ((ntiles - 1) & 1)
        issue_pv(last, pa[1]);
      else
        issue_pv(last, pa[0]);
    } else {
      pack(pa[0]);
      issue_pv(last, pa[0]);
    }
    turn_end(true);
    wgmma_wait<0>();
    pin(acc);

    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    const int r0 = row0 + 64 * cons + 16 * warp + g, r1 = r0 + 8;
    bf16* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (j * 8 >= D) break;  // pad columns are not stored
      const int col = 8 * j + 2 * t;
      if (r0 < Nq)
        *reinterpret_cast<uint32_t*>(op + r0 * os.n + col) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < Nq)
        *reinterpret_cast<uint32_t*>(op + r1 * os.n + col) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------- host
struct Args {
  const void *q, *k, *v;
  bf16* o;
  int B, H, Nq, Nk, D;
  Strides qs, ks, vs, os;
  float scale_log2;
  cudaStream_t stream;
};

template <class C>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = sizeof(Smem<C>) + 1024;  // + the base's alignment
  static_assert(smem * C::kBlocksPerSM <= kSmemBytes, "Q and the K/V ring fit shared memory");
  auto kern = flash_wgmma_narrow_kernel<C>;
  // once per instance: a kernel built with fewer registers than setmaxnreg
  // hands on would wait forever in setmaxnreg.inc, so it is refused
  static const cudaError_t ready = [kern] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return e;
    if (attr.numRegs < C::kLaunchRegs) return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }();
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map<C::W>(&mq, a.q, a.B, a.H, a.Nq, a.D, a.qs, C::kRows);
  if (r == CUDA_SUCCESS) r = make_map<C::W>(&mk, a.k, a.B, a.H, a.Nk, a.D, a.ks, C::BK);
  if (r == CUDA_SUCCESS) r = make_map<C::W>(&mv, a.v, a.B, a.H, a.Nk, a.D, a.vs, C::BK);
  if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(10000 + (int)r);
  dim3 grid((a.Nq + C::kRows - 1) / C::kRows, a.B * a.H);
  kern<<<grid, C::kThreads, smem, a.stream>>>(mq, mk, mv, a.o, a.H, a.Nq, a.Nk, a.D, a.os,
                                               a.scale_log2);
  return cudaGetLastError();
}

// Consumers a block: 3 (192 query rows: fewer blocks re-read each K/V
// tile) where their 128 registers hold the fragments (DP <= 64) and the
// query rows fill blocks that large; else 2 (128 rows, 168 registers),
// which at DP <= 64 hold a 128-key tile with a single P buffer: half the
// tiles, and so half the syncs, of a short key loop. Measured (PERF.md,
// `probe_flash`): at [16,8,1024,40] 3 consumers take 0.1025 ms and 2 0.1126;
// at [16,8,256,48] 3 take 0.0136, 2 with 64-key tiles 0.0122, as routed
// less.
template <int DP>
cudaError_t route(const Args& a) {
#ifdef FLASH_PROBE_CONSUMERS
  return launch<Config<DP, FLASH_PROBE_CONSUMERS>>(a);
#else
  if constexpr (DP <= 64) {
    if (a.Nq > 256) return launch<Config<DP, 3>>(a);
    return launch<Config<DP, 2, 128, false>>(a);
  }
  return launch<Config<DP, 2>>(a);
#endif
}

}  // namespace

// Error codes: a cudaError_t, or 10000 + the CUresult of a tensor map that
// could not be encoded. The caller guarantees 16-byte aligned bases and
// strides that are multiples of 8 elements (TMA's 16-byte rule).
extern "C" int ealdm_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D < 8 || D > 128 || D % 8)
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const Args a{q, k, v, static_cast<bf16*>(o), B, H, Nq, Nk, D,
               Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
               Strides{o_sb, o_sh, o_sn}, scale * 1.4426950408889634f,
               static_cast<cudaStream_t>(stream)};
  switch ((D + 31) / 32 * 32) {
    case 32: return (int)route<32>(a);
    case 64: return (int)route<64>(a);
    case 96: return (int)route<96>(a);
    default: return (int)route<128>(a);
  }
}
