// Flash attention forward in bfloat16 for head dims 584 to 1,920,
// written for Hopper (sm_90a): a thread-block cluster splits the head dim
// across its blocks, each block runs wgmma products on its depth slice fed by
// TMA copies, and the blocks sum their partial scores through distributed
// shared memory.
//
// Replaces: ealdm_tpu/ops/attention.py `_flash_kernel` (via `_flash_forward`,
// public `flash_attention`) and `_flash_packed_kernel` (via
// `_flash_packed_forward`, public `flash_attention_packed`) for the bfloat16
// head dims that `ops/attention.py` routes here (`DEEP_WGMMA_HEAD_DIMS`,
// with the slice width of `deep_slices`). No configuration of the repo has
// such a head; the JAX kernel takes any D.
// Q, K and V are addressed by (batch, head, row) strides with a contiguous
// head dimension, so [B,H,N,D], the head-strided view of a [B,N,H*D]
// projection and the packed layout all load without a copy.
//
// Math (as flash_attention_sm90_wide.cu and the Pallas kernel): fp32 scores,
// running max and sum and fp32 accumulator; the scale folded with log2(e)
// into one FMA before ex2.approx; P rounded to bf16 for P*V, the row sums
// from the fp32 P; keys >= Nk masked to -inf, query rows >= Nq not stored,
// output columns >= D never written. The scores are the sum of CS partial
// products taken over depth slices, added in the order of the slices.
//
// Bound on this card: the tensor cores (4*D operations a score against one
// exponential). What binds the design is the head dim: at D = 960 one
// 64-row tile of Q, or of K, is 120 KB of bf16, so Q beside a K/V ring does
// not fit a block's 227 KB, and a 64 x 960 fp32 O (240 KB) fits no block's
// registers. Design:
//  * A cluster of CS blocks owns 64 query rows of one (batch, head); block c
//    owns depth columns [c*W, (c+1)*W). The caller picks W: 512 (CS = 2)
//    or 384 (CS = 2 to 5, so D <= 1,920). Q's slice stays in the block's shared memory, its K and V slices
//    of each 32-key tile go through rings of TMA copies, and it holds O's
//    columns of that slice. Every byte of Q, K and V is read once a
//    cluster, and no product is computed twice.
//  * Warpgroup 0, the S warpgroup, computes the partial S_c = Q_c K_c^T of
//    each tile (wgmma m64n32k16, W/16 k-steps) and pushes it, each thread
//    its fragment, into a receive slot of every peer (st.async, counted on
//    the peer's mbarrier by complete_tx, as TMA copies are counted). A
//    thread then adds the CS partials of its fragment in rank order 0 ..
//    CS-1, its own from registers and its peers' from its receive slots, so
//    every block holds a bit-identical S, and the same row maxima, sums
//    and P. It tells each peer by a remote arrival that its slot has been
//    read; a block pushes into a buffer again only after every peer has.
//    The two halves run a tile apart: at tile j it issues S of tile j + 1,
//    sums tile j - 1's partials (pushed a tile earlier, so no block waits
//    for a peer in step) and pushes tile j's. It runs the online softmax and
//    stores P (bf16) and the rows' rescale alpha in shared memory, as the
//    wide kernel's S warpgroup does.
//  * Warpgroups 1 and 2, the PV warpgroups, each keep W/2 of the slice's O
//    columns in registers (W/4 fp32 a thread), rescale them by alpha and run
//    O += P V (wgmma m64n(W/2)k16, P and V from shared memory, V MN-major).
//  * Depth strips of a slice that lie wholly at or past D (d = 648 runs
//    DP = 768: block 1's last strip) are zero in Q and K from the start and
//    never copied; V's are never copied, and the O columns they feed are not
//    stored.
//  * What the copies cost: most of the kernel (PERF.md). Sharing them
//    between two query blocks of a cluster by TMA multicast made them no
//    faster and the kernel slower (the pair waits on each other).
//  * What the exchange costs (PERF.md): the distributed shared memory moved
//    about 2 TB/s over the whole card here, so the (CS - 1) x 64 x 4 bytes
//    a key a block sends must stay small beside its K/V copies' 4 W bytes:
//    a first design with W = 256 (CS = 4 at D = 960) spent 0.33 ms of 0.45
//    in it. And blocks that read their peers' buffers with
//    cluster-scope acquire and release (a GPU-wide fence and an L1
//    invalidation each) spent about 0.07 ms of 0.21 in them.
#include <type_traits>

#include "flash_sm90_common.cuh"

namespace {

// Probe builds (kernels/probe_flash.py) compile this file with parts of the
// loop left out (FLASH_PROBE_SKIP: 1 the softmax, 2 the products, 4 the V
// copies, 8 the exchange: each block's S is its own partial), to time what
// paces the kernel. A normal build leaves out nothing.
#ifndef FLASH_PROBE_SKIP
#define FLASH_PROBE_SKIP 0
#endif
constexpr bool kRunSoftmax = !(FLASH_PROBE_SKIP & 1), kRunProducts = !(FLASH_PROBE_SKIP & 2),
               kCopyV = !(FLASH_PROBE_SKIP & 4), kExchange = !(FLASH_PROBE_SKIP & 8);

constexpr int kStrip = 64;             // columns of a TMA box (128-byte rows)
constexpr int kStripRow = 2 * kStrip;  // its bytes
constexpr int kPStrip = 64 * 16 * 2;   // a 16-key strip of P: 64 rows x 32 bytes
constexpr int kBK = 32;                // keys a tile
constexpr int kNP = 2;                 // PV warpgroups
constexpr int kThreads = 128 * (1 + kNP);

// named barriers (0 is __syncthreads), each over the whole block
constexpr int kBarFull = 1;  // 1, 2: P buffer 0 / 1 holds its tile's P and alpha
constexpr int kBarFree = 3;  // 3, 4: P buffer 0 / 1 may be written again
constexpr int kBarEnd = 5;   // the row sums are stored

// A block's depth slice of W columns and receive slots for up to PEERS
// peers' partial S.
template <int W_, int PEERS_>
struct Config {
  static constexpr int W = W_, PEERS = PEERS_, BK = kBK;
  static constexpr int CH = W / kStrip;  // strips of the slice
  static constexpr int COLS = W / kNP;   // O columns of a PV warpgroup
  static constexpr int CPV = COLS / kStrip;
  static constexpr int kQBytes = 64 * W * 2;
  static constexpr int kTileBytes = BK * W * 2;  // a K (or V) tile's slice
  static constexpr int kPBytes = 64 * BK * 2;
  static constexpr int kXBytes = 64 * BK * 4;  // a partial S
  static constexpr int kFixed =
      kQBytes + 2 * kPBytes + 2 * PEERS * kXBytes + 3 * 64 * 4 + 1024 + 256;
  static constexpr int kFit = (kSmemBytes - kFixed) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(COLS % kStrip == 0 && COLS <= 256, "a PV warpgroup's columns: one wgmma");
  static_assert(kStages >= 2, "two K/V slots beside Q");
};

template <class C>
struct alignas(1024) Smem {  // every strip 1024-byte aligned (the swizzles' period)
  bf16 q[C::CH][64][kStrip];
  bf16 k[C::kStages][C::CH][C::BK][kStrip];
  bf16 v[C::kStages][C::CH][C::BK][kStrip];
  float4 rx[2][C::PEERS][C::BK / 8][128];  // the peers' partial S of a tile, by thread
  bf16 p[2][C::BK / 16][64][16];  // P in bf16, 16-key strips (32-byte swizzle)
  float alpha[2][64];             // O's rescale of the tile in each P buffer
  float l_fin[64];                // the rows' final sums
  uint64_t q_full, k_full[C::kStages], v_full[C::kStages], v_empty[C::kStages];
  uint64_t x_full[2];  // the peers' partials of the buffer's tile have landed
  uint64_t x_free[2];  // the peers have read this block's partials in the buffer
};

// ---------------------------------------------------------------- kernel
// Fragment of a thread (warp w of its warpgroup, lane 4g + t): rows 16w + g
// and 16w + g + 8 of the block's 64; S holds keys 8j + 2t, 8j + 2t + 1 of
// the tile, O columns 8j + 2t, 8j + 2t + 1 of the block's slice.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_deep_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H,
                        int Nq, int Nk, int D, Strides os, float scale_log2) {
  constexpr int W = C::W, CH = C::CH, BK = C::BK, ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& s = *reinterpret_cast<Smem<C>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int cs = static_cast<int>(cluster_size()), rank = static_cast<int>(cluster_rank());
  const int peers = cs - 1;  // <= C::PEERS (the host's check)
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x / cs * 64, col0 = rank * W;
  const int n = (Nk + BK - 1) / BK;
  // strips of this block's slice that hold columns < D (the host keeps col0 < D)
  const int valid = min(CH, (D - col0 + kStrip - 1) / kStrip);

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.v_empty[i], 4 * kNP);  // lane 0 of each PV warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.x_full[i], 1);              // this block's expect_tx, then the bytes
      mbar_init(&s.x_free[i], 4 * peers);  // one arrival from each S warp of each peer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (valid < CH) {  // zeros in the strips past D, which are never copied
    constexpr int kStripVecs = 64 * kStrip / 8, kKVecs = BK * kStrip / 8;
    for (int i = threadIdx.x; i < (CH - valid) * kStripVecs; i += kThreads)
      reinterpret_cast<uint4*>(s.q[valid])[i] = make_uint4(0, 0, 0, 0);
    for (int st = 0; st < ST; ++st)
      for (int i = threadIdx.x; i < (CH - valid) * kKVecs; i += kThreads)
        reinterpret_cast<uint4*>(s.k[st][valid])[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  cluster_sync();  // every block's mbarriers are set before a peer arrives on them

  auto load_k = [&](int i) {  // K of tile i into slot i % ST
    const int st = i % ST;
    mbar_expect_tx(&s.k_full[st], valid * BK * kStripRow);
#pragma unroll 1
    for (int c = 0; c < valid; ++c)
      tma_load(s.k[st][c], &tm_k, &s.k_full[st], col0 + kStrip * c, i * BK, h, b);
  };
  auto load_v = [&](int i) {
    const int st = i % ST;
    mbar_expect_tx(&s.v_full[st], kCopyV ? valid * BK * kStripRow : 0);
#pragma unroll 1
    for (int c = 0; c < valid && kCopyV; ++c)
      tma_load(s.v[st][c], &tm_v, &s.v_full[st], col0 + kStrip * c, i * BK, h, b);
  };

  if (wg == 0) {  // the S warpgroup
    if (tid == 0) {
      mbar_expect_tx(&s.q_full, valid * 64 * kStripRow);
#pragma unroll 1
      for (int c = 0; c < valid; ++c)
        tma_load(s.q[c], &tm_q, &s.q_full, col0 + kStrip * c, row0, h, b);
#pragma unroll 1
      for (int i = 0; i < ST && i < n; ++i) {
        load_k(i);
        load_v(i);
      }
    }
    float sc[2][BK / 2];  // S of two tiles, then P in fp32: 64 rows x BK keys
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (raw scores)
    float l0 = 0.f, l1 = 0.f;              // this thread's part of their sums
    float alpha0 = 0.f, alpha1 = 0.f;
    const uint64_t q_desc = smem_desc<kStrip>(smem_u32(s.q[0][0]), 16);
    const uint64_t k_desc = smem_desc<kStrip>(smem_u32(s.k[0][0][0]), 16);
    // the partial S = Q_c K_c^T, 4 k-steps of 32 bytes a strip; each strip's
    // descriptors from bases passed through an empty asm (as the wide kernel)
    auto issue_s = [&](int st, float (&d)[BK / 2]) {
      wgmma_fence();
#pragma unroll
      for (int strip = 0; strip < CH; ++strip) {
        uint64_t qd = q_desc, kd = k_desc + st * CH * BK * kStripRow / 16;
        asm volatile("" : "+l"(qd), "+l"(kd));
        qd += strip * 64 * kStripRow / 16;
        kd += strip * BK * kStripRow / 16;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, qd + 2 * kk, kd + 2 * kk, strip + kk > 0);
      }
      wgmma_commit();
    };
    // The exchange of tile i's S (buffer B = i % 2). `publish` pushes this
    // block's partial into its slot of each peer's buffer B, once every peer
    // has read the slot's tile i - 2, and keeps it in `mine`; `gather`, a
    // tile later, adds the cluster's partials in rank order into `x` and
    // tells the peers it has read their slots. A block's slot in a peer's
    // buffer is its rank, less one above the peer's. (B is a plain int: cicc
    // of CUDA 12.8 crashes on these lambdas called with step's
    // integral_constant.) A probe build without the exchange takes each
    // block's own partial as S.
    float mine[BK / 2];  // this block's partial of the tile being exchanged
    auto publish = [&](int i, int B, const float (&x)[BK / 2]) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) mine[e] = x[e];
      // the copy here: deferred, ptxas would make it from registers that
      // the next S product is writing, and serialize every wgmma (C7514)
      pin(mine);
      if constexpr (kExchange) {
        if (i >= 2) mbar_wait(&s.x_free[B], ((i >> 1) - 1) & 1);
        if (tid == 0) mbar_expect_tx(&s.x_full[B], peers * C::kXBytes);
#pragma unroll 1
        for (int p = 0; p < peers; ++p) {
          const int peer = (rank + 1 + p) % cs, slot = rank - (rank > peer);
          const uint32_t dst = map_rank(&s.rx[B][slot][0][tid], peer);
          const uint32_t bar = map_rank(&s.x_full[B], peer);
#pragma unroll
          for (int q4 = 0; q4 < BK / 8; ++q4)
            st_async(dst + q4 * 128 * 16,
                     make_float4(x[4 * q4], x[4 * q4 + 1], x[4 * q4 + 2], x[4 * q4 + 3]), bar);
        }
      }
    };
    auto gather = [&](int i, int B, float (&x)[BK / 2]) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) x[e] = mine[e];
      if constexpr (kExchange) {
        mbar_wait(&s.x_full[B], (i >> 1) & 1);
#pragma unroll 1
        for (int r = 0; r < cs; ++r) {  // rank order, in every block
          float4 y[BK / 8];
          if (r == rank) {
#pragma unroll
            for (int q4 = 0; q4 < BK / 8; ++q4)
              y[q4] = make_float4(mine[4 * q4], mine[4 * q4 + 1], mine[4 * q4 + 2],
                                  mine[4 * q4 + 3]);
          } else {
#pragma unroll
            for (int q4 = 0; q4 < BK / 8; ++q4) y[q4] = s.rx[B][r - (r > rank)][q4][tid];
          }
          if (r == 0) {
#pragma unroll
            for (int q4 = 0; q4 < BK / 8; ++q4) {
              x[4 * q4] = y[q4].x;
              x[4 * q4 + 1] = y[q4].y;
              x[4 * q4 + 2] = y[q4].z;
              x[4 * q4 + 3] = y[q4].w;
            }
          } else {
#pragma unroll
            for (int q4 = 0; q4 < BK / 8; ++q4) {
              x[4 * q4] += y[q4].x;
              x[4 * q4 + 1] += y[q4].y;
              x[4 * q4 + 2] += y[q4].z;
              x[4 * q4 + 3] += y[q4].w;
            }
          }
        }
        __syncwarp();
        if (lane < peers) mbar_arrive_remote(&s.x_free[B], (rank + 1 + lane) % cs);
      }
    };
    // online softmax of tile j in base 2, p = 2^(s*c - m*c) with c =
    // scale * log2(e), written over S; sets alpha
    auto softmax = [&](int j, float (&x)[BK / 2]) {
      const int k0 = j * BK;
      if (k0 + BK > Nk) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * jj + 2 * t + (e & 1) >= Nk) x[4 * jj + e] = -INFINITY;
      }
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        x0 = fmaxf(x0, fmaxf(x[4 * jj], x[4 * jj + 1]));
        x1 = fmaxf(x1, fmaxf(x[4 * jj + 2], x[4 * jj + 3]));
      }
      const float mx0 = quad_max(x0), mx1 = quad_max(x1);
      alpha0 = ex2((m0 - mx0) * scale_log2);
      alpha1 = ex2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        x[4 * jj] = ex2(fmaf(x[4 * jj], scale_log2, -mc0));
        x[4 * jj + 1] = ex2(fmaf(x[4 * jj + 1], scale_log2, -mc0));
        x[4 * jj + 2] = ex2(fmaf(x[4 * jj + 2], scale_log2, -mc1));
        x[4 * jj + 3] = ex2(fmaf(x[4 * jj + 3], scale_log2, -mc1));
        y0 += x[4 * jj] + x[4 * jj + 1];
        y1 += x[4 * jj + 2] + x[4 * jj + 3];
      }
      l0 = l0 * alpha0 + y0;
      l1 = l1 * alpha1 + y1;
    };
    // P (bf16) and alpha into buffer `buf`: key column kc of the tile lies
    // in strip kc / 16 at byte 2 * (kc % 16) of its row's 32, whose two
    // 16-byte halves the 32-byte swizzle exchanges where bit 2 of the row is set
    auto store_p = [&](int buf, const float (&x)[BK / 2]) {
      unsigned char* base = reinterpret_cast<unsigned char*>(s.p[buf][0][0]);
      const int flip = (g >> 2) & 1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        unsigned char* strip = base + jj / 2 * kPStrip + (((jj & 1) ^ flip) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(strip + r0 * 32) = pack_bf16(x[4 * jj], x[4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(strip + r1 * 32) = pack_bf16(x[4 * jj + 2], x[4 * jj + 3]);
      }
      if (t == 0) {
        s.alpha[buf][r0] = alpha0;
        s.alpha[buf][r1] = alpha1;
      }
      fence_proxy_async();
    };
    mbar_wait(&s.q_full, 0);
    mbar_wait(&s.k_full[0], 0);
    if constexpr (kRunProducts) issue_s(0, sc[0]);
    float ss[BK / 2];  // the cluster's S of a tile, then its P in fp32
    // tile j's S from the cluster; the softmax; once the PV warpgroups are
    // done with tile j - 2 (barrier kBarFree + B), P and alpha into buffer
    // B = j % 2, and kBarFull + B says so
    auto finish = [&](int j, int B) {
      gather(j, B, ss);
      if constexpr (kRunSoftmax) softmax(j, ss);
      if (j >= 2) bar_sync(kBarFree + B, kThreads);
      store_p(B, ss);
      bar_arrive(kBarFull + B, kThreads);
    };
    // Tile i (B = i % 2, its partial S in sc[B]): issue S of tile i + 1 into
    // sc[B ^ 1]; wait for S of tile i and reload its K slot; finish tile
    // i - 1; publish tile i. Each wait stands right after an issue: the
    // compiler schedules a wait as early as it can.
    auto step = [&](int i, auto buf_c, auto more_c) {
      constexpr int B = decltype(buf_c)::value;
      constexpr bool more = decltype(more_c)::value;
      if constexpr (more) {
        mbar_wait(&s.k_full[(i + 1) % ST], ((i + 1) / ST) & 1);
        if constexpr (kRunProducts) issue_s((i + 1) % ST, sc[B ^ 1]);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      pin(sc[B]);
      if (tid == 0 && i + ST < n) load_k(i + ST);  // tile i's K slot is free
      if (i >= 1) finish(i - 1, B ^ 1);
      publish(i, B, sc[B]);
    };
    using Zero = std::integral_constant<int, 0>;
    using One = std::integral_constant<int, 1>;
    int i = 0;
#pragma unroll 1
    for (; i + 2 < n; i += 2) {
      step(i, Zero{}, std::true_type{});
      step(i + 1, One{}, std::true_type{});
    }
    if (n - i == 2) {
      step(i, Zero{}, std::true_type{});
      step(i + 1, One{}, std::false_type{});
    } else {
      step(i, Zero{}, std::false_type{});
    }
    finish(n - 1, (n - 1) & 1);
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (t == 0) {
      s.l_fin[r0] = l0;
      s.l_fin[r1] = l1;
    }
    bar_arrive(kBarEnd, kThreads);
    cluster_sync();  // no block leaves while a peer may still read or arrive on its memory
    return;
  }

  // a PV warpgroup: O's columns [col0 + COLS * pv, col0 + COLS * (pv + 1))
  constexpr int COLS = C::COLS;
  const int pv = wg - 1;
  float acc[COLS / 2];  // O: 64 rows x COLS columns
  // zeros the compiler cannot see through: from constant zeros it builds
  // code that ptxas answers by serializing every wgmma (C7515)
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[i]));
  const uint64_t v_desc = smem_desc<kStrip>(smem_u32(s.v[0][C::CPV * pv][0]), BK * kStripRow);
  const uint64_t p_desc = smem_desc<16>(smem_u32(s.p[0][0][0]), 16);
  // Tile i (buffer B = i % 2): wait at kBarFull + B for its P and alpha;
  // wait for P V of tile i - 1, which frees its V slot (reloaded by one
  // thread once every PV warp has arrived) and its P buffer (kBarFree +
  // B ^ 1); rescale O; issue P V of tile i.
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int st = i % ST, buf = i & 1;
    bar_sync(kBarFull + buf, kThreads);
    wgmma_wait<0>();
    pin(acc);
    if (i >= 1) {
      if (lane == 0) mbar_arrive(&s.v_empty[(i - 1) % ST]);
      if (i + 1 < n) bar_arrive(kBarFree + (buf ^ 1), kThreads);
      if (pv == 0 && tid == 0 && i - 1 + ST < n) {  // tile i - 1's V slot, once free
        mbar_wait(&s.v_empty[(i - 1) % ST], ((i - 1) / ST) & 1);
        load_v(i - 1 + ST);
      }
    }
    const float a0 = s.alpha[buf][r0], a1 = s.alpha[buf][r1];
#pragma unroll
    for (int jj = 0; jj < COLS / 8; ++jj) {
      acc[4 * jj] *= a0;
      acc[4 * jj + 1] *= a0;
      acc[4 * jj + 2] *= a1;
      acc[4 * jj + 3] *= a1;
    }
    mbar_wait(&s.v_full[st], (i / ST) & 1);
    if constexpr (kRunProducts) {  // O += P V[:, this warpgroup's columns]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_vt(acc, p_desc + (buf * (BK / 16) + kk) * (kPStrip / 16),
                    v_desc + (st * CH * BK + 16 * kk) * kStripRow / 16);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  pin(acc);

  bar_sync(kBarEnd, kThreads);
  const float inv0 = 1.f / s.l_fin[r0], inv1 = 1.f / s.l_fin[r1];
  const int q0 = row0 + r0, q1 = row0 + r1;
  bf16* op = o + b * os.b + h * os.h + col0 + COLS * pv;
#pragma unroll
  for (int jj = 0; jj < COLS / 8; ++jj) {
    if (col0 + COLS * pv + jj * 8 >= D) break;  // pad columns are not stored
    const int col = 8 * jj + 2 * t;
    if (q0 < Nq)
      *reinterpret_cast<uint32_t*>(op + q0 * os.n + col) =
          pack_bf16(acc[4 * jj] * inv0, acc[4 * jj + 1] * inv0);
    if (q1 < Nq)
      *reinterpret_cast<uint32_t*>(op + q1 * os.n + col) =
          pack_bf16(acc[4 * jj + 2] * inv1, acc[4 * jj + 3] * inv1);
  }
  cluster_sync();
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
  static_assert(smem <= kSmemBytes, "Q, the K/V rings, the exchange and P fit shared memory");
  const int cs = (a.D + C::W - 1) / C::W;
  if (cs < 2 || cs > C::PEERS + 1) return cudaErrorInvalidValue;
  auto kern = flash_wgmma_deep_kernel<C>;
  static const cudaError_t ready = [kern] {  // once per instance
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }();
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map<kStrip>(&mq, a.q, a.B, a.H, a.Nq, a.D, a.qs, 64);
  if (r == CUDA_SUCCESS) r = make_map<kStrip>(&mk, a.k, a.B, a.H, a.Nk, a.D, a.ks, C::BK);
  if (r == CUDA_SUCCESS) r = make_map<kStrip>(&mv, a.v, a.B, a.H, a.Nk, a.D, a.vs, C::BK);
  if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(10000 + (int)r);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Nq + 63) / 64 * cs, a.B * a.H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, mq, mk, mv, a.o, a.H, a.Nq, a.Nk, a.D, a.os,
                                     a.scale_log2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Error codes: a cudaError_t, or 10000 + the CUresult of a tensor map that
// could not be encoded. W is the depth slice of a block, 512 or 384, and D a
// multiple of 8 that spans two blocks of 512, or two to five of 384
// (`deep_slices` in ops/attention.py picks W). The caller guarantees 16-byte
// aligned bases and strides that are multiples of 8 elements (TMA's 16-byte
// rule).
extern "C" int ealdm_flash_attention_sm90_deep(
    const void* q, const void* k, const void* v, void* o, int W, int B, int H, int Nq, int Nk,
    int D, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D % 8 || (W != 512 && W != 384))
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const Args a{q, k, v, static_cast<bf16*>(o), B, H, Nq, Nk, D,
               Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
               Strides{o_sb, o_sh, o_sn}, scale * 1.4426950408889634f,
               static_cast<cudaStream_t>(stream)};
  return (int)(W == 512 ? launch<Config<512, 1>>(a) : launch<Config<384, 4>>(a));
}
