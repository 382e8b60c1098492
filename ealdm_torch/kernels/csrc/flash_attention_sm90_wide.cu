// Flash attention forward in bfloat16 for head dims 136 to 576, written for
// Hopper (sm_90a): wgmma products, TMA copies into separate K and V rings,
// a warpgroup that computes S and the softmax, and warpgroups that split O
// by columns.
//
// Replaces: ealdm_tpu/ops/attention.py `_flash_kernel` (via `_flash_forward`,
// public `flash_attention`) and `_flash_packed_kernel` (via
// `_flash_packed_forward`, public `flash_attention_packed`) for the bfloat16
// head dims that `ops/attention.py` routes here (`WIDE_WGMMA_HEAD_DIMS`:
// cin256-v2's d=384 and 576 and the VAEs' d=512). Q, K and V are addressed
// by (batch, head, row) strides with a contiguous head dimension, so
// [B,H,N,D], the head-strided view of a [B,N,H*D] projection and the packed
// layout all load without a copy.
//
// Math (as flash_attention_sm90.cu and the Pallas kernel): fp32 scores,
// running max and sum and fp32 accumulator; the scale folded with log2(e)
// into one FMA before ex2.approx; P rounded to bf16 for P*V, the row sums
// from the fp32 P; keys >= Nk masked to -inf, query rows >= Nq not stored,
// output columns >= D never written. D is a multiple of 8, computed at
// DP = round_up(D, 64) (320 and 448 at 384 and 512); the pad columns are
// TMA's zero fill.
//
// Bound on this card: the tensor cores (4*D operations a score against one
// exponential), and at 256 keys the bytes. What binds a wide kernel's design
// is where O lives: 64 rows x DP fp32 columns take DP/2 registers a thread
// of one warpgroup, and ptxas compiles every thread within the launch
// bound's registers (168 with 3 warpgroups a block, 128 with 4), whatever
// `setmaxnreg` would hand on at run time. Design:
//  * A block owns 64 query rows (wgmma's M). Warpgroup 0, the S
//    warpgroup, computes S = Q K^T for each tile of BK keys (wgmma
//    m64nBKk16, Q and K from shared memory, DP/16 k-steps), runs the online
//    softmax and stores P as bf16 in shared memory in wgmma's K-major A
//    layout (strips of 16 keys with the 32-byte swizzle), beside each row's
//    rescale alpha. It holds no O, so S can be double buffered: it issues
//    tile j + 1's S before tile j's softmax.
//  * NP PV warpgroups each keep O's columns [c*DP/NP, (c+1)*DP/NP) in
//    registers, rescale them by alpha and run O += P V[:, their columns]
//    (wgmma m64n(DP/NP)k16, P and V from shared memory, V MN-major).
//  * Q is loaded once. K and V tiles go through separate rings of kStages
//    slots, each 64-column strip one TMA box with the 128-byte swizzle (the
//    pad columns and rows past N are TMA's zero fill). There is no producer
//    warp: one thread of the S warpgroup loads Q and K (a K slot is free
//    once its S has landed), one of PV warpgroup 0 loads V (a V slot is
//    free once every PV warp's P V has: an mbarrier), so that the S
//    warpgroup never waits for P V.
//  * P and alpha are double buffered: a named barrier a buffer says it is
//    full (the S warpgroup arrives, the PV warpgroups wait), another that it
//    is free again (the other way round).
//  * With KS = 2 the keys split over a cluster of two blocks that share the
//    64 query rows; the second sends its O, row maxima and sums to the
//    first through distributed shared memory, which combines them. It runs
//    where twice the blocks fill the SMs' waves better (`launch_split`).
//  * What paces it (kernels/probe_flash.py): the copies. Every 64-row block
//    reads its head's whole K and V from the L2, so at 1,024 keys the copies
//    alone take most of the kernel's time.
#include <type_traits>

#include "flash_sm90_common.cuh"

namespace {

// Probe builds (kernels/probe_flash.py) compile this file with parts of the
// loop left out (FLASH_PROBE_SKIP: 1 the softmax, 2 the products, 4 the V
// copies), or with the PV warpgroups at d = 384 (FLASH_PROBE_PV_GROUPS) or
// the key split (FLASH_PROBE_SPLIT) changed, to time what paces the kernel.
// A normal build leaves out nothing.
#ifndef FLASH_PROBE_SKIP
#define FLASH_PROBE_SKIP 0
#endif
constexpr bool kRunSoftmax = !(FLASH_PROBE_SKIP & 1), kRunProducts = !(FLASH_PROBE_SKIP & 2),
               kCopyV = !(FLASH_PROBE_SKIP & 4);
#ifndef FLASH_PROBE_SPLIT
#define FLASH_PROBE_SPLIT -1
#endif

constexpr int kStrip = 64;             // columns of a TMA box (128-byte rows)
constexpr int kStripRow = 2 * kStrip;  // its bytes
constexpr int kPStrip = 64 * 16 * 2;   // a 16-key strip of P: 64 rows x 32 bytes

// named barriers (0 is __syncthreads), each over the whole block
constexpr int kBarFull = 1;  // 1, 2: P buffer 0 / 1 holds its tile's P and alpha
constexpr int kBarFree = 3;  // 3, 4: P buffer 0 / 1 may be written again
constexpr int kBarEnd = 5;   // the row sums and maxima are stored

// A launch configuration: NP PV warpgroups beside the S warpgroup, K/V
// tiles of BK keys, KS blocks a cluster splitting the keys.
template <int DP_, int NP_, int BK_, int KS_>
struct Config {
  static constexpr int DP = DP_, NP = NP_, BK = BK_, KS = KS_;
  static constexpr int CH = DP / kStrip;  // strips of a row
  static constexpr int COLS = DP / NP;    // O columns of a PV warpgroup
  static constexpr int CS = COLS / kStrip;
  static constexpr int kThreads = 128 * (NP + 1);
  static constexpr int kQBytes = 64 * DP * 2;
  static constexpr int kTileBytes = BK * DP * 2;  // a K (or V) tile
  static constexpr int kPBytes = 64 * BK * 2;
  static constexpr int kFixed = kQBytes + 2 * kPBytes + 4 * 64 * 4 + 1024 + 256;
  static constexpr int kFit = (kSmemBytes - kFixed) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(DP % kStrip == 0 && COLS % kStrip == 0 && COLS <= 256, "O's column strips");
  static_assert(BK % 16 == 0 && BK <= 64, "S's key tile");
  static_assert(kStages >= 2, "two K/V slots beside Q");
  static_assert(KS == 1 || NP * (COLS / 8 + 1) * 128 * 16 <= kQBytes + 2 * kStages * kTileBytes,
                "the cluster partner's O fits where Q and the K/V rings were");
};

template <class C>
struct alignas(1024) Smem {  // every strip 1024-byte aligned (the swizzles' period)
  bf16 q[C::CH][64][kStrip];
  bf16 k[C::kStages][C::CH][C::BK][kStrip];
  bf16 v[C::kStages][C::CH][C::BK][kStrip];
  bf16 p[2][C::BK / 16][64][16];  // P in bf16, 16-key strips (32-byte swizzle)
  float alpha[2][64];             // O's rescale of the tile in each P buffer
  float l_fin[64], m_fin[64];     // the rows' final sums and maxima
  uint64_t q_full, k_full[C::kStages], v_full[C::kStages], v_empty[C::kStages];
};

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// ---------------------------------------------------------------- kernel
// Fragment of a thread (warp w of its warpgroup, lane 4g + t): rows 16w + g
// and 16w + g + 8 of the block's 64; S holds keys 8j + 2t, 8j + 2t + 1 of
// the tile, O columns 8j + 2t, 8j + 2t + 1 of the warpgroup's strips.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H,
                        int Nq, int Nk, int D, Strides os, float scale_log2) {
  constexpr int DP = C::DP, CH = C::CH, BK = C::BK, ST = C::kStages, COLS = C::COLS;
  constexpr int kAll = C::kThreads;
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& s = *reinterpret_cast<Smem<C>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x / C::KS * 64;
  // this block's key tiles: [t0, t0 + n) of ntiles (the host keeps ntiles >= KS)
  const int ntiles = (Nk + BK - 1) / BK;
  const int rank = C::KS > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int t0 = ntiles * rank / C::KS, n = ntiles * (rank + 1) / C::KS - t0;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.v_empty[i], 4 * C::NP);  // lane 0 of each PV warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_k = [&](int i) {  // K of local tile i into slot i % ST
    const int st = i % ST;
    mbar_expect_tx(&s.k_full[st], C::kTileBytes);
#pragma unroll 1
    for (int c = 0; c < CH; ++c)
      tma_load(s.k[st][c], &tm_k, &s.k_full[st], kStrip * c, (t0 + i) * BK, h, b);
  };
  auto load_v = [&](int i) {
    const int st = i % ST;
    mbar_expect_tx(&s.v_full[st], kCopyV ? C::kTileBytes : 0);
#pragma unroll 1
    for (int c = 0; c < CH && kCopyV; ++c)
      tma_load(s.v[st][c], &tm_v, &s.v_full[st], kStrip * c, (t0 + i) * BK, h, b);
  };

  if (wg == 0) {  // the S warpgroup
    if (tid == 0) {
      mbar_expect_tx(&s.q_full, C::kQBytes);
#pragma unroll 1
      for (int c = 0; c < CH; ++c) tma_load(s.q[c], &tm_q, &s.q_full, kStrip * c, row0, h, b);
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
    // Descriptors: the start address is the low field, so a strip or k-step
    // further is the base descriptor plus its offset / 16.
    const uint64_t q_desc = smem_desc<kStrip>(smem_u32(s.q[0][0]), 16);
    const uint64_t k_desc = smem_desc<kStrip>(smem_u32(s.k[0][0][0]), 16);
    // S = Q K^T, 4 k-steps of 32 bytes a strip, unrolled. Each strip's
    // descriptors come from bases passed through an empty asm at the
    // strip's start: computed ahead, the DP / 16 descriptor pairs stay live
    // at once and spill; a loop over the strips makes ptxas wait for each
    // product (PERF.md).
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
    // Tile i (B = i % 2, its S in sc[B] and its P in buffer B): issue S of
    // tile i + 1 into sc[B ^ 1]; wait for S of tile i (the older group) and
    // reload its K slot; the softmax; once the PV warpgroups are done with
    // tile i - 2 (barrier kBarFree + B), P and alpha into buffer B, and
    // kBarFull + B says so. Each wait stands right after an issue: the
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
      if constexpr (kRunSoftmax) softmax(t0 + i, sc[B]);
      if (i >= 2) bar_sync(kBarFree + B, kAll);
      store_p(B, sc[B]);
      bar_arrive(kBarFull + B, kAll);
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
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (t == 0) {
      s.l_fin[r0] = l0;
      s.l_fin[r1] = l1;
      s.m_fin[r0] = m0;
      s.m_fin[r1] = m1;
    }
    bar_arrive(kBarEnd, kAll);
    if constexpr (C::KS > 1) {  // the cluster barriers the PV warpgroups pass
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // a PV warpgroup: O's columns [COLS * pv, COLS * (pv + 1))
  const int pv = wg - 1;
  float acc[COLS / 2];  // O: 64 rows x COLS columns
  // zeros the compiler cannot see through: from constant zeros it builds
  // code that ptxas answers by serializing every wgmma (C7515)
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) asm volatile("mov.b32 %0, 0;\n" : "=f"(acc[i]));
  const uint64_t v_desc = smem_desc<kStrip>(smem_u32(s.v[0][C::CS * pv][0]), BK * kStripRow);
  const uint64_t p_desc = smem_desc<16>(smem_u32(s.p[0][0][0]), 16);
  // Tile i (buffer B = i % 2): wait at kBarFull + B for its P and alpha;
  // wait for P V of tile i - 1, which frees its V slot (reloaded by one
  // thread once every PV warp has arrived) and its P buffer (kBarFree +
  // B ^ 1, which the S warpgroup waits for at tile i + 1); rescale O; issue
  // P V of tile i.
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int st = i % ST, buf = i & 1;
    bar_sync(kBarFull + buf, kAll);
    wgmma_wait<0>();
    pin(acc);
    if (i >= 1) {
      if (lane == 0) mbar_arrive(&s.v_empty[(i - 1) % ST]);
      if (i + 1 < n) bar_arrive(kBarFree + (buf ^ 1), kAll);
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

  bar_sync(kBarEnd, kAll);
  float sum0 = s.l_fin[r0], sum1 = s.l_fin[r1];
  // O = (O * fa + O' * fb) / sum, O' the cluster partner's
  float fa0 = 1.f, fa1 = 1.f, fb0 = 0.f, fb1 = 0.f;
  const float4* partner = nullptr;
  if constexpr (C::KS > 1) {
    // Block 1 of the pair sends (O, max, sum) to block 0, into the shared
    // memory of block 0's Q and K/V rings (free once both pass the first
    // cluster barrier), one float4 a thread a step; block 0 combines.
    const float m0 = s.m_fin[r0], m1 = s.m_fin[r1];
    float4* xfer = reinterpret_cast<float4*>(s.q[0][0]) + pv * (COLS / 8 + 1) * 128 + tid;
    cluster_sync();
    if (rank == 1) {
      const uint32_t dst = map_rank(xfer, 0);
#pragma unroll
      for (int q4 = 0; q4 < COLS / 8; ++q4)
        st_cluster(dst + q4 * 128 * 16,
                   make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]));
      st_cluster(dst + COLS / 8 * 128 * 16, make_float4(m0, sum0, m1, sum1));
    }
    cluster_sync();
    if (rank == 1) return;
    const float4 other = xfer[COLS / 8 * 128];
    const float mx0 = fmaxf(m0, other.x), mx1 = fmaxf(m1, other.z);
    fa0 = ex2((m0 - mx0) * scale_log2);
    fb0 = ex2((other.x - mx0) * scale_log2);
    fa1 = ex2((m1 - mx1) * scale_log2);
    fb1 = ex2((other.z - mx1) * scale_log2);
    sum0 = sum0 * fa0 + other.y * fb0;
    sum1 = sum1 * fa1 + other.w * fb1;
    partner = xfer;
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  fa0 *= inv0;
  fb0 *= inv0;
  fa1 *= inv1;
  fb1 *= inv1;
  const int q0 = row0 + r0, q1 = row0 + r1;
  bf16* op = o + b * os.b + h * os.h + COLS * pv;
#pragma unroll
  for (int jj = 0; jj < COLS / 8; ++jj) {
    if (COLS * pv + jj * 8 >= D) break;  // pad columns are not stored
    float4 x = make_float4(acc[4 * jj] * fa0, acc[4 * jj + 1] * fa0, acc[4 * jj + 2] * fa1,
                           acc[4 * jj + 3] * fa1);
    if constexpr (C::KS > 1) {
      const float4 y = partner[jj * 128];
      x.x = fmaf(y.x, fb0, x.x);
      x.y = fmaf(y.y, fb0, x.y);
      x.z = fmaf(y.z, fb1, x.z);
      x.w = fmaf(y.w, fb1, x.w);
    }
    const int col = 8 * jj + 2 * t;
    if (q0 < Nq) *reinterpret_cast<uint32_t*>(op + q0 * os.n + col) = pack_bf16(x.x, x.y);
    if (q1 < Nq) *reinterpret_cast<uint32_t*>(op + q1 * os.n + col) = pack_bf16(x.z, x.w);
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
  static_assert(smem <= kSmemBytes, "Q, the K/V rings and P fit shared memory");
  auto kern = flash_wgmma_wide_kernel<C>;
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
  cfg.gridDim = dim3((a.Nq + 63) / 64 * C::KS, a.B * a.H);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::KS > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, mq, mk, mv, a.o, a.H, a.Nq, a.Nk, a.D, a.os,
                                     a.scale_log2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Split the keys over a cluster of two blocks where twice the blocks fill
// the SMs' waves better (at 48 or 192 blocks of 64 rows on 132 SMs: 0.36 ->
// 0.73 and 0.73 -> 0.97 of the last wave) and each half still has a few
// tiles (FLASH_PROBE_SPLIT: 1 splits wherever there are the tiles, 0 never).
template <class C1, class C2>
cudaError_t launch_split(const Args& a) {
  static const long long sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<long long>(n);
  }();
  const long long blocks = static_cast<long long>((a.Nq + 63) / 64) * a.B * a.H;
  auto filled = [](long long x) {  // the share of the waves' SM slots x blocks fill
    return static_cast<double>(x) / ((x + sms - 1) / sms * sms);
  };
  const bool fits = (a.Nk + C2::BK - 1) / C2::BK >= 4;
  if (fits && (FLASH_PROBE_SPLIT == 1 || (FLASH_PROBE_SPLIT < 0 && filled(2 * blocks) > filled(blocks))))
    return launch<C2>(a);
  return launch<C1>(a);
}

// PV warpgroups (NP) and keys a tile (BK) at each DP: O takes DP / (2 NP)
// registers a thread, within 168 with 2 PV warpgroups and 128 with 3; Q and
// two or three K/V slots fill the shared memory. d = 320 and 448 run at 384
// and 512 (five or seven 64-column strips do not split evenly).
#ifndef FLASH_PROBE_PV_GROUPS
#define FLASH_PROBE_PV_GROUPS 2
#endif
cudaError_t route(const Args& a) {
  constexpr int NP384 = FLASH_PROBE_PV_GROUPS;
  if (a.D <= 192) return launch<Config<192, 3, 64, 1>>(a);
  if (a.D <= 256) return launch<Config<256, 2, 64, 1>>(a);
  if (a.D <= 384) return launch_split<Config<384, NP384, 32, 1>, Config<384, NP384, 32, 2>>(a);
  if (a.D <= 512) return launch<Config<512, 2, 32, 1>>(a);
  return launch_split<Config<576, 3, 32, 1>, Config<576, 3, 32, 2>>(a);
}

}  // namespace

// Error codes: a cudaError_t, or 10000 + the CUresult of a tensor map that
// could not be encoded. The caller guarantees 16-byte aligned bases and
// strides that are multiples of 8 elements (TMA's 16-byte rule).
extern "C" int ealdm_flash_attention_sm90_wide(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B * H > 65535 || D < 136 || D > 576 || D % 8)
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const Args a{q, k, v, static_cast<bf16*>(o), B, H, Nq, Nk, D,
               Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
               Strides{o_sb, o_sh, o_sn}, scale * 1.4426950408889634f,
               static_cast<cudaStream_t>(stream)};
  return (int)route(a);
}
