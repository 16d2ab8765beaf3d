// FlashAttention backward for Hopper (sm_90a), bf16: all five products on
// wgmma, tiles by TMA into mbarrier-guarded rings, no atomics.
//
// The gradient of flash_attention_sm90.cu (bf16 inputs; fp32 inputs keep the
// CUDA-core kernel, flash_attention_bwd.cu), by the formulas of
// ref.flash_attention_backward_reference:
//
//   P  = exp(scale q k^T - lse) on visible pairs, 0 elsewhere
//   dV = P^T dO              D  = rowsum(dO * O)
//   dS = P * (dO V^T - D)    dQ = scale dS K      dK = scale dS^T Q
//
// with P and dS rounded to bf16 before they feed a product, as FlashAttention
// 2 and 3 do; every sum is fp32.  Contract: q/o/dO [B,Hq,Sq,D], k/v
// [B,Hkv,Sk,D] contiguous bf16; lse [B,Hq,Sq] fp32 from the forward; `ld`
// fp32 scratch of B*Hq*Sq_pad pairs (Sq_pad = Sq rounded up to 128).  dq, dk,
// dv come out in bf16.  Masks and GQA as in the forward: dK and dV of a KV
// head sum over the query heads of its group.
//
// Three kernels, and a fourth where heads are split, none with atomics, so two
// runs give the same bits (bitwise resume of training rests on it):
//   1. bwd_prep: per query row, the pair (lse * log2 e, D = rowsum(dO * O)),
//      one warp a row; padded rows get (+inf, 0), so their P is exactly 0.
//      The pairs of a q tile are one 16-byte aligned run, which the dK/dV
//      kernel reads with one bulk copy (lse's own rows of Sq floats are not
//      16-byte strided for every Sq, as TMA needs).
//   2. bwd_dkdv: one block per (128 keys, KV head, batch, head split): two
//      consumer warpgroups of 64 keys and a producer warpgroup (which gives
//      its registers to the consumers: setmaxnreg).  K and V come in once by
//      TMA; the producer then walks the split's query heads and the q tiles
//      of BQ rows that see the block's keys, loading Q, dO and their pairs
//      into a ring of three stages (two at D=256).  Each warpgroup computes
//      S^T = K Q^T and dP^T = V dO^T (wgmma, K-major operands), so P^T and
//      dS^T sit in its accumulator registers with keys as rows: rounded to
//      bf16 they are the A operands of dV += P^T dO and dK += dS^T Q straight
//      from registers, with dO and Q read MN-major from the same tiles.  dK
//      and dV stay in fp32 registers over the whole loop.
//      Head splits: a KV group's G query heads may be split into HS runs of
//      G / HS heads, one block each (grid B * Hkv * HS by key tiles), so a
//      narrow grid (MQA at a small batch: 32 blocks at recurrentgemma-9b's
//      training shape) fills the card.  The wrapper picks HS from the shape
//      and the SM count alone (flash_attention_bwd.py:head_splits).  With HS
//      > 1 each block writes its fp32 dK, dV to scratch [2, HS, B, Hkv, Sk,
//      D], and 4. bwd_reduce sums the HS partials in split order and casts
//      to bf16: no atomics, and HS = 1 writes bf16 directly, as before.
//   3. bwd_dq: one block per 128 query rows of a head, or 64 rows of two heads
//      of a KV group, as the forward: Q and dO slabs once, K/V tiles of 64 keys
//      (48 at D=256, 32 at 160) through a two-stage ring; S = Q K^T and
//      dP = dO V^T, then dQ += dS K with dS from registers and K read
//      MN-major.
//
// What bounds it: the tensor cores.  At llama3.2-3b's training shape (B=4,
// 24/8 heads, S=1024, D=128, causal) the backward needs 2.5x the forward's
// 25.8 GFLOP (about 65 us at 989 TFLOP/s); the dQ kernel recomputes S and dP,
// so seven products are issued for the five needed.  Head dims 32, 64, 128
// and 256 (BQ = 32 at D=128: dK and dV take 128 accumulator registers a
// thread).  At D=256 dK and dV of 64 keys would take 256
// registers a thread, over the 255 a thread may have, so the dK/dV kernel
// splits D between its two consumer warpgroups: a block takes 64 keys, and
// each warpgroup keeps the dK and dV of one half of the columns (64 x 128, 128
// registers).  At D=256 the two warpgroups also split the recomputed
// products instead of both computing them: warpgroup 0 takes S^T = K Q^T,
// warpgroup 1 dP^T = V dO^T, each over all of D for a q tile of 64 rows
// (m64n64, where 32-row tiles gave m64n32).  Warpgroup 0 turns S^T into P^T
// and hands it over in fp32 through shared memory (one fragment a thread: the
// two warpgroups' fragments have one layout, so thread t reads what thread t
// wrote); warpgroup 1 forms dS^T = P^T (dP^T - D) and hands it back in bf16;
// two named barriers order the exchange.  Both then run dV += P^T dO and dK
// += dS^T Q on their own 128 columns: four products issued for the four
// needed, where both warpgroups recomputing S^T and dP^T issued six.  The
// 64-row Q and dO tiles take two stages of the ring (130 KB), K and V 64 KB,
// the exchange 24 KB (32-row tiles in three or four stages ran 15% slower:
// the m64n32 products).  Head dim 160 keeps the shape it had (both
// warpgroups recompute, 32-row tiles).  The dQ kernel takes K/V tiles of 48
// keys at D=256 (m64n48 for S and dP; 32 at 160), so the two 64-row Q and dO
// slabs (128 KB) and a two-stage ring of K and V (96 KB) fit the 227 KB of
// shared memory a block may have, and dQ's 64 x 256 accumulator (128
// registers) leaves room for S and dP.  Head dims 112 and
// 160 run on tiles of 128 and 192 columns (sm90.cuh: padded_dim): products
// that reduce over D stop at D, and output columns past D are not stored.
// 112 takes D=128's layout.  160 splits as 256 does, by whole 64-column
// blocks of the tiles (an MN-major operand starts on a block): warpgroup 0
// keeps dK and dV of columns 0-127 (128 registers), warpgroup 1 those of
// 128-191 (64 registers, 32 of them real); the dQ kernel takes 32-key tiles,
// as at 256, and its 64 x 192 accumulator is one m64n192 product.
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace repro::sm90;

constexpr int WG_ROWS = 64;
constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;
constexpr int NT = WG_THREADS * (CONSUMERS + 1);  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PAD = 128;                  // Sq_pad: Sq rounded up to this

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int D>
struct DkDv {
  static constexpr int DP = padded_dim(D);       // the tiles' columns
  static constexpr bool SPLIT = DP > 128;        // the warpgroups split D, not the keys
  // keys a block; flash_attention_bwd.py's dkdv_keys repeats this rule for its
  // head-split planner: change the two together
  static constexpr int KEYS = SPLIT ? WG_ROWS : CONSUMERS * WG_ROWS;
  // dK, dV columns of warpgroups 0 and 1, whole 64-column blocks
  static constexpr int DW0 = SPLIT ? round_up(DP / CONSUMERS, 64) : DP;
  static constexpr int DW1 = SPLIT ? DP - DW0 : DP;
  // the warpgroups split S^T and dP^T and share P^T and dS^T
  static constexpr bool SHARE = D == 256;
  static constexpr int BQ = SHARE || DP < 128 ? 64 : 32;  // q rows a tile
  static constexpr int STAGES = SHARE ? 2 : 3;
  using KVT = Tile<KEYS, DP>;                    // the block's keys
  using QT = Tile<BQ, DP>;                       // a q or dO tile
  static constexpr int STAGE_BYTES = round_up(2 * QT::BYTES + BQ * 8, 1024);
  static constexpr int ST_OFF = 2 * KVT::BYTES;
  // SHARE: the exchange of P^T (fp32) and dS^T (bf16 pairs), a fragment a thread
  static constexpr int XP_OFF = ST_OFF + STAGES * STAGE_BYTES;
  static constexpr int XS_OFF = XP_OFF + (SHARE ? WG_THREADS * (BQ / 2) * 4 : 0);
  static constexpr int BAR_OFF = XS_OFF + (SHARE ? WG_THREADS * (BQ / 4) * 4 : 0);
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "over the shared memory a block may have");
};

template <int D>
struct Dq {
  static constexpr int DP = padded_dim(D);       // the tiles' columns
  static constexpr int BN = D == 256 ? 48 : DP > 128 ? 32 : 64;  // keys a tile
  static constexpr int STAGES = 2;
  using QT = Tile<WG_ROWS, DP>;
  using KT = Tile<BN, DP>;
  static constexpr int DO_OFF = CONSUMERS * QT::BYTES;
  static constexpr int ST_OFF = 2 * CONSUMERS * QT::BYTES;
  static constexpr int STAGE_BYTES = 2 * KT::BYTES;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// the pair (lse * log2 e, rowsum(dO * O)) of every padded row
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_sm90(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
              const float* __restrict__ lse, float2* __restrict__ ld, int Sq, int Sq_pad,
              long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / Sq_pad;
  const int q = (int)(row % Sq_pad);
  if (q >= Sq) {
    if (lane == 0) ld[row] = make_float2(INFINITY, 0.f);
    return;
  }
  const size_t off = ((size_t)bh * Sq + q) * D;
  float s = 0.f;
  for (int i = lane; i < D / 8; i += 32) {
    const uint4 a = reinterpret_cast<const uint4*>(o + off)[i];
    const uint4 b = reinterpret_cast<const uint4*>(dO + off)[i];
    const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(__bfloat162float(av[e]), __bfloat162float(bv[e]), s);
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off2);
  if (lane == 0) ld[row] = make_float2(lse[(size_t)bh * Sq + q] * LOG2E, s);
}

// P (or P^T) and dS (or dS^T) of one accumulator fragment pair, in place:
// s holds the logits, dp the products dO V^T; (lse2, delta) of each element's
// query row come from `pair`.  Masked elements get P = 0.
template <int R, class Pair, class Visible>
__device__ __forceinline__ void p_and_ds(float (&s)[R], float (&dp)[R], float scale_log2,
                                         bool edge, Pair pair, Visible visible) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 ld = pair(j, e);
      float p = exp2f(s[4 * j + e] * scale_log2 - ld.x);
      if (edge && !visible(j, e)) p = 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ld.y);
    }
}

// Waits until the `count` threads of named barrier `id` have arrived (the two
// consumer warpgroups; 0 is __syncthreads').  Orders their shared memory.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// k-step kk of an accumulator fragment as wgmma A operand registers, in bf16
template <int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int HS, int Hq, int Hkv,
              int Sq, int Sq_pad, int Sk, float scale, float scale_log2, int causal, int window,
              int q_offset) {
  using C = DkDv<D>;
  using KVT = typename C::KVT;
  using QT = typename C::QT;
  constexpr int BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t k_s = base, v_s = base + KVT::BYTES, st_s = base + C::ST_OFF;
  const uint32_t kv_bar = base + C::BAR_OFF;
  const uint32_t full_bar = kv_bar + 8, empty_bar = kv_bar + 8 * (1 + STAGES);

  // the block's KV head and the split of its group's G query heads it takes
  const int bh = blockIdx.x / HS, split = blockIdx.x % HS;
  const int b = bh / Hkv, hk = bh % Hkv, G = Hq / Hkv, GS = G / HS;
  const int k0 = blockIdx.y * C::KEYS;  // causal: low key tiles are the longest
  const int k_last = min(k0 + C::KEYS, Sk) - 1;
  // the q rows that see a key of this block
  int q_begin = causal ? max(0, k0 - q_offset) : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_it = GS * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(kv_bar, 2 * KVT::BYTES);
      tma_load_tile<KVT>(k_s, &tk, k0, b * Hkv + hk, kv_bar);
      tma_load_tile<KVT>(v_s, &tv, k0, b * Hkv + hk, kv_bar);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int h = hk * G + split * GS + it / n_q, q0 = q_begin + (it % n_q) * BQ;
        if (it >= STAGES) mbar_wait(empty_bar + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t st = st_s + s * C::STAGE_BYTES, bar = full_bar + 8 * s;
        mbar_expect_tx(bar, 2 * QT::BYTES + BQ * 8);
        tma_load_tile<QT>(st, &tq, q0, b * Hq + h, bar);
        tma_load_tile<QT>(st + QT::BYTES, &tdo, q0, b * Hq + h, bar);
        bulk_load(st + 2 * QT::BYTES, ld + (size_t)(b * Hq + h) * Sq_pad + q0, BQ * 8, bar);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // a consumer warpgroup: keys kb..kb + 63, dK and dV columns col0..col0 + DW - 1
  auto consume = [&](auto dw) {
    constexpr int DW = decltype(dw)::value;
    const int krow = C::SPLIT ? 0 : wg * WG_ROWS;  // its keys' first row in the K/V tiles
    const int kb = k0 + krow, col0 = C::SPLIT ? wg * C::DW0 : 0;
    // its columns of the Q and dO tiles, as MN-major operands: whole column blocks
    const uint32_t col_off = (col0 / QT::CB) * QT::BLOCK_BYTES;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;  // this thread's keys: kb + r0 and kb + r0 + 8
    const int cq = 2 * (lane % 4);
    const int key0 = kb + r0, key1 = key0 + 8;

    float dk_acc[DW / 2], dv_acc[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int q0 = q_begin + (it % n_q) * BQ;
      const uint32_t q_tile = st_s + s * C::STAGE_BYTES, do_tile = q_tile + QT::BYTES;
      const float2* pairs = reinterpret_cast<const float2*>(gbase + C::ST_OFF + s * C::STAGE_BYTES +
                                                            2 * QT::BYTES);
      const int p_lo = q0 + q_offset, p_hi = p_lo + BQ - 1;  // positions of the tile's rows
      const bool dead = kb >= Sk || (causal && kb > p_hi) ||
                        (window > 0 && kb + WG_ROWS - 1 <= p_lo - window);
      mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
      const bool edge = kb + WG_ROWS > Sk || (causal && kb + WG_ROWS - 1 > p_lo) ||
                        (window > 0 && kb <= p_hi - window);
      if constexpr (C::SHARE) {
        // `dead` is the same for both warpgroups (they hold the same keys), so
        // both reach the named barriers, or neither does
        if (!dead) {
          // warpgroup 0: S^T = K Q^T, then P^T; warpgroup 1: dP^T = V dO^T, then dS^T
          float acc[BQ / 2];
          const uint32_t a_tile = wg == 0 ? k_s : v_s, b_tile = wg == 0 ? q_tile : do_tile;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_ss<0, 0>(acc, KVT::kmajor(a_tile, 0, kk), QT::kmajor(b_tile, 0, kk), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);

          float* const xp = reinterpret_cast<float*>(gbase + C::XP_OFF);
          uint32_t* const xs = reinterpret_cast<uint32_t*>(gbase + C::XS_OFF);
          uint32_t pa[BQ / 16][4], sa[BQ / 16][4];  // P^T and dS^T in bf16
          if (wg == 0) {
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = e < 2 ? key0 : key1, pos = p_lo + 8 * j + cq + (e & 1);
                float p = exp2f(acc[4 * j + e] * scale_log2 - pairs[8 * j + cq + (e & 1)].x);
                if (edge && !(key < Sk && (!causal || key <= pos) &&
                              (window <= 0 || key > pos - window)))
                  p = 0.f;
                acc[4 * j + e] = p;
                xp[(4 * j + e) * WG_THREADS + t] = p;
              }
            named_bar_sync(1, CONSUMERS * WG_THREADS);  // P^T is out
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) to_a(pa[kk], acc, kk);
            named_bar_sync(2, CONSUMERS * WG_THREADS);  // dS^T is in
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) sa[kk][r] = xs[(4 * kk + r) * WG_THREADS + t];
          } else {
            named_bar_sync(1, CONSUMERS * WG_THREADS);
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {  // 8 elements: columns j = 2 kk, 2 kk + 1
              float p[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int j = 2 * kk + i / 4, e = i % 4;
                p[i] = xp[(8 * kk + i) * WG_THREADS + t];
                acc[8 * kk + i] = p[i] * (acc[8 * kk + i] - pairs[8 * j + cq + (e & 1)].y);
              }
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                pa[kk][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
                sa[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
                xs[(4 * kk + r) * WG_THREADS + t] = sa[kk][r];
              }
            }
            named_bar_sync(2, CONSUMERS * WG_THREADS);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            mma_rs<1>(dv_acc, pa[kk], QT::mnmajor(do_tile + col_off, kk), 1);
            mma_rs<1>(dk_acc, sa[kk], QT::mnmajor(q_tile + col_off, kk), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk_acc);
          fence_regs(dv_acc);
        }
      } else if (!dead) {
        float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: keys x q rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<0, 0>(st, KVT::kmajor(k_s, krow, kk), QT::kmajor(q_tile, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<0, 0>(dpt, KVT::kmajor(v_s, krow, kk), QT::kmajor(do_tile, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        p_and_ds(st, dpt, scale_log2, edge,
                 [&](int j, int e) { return pairs[8 * j + cq + (e & 1)]; },
                 [&](int j, int e) {
                   const int key = e < 2 ? key0 : key1, pos = p_lo + 8 * j + cq + (e & 1);
                   return key < Sk && (!causal || key <= pos) && (window <= 0 || key > pos - window);
                 });
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];  // P^T and dS^T in bf16
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          to_a(pa[kk], st, kk);
          to_a(sa[kk], dpt, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          mma_rs<1>(dv_acc, pa[kk], QT::mnmajor(do_tile + col_off, kk), 1);
          mma_rs<1>(dk_acc, sa[kk], QT::mnmajor(q_tile + col_off, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    }

    const size_t rows = (size_t)(b * Hkv + hk) * Sk;
    if (part != nullptr) {  // head splits: this split's fp32 dK, dV; bwd_reduce sums them
      const size_t plane = (size_t)(gridDim.x / HS) * Sk * D;  // one split's [B, Hkv, Sk, D]
      float* const pk = part + split * plane + rows * D;
      float* const pv = part + (HS + split) * plane + rows * D;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        const int col = col0 + 8 * j + cq;
        if (C::DP != D && col0 + 8 * j >= D) break;  // padding columns
        if (key0 < Sk) {
          *reinterpret_cast<float2*>(pk + (size_t)key0 * D + col) =
              make_float2(dk_acc[4 * j], dk_acc[4 * j + 1]);
          *reinterpret_cast<float2*>(pv + (size_t)key0 * D + col) =
              make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
        }
        if (key1 < Sk) {
          *reinterpret_cast<float2*>(pk + (size_t)key1 * D + col) =
              make_float2(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
          *reinterpret_cast<float2*>(pv + (size_t)key1 * D + col) =
              make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int col = col0 + 8 * j + cq;
      if (C::DP != D && col0 + 8 * j >= D) break;  // padding columns
      if (key0 < Sk) {
        *reinterpret_cast<uint32_t*>(dk + (rows + key0) * D + col) =
            pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + (rows + key0) * D + col) =
            pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key1 < Sk) {
        *reinterpret_cast<uint32_t*>(dk + (rows + key1) * D + col) =
            pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + (rows + key1) * D + col) =
            pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  };
  if constexpr (C::DW0 == C::DW1) {
    consume(std::integral_constant<int, C::DW0>{});
  } else if (wg == 0) {
    consume(std::integral_constant<int, C::DW0>{});
  } else {
    consume(std::integral_constant<int, C::DW1>{});
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
            int Sq, int Sq_pad, int Sk, float scale, float scale_log2, int causal, int window,
            int q_offset, int pair_heads) {
  using C = Dq<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::DO_OFF, st_s = base + C::ST_OFF;
  const uint32_t q_bar = base + C::BAR_OFF;
  const uint32_t full_bar = q_bar + 8, empty_bar = q_bar + 8 * (1 + STAGES);

  // the block's heads and rows, as in the forward
  const int hpb = pair_heads ? 2 : 1;
  const int span = pair_heads ? WG_ROWS : CONSUMERS * WG_ROWS;
  const int b = blockIdx.x / (Hq / hpb);
  const int h0 = (blockIdx.x % (Hq / hpb)) * hpb;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * span;
  const int hk = h0 / (Hq / Hkv);
  const int q_lo = q0 + q_offset, q_hi = min(q0 + span, Sq) - 1 + q_offset;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  k_begin = (k_begin / BN) * BN;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, 2 * CONSUMERS * QT::BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        const int row = pair_heads ? q0 : q0 + w * WG_ROWS;
        const int bh = b * Hq + (pair_heads ? h0 + w : h0);
        tma_load_tile<QT>(q_s + w * QT::BYTES, &tq, row, bh, q_bar);
        tma_load_tile<QT>(do_s + w * QT::BYTES, &tdo, row, bh, q_bar);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty_bar + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t st = st_s + s * C::STAGE_BYTES, bar = full_bar + 8 * s;
        mbar_expect_tx(bar, 2 * KT::BYTES);
        const int kt = k_begin + it * BN;
        tma_load_tile<KT>(st, &tk, kt, b * Hkv + hk, bar);
        tma_load_tile<KT>(st + KT::BYTES, &tv, kt, b * Hkv + hk, bar);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // a consumer warpgroup: 64 rows of one head
  const int head = pair_heads ? h0 + wg : h0;
  const int row0 = pair_heads ? q0 : q0 + wg * WG_ROWS;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = row0 + r0 + q_offset, pos1 = pos0 + 8;
  const int wg_lo = row0 + q_offset, wg_hi = min(row0 + WG_ROWS, Sq) - 1 + q_offset;
  const size_t prow = (size_t)(b * Hq + head) * Sq_pad + row0 + r0;
  const float2 pr0 = ld[prow], pr1 = ld[prow + 8];  // rows past Sq: (+inf, 0)
  const uint32_t q_tile = q_s + wg * QT::BYTES, do_tile = do_s + wg * QT::BYTES;

  float dq_acc[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % STAGES;
    const int kt = k_begin + it * BN;
    const uint32_t k_tile = st_s + s * C::STAGE_BYTES, v_tile = k_tile + KT::BYTES;
    const bool dead = wg_hi < wg_lo || (causal && kt > wg_hi) ||
                      (window > 0 && kt + BN - 1 <= wg_lo - window);
    mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
    if (!dead) {
      float sc[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(sc, QT::kmajor(q_tile, 0, kk), KT::kmajor(k_tile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(dp, QT::kmajor(do_tile, 0, kk), KT::kmajor(v_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = kt + BN > Sk || (causal && kt + BN - 1 > wg_lo) ||
                        (window > 0 && kt <= wg_hi - window);
      p_and_ds(sc, dp, scale_log2, edge, [&](int, int e) { return e < 2 ? pr0 : pr1; },
               [&](int j, int e) {
                 const int key = kt + 8 * j + cq + (e & 1), pos = e < 2 ? pos0 : pos1;
                 return key < Sk && (!causal || key <= pos) && (window <= 0 || key > pos - window);
               });
      uint32_t sa[BN / 16][4];  // dS in bf16
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a(sa[kk], dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) mma_rs<1>(dq_acc, sa[kk], KT::mnmajor(k_tile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }

  const size_t rows = (size_t)(b * Hq + head) * Sq;
  const int ra = row0 + r0, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(dq + (rows + ra) * D + col) =
          pack_bf16(dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(dq + (rows + rb) * D + col) =
          pack_bf16(dq_acc[4 * j + 2] * scale, dq_acc[4 * j + 3] * scale);
  }
}

// dk = scale * sum of the HS partials of part[0], dv = the sum of part[1], each
// summed in split order and cast to bf16; four elements a thread.
__global__ void __launch_bounds__(256)
bwd_reduce_sm90(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, long long n4, int HS, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const long long j = is_v ? i - n4 : i;
  const float4* src = reinterpret_cast<const float4*>(part) + (is_v ? HS * n4 : 0) + j;
  float4 sum = src[0];
  for (int h = 1; h < HS; ++h) {
    const float4 v = src[h * n4];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const float f = is_v ? 1.f : scale;
  reinterpret_cast<uint2*>(is_v ? dv : dk)[j] =
      make_uint2(pack_bf16(sum.x * f, sum.y * f), pack_bf16(sum.z * f, sum.w * f));
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dO, void* ld, void* part, void* dq, void* dk, void* dv, int B,
                   int Hq, int Hkv, int Sq, int Sk, int HS, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  using KV = DkDv<D>;
  using Q = Dq<D>;
  if (HS < 1 || (Hq / Hkv) % HS != 0 || (HS > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const int Sq_pad = round_up(Sq, PAD);
  const float scale_log2 = scale * LOG2E;
  const long long rows = (long long)B * Hq * Sq_pad;
  bwd_prep_sm90<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float2*>(ld), Sq, Sq_pad, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // tensor maps of the dK/dV kernel (q tiles of BQ rows, 128 keys) and of the
  // dQ kernel (64-row slabs, 64-key tiles)
  CUtensorMap tq, tdo, tk, tv, tq2, tdo2, tk2, tv2;
  int err = repro::make_tmap_3d(&tq, q, D, Sq, B * Hq, KV::BQ, KV::QT::SW);
  if (!err) err = repro::make_tmap_3d(&tdo, dO, D, Sq, B * Hq, KV::BQ, KV::QT::SW);
  if (!err) err = repro::make_tmap_3d(&tk, k, D, Sk, B * Hkv, KV::KEYS, KV::KVT::SW);
  if (!err) err = repro::make_tmap_3d(&tv, v, D, Sk, B * Hkv, KV::KEYS, KV::KVT::SW);
  if (!err) err = repro::make_tmap_3d(&tq2, q, D, Sq, B * Hq, WG_ROWS, Q::QT::SW);
  if (!err) err = repro::make_tmap_3d(&tdo2, dO, D, Sq, B * Hq, WG_ROWS, Q::QT::SW);
  if (!err) err = repro::make_tmap_3d(&tk2, k, D, Sk, B * Hkv, Q::BN, Q::KT::SW);
  if (!err) err = repro::make_tmap_3d(&tv2, v, D, Sk, B * Hkv, Q::BN, Q::KT::SW);
  if (err) return static_cast<cudaError_t>(err);
  const float2* ld2 = static_cast<const float2*>(ld);

  e = cudaFuncSetAttribute(bwd_dkdv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           KV::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid_kv(B * Hkv * HS, (Sk + KV::KEYS - 1) / KV::KEYS);
  bwd_dkdv_sm90<D><<<grid_kv, NT, KV::SMEM, stream>>>(
      tq, tk, tv, tdo, ld2, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      HS > 1 ? static_cast<float*>(part) : nullptr, HS, Hq, Hkv, Sq, Sq_pad, Sk, scale,
      scale_log2, causal, window, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  e = cudaFuncSetAttribute(bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (e != cudaSuccess) return e;
  const int pair = (Hq / Hkv) % 2 == 0;
  const int span = pair ? WG_ROWS : CONSUMERS * WG_ROWS;
  const dim3 grid_q(B * Hq / (pair ? 2 : 1), (Sq + span - 1) / span);
  bwd_dq_sm90<D><<<grid_q, NT, Q::SMEM, stream>>>(
      tq2, tk2, tv2, tdo2, ld2, static_cast<__nv_bfloat16*>(dq), Hq, Hkv, Sq, Sq_pad, Sk, scale,
      scale_log2, causal, window, q_offset, pair);
  e = cudaGetLastError();
  if (e != cudaSuccess || HS == 1) return e;

  const long long n4 = (long long)B * Hkv * Sk * D / 4;  // D is a multiple of 8
  bwd_reduce_sm90<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n4, HS, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  window <= 0: no window.  ld: fp32 scratch of 2 * B * Hq * Sq_pad
// floats, Sq_pad = Sq rounded up to 128.  head_splits: HS, a divisor of Hq /
// Hkv; part: fp32 scratch of 2 * HS * B * Hkv * Sk * D floats where HS > 1
// (null where HS = 1).  Returns the first cudaError_t of the tensor maps and
// the launches (0 on success); the kernels run asynchronously, in order, on
// `stream`.
extern "C" int repro_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                              const void* o, const void* lse, const void* dO,
                                              void* ld, void* part, void* dq, void* dk, void* dv,
                                              int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                              int head_splits, float scale, int causal,
                                              int window, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FAB_ARGS q, k, v, o, lse, dO, ld, part, dq, dk, dv, B, Hq, Hkv, Sq, Sk, head_splits, \
                       scale, causal, window, q_offset, s
  switch (D) {
    case 32: return launch<32>(REPRO_FAB_ARGS);
    case 64: return launch<64>(REPRO_FAB_ARGS);
    case 112: return launch<112>(REPRO_FAB_ARGS);
    case 128: return launch<128>(REPRO_FAB_ARGS);
    case 160: return launch<160>(REPRO_FAB_ARGS);
    case 256: return launch<256>(REPRO_FAB_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FAB_ARGS
}
