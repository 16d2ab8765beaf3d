// FlashAttention forward for Hopper (sm_90a), bf16: wgmma on the tensor cores,
// Q, K and V tiles by TMA into shared memory guarded by mbarriers.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention
// for bf16 inputs (fp32 inputs keep the CUDA-core kernel, flash_attention.cu).
// Contract, as that kernel's: q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] contiguous bf16;
// o [B,Hq,Sq,D] bf16; when lse is not null, each row's fp32 log-sum-exp of its
// scaled logits (m + log l).  Query row i sits at absolute position
// i + q_offset; key j is visible when j < Sk, j <= pos (causal) and
// j > pos - window (window > 0).  Query head h reads KV head h / (Hq / Hkv).
//
// Work tiles: 128 rows of one head, or, when the group size Hq / Hkv is even,
// the same 64 rows of two heads of one KV group, which then share every K/V
// tile (recurrentgemma-9b: 16 query heads over one KV head); causal tiles
// longest first (the last rows see the most keys).  The grid is persistent:
// `blocks` blocks (the wrapper gives min(tiles, SMs)), block p taking tiles
// p, p + blocks, ... (flash_attention.py: work_tiles, block_walk).
//
// A block: 384 threads, two consumer warpgroups of 64 query rows each and one
// producer warpgroup that gives its registers to them (setmaxnreg).  Two
// producer threads issue the TMA copies: one the Q slabs and the K tiles,
// one the V tiles, each walking the tiles the masks leave visible (the
// CUDA-core kernel's bounds), BN keys a tile, through a ring of STAGES
// stages with a "full" and an "empty" barrier each for K and for V, so that
// Q K^T waits for K alone and a K slot is refilled as soon as its Q K^T is
// done.  A consumer's Q slab has barriers of its own: the next work tile's Q
// is loaded once the last Q K^T of this one is done, under its last softmax,
// P V and epilogue, and the ring runs on into the next tile's K/V.
//
// A consumer warpgroup overlaps its tensor cores with its softmax: tile j's
// S = Q K_j^T is issued together with O = O * a_{j-1} + P_{j-1} V_{j-1}, and
// the softmax of S_j runs while P V_{j-1} is still in the tensor cores
// (wgmma_wait<1>).  The two warpgroups take turns at issuing their products
// (named barriers 1 and 2, FlashAttention-3's ping-pong), so one's softmax
// runs under the other's products.  O sees the same operations in the same
// order as in a loop that does S, softmax, P V one tile at a time (rescale
// by tile j's factor, then add P_j V_j), so the bits are that loop's: the
// online softmax on the accumulator fragment (row max and sum over the four
// lanes that share a row; exp2f of x * scale_log2 - m), P rounded to bf16 in
// registers as wgmma's A operand, V in its natural [keys, D] layout
// (MN-major).  What is saved is no arithmetic of O: masks only on tiles that
// cross the diagonal, the window edge or Sk (a compile-time path, the bounds
// taken once a row), no rescale where it is by exactly 1, no tile that a
// warpgroup's rows cannot see, and O stored 16 bytes a lane.  ptxas must not
// serialize the products: between a product's issue and its wait there is
// no branch that depends on the lane, no barrier wait loop, no division.
//
// What bounds it: at llama3.2-3b's prefill shape (B=4, S=1024, causal) 25.8
// GFLOP on 67 MB, the tensor cores' 989 TFLOP/s (about 26 us).  Head dims 32,
// 64, 112, 128 (BN = 128 keys) and 160, 256 (BN = 64: the 64 x 256 fp32
// accumulator is 128 registers a thread, inside the 240 a consumer thread
// gets).  112 and 160 keep tiles of 128 and 192 columns (sm90.cuh:
// padded_dim): S = Q K^T reduces over the true D, and O += P V runs at the
// true width in block-aligned products (64 + 48, 128 + 32 columns).
#include "sm90.cuh"
#include "tile.cuh"

namespace {

using namespace repro::sm90;
using repro::NEG_INF;

constexpr int WG_ROWS = 64;                // query rows of a consumer warpgroup
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int NT = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int SMEM_MAX = 232448;           // shared memory a block can have
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int DP = padded_dim(D);       // the tiles' columns
  static constexpr int BN = DP > 128 ? 64 : 128;  // keys a tile
  using QT = Tile<WG_ROWS, DP>;
  using KT = Tile<BN, DP>;
  static constexpr int BARS = 2 * CONSUMERS + 4 * 4;  // Q full/empty; K, V full/empty
  // as many K/V stages as shared memory holds, up to 4 (112, 128, 160: 3; 256: 2)
  static constexpr int FIT = (SMEM_MAX - 1024 - 8 * BARS - CONSUMERS * QT::BYTES) / (2 * KT::BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(STAGES >= 2, "two K/V stages at least");
  static constexpr int K_OFF = CONSUMERS * QT::BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KT::BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KT::BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;  // + alignment slack
};

// A work tile: its batch, first head, first row, and the key tiles its rows see.
struct Work {
  int b, h0, q0, k_begin, n_kv;
};

template <int BN>
__device__ __forceinline__ Work work_tile(int w, int Hq, int Sq, int Sk, int causal, int window,
                                          int q_offset, int pair_heads, int gx, int gy) {
  const int hpb = pair_heads ? 2 : 1;
  const int span = pair_heads ? WG_ROWS : CONSUMERS * WG_ROWS;
  const int x = w % gx, y = w / gx;
  Work t;
  t.b = x / (Hq / hpb);
  t.h0 = (x % (Hq / hpb)) * hpb;
  t.q0 = (causal ? gy - 1 - y : y) * span;
  // the keys its rows see (absolute positions q_lo..q_hi)
  const int q_lo = t.q0 + q_offset, q_hi = min(t.q0 + span, Sq) - 1 + q_offset;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  t.k_begin = (k_begin / BN) * BN;
  t.n_kv = k_end > t.k_begin ? (k_end - t.k_begin + BN - 1) / BN : 0;
  return t;
}

// The key tiles [lo, hi) of a work tile's n_kv that rows wg_lo..wg_hi see:
// the masks cut a prefix (window) and a suffix (causal) of the work tile's.
template <int BN>
__device__ __forceinline__ void live_tiles(int kb, int n_kv, int wg_lo, int wg_hi, int causal,
                                           int window, int& lo, int& hi) {
  lo = 0;
  hi = wg_hi < wg_lo ? 0 : n_kv;
  while (lo < hi && window > 0 && kb + lo * BN + BN - 1 <= wg_lo - window) ++lo;
  while (hi > lo && causal && kb + (hi - 1) * BN > wg_hi) --hi;
}

// What the softmax needs of a warpgroup's rows: this thread's first column
// of each 8-column chunk (cq) and its two rows' positions, the masks, and
// the rows' first and last positions (wg_lo, wg_hi).
struct Rows {
  int cq, pos0, pos1, wg_lo, wg_hi, Sk, causal, window;
  float scale_log2;
};

// Scales one tile's logits (and masks them, on a tile that crosses the
// diagonal, the window's edge or Sk: EDGE), updates the row max m and the
// row sum l (this thread's share), turns the logits into exp2f(x - m) and
// returns each row's rescale factor exp2f(m_old - m_new).  The two
// instantiations are the two paths of one loop that asked `edge` at run
// time: a tile's mask is decided once, not predicated element by element.
template <bool EDGE, int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1,
                                               const Rows& r, int k0) {
  float mx0 = m0, mx1 = m1;
  // key k0 + cq + c (c = 8 j + (e & 1), a constant of the unrolled loop) is
  // visible to row pos when key < Sk, key <= pos (causal) and key > pos -
  // window: when lo <= c <= hi, with the row's bounds taken once
  int lo0 = -(1 << 30), lo1 = -(1 << 30), hi0 = 0, hi1 = 0;
  if constexpr (EDGE) {
    const int base = k0 + r.cq;
    hi0 = hi1 = r.Sk - 1 - base;
    if (r.causal) {
      hi0 = min(hi0, r.pos0 - base);
      hi1 = min(hi1, r.pos1 - base);
    }
    if (r.window > 0) {
      lo0 = r.pos0 - r.window + 1 - base;
      lo1 = r.pos1 - r.window + 1 - base;
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * r.scale_log2;
      if constexpr (EDGE) {
        const int c = 8 * j + (e & 1);
        const bool ok = e < 2 ? (c >= lo0 && c <= hi0) : (c >= lo1 && c <= hi1);
        x = ok ? x : NEG_INF;
      }
      sc[4 * j + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  a0 = exp2f(m0 - mx0);
  a1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = exp2f(sc[4 * j] - m0);
    sc[4 * j + 1] = exp2f(sc[4 * j + 1] - m0);
    sc[4 * j + 2] = exp2f(sc[4 * j + 2] - m1);
    sc[4 * j + 3] = exp2f(sc[4 * j + 3] - m1);
    s0 += sc[4 * j] + sc[4 * j + 1];
    s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
}

// P in bf16, as wgmma's A fragments.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// O *= the rows' factors, unless every row of the warp keeps its max (a = 1
// exactly, which leaves O as it is).
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float a0, float a1) {
  if (!__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= a0;
    acc[4 * j + 1] *= a0;
    acc[4 * j + 2] *= a1;
    acc[4 * j + 3] *= a1;
  }
}

// O += P V_tile, issued (not waited for): the true D columns, in products
// that start on a column block.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[Fwd<D>::BN / 16][4], uint32_t v_tile) {
  using KT = typename Fwd<D>::KT;
#pragma unroll
  for (int kk = 0; kk < Fwd<D>::BN / 16; ++kk) {
    if constexpr (D == 112) {
      mma_rs_at<64, 1, 0>(acc, p[kk], KT::mnmajor(v_tile, kk), 1);
      mma_rs_at<48, 1, 32>(acc, p[kk], KT::mnmajor(v_tile + KT::BLOCK_BYTES, kk), 1);
    } else if constexpr (D == 160) {
      mma_rs_at<128, 1, 0>(acc, p[kk], KT::mnmajor(v_tile, kk), 1);
      mma_rs_at<32, 1, 64>(acc, p[kk], KT::mnmajor(v_tile + 2 * KT::BLOCK_BYTES, kk), 1);
    } else {
      mma_rs<1>(acc, p[kk], KT::mnmajor(v_tile, kk), 1);
    }
  }
}

// Stores row `e` (0: r0, 1: r0 + 8) of this thread's part of a warpgroup's
// O, times `inv` (1 / l), in bf16 to `row` (the row's first column), if `ok`.
// The four lanes that share a row (q = lane % 4) hold 2 columns of each
// 8-column chunk; they trade their 4-byte pieces (two xor shuffles) so that
// each writes 16 bytes of one chunk, four chunks at a time, and 8 bytes of
// each of a last pair of chunks (D = 112): a quarter of the store
// instructions, each a whole 64 bytes of a row.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, bool ok, const float (&acc)[D / 2],
                                          int e, float inv, int q) {
  uint32_t w[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    w[j] = pack_bf16(acc[4 * j + 2 * e] * inv, acc[4 * j + 2 * e + 1] * inv);
  const bool odd = q & 1, high = q & 2;
#pragma unroll
  for (int j0 = 0; j0 < D / 8; j0 += 4) {
    // pairs of chunks: an even lane keeps 4 columns of chunk j0 (+ 2), an
    // odd lane of chunk j0 + 1 (+ 3), each at column 2 (q & 2) of its chunk
    const uint32_t r01 = __shfl_xor_sync(0xffffffffu, odd ? w[j0] : w[j0 + 1], 1);
    const uint32_t a0 = odd ? r01 : w[j0], a1 = odd ? w[j0 + 1] : r01;
    if (j0 + 4 > D / 8) {  // the last pair: 8 bytes each
      if (ok)
        *reinterpret_cast<uint2*>(row + 8 * (j0 + odd) + 2 * (q & 2)) = make_uint2(a0, a1);
      break;
    }
    const uint32_t r23 = __shfl_xor_sync(0xffffffffu, odd ? w[j0 + 2] : w[j0 + 3], 1);
    const uint32_t b0 = odd ? r23 : w[j0 + 2], b1 = odd ? w[j0 + 3] : r23;
    // then lanes q and q ^ 2 complete chunk j0 + odd (q < 2) or j0 + 2 + odd
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, high ? a0 : b0, 2);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, high ? a1 : b1, 2);
    const uint4 v = high ? make_uint4(s0, s1, b0, b1) : make_uint4(a0, a1, s0, s1);
    if (ok) *reinterpret_cast<uint4*>(row + 8 * (j0 + odd + (high ? 2 : 0))) = v;
  }
}

// A consumer warpgroup's state over one work tile, and its steps.  `g` is
// the ring position of the work tile's first K/V tile; tile `it` of the work
// tile sits in slot (g + it) % STAGES.
template <int D>
struct Consumer {
  using C = Fwd<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  static constexpr int BN = C::BN, STAGES = C::STAGES;
  uint32_t q_tile, k_s, v_s, k_full, k_empty, v_full, v_empty, q_empty;
  int lane, g, hi, turn, other;  // turn, other: the two warpgroups' named barriers
  float acc[D / 2], sc[BN / 2];
  uint32_t p[BN / 16][4];
  float m0, m1, l0, l1, a0, a1;  // l: this thread's share of the row sum

  __device__ __forceinline__ uint32_t bar(int it) const { return 8 * ((g + it) % STAGES); }
  __device__ __forceinline__ uint32_t phase(int it) const { return ((g + it) / STAGES) & 1; }
  __device__ __forceinline__ uint32_t tile(uint32_t ring, int it) const {
    return ring + ((g + it) % STAGES) * KT::BYTES;
  }
  __device__ __forceinline__ void wait_k(int it) const { mbar_wait(k_full + bar(it), phase(it)); }
  __device__ __forceinline__ void wait_v(int it) const { mbar_wait(v_full + bar(it), phase(it)); }
  // one arrival a warp (a wgmma_wait has already synchronized its lanes)
  __device__ __forceinline__ void arrive(uint32_t b, bool pred) const {
    mbar_arrive_if(b, pred && lane == 0);
  }
  // A tile these rows cannot see: its slots passed on, and an empty turn.
  __device__ __forceinline__ void skip(int it) const {
    wait_k(it);
    arrive(k_empty + bar(it), true);
    wait_v(it);
    arrive(v_empty + bar(it), true);
    take_turn();
    pass_turn();
  }
  // The two warpgroups take turns at the tensor cores: a warpgroup issues its
  // products once the other has issued its own (bar.sync on its barrier, which
  // the other's bar.arrive completes), so one's softmax runs under the
  // other's products.  Each takes n_kv + 1 turns a work tile, whatever its
  // rows see: a turn a K/V tile (its Q K^T, or an empty turn where the tile
  // is skipped) and one for the last P V, so at its k-th turn neither
  // warpgroup needs a tile that waits on the other's (k+1)-th.
  __device__ __forceinline__ void take_turn() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(turn) : "memory");
  }
  __device__ __forceinline__ void pass_turn() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
  }
  __device__ __forceinline__ void issue_qk(int it) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0, 0>(sc, QT::kmajor(q_tile, 0, kk), KT::kmajor(tile(k_s, it), 0, kk), kk > 0);
  }

  // The first tile these rows see: S, then its softmax (O is still zero).
  template <bool EDGE>
  __device__ __forceinline__ void first(int it, int k0, const Rows& r) {
    wait_k(it);
    take_turn();
    wgmma_fence();
    issue_qk(it);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    arrive(k_empty + bar(it), true);
    arrive(q_empty, it + 1 == hi);
    online_softmax<EDGE, BN>(sc, m0, m1, l0, l1, a0, a1, r, k0);
    pack_p<BN>(p, sc);
  }

  // S_it = Q K_it^T, then O = O * a_{it-1} + P_{it-1} V_{it-1} under it, and
  // the softmax of S_it under P V.  No barrier is waited on, and no branch
  // that depends on the lane taken, while a product is in flight.
  template <bool EDGE>
  __device__ __forceinline__ void step(int it, int k0, const Rows& r) {
    wait_k(it);
    wait_v(it - 1);
    take_turn();
    wgmma_fence();
    issue_qk(it);
    wgmma_commit();
    rescale<D>(acc, a0, a1);
    wgmma_fence();
    issue_pv<D>(acc, p, tile(v_s, it - 1));
    wgmma_commit();
    pass_turn();
    wgmma_wait<1>();  // S_it is in
    fence_regs(sc);
    arrive(k_empty + bar(it), true);
    arrive(q_empty, it + 1 == hi);
    online_softmax<EDGE, BN>(sc, m0, m1, l0, l1, a0, a1, r, k0);
    wgmma_wait<0>();  // P_{it-1} V_{it-1} is in
    fence_regs(acc);
    fence_regs(p);
    arrive(v_empty + bar(it - 1), true);
    pack_p<BN>(p, sc);
  }

  // O = O * a_it + P_it V_it, the last tile's.
  __device__ __forceinline__ void last(int it) {
    wait_v(it);
    rescale<D>(acc, a0, a1);
    take_turn();
    wgmma_fence();
    issue_pv<D>(acc, p, tile(v_s, it));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    arrive(v_empty + bar(it), true);
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int B, int Hq, int Hkv, int Sq, int Sk, float scale_log2,
               int causal, int window, int q_offset, int pair_heads) {
  using C = Fwd<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 8 * CONSUMERS;
  const uint32_t k_full = q_empty + 8 * CONSUMERS, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;

  const int hpb = pair_heads ? 2 : 1;
  const int span = pair_heads ? WG_ROWS : CONSUMERS * WG_ROWS;
  const int gx = B * Hq / hpb, gy = (Sq + span - 1) / span, n_work = gx * gy;

  if (threadIdx.x == 0) {
    for (int w = 0; w < CONSUMERS; ++w) {
      mbar_init(q_full + 8 * w, 1);
      mbar_init(q_empty + 8 * w, 4);  // one arrival a warp of the warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMERS * 4);  // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warpgroup: two threads issue every copy
    setmaxnreg_dec<24>();
    const int t = threadIdx.x - CONSUMERS * 128;
    if (t == 0 || t == 32) {
      const bool is_k = t == 0;  // Q and K; or V
      const CUtensorMap* map = is_k ? &tk : &tv;
      const uint32_t ring = is_k ? k_s : v_s, full = is_k ? k_full : v_full;
      const uint32_t empty = is_k ? k_empty : v_empty;
      int g = 0;  // the block's K/V tiles so far
      int i = 0;  // its work tiles so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++i) {
        const Work wt = work_tile<BN>(w, Hq, Sq, Sk, causal, window, q_offset, pair_heads, gx, gy);
        const int hk = wt.h0 / (Hq / Hkv);
        if (is_k) {
          for (int c = 0; c < CONSUMERS; ++c) {
            if (i > 0) mbar_wait(q_empty + 8 * c, (i - 1) & 1);
            mbar_expect_tx(q_full + 8 * c, QT::BYTES);
            tma_load_tile<QT>(q_s + c * QT::BYTES, &tq, pair_heads ? wt.q0 : wt.q0 + c * WG_ROWS,
                              wt.b * Hq + (pair_heads ? wt.h0 + c : wt.h0), q_full + 8 * c);
          }
        }
        for (int it = 0; it < wt.n_kv; ++it, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
          mbar_expect_tx(full + 8 * s, KT::BYTES);
          tma_load_tile<KT>(ring + s * KT::BYTES, map, wt.k_begin + it * BN, wt.b * Hkv + hk,
                            full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // a consumer warpgroup: 64 rows of one head a work tile
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  Consumer<D> c;
  c.q_tile = q_s + wg * QT::BYTES;
  c.k_s = k_s;
  c.v_s = v_s;
  c.k_full = k_full;
  c.k_empty = k_empty;
  c.v_full = v_full;
  c.v_empty = v_empty;
  c.q_empty = q_empty + 8 * wg;
  c.lane = lane;
  c.g = 0;
  c.turn = 1 + wg;  // named barrier 0 is __syncthreads'
  c.other = 2 - wg;
  if (wg == 1) c.pass_turn();  // warpgroup 0 goes first
  int i = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++i) {
    const Work wt = work_tile<BN>(w, Hq, Sq, Sk, causal, window, q_offset, pair_heads, gx, gy);
    const int head = pair_heads ? wt.h0 + wg : wt.h0;
    const int row0 = pair_heads ? wt.q0 : wt.q0 + wg * WG_ROWS;
    Rows r;
    r.cq = 2 * (lane % 4);  // this thread's first column of each 8-column chunk
    r.pos0 = row0 + r0 + q_offset;
    r.pos1 = r.pos0 + 8;
    r.wg_lo = row0 + q_offset;
    r.wg_hi = min(row0 + WG_ROWS, Sq) - 1 + q_offset;
    r.Sk = Sk;
    r.causal = causal;
    r.window = window;
    r.scale_log2 = scale_log2;
    // the key tiles [lo, hi) these rows see; of those, the tiles [e_lo, e_hi)
    // need no mask (they cross no diagonal, window edge or Sk)
    const int kb = wt.k_begin;
    int lo, hi;
    live_tiles<BN>(kb, wt.n_kv, r.wg_lo, r.wg_hi, causal, window, lo, hi);
    int e_lo = lo, e_hi = hi;
    while (e_lo < hi && window > 0 && kb + e_lo * BN <= r.wg_hi - window) ++e_lo;
    while (e_hi > e_lo && (kb + e_hi * BN > Sk || (causal && kb + e_hi * BN - 1 > r.wg_lo))) --e_hi;
    c.hi = hi;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) c.acc[j] = 0.f;
    c.m0 = c.m1 = NEG_INF;
    c.l0 = c.l1 = 0.f;

    mbar_wait(q_full + 8 * wg, i & 1);
    for (int it = 0; it < lo; ++it) c.skip(it);
    if (lo < hi) {
      if (lo < e_lo || lo >= e_hi)
        c.template first<true>(lo, kb + lo * BN, r);
      else
        c.template first<false>(lo, kb + lo * BN, r);
      int it = lo + 1;
      for (; it < e_lo; ++it) c.template step<true>(it, kb + it * BN, r);
      for (; it < e_hi; ++it) c.template step<false>(it, kb + it * BN, r);
      for (; it < hi; ++it) c.template step<true>(it, kb + it * BN, r);
      c.last(hi - 1);
    } else {  // nothing to compute: the last P V's turn, empty
      c.arrive(c.q_empty, true);
      c.take_turn();
      c.pass_turn();
    }
    for (int it = hi; it < wt.n_kv; ++it) c.skip(it);
    c.g += wt.n_kv;

    float l0 = c.l0, l1 = c.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const float i0 = 1.f / d0, i1 = 1.f / d1;
    const size_t rows = (size_t)(wt.b * Hq + head) * Sq;
    const int ra = row0 + r0, rb = ra + 8;
    store_row<D>(o + (rows + ra) * D, ra < Sq, c.acc, 0, i0, lane % 4);
    store_row<D>(o + (rows + rb) * D, rb < Sq, c.acc, 1, i1, lane % 4);
    if (lse != nullptr && lane % 4 == 0) {
      if (ra < Sq) lse[rows + ra] = c.m0 * LN2 + logf(d0);
      if (rb < Sq) lse[rows + rb] = c.m1 * LN2 + logf(d1);
    }
  }
  // warpgroup 1 passed one turn more than warpgroup 0 took: take it, so that
  // no arrival is left on a named barrier when the block exits (a launch
  // after this one would find it there)
  if (wg == 0) c.take_turn();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                   int Hkv, int Sq, int Sk, float scale, int causal, int window, int q_offset,
                   int blocks, cudaStream_t stream) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err = repro::make_tmap_3d(&tq, q, D, Sq, B * Hq, WG_ROWS, C::QT::SW);
  if (!err) err = repro::make_tmap_3d(&tk, k, D, Sk, B * Hkv, C::BN, C::KT::SW);
  if (!err) err = repro::make_tmap_3d(&tv, v, D, Sk, B * Hkv, C::BN, C::KT::SW);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const int pair = (Hq / Hkv) % 2 == 0;
  flash_fwd_sm90<D><<<blocks, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, Hq, Hkv, Sq, Sk, scale * LOG2E, causal,
      window, q_offset, pair);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  window <= 0: no window.  lse may be null.  q, k, v 16-byte
// aligned (TMA).  blocks: the persistent grid, at least 1 (the wrapper gives
// min(work tiles, SMs)).  Returns the cudaError_t of the tensor maps and the
// launch (0 on success); the kernel runs asynchronously.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                                          int D, float scale, int causal, int window,
                                          int q_offset, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (blocks < 1) return cudaErrorInvalidValue;
#define REPRO_FA_ARGS q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale, causal, window, q_offset, blocks, s
  switch (D) {
    case 32: return launch<32>(REPRO_FA_ARGS);
    case 64: return launch<64>(REPRO_FA_ARGS);
    case 112: return launch<112>(REPRO_FA_ARGS);
    case 128: return launch<128>(REPRO_FA_ARGS);
    case 160: return launch<160>(REPRO_FA_ARGS);
    case 256: return launch<256>(REPRO_FA_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA_ARGS
}
