// FlashAttention forward for Hopper (sm_90a), bf16: wgmma on the tensor cores,
// K/V tiles by TMA into a ring of shared memory guarded by mbarriers.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention
// for bf16 inputs (fp32 inputs keep the CUDA-core kernel, flash_attention.cu).
// Contract, as that kernel's: q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] contiguous bf16;
// o [B,Hq,Sq,D] bf16; when lse is not null, each row's fp32 log-sum-exp of its
// scaled logits (m + log l).  Query row i sits at absolute position
// i + q_offset; key j is visible when j < Sk, j <= pos (causal) and
// j > pos - window (window > 0).  Query head h reads KV head h / (Hq / Hkv).
//
// Shape: 384 threads, two consumer warpgroups of 64 query rows each and one
// producer warpgroup that gives its registers to them (setmaxnreg).  A block
// holds 128 rows of one head, or, when the group size Hq / Hkv is even, the
// same 64 rows of two heads of one KV group, which then share every K/V tile
// (recurrentgemma-9b: 16 query heads over one KV head).
// The producer loads the two Q slabs once, then walks the K/V tiles the masks
// leave visible (the CUDA-core kernel's bounds), BN keys a tile, into a ring
// of two stages: it waits for a stage's "empty" barrier, arms its "full"
// barrier with the tile's bytes and issues the TMA boxes.  Each consumer
// warpgroup waits on "full", computes S = Q K^T with wgmma (both operands
// K-major in shared memory, fp32 accumulators in registers), runs the online
// softmax on the accumulator fragment (row max and sum over the four lanes
// that share a row; masks only on tiles that cross the diagonal, the window
// edge or Sk), rounds P to bf16 in registers and feeds it as wgmma's A
// operand to O += P V (V in its natural [keys, D] layout, MN-major), then
// releases the stage.  Tiles a warpgroup's rows cannot see are skipped.
// Causal tiles are issued longest first (the last q tiles see the most keys).
//
// What bounds it: at llama3.2-3b's prefill shape (B=4, S=1024, causal) 25.8
// GFLOP on 67 MB, the tensor cores' 989 TFLOP/s (about 26 us).  Head dims 32,
// 64, 112, 128 (BN = 128 keys) and 160, 256 (BN = 64: the 64 x 256 fp32
// accumulator is 128 registers a thread, inside the 240 a consumer thread
// gets; 197 KB of shared memory).  112 and 160 run on tiles of 128 and 192
// columns (sm90.cuh: padded_dim): S = Q K^T reduces over the true D, O += P V
// is m64n128 or m64n192 and the columns past D are not stored.
#include "sm90.cuh"
#include "tile.cuh"

namespace {

using namespace repro::sm90;
using repro::NEG_INF;

constexpr int WG_ROWS = 64;                // query rows of a consumer warpgroup
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int NT = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int DP = padded_dim(D);       // the tiles' columns
  static constexpr int BN = DP > 128 ? 64 : 128;  // keys a tile
  using QT = Tile<WG_ROWS, DP>;
  using KT = Tile<BN, DP>;
  static constexpr int K_OFF = CONSUMERS * QT::BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KT::BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KT::BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, float scale_log2,
               int causal, int window, int q_offset, int pair_heads) {
  using C = Fwd<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BN = C::BN, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t q_bar = base + C::BAR_OFF;
  const uint32_t full_bar = q_bar + 8, empty_bar = q_bar + 8 * (1 + STAGES);

  // the block's heads and rows; causal tiles longest first
  const int hpb = pair_heads ? 2 : 1;
  const int span = pair_heads ? WG_ROWS : CONSUMERS * WG_ROWS;
  const int b = blockIdx.x / (Hq / hpb);
  const int h0 = (blockIdx.x % (Hq / hpb)) * hpb;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * span;
  const int hk = h0 / (Hq / Hkv);

  // the keys its rows see (absolute positions q_lo..q_hi)
  const int q_lo = q0 + q_offset, q_hi = min(q0 + span, Sq) - 1 + q_offset;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  k_begin = (k_begin / BN) * BN;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS * 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, CONSUMERS * QT::BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        tma_load_tile<QT>(q_s + w * QT::BYTES, &tq, pair_heads ? q0 : q0 + w * WG_ROWS,
                          b * Hq + (pair_heads ? h0 + w : h0), q_bar);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty_bar + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * KT::BYTES);
        const int k0 = k_begin + it * BN;
        tma_load_tile<KT>(k_s + s * KT::BYTES, &tk, k0, b * Hkv + hk, full_bar + 8 * s);
        tma_load_tile<KT>(v_s + s * KT::BYTES, &tv, k0, b * Hkv + hk, full_bar + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // a consumer warpgroup: 64 rows of one head
  const int head = pair_heads ? h0 + wg : h0;
  const int row0 = pair_heads ? q0 : q0 + wg * WG_ROWS;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);            // its first column of each 8-column chunk
  const int pos0 = row0 + r0 + q_offset, pos1 = pos0 + 8;
  const int wg_lo = row0 + q_offset, wg_hi = min(row0 + WG_ROWS, Sq) - 1 + q_offset;
  const uint32_t q_tile = q_s + wg * QT::BYTES;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % STAGES;
    const int k0 = k_begin + it * BN;
    const uint32_t k_tile = k_s + s * KT::BYTES, v_tile = v_s + s * KT::BYTES;
    const bool dead = wg_hi < wg_lo || (causal && k0 > wg_hi) ||
                      (window > 0 && k0 + BN - 1 <= wg_lo - window);
    mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
    if (!dead) {
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(sc, QT::kmajor(q_tile, 0, kk), KT::kmajor(k_tile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > wg_lo) ||
                        (window > 0 && k0 <= wg_hi - window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + cq + (e & 1), pos = e < 2 ? pos0 : pos1;
            const bool ok = key < Sk && (!causal || key <= pos) && (window <= 0 || key > pos - window);
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
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
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
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
      uint32_t p[BN / 16][4];  // P in bf16, as wgmma's A fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) mma_rs<1>(acc, p[kk], KT::mnmajor(v_tile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / d0, i1 = 1.f / d1;
  const size_t rows = (size_t)(b * Hq + head) * Sq;
  const int ra = row0 + r0, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(o + (rows + ra) * D + col) =
          pack_bf16(acc[4 * j] * i0, acc[4 * j + 1] * i0);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(o + (rows + rb) * D + col) =
          pack_bf16(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (ra < Sq) lse[rows + ra] = m0 * LN2 + logf(d0);
    if (rb < Sq) lse[rows + rb] = m1 * LN2 + logf(d1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                   int Hkv, int Sq, int Sk, float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
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
  const int span = pair ? WG_ROWS : CONSUMERS * WG_ROWS;
  const dim3 grid(B * Hq / (pair ? 2 : 1), (Sq + span - 1) / span);
  flash_fwd_sm90<D><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq, Sk, scale * LOG2E, causal,
      window, q_offset, pair);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  window <= 0: no window.  lse may be null.  q, k, v 16-byte
// aligned (TMA).  Returns the cudaError_t of the tensor maps and the launch
// (0 on success); the kernel runs asynchronously.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                                          int D, float scale, int causal, int window,
                                          int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FA_ARGS q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale, causal, window, q_offset, s
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
