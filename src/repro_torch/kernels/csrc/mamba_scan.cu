// Mamba-1 selective scan for Hopper (sm_90a), fp32 state.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py:mamba_scan.
// Contract: x [B,S,Din], Bm/Cm [B,S,N] contiguous, one type for the three
// (fp32 or bf16); delta [B,S,Din] fp32 (post-softplus); A [Din,N], D [Din],
// h0 [B,Din,N] fp32 (h0 may be null: zeros).  For every (b, d, n):
//   h_t[n] = exp(delta_t A[d,n]) h_{t-1}[n] + delta_t x_t Bm_t[n],
//   y_t    = sum_n Cm_t[n] h_t[n] + D[d] x_t,
// y [B,S,Din] in x's type, hT [B,Din,N] fp32.  Every operand is widened to
// fp32 before any arithmetic, as in the Pallas kernel.
//
// What bounds it: at falcon-mamba-7b's prefill (B=4, S=1024, Din=8192, N=16,
// bf16 x/Bm/Cm, fp32 delta) it moves 269 MB (0.080 ms at 3.35 TB/s) and takes
// 537 M exponentials.  Those run on the special-function units, 16 an SM a
// clock: 0.128 ms at 1.98 GHz on 132 SMs, the floor.  The TPU kernel
// materialises [chunk, block_d, N] tiles of a and b in VMEM and runs an
// associative scan over them; here no [.., N] tensor leaves the registers and
// the recurrence runs step by step, with one exponential per (b, t, d, n).
//
// Shape: four lanes per (batch row, channel), each holding N / 4 of the
// channel's states in registers, so B=4, Din=8192 gives 4096 warps, ~31 an
// SM, all resident at once.  What holds it above the SFU floor is issue: a
// state's update is four instructions (the exponent's product, the
// exponential, (delta x) Bm, the fma into h) against 8 issue slots a state at
// the SFU's rate (128 lanes issue a clock against 16 exponentials), so the
// work around it decides the time.  The design keeps that work small:
//  - y_t's sum over states is a tree: within a lane, pairs of states by fma,
//    then the pairs; across the four lanes, a reduce-scatter every RS = 16
//    steps (two rounds of xor-shuffles over the 16 lane sums), after which
//    lane l holds y of steps 4 m + l, (lane 0 + lane 1) + (lane 2 + lane 3),
//    and adds x D: 0.75 shuffles a step where a per-step butterfly takes 2.
//  - A lane's Bm and Cm of a step sit side by side in shared memory in their
//    own type: one 16-byte load a step in bf16, widened by shifts.
//  - x, delta, Bm and Cm of the next tile of TS = 32 steps arrive by
//    cp.async into the other half of a two-stage buffer while this tile
//    computes; y goes through shared memory and leaves in 16-byte stores.
//    Two __syncthreads a tile.
// Exponentials are ex2.approx of delta * (A log2 e), A log2 e computed once a
// thread; nothing divides by a cumulative decay.  Rows past S and channels
// past Din are zero-filled: delta = 0 makes a = 1 and b = 0, so the padded
// steps leave h as it is, and every tile runs TS steps with no bound in the
// loop.
//
// With `ckpt` non-null the forward also writes the state entering every U =
// 16 steps, [B, ceil(S / U), Din, N] fp32: where the backward starts each
// group.
//
// The backward (repro_mamba_scan_bwd, no TPU kernel: the JAX package
// differentiates its XLA reference) is the reverse scan of the same
// recurrence, in the same layout of four lanes a channel.  With g_t the
// gradient of h_t:
//   g_t = Cm_t dy_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT),
//   dx_t = delta_t sum_n g_t Bm_t + D dy_t,
//   ddelta_t = x_t sum_n g_t Bm_t + sum_n g_t A a_t h_{t-1},
//   dA = sum_{b,t} g_t delta_t a_t h_{t-1},
//   dBm_t = sum_d g_t delta_t x_t,  dCm_t = sum_d dy_t h_t,  dD = sum_{b,t} dy_t x_t,
//   dh0 = a_0 g_0.
// The reverse recurrence is linear in g, so the sequence splits into chunks
// that run in parallel, as the RG-LRU's reverse scan does (rglru_scan.cu):
//   pass 1, a block per (64 channels, chunk of L1 = 64 steps, row), walks
//     its chunk back from a zero carry and writes the chunk's summary, fp32
//     [B, ceil(S / L1), Din, N] each: the a g it reaches at the chunk's first
//     step, and the product of its a_t.  It reads delta, dy and Cm, and runs
//     only for the chunks right of the second pass's first chunk;
//   pass 2, a block per (64 channels, chunk of L2 steps, row), folds the
//     summaries to its right, from the last (dhT folded in first; a fixed
//     order), into its true carry, then walks its chunk back one group of
//     U steps at a time.  A group's tiles (x, delta, dy, Bm, Cm and its
//     checkpoint) arrive by cp.async into one stage of two while the group
//     before it computes; Bm and Cm are widened to fp32 once, as they go in.
//     The group's states are run forward from the checkpoint and kept in
//     registers (U x N/4 a lane), then walked back, a_t taken again: two
//     exponentials a (b, t, d, n) here and one in pass 1 for the chunks it
//     covers (checkpoints every 32 steps would take a third: a tile's first
//     half run twice).
// The wrapper picks L2, a multiple of L1, so that pass 2 has about two blocks
// an SM: falcon-mamba-7b's training (B=1, Din=8192) gets 2 chunks of 512
// steps, 256 blocks, where one chunk would give 128 blocks of 8 warps for
// 132 SMs; B=4 takes one chunk and no pass 1.  The sums over the four lanes (dx,
// ddelta) are a reduce-scatter every four steps; dBm_t and dCm_t are summed
// over the warp's 8 channels by a reduce-scatter of shuffles (a buffer of the
// warp's in shared memory instead, 16-byte stores and a lane a column, moves
// twice the shared-memory bytes and was slower), then over the block's 8
// warps in order, into fp32 partials per block;
// dA and dD into partials per (row, chunk), dh0 from chunk 0.  A last
// kernel of this library sums each kind of partial in a fixed order, so,
// with no atomics, two runs give the same bits.  Nothing divides by a decay
// (exp(delta A) underflows to 0 over a group at falcon-mamba's decays).
// What bounds it at falcon-mamba-7b's training shape (B=1, S=1024,
// Din=8192, N=16, bf16): the exponentials, 134 M (b, t, d, n) at least once,
// 0.032 ms at the SFU's rate; the bytes it must move (x, delta, dy, Bm, Cm,
// the checkpoints in; dx, ddelta out), 0.041 ms.  What holds it above them is
// issue: pass 2's instructions around the exponentials (the walk's ten
// products and sums a state, the forward run again, the sums over lanes and
// channels); on an H100 SXM it takes 0.20 of the call's 0.24 ms there, pass 1
// 0.03 (its exponentials), the three sums 0.013.
#include "tile.cuh"

namespace {

constexpr int LANES = 4;              // threads per channel
constexpr int CH = 64;                // channels per block
constexpr int NT = CH * LANES;        // threads per block
constexpr int TS = 32;                // sequence steps per tile
constexpr int RS = 16;                // steps per reduce-scatter of the y shares
constexpr int U = 16;                 // steps between checkpoints; a group of the backward
constexpr int L1 = 64;                // steps of a chunk of the backward's summaries
constexpr int BWD_BLOCKS = 2;         // blocks of the backward's second pass an SM
constexpr int NW = NT / 32;           // warps a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One cp.async of BYTES (4, 8 or 16), zeros when !ok (src must stay valid).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    repro::cp_async16(dst, src, ok ? 16 : 0);
  else
    repro::cp_async_ca<BYTES>(dst, src, ok);
}

// Copies a [ROWS][CH] tile of a row-major [rows][Din] array (rows from row0,
// channels from d0) into shared memory: 16-byte cp.async where the chunk is
// whole and aligned, zeros past `steps` rows or Din, element by element on a
// ragged or unaligned Din.
template <typename T, int ROWS = TS>
__device__ __forceinline__ void load_cols(T* dst, const T* __restrict__ src, size_t row0,
                                          int steps, int d0, int Din, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = CH / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int j = i / CPR, c = (i % CPR) * VEC, d = d0 + c;
    T* out = dst + j * CH + c;
    const bool row_ok = j < steps;
    if (vec && (d + VEC <= Din || d >= Din || !row_ok)) {
      const bool ok = row_ok && d < Din;
      repro::cp_async16(out, ok ? src + (row0 + j) * Din + d : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out[e] = row_ok && d + e < Din ? src[(row0 + j) * Din + d + e]
                                       : repro::from_float<T>(0.f);
    }
  }
}

// Stores a [steps][CH] tile from shared memory into a row-major [rows][Din]
// array, in 16-byte stores where the chunk is whole and aligned.
template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ dst, const T* src, size_t row0,
                                           int steps, int d0, int Din, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = CH / VEC;
  for (int i = threadIdx.x; i < steps * CPR; i += NT) {
    const int j = i / CPR, cc = (i % CPR) * VEC, dc = d0 + cc;
    const size_t off = (row0 + j) * Din + dc;
    if (vec && dc + VEC <= Din) {
      *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(src + j * CH + cc);
    } else {
      for (int e = 0; e < VEC && dc + e < Din; ++e) dst[off + e] = src[j * CH + cc + e];
    }
  }
}

// Copies Bm and Cm of `steps` steps from row0 (zeros past them) into
// [step][lane][Bm, Cm][N / 4]: a lane's Bm and Cm of a step side by side.
// Thread i < 2 TS LANES copies one lane's Bm (first half) or Cm of one step.
template <typename T, int N>
__device__ __forceinline__ void load_bc(T* dst, const T* __restrict__ Bm,
                                        const T* __restrict__ Cm, size_t row0, int steps) {
  constexpr int SPL = N / LANES, CHUNK = SPL * (int)sizeof(T);
  static_assert(2 * TS * LANES <= NT, "a thread copies at most one lane's Bm or Cm of a step");
  const int tid = threadIdx.x;
  if (tid < 2 * TS * LANES) {
    const int which = tid / (TS * LANES), i = tid % (TS * LANES), j = i / LANES, l = i % LANES;
    const bool ok = j < steps;
    const T* src = (which ? Cm : Bm) + (ok ? (row0 + j) * N + l * SPL : 0);
    copy_async<CHUNK>(&dst[(i * 2 + which) * SPL], src, ok);
  }
}

// A lane's Bm and Cm of one step, widened to fp32 (bf16 by shifts, one load).
template <typename T, int SPL>
__device__ __forceinline__ void read_bc(const T* bcj, float (&bv)[SPL], float (&cv)[SPL]) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[SPL];
    if constexpr (SPL == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(bcj);
      r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(bcj);
      r[0] = q.x, r[1] = q.y;
    }
#pragma unroll
    for (int s = 0; s < SPL / 2; ++s) {
      bv[2 * s] = __uint_as_float(r[s] << 16);
      bv[2 * s + 1] = __uint_as_float(r[s] & 0xffff0000u);
      cv[2 * s] = __uint_as_float(r[SPL / 2 + s] << 16);
      cv[2 * s + 1] = __uint_as_float(r[SPL / 2 + s] & 0xffff0000u);
    }
  } else if constexpr (SPL == 4) {
    const float4 qb = *reinterpret_cast<const float4*>(bcj);
    const float4 qc = *reinterpret_cast<const float4*>(bcj + 4);
    bv[0] = qb.x, bv[1] = qb.y, bv[2] = qb.z, bv[3] = qb.w;
    cv[0] = qc.x, cv[1] = qc.y, cv[2] = qc.z, cv[3] = qc.w;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(bcj);
    bv[0] = q.x, bv[1] = q.y, cv[0] = q.z, cv[1] = q.w;
  }
}

// Reduce-scatter over the four lanes of a channel of K per-step shares (K a
// multiple of 4): after it lane ln holds the sums of steps 4 m + ln, (lane 0
// + lane 1) + (lane 2 + lane 3).
template <int K>
__device__ __forceinline__ void lane_scatter(const float (&part)[K], float (&z)[K / 4], int ln) {
  const bool b0 = ln & 1, b1 = ln & 2;
  float w[K / 2];
#pragma unroll
  for (int k = 0; k < K / 2; ++k) {
    const float keep = b0 ? part[2 * k + 1] : part[2 * k];
    const float send = b0 ? part[2 * k] : part[2 * k + 1];
    w[k] = keep + __shfl_xor_sync(FULL, send, 1);
  }
#pragma unroll
  for (int m = 0; m < K / 4; ++m) {
    const float keep = b1 ? w[2 * m + 1] : w[2 * m];
    const float send = b1 ? w[2 * m] : w[2 * m + 1];
    z[m] = keep + __shfl_xor_sync(FULL, send, 2);
  }
}

// CKPT: write the state entering each tile to ckpt (training); the serve
// path's build has no checkpoint code at all
template <typename T, int N, bool CKPT>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ Dv, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hT, float* __restrict__ ckpt, int S, int Din) {
  constexpr int SPL = N / LANES;                // states per lane
  static_assert(LANES == 4 && RS % 4 == 0 && TS % RS == 0, "the reduce-scatter is over 4 lanes");
  __shared__ __align__(16) T xs[2][TS * CH];
  __shared__ __align__(16) float ds[2][TS * CH];
  // [stage][step][lane][Bm, Cm][SPL]: a lane's Bm and Cm of a step side by side
  __shared__ __align__(16) T bc[2][TS * LANES * 2 * SPL];
  __shared__ __align__(16) T ys[TS * CH];

  const int b = blockIdx.y, d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int c = tid / LANES, ln = tid % LANES, d = d0 + c, n0 = ln * SPL;
  const bool live = d < Din;
  const bool vec_x = Din % (16 / sizeof(T)) == 0, vec_d = Din % 4 == 0;
  const size_t row = (size_t)b * S;  // first step of this batch row
  const int n_tiles = (S + TS - 1) / TS;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a2[s] = live ? A[(size_t)d * N + n0 + s] * LOG2E : 0.f;
    h[s] = (live && h0 != nullptr) ? h0[((size_t)b * Din + d) * N + n0 + s] : 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;

  // x, delta, Bm and Cm of tile t into stage t % 2, all by cp.async
  auto load_tile = [&](int t) {
    const int stage = t & 1, steps = min(TS, S - t * TS);
    load_cols<T>(xs[stage], x, row + t * TS, steps, d0, Din, vec_x);
    load_cols<float>(ds[stage], delta, row + t * TS, steps, d0, Din, vec_d);
    load_bc<T, N>(bc[stage], Bm, Cm, row + t * TS, steps);
    repro::cp_async_commit();
  };

  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int n_ck = (S + U - 1) / U;
    repro::cp_async_wait<0>();
    __syncthreads();  // tile t is in place; ys and the other stage are free
    if (t + 1 < n_tiles) load_tile(t + 1);
    const T* xt = xs[st];
    const float* dtt = ds[st];
#pragma unroll
    for (int g0 = 0; g0 < TS; g0 += RS) {
      if (CKPT && live && t * TS + g0 < S) {  // the state entering every U = RS steps
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          ckpt[(((size_t)b * n_ck + (t * TS + g0) / U) * Din + d) * N + n0 + s] = h[s];
      }
      float part[RS];  // the lane's share of y_t for the RS steps of this group
#pragma unroll
      for (int jj = 0; jj < RS; ++jj) {
        const int j = g0 + jj;
        const float dt = dtt[j * CH + c], dx = dt * repro::to_float(xt[j * CH + c]);
        float bv[SPL], cv[SPL];
        read_bc<T, SPL>(&bc[st][(j * LANES + ln) * 2 * SPL], bv, cv);
#pragma unroll
        for (int s = 0; s < SPL; ++s) h[s] = fmaf(ex2(dt * a2[s]), h[s], dx * bv[s]);
        // the lane's share as a tree: pairs of states by fma, then the pairs
        float p[SPL / 2];
#pragma unroll
        for (int s = 0; s < SPL / 2; ++s)
          p[s] = fmaf(h[2 * s + 1], cv[2 * s + 1], h[2 * s] * cv[2 * s]);
#pragma unroll
        for (int w = 1; w < SPL / 2; w *= 2)
#pragma unroll
          for (int s = 0; s < SPL / 2; s += 2 * w) p[s] += p[s + w];
        part[jj] = p[0];
      }
      // after the reduce-scatter lane ln holds y_t of the steps t = g0 + 4 m + ln
      float z[RS / 4];
      lane_scatter(part, z, ln);
#pragma unroll
      for (int m = 0; m < RS / 4; ++m) {
        const int j = g0 + 4 * m + ln;
        ys[j * CH + c] = repro::from_float<T>(fmaf(repro::to_float(xt[j * CH + c]), dd, z[m]));
      }
    }
    __syncthreads();  // ys is whole
    store_cols<T>(y, ys, row + t * TS, min(TS, S - t * TS), d0, Din, vec_x);
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) hT[((size_t)b * Din + d) * N + n0 + s] = h[s];
  }
}

// SPL values in shared memory (a lane's of a [*, N] row), widened to fp32
// (bf16 by shifts; one aligned load).
template <typename T, int SPL>
__device__ __forceinline__ void read_row(const T* p, float (&v)[SPL]) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[SPL / 2];
    if constexpr (SPL == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      r[0] = q.x, r[1] = q.y;
    } else {
      r[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int s = 0; s < SPL / 2; ++s) {
      v[2 * s] = __uint_as_float(r[s] << 16);
      v[2 * s + 1] = __uint_as_float(r[s] & 0xffff0000u);
    }
  } else if constexpr (SPL == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

// Pass 1: the summary of summary chunk f0 + blockIdx.y (L1 steps) of row
// blockIdx.z, for the block's channels: walked back from a zero carry, the
// a g it reaches at the chunk's first step and the product of its a_t, fp32
// [B, ceil(S / L1), Din, N] each.  Steps past S are zero-filled: delta = 0
// gives a = 1 and dy = 0 adds nothing, so every chunk runs L1 steps.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
mamba_bwd_pass1_kernel(const float* __restrict__ delta, const float* __restrict__ A,
                       const T* __restrict__ Cm, const T* __restrict__ dy,
                       float* __restrict__ sum_ga, float* __restrict__ sum_a, int S, int Din,
                       int f0) {
  constexpr int SPL = N / LANES, VEC = 16 / sizeof(T);
  __shared__ __align__(16) float ds[L1 * CH];
  __shared__ __align__(16) T dys[L1 * CH];
  __shared__ __align__(16) T cms[L1 * N];
  const int f = f0 + blockIdx.y, b = blockIdx.z, nF = (S + L1 - 1) / L1;
  const int d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int c = tid / LANES, ln = tid % LANES, d = d0 + c, n0 = ln * SPL;
  const bool live = d < Din;
  const size_t row0 = (size_t)b * S + (size_t)f * L1;
  const int steps = min(L1, S - f * L1);
  load_cols<float, L1>(ds, delta, row0, steps, d0, Din, Din % 4 == 0);
  load_cols<T, L1>(dys, dy, row0, steps, d0, Din, Din % VEC == 0);
  for (int i = tid; i < L1 * N / VEC; i += NT) {  // Cm's rows, 16 bytes at a time
    const bool ok = i * VEC / N < steps;
    repro::cp_async16(&cms[i * VEC], ok ? Cm + row0 * N + i * VEC : Cm, ok ? 16 : 0);
  }
  repro::cp_async_commit();
  float a2[SPL], ga[SPL], pr[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a2[s] = live ? A[(size_t)d * N + n0 + s] * LOG2E : 0.f;
    ga[s] = 0.f;
    pr[s] = 1.f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll 4
  for (int j = L1 - 1; j >= 0; --j) {
    const float dt = ds[j * CH + c], gy = repro::to_float(dys[j * CH + c]);
    float cv[SPL];
    read_row<T, SPL>(&cms[j * N + n0], cv);
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const float a = ex2(dt * a2[s]);
      ga[s] = a * fmaf(cv[s], gy, ga[s]);
      pr[s] *= a;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const size_t o = (((size_t)b * nF + f) * Din + d) * N + n0 + s;
      sum_ga[o] = ga[s];
      sum_a[o] = pr[s];
    }
  }
}

// Shared memory of pass 2, in bytes.  Two stages of a group's tiles (x, dy in
// T; delta fp32; Bm and Cm widened to fp32 as [step][lane][Bm, Cm][SPL]; the
// checkpoint it starts from, [CH][N] fp32); the dx (T) and ddelta (fp32)
// tiles; the warps' sums of dBm and dCm of a group, [U][NW][2][N].
template <typename T, int N>
struct Bwd {
  static constexpr int SPL = N / LANES, V = 2 * SPL, R = 2 * N;
  static constexpr int TILE_T = U * CH * (int)sizeof(T), TILE_F = U * CH * 4, BCF = U * R * 4;
  static constexpr int XS = 0, DYS = TILE_T, DS = 2 * TILE_T, BC = DS + TILE_F;
  static constexpr int CK = BC + BCF, STAGE = CK + CH * N * 4;
  static constexpr int DXS = 2 * STAGE, DDS = DXS + TILE_T, RED = DDS + TILE_F;
  static constexpr int SMEM = RED + U * NW * R * 4;
};

// The sum over a warp's 8 channels (lane bits 2-4) of V = 4 or 8 shares a
// lane: a reduce-scatter, after which the lane holds share (lane / 4 % 8) /
// (8 / V), summed; with V = 4 the two lanes of a pair of channels hold the same.
template <int V>
__device__ __forceinline__ float channel_sum(float (&v)[V], int lane) {
  static_assert(V == 4 || V == 8, "4 or 8 shares a lane");
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const bool hi = lane & 16;
    const float keep = hi ? v[V / 2 + k] : v[k], send = hi ? v[k] : v[V / 2 + k];
    v[k] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const bool hi = lane & 8;
    const float keep = hi ? v[V / 4 + k] : v[k], send = hi ? v[k] : v[V / 4 + k];
    v[k] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  if constexpr (V == 8) {
    const bool hi = lane & 4;
    const float keep = hi ? v[1] : v[0], send = hi ? v[0] : v[1];
    return keep + __shfl_xor_sync(FULL, send, 4);
  } else {
    return v[0] + __shfl_xor_sync(FULL, v[0], 4);
  }
}

// Pass 2: chunk blockIdx.y (L2 steps) of row blockIdx.z from its true carry.
template <typename T, int N>
__global__ void __launch_bounds__(NT, BWD_BLOCKS)
mamba_bwd_pass2_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, const float* __restrict__ Dv,
                       const T* __restrict__ dy, const float* __restrict__ dhT,
                       const float* __restrict__ ckpt, const float* __restrict__ sum_ga,
                       const float* __restrict__ sum_a, T* __restrict__ dx,
                       float* __restrict__ ddelta, float* __restrict__ part_bc,
                       float* __restrict__ part_a, float* __restrict__ part_d,
                       float* __restrict__ dh0, int S, int Din, int L2) {
  using L = Bwd<T, N>;
  constexpr int SPL = L::SPL, V = L::V, R = L::R;
  extern __shared__ __align__(16) uint8_t smem[];
  T* dxs = reinterpret_cast<T*>(smem + L::DXS);
  float* dds = reinterpret_cast<float*>(smem + L::DDS);
  float* red = reinterpret_cast<float*>(smem + L::RED);  // [U][NW][Bm, Cm][N]

  const int k = blockIdx.y, nC = gridDim.y, b = blockIdx.z, nB = gridDim.z;
  const int d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int c = tid / LANES, ln = tid % LANES, d = d0 + c, n0 = ln * SPL;
  const int lane = tid % 32, warp = tid / 32;
  const bool live = d < Din;
  const bool vec_x = Din % (16 / sizeof(T)) == 0, vec_d = Din % 4 == 0;
  const size_t row = (size_t)b * S;
  const int n_ck = (S + U - 1) / U, nF = (S + L1 - 1) / L1;
  const int t_begin = k * L2, t_end = min(S, t_begin + L2);
  const int q_lo = t_begin / U, q_hi = (t_end - 1) / U;

  // a group's tiles into stage q & 1 by cp.async; Bm and Cm into registers
  // (a thread below U 2 LANES takes one lane's SPL of one step), widened into
  // the stage by put_bc when the stage is free
  auto stage_ptr = [&](int q, int off) { return smem + (q & 1) * L::STAGE + off; };
  auto issue = [&](int q) {
    const int steps = min(U, S - q * U);
    load_cols<T, U>(reinterpret_cast<T*>(stage_ptr(q, L::XS)), x, row + q * U, steps, d0, Din,
                    vec_x);
    load_cols<T, U>(reinterpret_cast<T*>(stage_ptr(q, L::DYS)), dy, row + q * U, steps, d0, Din,
                    vec_x);
    load_cols<float, U>(reinterpret_cast<float*>(stage_ptr(q, L::DS)), delta, row + q * U, steps,
                        d0, Din, vec_d);
    static_assert(CH * N / 4 <= NT, "a thread copies at most 16 bytes of a checkpoint");
    if (tid < CH * N / 4) {  // the states entering the group, [CH][N]
      const bool ok = d0 + tid * 4 / N < Din;
      const float* src = ckpt + (((size_t)b * n_ck + q) * Din + d0) * N + tid * 4;
      repro::cp_async16(stage_ptr(q, L::CK + tid * 16), ok ? src : ckpt, ok ? 16 : 0);
    }
    repro::cp_async_commit();
  };
  static_assert(U * 2 * LANES <= NT, "a thread takes at most one lane's Bm or Cm of a step");
  T bcr[SPL];
  auto get_bc = [&](int q) {
    if (tid < U * 2 * LANES) {
      const int u = tid / (2 * LANES), l = tid / 2 % LANES, which = tid % 2;
      const bool ok = q * U + u < S;
      const T* src = (which ? Cm : Bm) + (row + q * U + u) * N + l * SPL;
#pragma unroll
      for (int s = 0; s < SPL; ++s) bcr[s] = ok ? src[s] : repro::from_float<T>(0.f);
    }
  };
  auto put_bc = [&](int q) {
    if (tid < U * 2 * LANES) {
      float* dst = reinterpret_cast<float*>(stage_ptr(q, L::BC)) + tid * SPL;
#pragma unroll
      for (int s = 0; s < SPL; ++s) dst[s] = repro::to_float(bcr[s]);
    }
  };

  float af[SPL], a2[SPL], ga[SPL], da[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    af[s] = live ? A[(size_t)d * N + n0 + s] : 0.f;
    a2[s] = af[s] * LOG2E;
    ga[s] = (live && dhT != nullptr) ? dhT[((size_t)b * Din + d) * N + n0 + s] : 0.f;
    da[s] = 0.f;
  }
  issue(q_hi);
  get_bc(q_hi);
  put_bc(q_hi);
  // the true carry: the summaries to the right, from the last (dhT folded in first)
  for (int f = nF - 1; f >= (k + 1) * (L2 / L1); --f) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const size_t o = (((size_t)b * nF + f) * Din + d) * N + n0 + s;
      if (live) ga[s] = fmaf(sum_a[o], ga[s], sum_ga[o]);
    }
  }
  const float dd = live ? Dv[d] : 0.f;
  float dD = 0.f;

  for (int q = q_hi; q >= q_lo; --q) {
    repro::cp_async_wait<0>();
    __syncthreads();  // group q is in place; group q + 1's buffers are free
    if (q > q_lo) {   // group q - 1 arrives under this one
      issue(q - 1);
      get_bc(q - 1);
    }
    const T* xs = reinterpret_cast<const T*>(stage_ptr(q, L::XS));
    const T* dys = reinterpret_cast<const T*>(stage_ptr(q, L::DYS));
    const float* ds = reinterpret_cast<const float*>(stage_ptr(q, L::DS));
    const float* bcf = reinterpret_cast<const float*>(stage_ptr(q, L::BC));

    // the forward's states of the group, from its checkpoint
    float hin[SPL], hs[U][SPL];
    read_row<float, SPL>(reinterpret_cast<const float*>(stage_ptr(q, L::CK)) + c * N + n0, hin);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dt = ds[u * CH + c], dxv = dt * repro::to_float(xs[u * CH + c]);
      float bv[SPL];
      read_row<float, SPL>(&bcf[((u * LANES + ln) * 2) * SPL], bv);
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        hs[u][s] = fmaf(ex2(dt * a2[s]), u ? hs[u - 1][s] : hin[s], dxv * bv[s]);
    }

    // the walk back, four steps at a time (one reduce-scatter over the lanes)
#pragma unroll
    for (int j0 = U - 4; j0 >= 0; j0 -= 4) {
      float px[4], pd[4];  // the lane's shares of sum_n g Bm and of sum_n g A a h, per step
#pragma unroll
      for (int uu = 3; uu >= 0; --uu) {
        const int u = j0 + uu;
        const float dt = ds[u * CH + c], xv = repro::to_float(xs[u * CH + c]);
        const float gy = repro::to_float(dys[u * CH + c]), dxv = dt * xv;
        float bv[SPL], cv[SPL], v[V];
        read_row<float, SPL>(&bcf[((u * LANES + ln) * 2) * SPL], bv);
        read_row<float, SPL>(&bcf[((u * LANES + ln) * 2 + 1) * SPL], cv);
        float sx = 0.f, sd = 0.f;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const float g = fmaf(cv[s], gy, ga[s]);
          const float a = ex2(dt * a2[s]);  // again: kept, a_t would take 1 block an SM, not 2
          const float p = g * (a * (u ? hs[u - 1][s] : hin[s]));  // g a_t h_{t-1}
          sx = fmaf(g, bv[s], sx);
          sd = fmaf(p, af[s], sd);
          da[s] = fmaf(p, dt, da[s]);
          v[s] = g * dxv;              // this channel's share of dBm_t
          v[SPL + s] = gy * hs[u][s];  // and of dCm_t
          ga[s] = a * g;
        }
        px[uu] = sx;
        pd[uu] = sd;
        dD = fmaf(gy, xv, dD);
        const float w = channel_sum<V>(v, lane);  // dBm_t, dCm_t over the warp's channels
        const int share = (lane >> 2 & 7) / (8 / V);
        if ((lane >> 2 & 7) % (8 / V) == 0)
          red[((u * NW + warp) * 2 + share / SPL) * N + ln * SPL + share % SPL] = w;
      }
      // lane ln: sum_n g Bm and sum_n g A a h of step j0 + ln, over the lanes
      float zx[1], zd[1];
      lane_scatter(px, zx, ln);
      lane_scatter(pd, zd, ln);
      const int j = j0 + ln;
      const float dtj = ds[j * CH + c], xj = repro::to_float(xs[j * CH + c]);
      dxs[j * CH + c] =
          repro::from_float<T>(fmaf(dtj, zx[0], dd * repro::to_float(dys[j * CH + c])));
      dds[j * CH + c] = fmaf(xj, zx[0], zd[0]);  // x_t sum_n g Bm + sum_n g A a h
    }
    if (q > q_lo) put_bc(q - 1);  // stage (q - 1) & 1 was last read in group q + 1
    __syncthreads();  // red, dxs and dds are whole
    for (int i = tid; i < U * R; i += NT) {  // the block's sums over its warps, in order
      const int u = i / R, o = i % R, t = q * U + u;
      float sum = red[u * NW * R + o];
#pragma unroll
      for (int w = 1; w < NW; ++w) sum += red[(u * NW + w) * R + o];
      if (t < S)  // [block][Bm, Cm][B][S][N]
        part_bc[(((size_t)blockIdx.x * 2 + o / N) * nB + b) * S * N + (size_t)t * N + o % N] =
            sum;
    }
    const int steps = min(U, S - q * U);
    store_cols<T>(dx, dxs, row + q * U, steps, d0, Din, vec_x);
    store_cols<float>(ddelta, dds, row + q * U, steps, d0, Din, vec_d);
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      part_a[(((size_t)b * nC + k) * Din + d) * N + n0 + s] = da[s];
      if (k == 0) dh0[((size_t)b * Din + d) * N + n0 + s] = ga[s];
    }
    if (ln == 0) part_d[((size_t)b * nC + k) * Din + d] = dD;
  }
}

// out[m] = sum over k < K of part[k][m], k in order: the backward's partials
// summed over blocks or (row, chunk)s, the same way every run.  Eight loads
// are issued before their adds.
template <typename To>
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ part, To* __restrict__ out, int K, long long M) {
  const long long m = (long long)blockIdx.x * 256 + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  int k = 0;
  for (; k + 8 <= K; k += 8) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = part[(size_t)(k + e) * M + m];
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  for (; k < K; ++k) s += part[(size_t)k * M + m];
  out[m] = repro::from_float<To>(s);
}

template <typename To>
cudaError_t sum_rows(const float* part, void* out, int K, long long M, cudaStream_t stream) {
  sum_rows_kernel<To><<<(unsigned)((M + 255) / 256), 256, 0, stream>>>(
      part, static_cast<To*>(out), K, M);
  return cudaGetLastError();
}

// fp32 floats of the backward's scratch, in this order: the dBm/dCm
// partials [ceil(Din / CH)][2][B][S][N], the dA partials [B][nC][Din][N], the
// dD partials [B][nC][Din], the summaries (a g, then the product of a_t)
// [B][ceil(S / L1)][Din][N] each; nC = ceil(S / L2).
long long bwd_scratch(int B, int S, int Din, int N, int L2) {
  const long long blocks = (Din + CH - 1) / CH, nC = (S + L2 - 1) / L2, nF = (S + L1 - 1) / L1;
  return blocks * 2 * B * S * N + (long long)B * nC * Din * (N + 1) + 2LL * B * nF * Din * N;
}

template <typename T, int N>
cudaError_t launch_bwd(const void* x, const float* delta, const float* A, const void* Bm,
                       const void* Cm, const float* Dv, const void* dy, const float* dhT,
                       const float* ckpt, void* dx, float* ddelta, float* dA, void* dbc,
                       float* dD, float* dh0, float* scratch, int B, int S, int Din, int L2,
                       cudaStream_t stream) {
  using L = Bwd<T, N>;
  const int blocks = (Din + CH - 1) / CH, nC = (S + L2 - 1) / L2, nF = (S + L1 - 1) / L1;
  float* part_bc = scratch;
  float* part_a = part_bc + (size_t)blocks * 2 * B * S * N;
  float* part_d = part_a + (size_t)B * nC * Din * N;
  float* sum_ga = part_d + (size_t)B * nC * Din;
  float* sum_a = sum_ga + (size_t)B * nF * Din * N;
  const T *xt = static_cast<const T*>(x), *dyt = static_cast<const T*>(dy);
  const T *bt = static_cast<const T*>(Bm), *ct = static_cast<const T*>(Cm);
  const int f0 = L2 / L1;  // the summary chunks right of chunk 0's end
  if (nF > f0) {
    mamba_bwd_pass1_kernel<T, N><<<dim3(blocks, nF - f0, B), NT, 0, stream>>>(
        delta, A, ct, dyt, sum_ga, sum_a, S, Din, f0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(mamba_bwd_pass2_kernel<T, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  mamba_bwd_pass2_kernel<T, N><<<dim3(blocks, nC, B), NT, L::SMEM, stream>>>(
      xt, delta, A, bt, ct, Dv, dyt, dhT, ckpt, sum_ga, sum_a, static_cast<T*>(dx), ddelta,
      part_bc, part_a, part_d, dh0, S, Din, L2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = sum_rows<T>(part_bc, dbc, blocks, 2LL * B * S * N, stream);  // dBm, dCm over blocks
  if (e != cudaSuccess) return e;
  e = sum_rows<float>(part_a, dA, B * nC, (long long)Din * N, stream);  // dA over (row, chunk)
  if (e != cudaSuccess) return e;
  return sum_rows<float>(part_d, dD, B * nC, Din, stream);              // dD over (row, chunk)
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* delta, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, const float* h0, void* y, float* hT,
                   float* ckpt, int B, int S, int Din, cudaStream_t stream) {
  const dim3 grid((Din + CH - 1) / CH, B);
  auto kernel = ckpt != nullptr ? mamba_scan_kernel<T, N, true> : mamba_scan_kernel<T, N, false>;
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), delta, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dv, h0, static_cast<T*>(y), hT, ckpt, S, Din);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y).  h0 may be null; ckpt
// may be null (no checkpoints).  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously.
extern "C" int repro_mamba_scan(const void* x, const void* delta, const void* A, const void* Bm,
                                const void* Cm, const void* Dv, const void* h0, void* y, void* hT,
                                void* ckpt, int dtype, int B, int S, int Din, int N,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  const float* a = static_cast<const float*>(A);
  const float* dv = static_cast<const float*>(Dv);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  float* ck = static_cast<float*>(ckpt);
#define REPRO_MS_ARGS x, dl, a, Bm, Cm, dv, h, y, ht, ck, B, S, Din, st
  if (dtype == 0 && N == 8) return launch<float, 8>(REPRO_MS_ARGS);
  if (dtype == 0 && N == 16) return launch<float, 16>(REPRO_MS_ARGS);
  if (dtype == 1 && N == 8) return launch<__nv_bfloat16, 8>(REPRO_MS_ARGS);
  if (dtype == 1 && N == 16) return launch<__nv_bfloat16, 16>(REPRO_MS_ARGS);
#undef REPRO_MS_ARGS
  return cudaErrorInvalidValue;
}

// The backward.  dy, dx, dbc ([2][B][S][N]: dBm then dCm) in x's type; dhT
// may be null (zeros); ckpt from the forward, the state entering every U
// steps.  `chunk` (a positive multiple of L1) is the steps of a chunk of the
// second pass; scratch is fp32 of exactly bwd_scratch(B, S, Din, N, chunk)
// floats, `scratch_floats` (cudaErrorInvalidValue otherwise, so a caller that
// sized it for another layout cannot be written past).  Returns the first
// cudaError_t of the five launches (0 on success); they run asynchronously,
// in order, on `stream`.
extern "C" int repro_mamba_scan_bwd(const void* x, const void* delta, const void* A,
                                    const void* Bm, const void* Cm, const void* Dv,
                                    const void* dy, const void* dhT, const void* ckpt, void* dx,
                                    void* ddelta, void* dA, void* dbc, void* dD, void* dh0,
                                    void* scratch, long long scratch_floats, int dtype, int B,
                                    int S, int Din, int N, int chunk, void* stream) {
  if (chunk <= 0 || chunk % L1 != 0 || (N != 8 && N != 16) ||
      scratch_floats != bwd_scratch(B, S, Din, N, chunk))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MSB_ARGS x, static_cast<const float*>(delta), static_cast<const float*>(A), Bm, Cm, \
    static_cast<const float*>(Dv), dy, static_cast<const float*>(dhT),                          \
    static_cast<const float*>(ckpt), dx, static_cast<float*>(ddelta), static_cast<float*>(dA),  \
    dbc, static_cast<float*>(dD), static_cast<float*>(dh0), static_cast<float*>(scratch), B, S, \
    Din, chunk, st
  if (dtype == 0 && N == 8) return launch_bwd<float, 8>(REPRO_MSB_ARGS);
  if (dtype == 0 && N == 16) return launch_bwd<float, 16>(REPRO_MSB_ARGS);
  if (dtype == 1 && N == 8) return launch_bwd<__nv_bfloat16, 8>(REPRO_MSB_ARGS);
  if (dtype == 1 && N == 16) return launch_bwd<__nv_bfloat16, 16>(REPRO_MSB_ARGS);
#undef REPRO_MSB_ARGS
  return cudaErrorInvalidValue;
}

// The layout the backward's scratch is sized by: channels a block (CH), steps
// between checkpoints (U), steps of a summary chunk (L1).
extern "C" int repro_mamba_scan_bwd_layout(int which) {
  return which == 0 ? CH : which == 1 ? U : L1;
}
