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
// With `ckpt` non-null the forward also writes the state entering every tile,
// [B, ceil(S / TS), Din, N] fp32: where the backward starts each tile from.
//
// The backward (repro_mamba_scan_bwd, no TPU kernel: the JAX package
// differentiates its XLA reference) is the reverse scan of the same
// recurrence, in the same layout of four lanes a channel.  With g_t the
// gradient of h_t:
//   g_t = Cm_t dy_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT),
//   dx_t = delta_t sum_n g_t Bm_t + D dy_t,
//   ddelta_t = sum_n g_t (x_t Bm_t + A a_t h_{t-1}),  dA = sum_{b,t} g_t delta_t a_t h_{t-1},
//   dBm_t = sum_d g_t delta_t x_t,  dCm_t = sum_d dy_t h_t,  dD = sum_{b,t} dy_t x_t,
//   dh0 = a_0 g_0.
// A block walks its tiles from the last to the first.  A tile's states are
// recomputed from its checkpoint in two halves of U = 16 steps: the lane runs
// the first half to get the state entering the second, then, for each half
// from the last, runs it again keeping its U x N/4 states in registers and
// walks it backwards.  Nothing divides by a decay (exp(delta A) underflows
// to 0 over a tile at falcon-mamba's decays).  The sums over the four lanes
// (dx, ddelta) are the forward's reduce-scatter; the sums over channels
// (dBm, dCm) are a reduce-scatter over the warp's 8 channels, then a sum
// over the block's 8 warps in shared memory, into per-block fp32 partials;
// dA and dD go out per batch row.  A second kernel of this library sums the
// partials over blocks and rows in a fixed order, so, with no atomics, two
// runs give the same bits.  What bounds it: the exponentials, three per
// (b, t, d, n) (the first half's extra run, the run that keeps the states,
// the walk back), 1.6 G at falcon-mamba-7b's shape, ~0.39 ms at the SFU's
// rate; the bytes it moves (x, delta, dy, Bm, Cm and the checkpoints in,
// dx and ddelta out) take ~0.17 ms.
#include "tile.cuh"

namespace {

constexpr int LANES = 4;              // threads per channel
constexpr int CH = 64;                // channels per block
constexpr int NT = CH * LANES;        // threads per block
constexpr int TS = 32;                // sequence steps per tile
constexpr int RS = 16;                // steps per reduce-scatter of the y shares
constexpr int U = 16;                 // steps the backward keeps in registers
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

// Copies a [TS][CH] tile of a row-major [rows][Din] array (rows from row0,
// channels from d0) into shared memory: 16-byte cp.async where the chunk is
// whole and aligned, zeros past `steps` rows or Din, element by element on a
// ragged or unaligned Din.
template <typename T>
__device__ __forceinline__ void load_cols(T* dst, const T* __restrict__ src, size_t row0,
                                          int steps, int d0, int Din, bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPR = CH / VEC;
  for (int i = threadIdx.x; i < TS * CPR; i += NT) {
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

// Reduce-scatter over the four lanes of a channel of RS = 16 per-step
// shares: after it lane ln holds the sums of steps 4 m + ln, (lane 0 +
// lane 1) + (lane 2 + lane 3).
__device__ __forceinline__ void lane_scatter(const float (&part)[RS], float (&z)[RS / 4], int ln) {
  const bool b0 = ln & 1, b1 = ln & 2;
  float w[RS / 2];
#pragma unroll
  for (int k = 0; k < RS / 2; ++k) {
    const float keep = b0 ? part[2 * k + 1] : part[2 * k];
    const float send = b0 ? part[2 * k] : part[2 * k + 1];
    w[k] = keep + __shfl_xor_sync(FULL, send, 1);
  }
#pragma unroll
  for (int m = 0; m < RS / 4; ++m) {
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
    if (CKPT && live) {  // the state entering the tile
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        ckpt[(((size_t)b * n_tiles + t) * Din + d) * N + n0 + s] = h[s];
    }
    repro::cp_async_wait<0>();
    __syncthreads();  // tile t is in place; ys and the other stage are free
    if (t + 1 < n_tiles) load_tile(t + 1);
    const T* xt = xs[st];
    const float* dtt = ds[st];
#pragma unroll
    for (int g0 = 0; g0 < TS; g0 += RS) {
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

// Shared memory of the backward, in bytes: x, dy, dx tiles in T; delta,
// ddelta tiles in fp32; Bm/Cm of a tile; the warps' dBm/dCm sums of U steps.
template <typename T, int N>
struct Bwd {
  static constexpr int TILE_T = TS * CH * (int)sizeof(T), TILE_F = TS * CH * 4;
  static constexpr int XS = 0, DYS = XS + TILE_T, DXS = DYS + TILE_T, DS = DXS + TILE_T;
  static constexpr int DDS = DS + TILE_F, BC = DDS + TILE_F;
  static constexpr int RED = BC + TS * 2 * N * (int)sizeof(T);
  static constexpr int SMEM = RED + U * NW * 2 * N * 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
mamba_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dv,
                      const T* __restrict__ dy, const float* __restrict__ dhT,
                      const float* __restrict__ ckpt, T* __restrict__ dx,
                      float* __restrict__ ddelta, float* __restrict__ part_bc,
                      float* __restrict__ part_a, float* __restrict__ part_d,
                      float* __restrict__ dh0, int S, int Din) {
  using L = Bwd<T, N>;
  constexpr int SPL = N / LANES;
  static_assert(TS == 2 * U && U == RS, "a tile is two halves of one reduce-scatter each");
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem + L::XS);
  T* dys = reinterpret_cast<T*>(smem + L::DYS);
  T* dxs = reinterpret_cast<T*>(smem + L::DXS);
  float* ds = reinterpret_cast<float*>(smem + L::DS);
  float* dds = reinterpret_cast<float*>(smem + L::DDS);
  T* bc = reinterpret_cast<T*>(smem + L::BC);
  float* red = reinterpret_cast<float*>(smem + L::RED);  // [U][NW][Bm, Cm][N]

  const int b = blockIdx.y, d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int c = tid / LANES, ln = tid % LANES, d = d0 + c, n0 = ln * SPL;
  const int lane = tid % 32, warp = tid / 32;
  const bool live = d < Din;
  const bool vec_x = Din % (16 / sizeof(T)) == 0, vec_d = Din % 4 == 0;
  const size_t row = (size_t)b * S;
  const int n_tiles = (S + TS - 1) / TS;

  float af[SPL], a2[SPL], ga[SPL], da[SPL];  // ga: a_{t+1} g_{t+1}
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    af[s] = live ? A[(size_t)d * N + n0 + s] : 0.f;
    a2[s] = af[s] * LOG2E;
    ga[s] = (live && dhT != nullptr) ? dhT[((size_t)b * Din + d) * N + n0 + s] : 0.f;
    da[s] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;
  float dD = 0.f;

  for (int t = n_tiles - 1; t >= 0; --t) {
    const int steps = min(TS, S - t * TS);
    __syncthreads();  // the last tile's shared memory is free
    load_cols<T>(xs, x, row + t * TS, steps, d0, Din, vec_x);
    load_cols<float>(ds, delta, row + t * TS, steps, d0, Din, vec_d);
    load_cols<T>(dys, dy, row + t * TS, steps, d0, Din, vec_x);
    load_bc<T, N>(bc, Bm, Cm, row + t * TS, steps);
    repro::cp_async_commit();
    float h0v[SPL], hm[SPL];  // the states entering steps 0 and U of the tile
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      h0v[s] = live ? ckpt[(((size_t)b * n_tiles + t) * Din + d) * N + n0 + s] : 0.f;
    repro::cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int s = 0; s < SPL; ++s) hm[s] = h0v[s];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float dt = ds[j * CH + c], dxv = dt * repro::to_float(xs[j * CH + c]);
      float bv[SPL], cv[SPL];
      read_bc<T, SPL>(&bc[(j * LANES + ln) * 2 * SPL], bv, cv);
#pragma unroll
      for (int s = 0; s < SPL; ++s) hm[s] = fmaf(ex2(dt * a2[s]), hm[s], dxv * bv[s]);
    }

#pragma unroll 1
    for (int half = TS / U - 1; half >= 0; --half) {
      const int j0 = half * U;
      float hin[SPL], hs[U][SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s) hin[s] = half ? hm[s] : h0v[s];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const float dt = ds[j * CH + c], dxv = dt * repro::to_float(xs[j * CH + c]);
        float bv[SPL], cv[SPL];
        read_bc<T, SPL>(&bc[(j * LANES + ln) * 2 * SPL], bv, cv);
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          hs[u][s] = fmaf(ex2(dt * a2[s]), u ? hs[u - 1][s] : hin[s], dxv * bv[s]);
      }
      float px[U], pd[U];  // the lane's shares of sum_n g Bm and of ddelta, per step
#pragma unroll
      for (int u = U - 1; u >= 0; --u) {
        const int j = j0 + u;
        const float dt = ds[j * CH + c], xv = repro::to_float(xs[j * CH + c]);
        const float gy = repro::to_float(dys[j * CH + c]), dxv = dt * xv;
        float bv[SPL], cv[SPL], v[2 * SPL];
        read_bc<T, SPL>(&bc[(j * LANES + ln) * 2 * SPL], bv, cv);
        float sx = 0.f, sd = 0.f;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const float g = fmaf(cv[s], gy, ga[s]);
          const float a = ex2(dt * a2[s]);
          const float ah = a * (u ? hs[u - 1][s] : hin[s]);  // a_t h_{t-1}
          sx = fmaf(g, bv[s], sx);
          sd = fmaf(g, fmaf(af[s], ah, xv * bv[s]), sd);
          da[s] = fmaf(g * dt, ah, da[s]);
          v[s] = g * dxv;               // this channel's share of dBm_t
          v[SPL + s] = gy * hs[u][s];   // and of dCm_t
          ga[s] = a * g;
        }
        px[u] = sx;
        pd[u] = sd;
        dD = fmaf(gy, xv, dD);
        const float w = channel_sum<2 * SPL>(v, lane);
        const int share = (lane >> 2 & 7) / (8 / (2 * SPL));
        if ((lane >> 2 & 7) % (8 / (2 * SPL)) == 0)
          red[((u * NW + warp) * 2 + share / SPL) * N + ln * SPL + share % SPL] = w;
      }
      float zx[U / 4], zd[U / 4];
      lane_scatter(px, zx, ln);
      lane_scatter(pd, zd, ln);
#pragma unroll
      for (int m = 0; m < U / 4; ++m) {
        const int j = j0 + 4 * m + ln;
        dxs[j * CH + c] = repro::from_float<T>(
            fmaf(ds[j * CH + c], zx[m], dd * repro::to_float(dys[j * CH + c])));
        dds[j * CH + c] = zd[m];
      }
      __syncthreads();  // red is whole
      for (int i = tid; i < U * 2 * N; i += NT) {
        const int u = i / (2 * N), r = i % (2 * N), ts = t * TS + j0 + u;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += red[(u * NW + w) * 2 * N + r];
        if (ts < S)  // [block][Bm, Cm][B][S][N]
          part_bc[(((size_t)blockIdx.x * 2 + r / N) * gridDim.y + b) * S * N + (size_t)ts * N +
                  r % N] = sum;
      }
      __syncthreads();  // red may be written again
    }
    store_cols<T>(dx, dxs, row + t * TS, steps, d0, Din, vec_x);
    store_cols<float>(ddelta, dds, row + t * TS, steps, d0, Din, vec_d);
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      dh0[((size_t)b * Din + d) * N + n0 + s] = ga[s];
      part_a[((size_t)b * Din + d) * N + n0 + s] = da[s];
    }
    if (ln == 0) part_d[(size_t)b * Din + d] = dD;
  }
}

// out[m] = sum over k < K of part[k][m], k in order: the backward's partials
// summed over blocks or batch rows, the same way every run.
template <typename To>
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ part, To* __restrict__ out, int K, long long M) {
  const long long m = (long long)blockIdx.x * 256 + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += part[(size_t)k * M + m];
  out[m] = repro::from_float<To>(s);
}

template <typename To>
cudaError_t sum_rows(const float* part, void* out, int K, long long M, cudaStream_t stream) {
  sum_rows_kernel<To><<<(unsigned)((M + 255) / 256), 256, 0, stream>>>(
      part, static_cast<To*>(out), K, M);
  return cudaGetLastError();
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

template <typename T, int N>
cudaError_t launch_bwd(const void* x, const float* delta, const float* A, const void* Bm,
                       const void* Cm, const float* Dv, const void* dy, const float* dhT,
                       const float* ckpt, void* dx, float* ddelta, float* dA, void* dbc,
                       float* dD, float* dh0, float* part_bc, float* part_a, float* part_d,
                       int B, int S, int Din, cudaStream_t stream) {
  using L = Bwd<T, N>;
  cudaError_t e = cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  const int blocks = (Din + CH - 1) / CH;
  mamba_scan_bwd_kernel<T, N><<<dim3(blocks, B), NT, L::SMEM, stream>>>(
      static_cast<const T*>(x), delta, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dv, static_cast<const T*>(dy), dhT, ckpt, static_cast<T*>(dx), ddelta, part_bc, part_a,
      part_d, dh0, S, Din);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = sum_rows<T>(part_bc, dbc, blocks, 2LL * B * S * N, stream);  // dBm, dCm over blocks
  if (e != cudaSuccess) return e;
  e = sum_rows<float>(part_a, dA, B, (long long)Din * N, stream);  // dA over rows
  if (e != cudaSuccess) return e;
  return sum_rows<float>(part_d, dD, B, Din, stream);              // dD over rows
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
// may be null (zeros); ckpt from the forward; part_bc fp32 scratch of
// part_blocks * 2 * B * S * N floats, part_a of B * Din * N, part_d of
// B * Din.  part_blocks must be ceil(Din / CH), the blocks that write
// partials (cudaErrorInvalidValue otherwise, so a caller that sized the
// scratch for another tile width cannot be written past).  Returns the
// first cudaError_t of the four launches (0 on success); they run
// asynchronously, in order, on `stream`.
extern "C" int repro_mamba_scan_bwd(const void* x, const void* delta, const void* A,
                                    const void* Bm, const void* Cm, const void* Dv,
                                    const void* dy, const void* dhT, const void* ckpt, void* dx,
                                    void* ddelta, void* dA, void* dbc, void* dD, void* dh0,
                                    void* part_bc, void* part_a, void* part_d, int dtype, int B,
                                    int S, int Din, int N, int part_blocks, void* stream) {
  if (part_blocks != (Din + CH - 1) / CH) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MSB_ARGS x, static_cast<const float*>(delta), static_cast<const float*>(A), Bm, Cm, \
    static_cast<const float*>(Dv), dy, static_cast<const float*>(dhT),                          \
    static_cast<const float*>(ckpt), dx, static_cast<float*>(ddelta), static_cast<float*>(dA),  \
    dbc, static_cast<float*>(dD), static_cast<float*>(dh0), static_cast<float*>(part_bc),      \
    static_cast<float*>(part_a), static_cast<float*>(part_d), B, S, Din, st
  if (dtype == 0 && N == 8) return launch_bwd<float, 8>(REPRO_MSB_ARGS);
  if (dtype == 0 && N == 16) return launch_bwd<float, 16>(REPRO_MSB_ARGS);
  if (dtype == 1 && N == 8) return launch_bwd<__nv_bfloat16, 8>(REPRO_MSB_ARGS);
  if (dtype == 1 && N == 16) return launch_bwd<__nv_bfloat16, 16>(REPRO_MSB_ARGS);
#undef REPRO_MSB_ARGS
  return cudaErrorInvalidValue;
}
