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
#include "tile.cuh"

namespace {

constexpr int LANES = 4;              // threads per channel
constexpr int CH = 64;                // channels per block
constexpr int NT = CH * LANES;        // threads per block
constexpr int TS = 32;                // sequence steps per tile
constexpr int RS = 16;                // steps per reduce-scatter of the y shares
constexpr float LOG2E = 1.4426950408889634f;

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

template <typename T, int N>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ Dv, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hT, int S, int Din) {
  constexpr int SPL = N / LANES;                // states per lane
  constexpr int CHUNK = SPL * (int)sizeof(T);   // bytes of a lane's Bm (or Cm) in a step
  static_assert(2 * TS * LANES <= NT, "a thread copies at most one lane's Bm or Cm of a step");
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

  // x, delta, Bm and Cm of tile t into stage t % 2, all by cp.async; thread i
  // < 2 TS LANES also copies one lane's Bm (first half) or Cm of one step
  auto load_tile = [&](int t) {
    const int stage = t & 1, steps = min(TS, S - t * TS);
    load_cols<T>(xs[stage], x, row + t * TS, steps, d0, Din, vec_x);
    load_cols<float>(ds[stage], delta, row + t * TS, steps, d0, Din, vec_d);
    if (tid < 2 * TS * LANES) {
      const int which = tid / (TS * LANES), i = tid % (TS * LANES), j = i / LANES, l = i % LANES;
      const bool ok = j < steps;
      const T* src = (which ? Cm : Bm) + (ok ? (row + t * TS + j) * N + l * SPL : 0);
      copy_async<CHUNK>(&bc[stage][(i * 2 + which) * SPL], src, ok);
    }
    repro::cp_async_commit();
  };

  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
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
        const T* bcj = &bc[st][(j * LANES + ln) * 2 * SPL];
        if constexpr (sizeof(T) == 2) {  // bf16 pairs to fp32 by shifts, one load
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
      // reduce-scatter over the four lanes: after it lane ln holds y_t of the
      // steps t = g0 + 4 m + ln, summed (lane 0 + lane 1) + (lane 2 + lane 3)
      const bool b0 = ln & 1, b1 = ln & 2;
      float w[RS / 2], z[RS / 4];
#pragma unroll
      for (int k = 0; k < RS / 2; ++k) {
        const float keep = b0 ? part[2 * k + 1] : part[2 * k];
        const float send = b0 ? part[2 * k] : part[2 * k + 1];
        w[k] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
#pragma unroll
      for (int m = 0; m < RS / 4; ++m) {
        const float keep = b1 ? w[2 * m + 1] : w[2 * m];
        const float send = b1 ? w[2 * m] : w[2 * m + 1];
        z[m] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
      for (int m = 0; m < RS / 4; ++m) {
        const int j = g0 + 4 * m + ln;
        ys[j * CH + c] = repro::from_float<T>(fmaf(repro::to_float(xt[j * CH + c]), dd, z[m]));
      }
    }
    __syncthreads();  // ys is whole
    {
      constexpr int VEC = 16 / sizeof(T), CPR = CH / VEC;
      const int steps = min(TS, S - t * TS);
      for (int i = tid; i < steps * CPR; i += NT) {
        const int j = i / CPR, cc = (i % CPR) * VEC, dc = d0 + cc;
        const size_t off = (row + t * TS + j) * Din + dc;
        if (vec_x && dc + VEC <= Din) {
          *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(ys + j * CH + cc);
        } else {
          for (int e = 0; e < VEC && dc + e < Din; ++e) y[off + e] = ys[j * CH + cc + e];
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) hT[((size_t)b * Din + d) * N + n0 + s] = h[s];
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* delta, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, const float* h0, void* y, float* hT, int B,
                   int S, int Din, cudaStream_t stream) {
  const dim3 grid((Din + CH - 1) / CH, B);
  mamba_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), delta, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dv, h0, static_cast<T*>(y), hT, S, Din);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const void* x, const float* delta, const float* A, const void* Bm,
                       const void* Cm, const float* Dv, const float* h0, void* y, float* hT,
                       int B, int S, int Din, cudaStream_t stream) {
  switch (N) {  // d_state 16 (falcon-mamba-7b) and 8 (its smoke config)
    case 8: return launch<T, 8>(x, delta, A, Bm, Cm, Dv, h0, y, hT, B, S, Din, stream);
    case 16: return launch<T, 16>(x, delta, A, Bm, Cm, Dv, h0, y, hT, B, S, Din, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y).  h0 may be null.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously.
extern "C" int repro_mamba_scan(const void* x, const void* delta, const void* A, const void* Bm,
                                const void* Cm, const void* Dv, const void* h0, void* y, void* hT,
                                int dtype, int B, int S, int Din, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  const float* a = static_cast<const float*>(A);
  const float* dv = static_cast<const float*>(Dv);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  if (dtype == 0) return dispatch_n<float>(N, x, dl, a, Bm, Cm, dv, h, y, ht, B, S, Din, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, x, dl, a, Bm, Cm, dv, h, y, ht, B, S, Din, s);
  return cudaErrorInvalidValue;
}
