// RG-LRU gated linear recurrence for Hopper (sm_90a), fp32 carry.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:rglru_scan.
// Contract: x, r, i [B,S,D] contiguous, one type for the three (fp32 or bf16);
// log_a [D] fp32; h0 [B,D] fp32 or null (zeros).  For every (b, d):
//   a_t = exp(c r_t log_a),  h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t),
// y [B,S,D] in x's type holds every h_t, hT [B,D] fp32 the last.  The gate
// product i_t x_t is rounded to x's type, as the JAX oracle takes it
// (`gated = i * x`, repro/kernels/ref.py:rglru_reference) and the plain
// version; the rest is fp32.
//
// Shape: a block per (batch row, 32 channels), a lane a channel, and its W
// warps split the sequence: a span of W x U steps, warp w taking U = 16 of
// them.  The TPU kernel runs an associative scan over each chunk of 256
// steps, with the carry in VMEM across a sequential grid axis; here a span is
// three steps:
//   1. each warp turns its U steps' inputs into a_t and b_t = sqrt(max(1 -
//      a_t^2, 1e-12)) (i_t x_t), kept in registers, and their summary from a
//      zero carry: P = prod a_t and H = the h it reaches, by the per-step
//      recurrence below;
//   2. the summaries go through shared memory, and every warp folds those of
//      the warps before it, from the first, into the span's carry: its own
//      carry in, h = P_j h + H_j a warp at a time.  Every warp also folds all
//      W, in the same order, so each holds the next span's carry;
//   3. each warp runs its U steps from its carry in, h = fmaf(a_t, h, b_t),
//      writing y.
// The inputs of the next span are loaded before step 2, so they arrive under
// steps 2 and 3; they stay in x's type until step 1 uses them (widened as
// loaded, each step's widening would wait for its loads before the next
// step's were issued, as the backward's note below says).  Nothing is read
// twice and nothing but y, hT (and the checkpoints) is written.
// Neighbouring lanes hold neighbouring channels, so every load and store of a
// [B,S,D] row coalesces.  The fold order is fixed, so two runs give the same
// bits; y differs from a step-by-step walk over the whole sequence in
// rounding only (the carries between warps come from summaries).  W = 8: a
// trial build with 4 warps a block (twice the blocks an SM) was slower at
// recurrentgemma-9b's training shape (B=2, 256 blocks: too few loads in
// flight) and no faster at its prefill.  A ragged S needs no padding: a
// warp's steps are cut at S.
//
// What bounds it: bytes.  Per element it reads three values and writes one,
// against ~12 operations (two exponentials and a square root among them), so
// the least time is the [B,S,D] traffic over the memory rate (recurrentgemma
// prefill, B=4, S=3072, D=4096, bf16: 403 MB, 0.12 ms at 3.35 TB/s).  A
// thread a row and channel walking all of S would have 16384 threads at that
// shape, ~4 warps an SM with 16 steps of loads in flight each, too few to
// pull the memory's rate (0.77 ms on an H100 SXM); here 512 blocks of 8
// warps, two an SM, keep a span's loads in flight under the last span's work.
//
// With `ckpt` non-null the forward also writes the carry entering every U
// steps, [B, ceil(S / U), D] fp32: each warp's carry in, the one its steps
// used, so the backward's recompute of a group from it gives y's own values.
//
// The backward (repro_rglru_scan_bwd, no TPU kernel: the JAX package
// differentiates its XLA reference).  With g_t the gradient of h_t, m_t =
// sqrt(max(1 - a_t^2, 1e-12)) and u_t = i_t x_t (in x's type; its rounding
// passes the gradient straight through):
//   g_t = dy_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT),
//   dx_t = g_t m_t i_t,  di_t = g_t m_t x_t,
//   dl_t = g_t a_t h_{t-1} - g_t u_t a_t^2 / m_t (the second term 0 where the
//          clamp holds: JAX's derivative of max),
//   dr_t = c log_a dl_t,  dlog_a = sum_{b,t} c r_t dl_t,  dh0 = a_0 g_0.
// The reverse recurrence is linear in g, so the sequence splits into chunks
// of BWD_L steps (a multiple of U) that run in parallel, in two passes of a
// thread per (row, chunk, channel):
//   pass 1 walks its chunk back from a zero carry and writes the chunk's
//     summary, fp32 [B, nC, D] each: the a g it reaches at the chunk's first
//     step, and the product of the chunk's a_t.  It reads r and dy only;
//   pass 2 folds the summaries of the chunks to its right, from the last to
//     its neighbour (a fixed order), into the true carry: the a g of the
//     next chunk's first step, dhT folded in first.  Then it walks its chunk
//     back again, one group of U steps at a time: each group's h_{t-1} is
//     recomputed from the forward's checkpoint by the forward's exact
//     arithmetic, keeping h and a_t for the walk back, which takes one more
//     exponential for a_t^2 (three a step, where the one-pass kernel took
//     four; keeping a_t^2 too cost the registers of more warps).  It writes
//     dx, dr, di, a dlog_a partial per (row, chunk) and, in chunk 0, dh0.
// A third kernel sums the dlog_a partials over rows and chunks in order: no
// atomics, so two runs give the same bits.  Nothing divides by a decay.
// What bounds it: bytes, four [B,S,D] reads (x, r, i, dy) and three writes
// (dx, dr, di), plus pass 1's second read of r and dy.  The one-pass kernel
// (a thread a row and channel) ran 8192 threads at the train shape (B=2,
// S=1024, D=4096), ~2 warps an SM, each waiting on its own loads; the chunks
// give it 16 x 8192, and pass 2's 128 registers a thread let 16 warps an SM
// keep their loads in flight.  Two channels a thread (one 4-byte load of a
// bf16 pair) took 168 registers and spilled, and ran slower.
// The loaded values stay in x's type until they are used: widened to fp32
// as they are loaded, the compiler put each step's widening right after its
// loads, ahead of the next step's, so in bf16 every step's loads waited for
// the last step's (16 round trips a group where fp32 made one); that is why
// the one-pass kernel ran 2.3x slower in bf16 than in fp32.
#include "tile.cuh"

namespace {

constexpr int U = 16;   // steps a warp takes of a span; the checkpoint spacing
constexpr int W = 8;    // warps of a block of the forward: a span is W U steps

// The gate product in x's type (a bf16 product of two bf16 is exact in fp32,
// so this is the oracle's rounded product), widened back to fp32.
template <typename T>
__device__ __forceinline__ float gate(float i, float x) {
  return repro::to_float(repro::from_float<T>(i * x));
}

// a_t and the input term b_t of one step, by the arithmetic the reverse scan
// repeats from the checkpoints (rglru_bwd_pass2_kernel)
template <typename T>
__device__ __forceinline__ void decay_input(T r, T i, T x, float la, float c, float& a,
                                            float& b) {
  const float log_at = (c * repro::to_float(r)) * la;
  a = expf(log_at);
  const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_at), 1e-12f));
  b = mult * gate<T>(repro::to_float(i), repro::to_float(x));
}

template <typename T>
__global__ void __launch_bounds__(32 * W, 2)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                  const float* __restrict__ log_a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ hT, float* __restrict__ ckpt, int S,
                  int D, float c) {
  constexpr int SPAN = W * U;
  __shared__ float2 sums[2][W][32];  // (P, H) of each warp's steps, by span parity
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int b = blockIdx.y, d = blockIdx.x * 32 + lane;
  const bool live = d < D;
  const float la = live ? log_a[d] : 0.f;
  float carry = (live && h0 != nullptr) ? h0[(size_t)b * D + d] : 0.f;  // into the span
  const size_t base = (size_t)b * S * D + d;
  const int groups = (S + U - 1) / U;

  T xv[U], rv[U], iv[U];  // the warp's next U steps, as loaded
  auto load = [&](int t0) {
    const int steps = live ? max(0, min(U, S - t0)) : 0;
    if (steps == U) {  // a whole group: its 3U loads issued in one run, no branch between
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t off = base + (size_t)(t0 + u) * D;
        xv[u] = x[off];
        rv[u] = r[off];
        iv[u] = gi[off];
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < steps) {
          const size_t off = base + (size_t)(t0 + u) * D;
          xv[u] = x[off];
          rv[u] = r[off];
          iv[u] = gi[off];
        }
      }
    }
  };

  load(w * U);
  for (int s0 = 0, k = 0; s0 < S; s0 += SPAN, ++k) {
    const int t0 = s0 + w * U, steps = live ? max(0, min(U, S - t0)) : 0;
    float av[U], bv[U], P = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        decay_input<T>(rv[u], iv[u], xv[u], la, c, av[u], bv[u]);
        H = fmaf(av[u], H, bv[u]);
        P *= av[u];
      }
    }
    if (s0 + SPAN < S) load(t0 + SPAN);  // under the fold and the run
    sums[k & 1][w][lane] = make_float2(P, H);
    __syncthreads();  // one a span: a warp writes sums[k & 1] again two spans on
    float hin = carry, h = carry;
#pragma unroll
    for (int j = 0; j < W; ++j) {  // warps in order: w's carry in, then the span's out
      if (j == w) hin = h;
      const float2 ph = sums[k & 1][j][lane];
      h = fmaf(ph.x, h, ph.y);
    }
    carry = h;
    if (steps > 0) {
      if (ckpt != nullptr) ckpt[((size_t)b * groups + t0 / U) * D + d] = hin;
      h = hin;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < steps) {
          h = fmaf(av[u], h, bv[u]);
          y[base + (size_t)(t0 + u) * D] = repro::from_float<T>(h);
        }
      }
      if (t0 + steps == S) hT[(size_t)b * D + d] = h;
    }
  }
}

constexpr int BWD_NT = 128;  // threads a block of the backward passes
// steps of a chunk of the backward; rglru_scan.py's BWD_CHUNK sizes the
// scratch from it (checked against repro_rglru_scan_bwd_chunk at load).  The
// passes take it as an argument, L: folded into their code, it let the
// compiler load a whole chunk ahead in pass 1, at 141 registers a thread
// where 48 do, and pass 1 ran ~25% slower for the warps it lost
constexpr int BWD_L = 64;
static_assert(BWD_L % U == 0, "a chunk is whole groups of the forward's checkpoints");

// Pass 1: the summary of chunk blockIdx.y of row blockIdx.z.
template <typename T>
__global__ void __launch_bounds__(BWD_NT)
rglru_bwd_pass1_kernel(const T* __restrict__ r, const float* __restrict__ log_a,
                       const T* __restrict__ dy, float* __restrict__ sum_ga,
                       float* __restrict__ sum_a, int S, int D, int L, float c) {
  const int d = blockIdx.x * BWD_NT + threadIdx.x;
  if (d >= D) return;
  const int ck = blockIdx.y, b = blockIdx.z;
  const int t_begin = ck * L, t_end = min(S, t_begin + L);
  const float la = log_a[d];
  float ga = 0.f, prod = 1.f;
  const size_t base = (size_t)b * S * D + d;
  for (int t0 = t_begin + (t_end - 1 - t_begin) / U * U; t0 >= t_begin; t0 -= U) {
    const int steps = min(U, t_end - t0);
    T rv[U], gv[U];  // as loaded: widened where used (see the note at the top)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        rv[u] = r[base + (size_t)(t0 + u) * D];
        gv[u] = dy[base + (size_t)(t0 + u) * D];
      }
    }
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      if (u < steps) {
        const float a = expf((c * repro::to_float(rv[u])) * la);
        ga = a * (repro::to_float(gv[u]) + ga);
        prod *= a;
      }
    }
  }
  const size_t o = ((size_t)b * gridDim.y + ck) * D + d;
  sum_ga[o] = ga;
  sum_a[o] = prod;
}

// Pass 2: chunk blockIdx.y of row blockIdx.z from its true carry.
template <typename T>
__global__ void __launch_bounds__(BWD_NT)
rglru_bwd_pass2_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                       const float* __restrict__ log_a, const T* __restrict__ dy,
                       const float* __restrict__ dhT, const float* __restrict__ ckpt,
                       const float* __restrict__ sum_ga, const float* __restrict__ sum_a,
                       T* __restrict__ dx, T* __restrict__ dr, T* __restrict__ di,
                       float* __restrict__ part_la, float* __restrict__ dh0, int S, int D, int L,
                       float c) {
  const int d = blockIdx.x * BWD_NT + threadIdx.x;
  if (d >= D) return;
  const int ck = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  const int t_begin = ck * L, t_end = min(S, t_begin + L);
  const float la = log_a[d];
  float ga = dhT != nullptr ? dhT[(size_t)b * D + d] : 0.f;  // a_{t+1} g_{t+1}
#pragma unroll 4
  for (int k = nC - 1; k > ck; --k) {  // the chunks to the right, last first
    const size_t o = ((size_t)b * nC + k) * D + d;
    ga = fmaf(sum_a[o], ga, sum_ga[o]);
  }
  float dla = 0.f;
  const size_t base = (size_t)b * S * D + d;
  const int groups = (S + U - 1) / U;
  for (int t0 = t_begin + (t_end - 1 - t_begin) / U * U; t0 >= t_begin; t0 -= U) {
    const int steps = min(U, t_end - t0);
    T xv[U], rv[U], iv[U], gv[U];  // as loaded: widened where used
    float hs[U], av[U];
    if (steps == U) {  // a whole group: its 4U loads issued in one run, no branch between
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t off = base + (size_t)(t0 + u) * D;
        xv[u] = x[off];
        rv[u] = r[off];
        iv[u] = gi[off];
        gv[u] = dy[off];
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < steps) {
          const size_t off = base + (size_t)(t0 + u) * D;
          xv[u] = x[off];
          rv[u] = r[off];
          iv[u] = gi[off];
          gv[u] = dy[off];
        }
      }
    }
    const float hin = ckpt[((size_t)b * groups + t0 / U) * D + d];
    float h = hin;
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the forward's carries, by its arithmetic
      if (u < steps) {
        float a, bu;
        decay_input<T>(rv[u], iv[u], xv[u], la, c, a, bu);
        h = fmaf(a, h, bu);
        hs[u] = h;
        av[u] = a;
      }
    }
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      if (u < steps) {
        const float xf = repro::to_float(xv[u]), rf = repro::to_float(rv[u]);
        const float i_f = repro::to_float(iv[u]);
        // a_t kept from the run forward; a_t^2 as the forward takes it, so the
        // clamp holds exactly where it held there
        const float a = av[u], a2 = expf(2.f * ((c * rf) * la)), q = 1.f - a2;
        const float mult = sqrtf(fmaxf(q, 1e-12f));
        const float g = repro::to_float(gv[u]) + ga;
        const float du = g * mult;
        float dl = g * (u ? hs[u - 1] : hin) * a;
        if (q > 1e-12f) dl -= g * gate<T>(i_f, xf) * a2 / mult;
        const size_t off = base + (size_t)(t0 + u) * D;
        dx[off] = repro::from_float<T>(du * i_f);
        di[off] = repro::from_float<T>(du * xf);
        dr[off] = repro::from_float<T>(dl * c * la);
        dla = fmaf(dl * c, rf, dla);
        ga = a * g;
      }
    }
  }
  part_la[((size_t)b * nC + ck) * D + d] = dla;
  if (ck == 0) dh0[(size_t)b * D + d] = ga;
}

// out[d] = sum over rows b < B of part[b][d], in order.
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int B, int D) {
  const int d = blockIdx.x * 256 + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * D + d];
  out[d] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* gi, const float* log_a,
                   const float* h0, void* y, float* hT, float* ckpt, int B, int S, int D, float c,
                   cudaStream_t stream) {
  const dim3 grid((D + 31) / 32, B);
  rglru_scan_kernel<T><<<grid, 32 * W, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(gi), log_a, h0,
      static_cast<T*>(y), hT, ckpt, S, D, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* r, const void* gi, const float* log_a,
                       const void* dy, const float* dhT, const float* ckpt, void* dx, void* dr,
                       void* di, float* dla, float* dh0, float* scratch, int B, int S, int D,
                       float c, cudaStream_t stream) {
  const int nC = (S + BWD_L - 1) / BWD_L;
  const size_t plane = (size_t)B * nC * D;  // scratch: dlog_a partials, then the summaries
  float *part = scratch, *sum_ga = scratch + plane, *sum_a = scratch + 2 * plane;
  const dim3 grid((D + BWD_NT - 1) / BWD_NT, nC, B);
  const T *xt = static_cast<const T*>(x), *rt = static_cast<const T*>(r);
  const T *it = static_cast<const T*>(gi), *dyt = static_cast<const T*>(dy);
  rglru_bwd_pass1_kernel<T><<<grid, BWD_NT, 0, stream>>>(rt, log_a, dyt, sum_ga, sum_a, S, D,
                                                         BWD_L, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rglru_bwd_pass2_kernel<T><<<grid, BWD_NT, 0, stream>>>(
      xt, rt, it, log_a, dyt, dhT, ckpt, sum_ga, sum_a, static_cast<T*>(dx), static_cast<T*>(dr),
      static_cast<T*>(di), part, dh0, S, D, BWD_L, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<(D + 255) / 256, 256, 0, stream>>>(part, dla, B * nC, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, i and y).  h0 and ckpt may be null.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously.
extern "C" int repro_rglru_scan(const void* x, const void* r, const void* gi, const void* log_a,
                                const void* h0, void* y, void* hT, void* ckpt, int dtype, int B,
                                int S, int D, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  float* ck = static_cast<float*>(ckpt);
  if (dtype == 0) return launch<float>(x, r, gi, la, h, y, ht, ck, B, S, D, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, gi, la, h, y, ht, ck, B, S, D, c, s);
  return cudaErrorInvalidValue;
}

// The backward.  dy, dx, dr, di in x's type; dhT may be null (zeros); ckpt
// from the forward; scratch fp32 of 3 * B * ceil(S / BWD_L) * D floats.
// Returns the first cudaError_t of the three launches (0 on success); they run
// asynchronously, in order, on `stream`.
extern "C" int repro_rglru_scan_bwd(const void* x, const void* r, const void* gi,
                                    const void* log_a, const void* dy, const void* dhT,
                                    const void* ckpt, void* dx, void* dr, void* di, void* dla,
                                    void* dh0, void* scratch, int dtype, int B, int S, int D,
                                    float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RSB_ARGS x, r, gi, static_cast<const float*>(log_a), dy,                        \
    static_cast<const float*>(dhT), static_cast<const float*>(ckpt), dx, dr, di,              \
    static_cast<float*>(dla), static_cast<float*>(dh0), static_cast<float*>(scratch), B, S, D, \
    c, s
  if (dtype == 0) return launch_bwd<float>(REPRO_RSB_ARGS);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(REPRO_RSB_ARGS);
#undef REPRO_RSB_ARGS
  return cudaErrorInvalidValue;
}

// BWD_L, the steps of a chunk of the backward.
extern "C" int repro_rglru_scan_bwd_chunk() { return BWD_L; }
