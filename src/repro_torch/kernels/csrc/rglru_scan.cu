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
// Shape: one thread per (batch row, channel), 64 channels to a block.  The
// TPU kernel runs an associative scan over each chunk of 256 steps, with the
// carry in VMEM across a sequential grid axis; here the carry stays in one
// fp32 register and the thread walks t = 0..S-1 itself, so no step is
// recomputed and nothing but y and hT is written.  Neighbouring threads hold
// neighbouring channels, so every load and store of a [B,S,D] row coalesces.
// The loads do not depend on the carry: each thread first loads U steps of
// x, r and i into registers (3U loads in flight), then runs the U steps.
// A ragged S needs no padding: the last group of steps is cut at S.
//
// What bounds it: bytes.  Per element it reads three values and writes one,
// against ~10 operations (two exponentials and a square root among them), so
// the least time is the [B,S,D] traffic over the memory rate (recurrentgemma
// prefill, B=4, S=3072, D=4096, bf16: 403 MB, 0.12 ms at 3.35 TB/s).  With
// one thread per channel that shape has only 16384 threads, about 4 warps an
// SM, too few loads in flight to pull the full rate; a chunked three-pass form
// (chunk summaries, carry across chunks, apply) that also splits the
// sequence over threads is the later fix.
//
// With `ckpt` non-null the forward also writes the carry entering every U
// steps, [B, ceil(S / U), D] fp32: where the backward starts each group.
//
// The backward (repro_rglru_scan_bwd, no TPU kernel: the JAX package
// differentiates its XLA reference) is one reverse pass over the groups of U
// steps, one thread per (row, channel) as the forward.  With g_t the
// gradient of h_t, m_t = sqrt(max(1 - a_t^2, 1e-12)) and u_t = i_t x_t (in
// x's type; its rounding passes the gradient straight through):
//   g_t = dy_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT),
//   dx_t = g_t m_t i_t,  di_t = g_t m_t x_t,
//   dl_t = g_t a_t h_{t-1} - g_t u_t a_t^2 / m_t (the second term 0 where the
//          clamp holds: JAX's derivative of max),
//   dr_t = c log_a dl_t,  dlog_a = sum_{b,t} c r_t dl_t,  dh0 = a_0 g_0.
// Each group's carries are recomputed from its checkpoint into registers by
// the forward's arithmetic, then walked backwards; nothing divides by a
// decay.  dlog_a goes out per row and a second kernel sums the rows in
// order: no atomics, so two runs give the same bits.  What bounds it: bytes,
// four [B,S,D] reads (x, r, i, dy) and three writes (dx, dr, di).
#include "tile.cuh"

namespace {

constexpr int NT = 64;  // channels (threads) per block
constexpr int U = 16;   // steps loaded ahead of the recurrence

// The gate product in x's type (a bf16 product of two bf16 is exact in fp32,
// so this is the oracle's rounded product), widened back to fp32.
template <typename T>
__device__ __forceinline__ float gate(float i, float x) {
  return repro::to_float(repro::from_float<T>(i * x));
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                  const float* __restrict__ log_a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ hT, float* __restrict__ ckpt, int S,
                  int D, float c) {
  const int b = blockIdx.y, d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const float la = log_a[d];
  float h = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  const int groups = (S + U - 1) / U;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int steps = min(U, S - t0);
    if (ckpt != nullptr) ckpt[((size_t)b * groups + t0 / U) * D + d] = h;
    float xv[U], rv[U], iv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        const size_t off = base + (size_t)(t0 + u) * D;
        xv[u] = repro::to_float(x[off]);
        rv[u] = repro::to_float(r[off]);
        iv[u] = repro::to_float(gi[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        const float log_at = (c * rv[u]) * la;
        const float a = expf(log_at);
        const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_at), 1e-12f));
        h = fmaf(a, h, mult * gate<T>(iv[u], xv[u]));
        y[base + (size_t)(t0 + u) * D] = repro::from_float<T>(h);
      }
    }
  }
  hT[(size_t)b * D + d] = h;
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                      const float* __restrict__ log_a, const T* __restrict__ dy,
                      const float* __restrict__ dhT, const float* __restrict__ ckpt,
                      T* __restrict__ dx, T* __restrict__ dr, T* __restrict__ di,
                      float* __restrict__ part_la, float* __restrict__ dh0, int S, int D,
                      float c) {
  const int b = blockIdx.y, d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const float la = log_a[d];
  float ga = dhT != nullptr ? dhT[(size_t)b * D + d] : 0.f;  // a_{t+1} g_{t+1}
  float dla = 0.f;
  const size_t base = (size_t)b * S * D + d;
  const int groups = (S + U - 1) / U;
  for (int k = groups - 1; k >= 0; --k) {
    const int t0 = k * U, steps = min(U, S - t0);
    float xv[U], rv[U], iv[U], gv[U], hs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        const size_t off = base + (size_t)(t0 + u) * D;
        xv[u] = repro::to_float(x[off]);
        rv[u] = repro::to_float(r[off]);
        iv[u] = repro::to_float(gi[off]);
        gv[u] = repro::to_float(dy[off]);
      }
    }
    const float hin = ckpt[((size_t)b * groups + k) * D + d];
    float h = hin;
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the forward's carries, by its arithmetic
      if (u < steps) {
        const float log_at = (c * rv[u]) * la;
        const float a = expf(log_at);
        const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_at), 1e-12f));
        h = fmaf(a, h, mult * gate<T>(iv[u], xv[u]));
        hs[u] = h;
      }
    }
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      if (u < steps) {
        const float log_at = (c * rv[u]) * la;
        const float a = expf(log_at), a2 = expf(2.f * log_at), q = 1.f - a2;
        const float mult = sqrtf(fmaxf(q, 1e-12f));
        const float g = gv[u] + ga;
        const float du = g * mult;
        float dl = g * (u ? hs[u - 1] : hin) * a;
        if (q > 1e-12f) dl -= g * gate<T>(iv[u], xv[u]) * a2 / mult;
        const size_t off = base + (size_t)(t0 + u) * D;
        dx[off] = repro::from_float<T>(du * iv[u]);
        di[off] = repro::from_float<T>(du * xv[u]);
        dr[off] = repro::from_float<T>(dl * c * la);
        dla = fmaf(dl * c, rv[u], dla);
        ga = a * g;
      }
    }
  }
  part_la[(size_t)b * D + d] = dla;
  dh0[(size_t)b * D + d] = ga;
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
  const dim3 grid((D + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(gi), log_a, h0,
      static_cast<T*>(y), hT, ckpt, S, D, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* r, const void* gi, const float* log_a,
                       const void* dy, const float* dhT, const float* ckpt, void* dx, void* dr,
                       void* di, float* dla, float* dh0, float* part, int B, int S, int D,
                       float c, cudaStream_t stream) {
  rglru_scan_bwd_kernel<T><<<dim3((D + NT - 1) / NT, B), NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(gi), log_a,
      static_cast<const T*>(dy), dhT, ckpt, static_cast<T*>(dx), static_cast<T*>(dr),
      static_cast<T*>(di), part, dh0, S, D, c);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<(D + 255) / 256, 256, 0, stream>>>(part, dla, B, D);
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
// from the forward; part fp32 scratch of B * D floats.  Returns the first
// cudaError_t of the two launches (0 on success); they run asynchronously,
// in order, on `stream`.
extern "C" int repro_rglru_scan_bwd(const void* x, const void* r, const void* gi,
                                    const void* log_a, const void* dy, const void* dhT,
                                    const void* ckpt, void* dx, void* dr, void* di, void* dla,
                                    void* dh0, void* part, int dtype, int B, int S, int D,
                                    float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RSB_ARGS x, r, gi, static_cast<const float*>(log_a), dy,                     \
    static_cast<const float*>(dhT), static_cast<const float*>(ckpt), dx, dr, di,           \
    static_cast<float*>(dla), static_cast<float*>(dh0), static_cast<float*>(part), B, S, D, \
    c, s
  if (dtype == 0) return launch_bwd<float>(REPRO_RSB_ARGS);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(REPRO_RSB_ARGS);
#undef REPRO_RSB_ARGS
  return cudaErrorInvalidValue;
}
