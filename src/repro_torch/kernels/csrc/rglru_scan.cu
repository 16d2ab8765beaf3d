// RG-LRU gated linear recurrence for Hopper (sm_90a), fp32 carry.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:rglru_scan.
// Contract: x, r, i [B,S,D] contiguous, one type for the three (fp32 or bf16);
// log_a [D] fp32; h0 [B,D] fp32 or null (zeros).  For every (b, d):
//   a_t = exp(c r_t log_a),  h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t),
// y [B,S,D] in x's type holds every h_t, hT [B,D] fp32 the last.  As in the
// Pallas kernel, every operand is widened to fp32 before any arithmetic.
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
#include "tile.cuh"

namespace {

constexpr int NT = 64;  // channels (threads) per block
constexpr int U = 16;   // steps loaded ahead of the recurrence

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ gi,
                  const float* __restrict__ log_a, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ hT, int S, int D, float c) {
  const int b = blockIdx.y, d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const float la = log_a[d];
  float h = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int steps = min(U, S - t0);
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
        h = fmaf(a, h, mult * (iv[u] * xv[u]));
        y[base + (size_t)(t0 + u) * D] = repro::from_float<T>(h);
      }
    }
  }
  hT[(size_t)b * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* gi, const float* log_a,
                   const float* h0, void* y, float* hT, int B, int S, int D, float c,
                   cudaStream_t stream) {
  const dim3 grid((D + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(gi), log_a, h0,
      static_cast<T*>(y), hT, S, D, c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, i and y).  h0 may be null.  Returns
// the cudaError_t of the launch (0 on success); the kernel runs asynchronously.
extern "C" int repro_rglru_scan(const void* x, const void* r, const void* gi, const void* log_a,
                                const void* h0, void* y, void* hT, int dtype, int B, int S, int D,
                                float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  if (dtype == 0) return launch<float>(x, r, gi, la, h, y, ht, B, S, D, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, gi, la, h, y, ht, B, S, D, c, s);
  return cudaErrorInvalidValue;
}
