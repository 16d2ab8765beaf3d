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
// Shape: one thread per (batch row, channel) holds the channel's N states in
// fp32 registers, 128 channels to a block, and walks the sequence itself.  The
// TPU kernel materialises a [chunk, block_d, N] tile of a and b in VMEM and
// runs an associative scan over it; here no [.., N] tensor ever leaves the
// registers, and y_t is a sum over the thread's own states, with no shuffle.
// The sequence goes in tiles of TS steps: the block first stages the tile's x
// and delta for its 128 channels and the tile's Bm and Cm rows (shared by
// every channel of the batch row) in shared memory as fp32, with coalesced
// loads, then each thread runs the TS steps out of shared memory (Bm and Cm
// as broadcast reads).  A ragged S needs no padding: the last tile is cut.
// exp(delta A) is taken as exp2(delta * (A log2 e)), with A log2 e computed
// once per thread.
//
// What bounds it: at falcon-mamba-7b's prefill (B=4, S=1024, Din=8192, N=16,
// bf16 x/Bm/Cm, fp32 delta) it moves 269 MB (0.080 ms at 3.35 TB/s) and does
// 537 M exponentials plus ~6 fp32 operations per (b, t, d, n): 3.8 GFLOP, or
// 0.056 ms at 67 TFLOP/s, so bytes bound it by that reckoning.  The
// exponentials run on the special-function units (16 per SM per clock), about
// 0.13 ms for 537 M, so in practice they are the limit; the design keeps them
// to one per state per step and overlaps them across the 16 independent state
// chains of a thread.  One thread per channel gives 32768 threads, about 8
// warps an SM: splitting the sequence over threads is the later fix.
#include "tile.cuh"

namespace {

constexpr int NT = 128;  // channels (threads) per block
constexpr int TS = 32;   // sequence steps per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int N>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ Dv, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hT, int S, int Din) {
  __shared__ float xs[TS][NT];
  __shared__ float ds[TS][NT];
  __shared__ float bs[TS][N];
  __shared__ float cs[TS][N];

  const int b = blockIdx.y, d0 = blockIdx.x * NT, tid = threadIdx.x, d = d0 + tid;
  const bool live = d < Din;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? A[(size_t)d * N + n] * LOG2E : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[((size_t)b * Din + d) * N + n] : 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;
  const size_t row = (size_t)b * S;  // first step of this batch row

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TS * NT; i += NT) {
      const int j = i / NT, col = i % NT;
      const bool ok = j < steps && d0 + col < Din;
      const size_t off = (row + t0 + j) * Din + d0 + col;
      xs[j][col] = ok ? repro::to_float(x[off]) : 0.f;
      ds[j][col] = ok ? delta[off] : 0.f;
    }
    for (int i = tid; i < TS * N; i += NT) {
      const int j = i / N, n = i % N;
      const bool ok = j < steps;
      const size_t off = (row + t0 + j) * N + n;
      bs[j][n] = ok ? repro::to_float(Bm[off]) : 0.f;
      cs[j][n] = ok ? repro::to_float(Cm[off]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < steps; ++j) {
      const float dt = ds[j][tid], xv = xs[j][tid];
      const float dx = dt * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float a = exp2f(dt * a2[n]);
        h[n] = fmaf(a, h[n], dx * bs[j][n]);
        acc = fmaf(h[n], cs[j][n], acc);
      }
      y[(row + t0 + j) * Din + d] = repro::from_float<T>(acc + xv * dd);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) hT[((size_t)b * Din + d) * N + n] = h[n];
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* delta, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, const float* h0, void* y, float* hT, int B,
                   int S, int Din, cudaStream_t stream) {
  const dim3 grid((Din + NT - 1) / NT, B);
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
