// Per-block magnitude top-k with residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_compress.py:topk_compress.
// Contract: x [n] fp32 or bf16, contiguous.  Each 1024-element block (the tail
// zero-padded) keeps its k largest |x|, in descending order, ties to the lowest
// index: vals [nb,k] fp32 (the kept x), idx [nb,k] int32 (the position in the
// block), and residual [n] in x's type (x with the kept entries set to +0).
//
// Shape: one warp per block, eight blocks per 256-thread CUDA block.  Lane l
// holds elements l, l+32, ..., l+992 of its block in registers (each of the 32
// loads reads 128 contiguous bytes across the warp), with their magnitudes.
// Each of the k rounds is the TPU kernel's argmax-and-clear: a lane's own max
// over its 32 values (strictly greater wins, so its lowest position), then a
// 5-step shuffle argmax (larger magnitude, ties to the lower position); the
// owning lane clears the winner (magnitude -1, value 0).  No sort, no shared
// memory, nothing of the block leaves registers until the residual is written.
//
// What bounds it: bytes.  The kernel reads x once and writes the residual once
// (plus nb*k*8 bytes of vals and idx): for llama3.2-3b's embedding delta (394 M
// fp32) 3.2 GB, 0.95 ms at 3.35 TB/s.  Each round costs a lane 32 compares and
// 10 shuffles, so at k=10 the arithmetic (~0.3 ms of issue slots) stays under
// the memory time.
#include "tile.cuh"

namespace {

constexpr int BLOCK = 1024;          // elements per top-k block (the JAX default)
constexpr int PER_LANE = BLOCK / 32;
constexpr int NT = 256;              // 8 warps: 8 top-k blocks per CUDA block

template <typename T>
__global__ void __launch_bounds__(NT)
topk_kernel(const T* __restrict__ x, long long n, long long nb, int k, float* __restrict__ vals,
            int* __restrict__ idx, T* __restrict__ res) {
  const long long blk = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blk >= nb) return;
  const long long base = blk * BLOCK;

  float v[PER_LANE], a[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const long long pos = base + j * 32 + lane;
    v[j] = pos < n ? repro::to_float(x[pos]) : 0.f;  // the zero-padded tail
    a[j] = fabsf(v[j]);
  }

  for (int r = 0; r < k; ++r) {
    float bm = -2.f;  // below every magnitude and the -1 of a cleared slot
    int bj = 0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (a[j] > bm) {
        bm = a[j];
        bj = j;
      }
    }
    int bp = bj * 32 + lane;  // position in the block
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, bm, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (om > bm || (om == bm && op < bp)) {
        bm = om;
        bp = op;
      }
    }
    // every lane now holds the winner; its owner clears it (unrolled compares
    // keep v and a in registers)
    float val = 0.f;
    if ((bp & 31) == lane) {
      const int sel = bp >> 5;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (j == sel) {
          val = v[j];
          v[j] = 0.f;
          a[j] = -1.f;
        }
      }
    }
    val = __shfl_sync(0xffffffffu, val, bp & 31);
    if (lane == 0) {
      vals[blk * k + r] = val;
      idx[blk * k + r] = bp;
    }
  }

#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const long long pos = base + j * 32 + lane;
    if (pos < n) res[pos] = repro::from_float<T>(v[j]);
  }
}

template <typename T>
cudaError_t launch(const void* x, long long n, int k, void* vals, void* idx, void* res,
                   cudaStream_t stream) {
  const long long nb = (n + BLOCK - 1) / BLOCK;
  const long long grid = (nb + NT / 32 - 1) / (NT / 32);
  topk_kernel<T><<<(unsigned)grid, NT, 0, stream>>>(
      static_cast<const T*>(x), n, nb, k, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<T*>(res));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  1 <= k <= 1024, n >= 1.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously.
extern "C" int repro_topk_compress(const void* x, long long n, int k, void* vals, void* idx,
                                   void* res, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > BLOCK || n < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, n, k, vals, idx, res, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, n, k, vals, idx, res, s);
  return cudaErrorInvalidValue;
}
