// FlashAttention-2 forward for Hopper (sm_90a), CUDA cores, fp32 softmax state.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention.
// Contract: q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], contiguous, fp32 or bf16 (one type
// for all three); o [B,Hq,Sq,D] in that type; when lse is not null, also each
// row's fp32 log-sum-exp of its scaled logits, lse [B,Hq,Sq] (m + log l: what
// the backward, flash_attention_bwd.cu, needs to rebuild P).  Query row i sits at absolute
// position i + q_offset; key j is visible when j < Sk, j <= pos (causal) and
// j > pos - window (window > 0).  Query head h reads KV head h / (Hq / Hkv).
//
// Shape: one 256-thread block per (tile of 64 query rows, query head, batch).
// A loop inside the block walks 64-key tiles of K/V, which take the place of
// the TPU's sequential grid axis; its bounds come from the masks (start past
// q_lo - window, stop at the causal diagonal), so fully masked tiles are never
// loaded.  Q, K, V and the probability tile sit in shared memory as fp32;
// each thread owns a 4x4 block of the score tile and a 4 x D/16 block of the
// output accumulator, so the row max and row sum are half-warp shuffles.
// The running max m, denominator l and accumulator stay in registers in fp32.
//
// What bounds it: at the serving prefill shape the work is compute-bound
// (25.8 GFLOP against 67 MB for llama3.2-3b, B=4, S=1024, causal), and this
// kernel runs its products on CUDA cores, not on the tensor cores (wgmma) that
// the bound assumes.  Register tiling (16 FMAs per 8 shared-memory loads)
// keeps it off the shared-memory limit.  The wrapper sends it fp32 inputs
// only, which it keeps in full fp32; bf16 goes to the wgmma/TMA kernel,
// flash_attention_sm90.cu (wgmma on fp32 is TF32, too coarse for fp32).
//
// Head dims 32, 64, 112 (kimi-k2), 128, 160 (stablelm-12b) and 256
// (recurrentgemma-9b's local attention): D / 16 accumulator columns a thread
// (7 at 112, 10 at 160).  At D=256 the tiles take 213,760 bytes of shared
// memory, inside the 232,448 a block may have, so one block runs on an SM at
// a time, and each thread keeps 64 accumulator floats in registers; at
// D=160, 140,032 bytes.
#include "tile.cuh"

namespace {

using repro::NEG_INF;
constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 column lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 float scale, int causal, int window, int q_offset) {
  constexpr int LDQ = D + 1;   // padded rows: column reads across rows hit distinct banks
  constexpr int LDP = BN + 1;
  constexpr int CW = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BM][LDQ]
  float* Ks = Qs + BM * LDQ;    // [BN][LDQ]
  float* Vs = Ks + BN * LDQ;    // [BN][D]
  float* Ps = Vs + BN * D;      // [BM][LDP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int rows = min(BM, Sq - q0);
  const T* qb = q + ((size_t)(b * Hq + h) * Sq + q0) * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  const int q_lo = q0 + q_offset, q_hi = q_lo + rows - 1;
  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  if (causal) k_end = min(Sk, q_hi + 1);
  k_begin = (k_begin / BN) * BN;

  repro::load_tile<T, D, NT>(Qs, LDQ, qb, BM, rows);

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    repro::load_tile<T, D, NT>(Ks, LDQ, kb + (size_t)k0 * D, BN, Sk - k0);
    repro::load_tile<T, D, NT>(Vs, D, vb + (size_t)k0 * D, BN, Sk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LDQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tc + 16 * c) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tc + 16 * c;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(tr * 4 + i) * LDP + tc + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = Vs[j * D + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r < rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = o + ((size_t)(b * Hq + h) * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < CW; ++c) orow[tc + 16 * c] = repro::from_float<T>(acc[i][c] / denom);
      if (lse != nullptr && tc == 0) lse[(size_t)(b * Hq + h) * Sq + q0 + r] = m[i] + logf(denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
#define REPRO_FA_ARGS q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale, causal, window, q_offset, stream
  switch (D) {
    case 32: return launch<T, 32>(REPRO_FA_ARGS);
    case 64: return launch<T, 64>(REPRO_FA_ARGS);
    case 112: return launch<T, 112>(REPRO_FA_ARGS);
    case 128: return launch<T, 128>(REPRO_FA_ARGS);
    case 160: return launch<T, 160>(REPRO_FA_ARGS);
    case 256: return launch<T, 256>(REPRO_FA_ARGS);
#undef REPRO_FA_ARGS
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  lse may be null
// (serving needs no log-sum-exp).  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                                     int D, float scale, int causal, int window, int q_offset,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale, causal, window,
                             q_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale, causal, window,
                                     q_offset, s);
  return cudaErrorInvalidValue;
}
