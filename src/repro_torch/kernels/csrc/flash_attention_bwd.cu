// FlashAttention-2 backward for Hopper (sm_90a), CUDA cores, fp32 accumulation.
//
// The JAX package has no backward kernel: it differentiates the XLA reference of
// repro/kernels/flash_attention.py:flash_attention.  This is the gradient of the
// port's forward (flash_attention.cu), by the formulas of
// ref.flash_attention_backward_reference:
//
//   P  = exp(scale q k^T - lse) on visible pairs, 0 elsewhere
//   dV = P^T dO              D  = rowsum(dO * O)
//   dS = P * (dO V^T - D)    dQ = scale dS K      dK = scale dS^T Q
//
// Contract: q/o/dO [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], one type (fp32 or bf16),
// contiguous; lse [B,Hq,Sq] fp32 from the forward; delta [B,Hq,Sq] fp32 scratch.
// dq, dk, dv come out in the input type.  The masks are the forward's (causal,
// window, q_offset); query head h reads KV head h / (Hq / Hkv), so dK and dV of a
// KV head sum over the query heads of its group.
//
// Three kernels, none with atomics, so two runs give the same bits (bitwise
// resume of training rests on it):
//   1. bwd_delta: D = rowsum(dO * O), one warp per row.
//   2. bwd_dkdv: one 256-thread block per (key tile, KV head, batch).  K and V
//      stay in shared memory; the block loops over the group's query heads and
//      over the q tiles the masks let see its keys, recomputing P and dS and
//      keeping its dK and dV tile in fp32 registers (R keys x D/16 columns a
//      thread).
//   3. bwd_dq: one block per (q tile, query head, batch), looping over the KV
//      tiles in the mask bounds, with its dQ tile in registers.
// Tiles are BT x BT (BT = 64 rows and keys; 32 at D=256, where four 64-row
// fp32 tiles would take 263 KB of shared memory, over the 227 KB a block may
// have), and each thread owns an R x R block of the score tiles (R = BT / 16).
//
// What bounds it: the backward does 2.5x the forward's products (five BTxBTxD
// products a tile pair against the forward's two; dQ's kernel recomputes S and
// dP, so seven are issued), compute-bound on the tensor cores' 989 TFLOP/s at
// the training shape.  Like the forward it runs on CUDA cores with register
// tiling; the wrapper sends it fp32 inputs only, and bf16 goes to the wgmma/TMA
// kernels of flash_attention_bwd_sm90.cu.  Head dims 32, 64, 112, 128, 160
// and 256; at 160 the dK/dV kernel's 64-row tiles take 198,656 bytes of
// shared memory.
#include "tile.cuh"

namespace {

using repro::NEG_INF;
constexpr int NT = 256;  // threads per block: 16 row groups x 16 column lanes

template <int D>
struct Tiles {
  static constexpr int BT = D == 256 ? 32 : 64;  // query rows and keys a tile
  static constexpr int R = BT / 16;              // rows and columns a thread owns
};

template <int D>
constexpr size_t smem_bytes_dkdv() {  // Q, dO, K, V tiles; P and dS; lse and D rows
  constexpr int BT = Tiles<D>::BT;
  return sizeof(float) * (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT);
}

template <int D>
constexpr size_t smem_bytes_dq() {    // Q, dO, K, V tiles; dS; lse and D rows
  constexpr int BT = Tiles<D>::BT;
  return sizeof(float) * (size_t)(4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
                 long long rows) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dO + row * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(repro::to_float(orow[d]), repro::to_float(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Loads the lse and D values of the BT q rows q0.. into shared memory; rows
// past Sq get 0 (their P is masked to 0 anyway).
template <int BT>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, const float* lse,
                                          const float* delta, int q0, int Sq) {
  if (threadIdx.x < BT) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < Sq ? lse[r] : 0.f;
    dl_s[threadIdx.x] = r < Sq ? delta[r] : 0.f;
  }
}

// The BTxBT tile pair (q rows q0.., keys k0..): this thread's RxR block of
// P and dS, from the tiles in shared memory.
template <int D>
__device__ __forceinline__ void p_ds_tile(float (&p)[Tiles<D>::R][Tiles<D>::R],
                                          float (&ds)[Tiles<D>::R][Tiles<D>::R], const float* Qs,
                                          const float* dOs, const float* Ks, const float* Vs,
                                          const float* lse_s, const float* dl_s, int q0, int k0,
                                          int Sq, int Sk, float scale, int causal, int window,
                                          int q_offset) {
  constexpr int LDQ = D + 1, R = Tiles<D>::R;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(tr * R + i) * LDQ + d];
      ov[i] = dOs[(tr * R + i) * LDQ + d];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      kv[c] = Ks[(tc + 16 * c) * LDQ + d];
      vv[c] = Vs[(tc + 16 * c) * LDQ + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = tr * R + i, qrow = q0 + r, qpos = qrow + q_offset;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int kpos = k0 + tc + 16 * c;
      bool ok = qrow < Sq && kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      p[i][c] = ok ? expf(s[i][c] * scale - lse_s[r]) : 0.f;
      ds[i][c] = p[i][c] * (dp[i][c] - dl_s[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Hq,
                int Hkv, int Sq, int Sk, float scale, int causal, int window, int q_offset) {
  constexpr int BT = Tiles<D>::BT, R = Tiles<D>::R;
  constexpr int LDQ = D + 1;   // padded rows: column reads across rows hit distinct banks
  constexpr int LDP = BT + 1;
  constexpr int CW = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // [BT][LDQ]
  float* Vs = Ks + BT * LDQ;    // [BT][LDQ]
  float* Qs = Vs + BT * LDQ;    // [BT][LDQ]
  float* dOs = Qs + BT * LDQ;   // [BT][LDQ]
  float* Ps = dOs + BT * LDQ;   // [BT][LDP]
  float* dSs = Ps + BT * LDP;   // [BT][LDP]
  float* lse_s = dSs + BT * LDP;
  float* dl_s = lse_s + BT;

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BT;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int keys = min(BT, Sk - k0);
  const size_t kv_off = (size_t)(b * Hkv + hk) * Sk * D + (size_t)k0 * D;
  repro::load_tile<T, D, NT>(Ks, LDQ, k + kv_off, BT, keys);
  repro::load_tile<T, D, NT>(Vs, LDQ, v + kv_off, BT, keys);

  // the q rows that see a key of this tile
  const int k_last = k0 + keys - 1;
  int q_begin = causal ? max(0, k0 - q_offset) : 0;
  q_begin = (q_begin / BT) * BT;
  const int q_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;

  float acc_k[R][CW], acc_v[R][CW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t row0 = (size_t)(b * Hq + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      repro::load_tile<T, D, NT>(Qs, LDQ, q + (row0 + q0) * D, BT, Sq - q0);
      repro::load_tile<T, D, NT>(dOs, LDQ, dO + (row0 + q0) * D, BT, Sq - q0);
      load_rows<BT>(lse_s, dl_s, lse + row0, delta + row0, q0, Sq);
      __syncthreads();

      float p[R][R], ds[R][R];
      p_ds_tile<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Sq, Sk, scale, causal, window,
                   q_offset);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          Ps[(tr * R + i) * LDP + tc + 16 * c] = p[i][c];
          dSs[(tr * R + i) * LDP + tc + 16 * c] = ds[i][c];
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's BT rows; this thread
      // holds keys tr*R+i and columns tc+16c
#pragma unroll 2
      for (int j = 0; j < BT; ++j) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[j * LDP + tr * R + i];
          sv[i] = dSs[j * LDP + tr * R + i];
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float ov = dOs[j * LDQ + tc + 16 * c];
          const float qv = Qs[j * LDQ + tc + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = tr * R + i;
    if (r < keys) {
      const size_t off = kv_off + (size_t)r * D;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        dk[off + tc + 16 * c] = repro::from_float<T>(acc_k[i][c] * scale);
        dv[off + tc + 16 * c] = repro::from_float<T>(acc_v[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dO, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv, int Sq,
              int Sk, float scale, int causal, int window, int q_offset) {
  constexpr int BT = Tiles<D>::BT, R = Tiles<D>::R;
  constexpr int LDQ = D + 1;
  constexpr int LDP = BT + 1;
  constexpr int CW = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BT][LDQ]
  float* dOs = Qs + BT * LDQ;   // [BT][LDQ]
  float* Ks = dOs + BT * LDQ;   // [BT][LDQ]
  float* Vs = Ks + BT * LDQ;    // [BT][LDQ]
  float* dSs = Vs + BT * LDQ;   // [BT][LDP]
  float* lse_s = dSs + BT * LDP;
  float* dl_s = lse_s + BT;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int rows = min(BT, Sq - q0);
  const size_t row0 = (size_t)(b * Hq + h) * Sq;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;
  repro::load_tile<T, D, NT>(Qs, LDQ, q + (row0 + q0) * D, BT, rows);
  repro::load_tile<T, D, NT>(dOs, LDQ, dO + (row0 + q0) * D, BT, rows);
  load_rows<BT>(lse_s, dl_s, lse + row0, delta + row0, q0, Sq);

  // the keys these rows see, as in the forward
  const int q_lo = q0 + q_offset, q_hi = q_lo + rows - 1;
  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  if (causal) k_end = min(Sk, q_hi + 1);
  k_begin = (k_begin / BT) * BT;

  float acc[R][CW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();
    repro::load_tile<T, D, NT>(Ks, LDQ, kb + (size_t)k0 * D, BT, Sk - k0);
    repro::load_tile<T, D, NT>(Vs, LDQ, vb + (size_t)k0 * D, BT, Sk - k0);
    __syncthreads();

    float p[R][R], ds[R][R];
    p_ds_tile<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, dl_s, q0, k0, Sq, Sk, scale, causal, window,
                 q_offset);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) dSs[(tr * R + i) * LDP + tc + 16 * c] = ds[i][c];
    __syncthreads();

    // dQ += dS K; this thread holds rows tr*R+i and columns tc+16c
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(tr * R + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kv = Ks[j * LDQ + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = tr * R + i;
    if (r < rows) {
      T* out = dq + (row0 + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < CW; ++c) out[tc + 16 * c] = repro::from_float<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dO, void* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Sk, float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *o_ = static_cast<const T*>(o),
          *dO_ = static_cast<const T*>(dO);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const long long rows = (long long)B * Hq * Sq;
  bwd_delta_kernel<T, D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      o_, dO_, delta_, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int BT = Tiles<D>::BT;
  constexpr size_t smem_kv = smem_bytes_dkdv<D>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, D><<<dim3((Sk + BT - 1) / BT, Hkv, B), NT, smem_kv, stream>>>(
      q_, k_, v_, dO_, lse_, delta_, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk,
      scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = smem_bytes_dq<D>();
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3((Sq + BT - 1) / BT, Hq, B), NT, smem_q, stream>>>(
      q_, k_, v_, dO_, lse_, delta_, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, scale, causal, window,
      q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* lse, const void* dO, void* delta, void* dq, void* dk, void* dv,
                       int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
#define REPRO_FAB_ARGS q, k, v, o, lse, dO, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, scale, causal, \
                       window, q_offset, stream
  switch (D) {
    case 32: return launch<T, 32>(REPRO_FAB_ARGS);
    case 64: return launch<T, 64>(REPRO_FAB_ARGS);
    case 112: return launch<T, 112>(REPRO_FAB_ARGS);
    case 128: return launch<T, 128>(REPRO_FAB_ARGS);
    case 160: return launch<T, 160>(REPRO_FAB_ARGS);
    case 256: return launch<T, 256>(REPRO_FAB_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FAB_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  delta is fp32
// scratch of B*Hq*Sq floats.  Returns the first cudaError_t of the three
// launches (0 on success); the kernels run asynchronously, in order, on `stream`.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dO,
                                         void* delta, void* dq, void* dk, void* dv, int dtype,
                                         int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                         float scale, int causal, int window, int q_offset,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, dO, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, scale,
                             causal, window, q_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, dO, delta, dq, dk, dv, B, Hq, Hkv, Sq,
                                     Sk, scale, causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
