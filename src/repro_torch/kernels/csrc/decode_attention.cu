// Single-query decode attention over a KV cache for Hopper (sm_90a), split-K.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:decode_attention.
// Contract: q [B,Hq,D], k/v [B,Hkv,S,D], contiguous, fp32 or bf16 (one type for
// all three); length [B] int32, key j of sequence b is visible when
// j < min(length[b], S); o [B,Hq,D] in q's type.  Query head h reads KV head
// h / (Hq / Hkv).
//
// Shape: the split pass runs one 128-thread block per (chunk of 256 keys, KV
// head, batch).  A block serves all Hq/Hkv query heads of its KV head, so each
// K/V row is read from device memory once for its group.  Blocks whose chunk
// starts at or past length[b] return at once, so the cache tail beyond the
// live length is never read (at max_cache_len 32768 the tail is ~30x the live
// cache).  Inside a block, 64-key tiles go through shared memory in fp32; each
// block keeps an online-softmax state (m, l, acc) per query head and writes it
// to a scratch buffer.  The combine pass merges the chunks of each (b, head).
//
// What bounds it: bytes.  One query row per head does ~1 FLOP per byte of
// K/V, far below the card's ~295 FLOP/byte ridge, so the least time is the
// live K/V bytes over 3.35 TB/s.  Splitting the keys over chunks is what puts
// enough blocks in flight to pull that bandwidth at batch 4 with 8 KV heads;
// the scratch traffic is one fp32 row per (chunk, head), small next to K/V.
//
// Head dims 32, 64, 112, 128, 160 and 256 (the combine pass runs D threads a
// block).  The split pass's shared memory grows with
// the group: recurrentgemma-9b (D=256, 16 query heads on one KV head) needs
// 168,384 bytes, so `launch` raises each instance's dynamic limit to its
// need.  With one KV head and a 2048-slot ring, that shape runs only 8
// chunks x 4 rows = 32 blocks on 132 SMs.
#include "tile.cuh"

namespace {

using repro::NEG_INF;
constexpr int TK = 64;      // keys per shared-memory tile
constexpr int CHUNK = 256;  // keys per split block
constexpr int NT = 128;     // threads per split block

template <int D>
size_t split_smem_bytes(int G) {
  return sizeof(float) * ((size_t)TK * (D + 1) + (size_t)TK * D + 2 * (size_t)G * D +
                          (size_t)G * TK + 3 * (size_t)G);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ length, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int Hq, int Hkv, int S, int n_chunks,
                    float scale) {
  constexpr int LDK = D + 1;
  const int G = Hq / Hkv;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = min(length[b], S);
  const int c0 = c * CHUNK;
  if (c0 >= len) return;
  const int c1 = min(c0 + CHUNK, len);

  extern __shared__ float smem[];
  float* Ks = smem;             // [TK][LDK]
  float* Vs = Ks + TK * LDK;    // [TK][D]
  float* Qs = Vs + TK * D;      // [G][D]
  float* As = Qs + G * D;       // [G][D]  accumulators
  float* Ps = As + G * D;       // [G][TK] scores, then probabilities
  float* Ms = Ps + G * TK;      // [G] running max
  float* Ls = Ms + G;           // [G] running denominator
  float* Al = Ls + G;           // [G] rescale factor of the current tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;  // the group's heads are adjacent
  for (int i = tid; i < G * D; i += NT) {
    Qs[i] = repro::to_float(qb[i]);
    As[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  const T* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * S * D;

  for (int k0 = c0; k0 < c1; k0 += TK) {
    const int valid = c1 - k0;
    __syncthreads();  // the previous tile's readers are done; Qs/As/Ms/Ls ready
    repro::load_tile<T, D, NT>(Ks, LDK, kb + (size_t)k0 * D, TK, valid);
    repro::load_tile<T, D, NT>(Vs, D, vb + (size_t)k0 * D, TK, valid);
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, j = i % TK;
      const float* qr = Qs + g * D;
      const float* kr = Ks + j * LDK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      Ps[i] = j < valid ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {  // one warp per head, two keys per lane
      float a = Ps[g * TK + lane], bb = Ps[g * TK + lane + 32];
      float mx = fmaxf(a, bb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      a = expf(a - m_new);
      bb = expf(bb - m_new);
      Ps[g * TK + lane] = a;
      Ps[g * TK + lane + 32] = bb;
      float sum = a + bb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      const float* pr = Ps + g * TK;
      float a = As[i] * Al[g];
#pragma unroll 8
      for (int j = 0; j < TK; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
      As[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    part_acc[(((size_t)b * Hq + hk * G + g) * n_chunks + c) * D + d] = As[i];
  }
  for (int g = tid; g < G; g += NT) {
    float* ml = part_ml + (((size_t)b * Hq + hk * G + g) * n_chunks + c) * 2;
    ml[0] = Ms[g];
    ml[1] = Ls[g];
  }
}

// One block of D threads per (head, batch): merges the chunks that the split
// pass wrote for this sequence's live length.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      const int* __restrict__ length, T* __restrict__ o, int Hq,
                                      int S, int n_chunks, int D) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(length[b], S);
  const int nc = len > 0 ? (len + CHUNK - 1) / CHUNK : 0;
  const size_t row = (size_t)b * Hq + h;
  const float* ml = part_ml + row * n_chunks * 2;
  float M = NEG_INF;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f, a = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float w = expf(ml[2 * c] - M);
    L = fmaf(ml[2 * c + 1], w, L);
    a = fmaf(part_acc[(row * n_chunks + c) * D + d], w, a);
  }
  o[row * D + d] = repro::from_float<T>(a / fmaxf(L, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length, void* o,
                   float* part_ml, float* part_acc, int B, int Hq, int Hkv, int S, int n_chunks,
                   float scale, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<D>(Hq / Hkv);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, D><<<dim3(n_chunks, Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      part_ml, part_acc, Hq, Hkv, S, n_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(Hq, B), D, 0, stream>>>(part_ml, part_acc, length,
                                                          static_cast<T*>(o), Hq, S, n_chunks, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const int* length,
                       void* o, float* part_ml, float* part_acc, int B, int Hq, int Hkv, int S,
                       int n_chunks, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    case 64: return launch<T, 64>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    case 112: return launch<T, 112>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    case 128: return launch<T, 128>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    case 160: return launch<T, 160>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    case 256: return launch<T, 256>(q, k, v, length, o, part_ml, part_acc, B, Hq, Hkv, S, n_chunks, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys per split block: the wrapper sizes the scratch buffers with it.
extern "C" int repro_decode_chunk() { return CHUNK; }

// dtype: 0 = float32, 1 = bfloat16.  part_ml [B,Hq,n_chunks,2] and part_acc
// [B,Hq,n_chunks,D] are fp32 scratch, n_chunks = ceil(S / CHUNK).  Returns the
// cudaError_t of the launches (0 on success); the kernels run asynchronously.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, void* part_ml, void* part_acc,
                                      int dtype, int B, int Hq, int Hkv, int S, int D,
                                      int n_chunks, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_chunks, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_chunks, scale, s);
  return cudaErrorInvalidValue;
}
