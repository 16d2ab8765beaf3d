// Per-block magnitude top-k with residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_compress.py:topk_compress.
// Contract: x [n] fp32 or bf16, contiguous.  Each 1024-element block (the tail
// zero-padded) keeps its k largest |x|, in descending order, ties to the lowest
// index: vals [nb,k] fp32 (the kept x), idx [nb,k] int32 (the position in the
// block), and residual [n] in x's type (x with the kept entries set to +0).
//
// Magnitudes are compared as the bits of |x| (fp32, or bf16 widened to fp32)
// read as unsigned integers: the order of |x| on every value but NaN, which
// ranks above +inf here (NaN is outside the contract: deltas of finite state).
//
// Shape: one warp per top-k block, eight per 256-thread CUDA block.  Lane l
// loads 16 bytes at a time (VEC = 4 fp32 or 8 bf16 values): elements
// j*32*VEC + l*VEC + c, 32 a lane, into its own padded row of shared memory
// (rows of 32 + VEC values, so a row read across the warp, a column read in
// index order and the 16-byte accesses are all free of bank conflicts).
//
// The selection does the same work whatever k is (k <= 32):
//  1. each lane's max magnitude, as it loads;
//  2. tau = the KT-th largest of the 32 lane maxes, KT = min(k + 1, 32): at
//     least k elements are >= tau, so every kept element is >= tau (a warp
//     bitonic sort; the one extra lane makes "k above tau" the common case
//     for data without ties);
//  3. the candidates, every |x| > tau: only lanes whose max is > tau (at most
//     KT - 1) hold one, so the warp reads those lanes' rows one at a time and
//     compacts them by ballot into a buffer of CAP = 64 (key, position);
//  4. when fewer than k exceed tau, the rest are the lowest-index entries
//     equal to tau: the warp walks the block in index order, 32 at a time,
//     until it has them (for a delta with few nonzeros, tau = 0 and one step
//     finds them);
//  5. a warp bitonic sort of the candidates by (|x| descending, index
//     ascending), 32 or 64 keys; the first k, then the ties, are the result.
// Blocks whose candidates overflow the buffer, and every block when k > 32,
// take the fallback in the same kernel: the TPU kernel's k rounds of
// argmax-and-clear over the lane's 32 magnitudes in registers.  Both paths
// compute the same function, bit for bit; on request the kernel records which
// one each block took (`path`).  The kept entries are zeroed in
// shared memory and the residual is stored from it, 16 bytes at a time.
//
// What bounds it: bytes.  The kernel reads x once and writes the residual once
// (plus nb*k*8 bytes of vals and idx): for llama3.2-3b's embedding delta (394 M
// fp32) 3.2 GB, 0.95 ms at 3.35 TB/s.  In those 0.95 ms the card dispatches
// ~2,600 warp instructions a top-k block (132 SMs x 4 schedulers x 1.98 GHz).  The
// rounds alone cost 293 SASS instructions each (a lane's 32 compares and
// selects, 10 shuffles, a 32-way compare to clear; counted in the SASS of
// the one-path kernel's sm_90a build), ~2,900 a block at k = 10: more instruction slots
// than the bytes' time, so the one-path kernel they were took 2.11 ms on an H100.  Here
// the fast path's two loops (over the lanes above tau, over rows of ties) take
// 30-33 instructions a trip, around code with no loop over k: 1.09 ms, 87% of
// the bound.
#include "tile.cuh"

namespace {

constexpr int BLOCK = 1024;          // elements per top-k block (the JAX default)
constexpr int PER_LANE = BLOCK / 32;
constexpr int NT = 256;              // 8 warps: 8 top-k blocks per CUDA block
constexpr int WARPS = NT / 32;
constexpr int FAST_K = 32;           // the largest k of the fast path
constexpr int CAP = 64;              // its candidate buffer
constexpr unsigned FULL = 0xffffffffu;

// The element type's bits: the kernel never converts a value except for vals.
template <typename T> struct Traits;
template <> struct Traits<float> {
  using Bits = unsigned;
  static __device__ __forceinline__ unsigned mag(unsigned b) { return b & 0x7fffffffu; }
  static __device__ __forceinline__ float value(unsigned b) { return __uint_as_float(b); }
  // max magnitude of the four values of a 16-byte word
  static __device__ __forceinline__ unsigned max_mag(const uint4& w) {
    return max(max(mag(w.x), mag(w.y)), max(mag(w.z), mag(w.w)));
  }
};
template <> struct Traits<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ unsigned mag(unsigned short b) {
    return (unsigned(b) & 0x7fffu) << 16;  // |x| widened to fp32
  }
  static __device__ __forceinline__ float value(unsigned short b) {
    return __uint_as_float(unsigned(b) << 16);
  }
  static __device__ __forceinline__ unsigned pair(unsigned w) {  // two bf16 in a word
    return max((w << 16) & 0x7fff0000u, w & 0x7fff0000u);
  }
  static __device__ __forceinline__ unsigned max_mag(const uint4& w) {
    return max(max(pair(w.x), pair(w.y)), max(pair(w.z), pair(w.w)));
  }
};

template <typename K> __device__ __forceinline__ K kmax(K a, K b) { return a > b ? a : b; }
template <typename K> __device__ __forceinline__ K kmin(K a, K b) { return a < b ? a : b; }

// Sorts one key a lane, descending: lane 0 ends with the largest.
template <typename K>
__device__ __forceinline__ K sort32_desc(K key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const K other = __shfl_xor_sync(FULL, key, stride);
      const bool take_max = ((lane & stride) == 0) == ((lane & size) == 0);
      key = take_max ? kmax(key, other) : kmin(key, other);
    }
  }
  return key;
}

// Sorts 64 keys, two a lane (indices lane and lane + 32), descending.
__device__ __forceinline__ void sort64_desc(unsigned long long& k0, unsigned long long& k1,
                                            int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: index lane against lane + 32, in the lane
        const unsigned long long hi = kmax(k0, k1), lo = kmin(k0, k1);
        k0 = hi;
        k1 = lo;
        continue;
      }
      const unsigned long long o0 = __shfl_xor_sync(FULL, k0, stride);
      const unsigned long long o1 = __shfl_xor_sync(FULL, k1, stride);
      const bool lower = (lane & stride) == 0;
      const bool max0 = lower == ((lane & size) == 0);
      const bool max1 = lower == (((lane + 32) & size) == 0);
      k0 = max0 ? kmax(k0, o0) : kmin(k0, o0);
      k1 = max1 ? kmax(k1, o1) : kmin(k1, o1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 3)
topk_kernel(const T* __restrict__ xv, long long n, long long nb, int k, int vec_ok,
            float* __restrict__ vals, int* __restrict__ idx, T* __restrict__ resv,
            unsigned char* __restrict__ path) {
  using Tr = Traits<T>;
  using Bits = typename Tr::Bits;
  constexpr int VEC = 16 / sizeof(T);   // values a 16-byte access
  constexpr int NV = PER_LANE / VEC;    // 16-byte accesses a lane
  constexpr int ROW = PER_LANE + VEC;   // a lane's row in shared memory, padded
  __shared__ __align__(16) Bits s_x[WARPS][32 * ROW];
  __shared__ unsigned long long s_cand[WARPS][CAP];
  __shared__ short s_tie[WARPS][FAST_K];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * WARPS + warp;
  if (blk >= nb) return;  // the whole warp: no barrier of the CUDA block follows
  const Bits* x = reinterpret_cast<const Bits*>(xv) + blk * BLOCK;
  Bits* res = reinterpret_cast<Bits*>(resv) + blk * BLOCK;
  const long long left = n - blk * BLOCK;  // this block's elements in x, >= 1
  const bool whole = vec_ok && left >= BLOCK;
  Bits* sx = s_x[warp];
  Bits* row = sx + lane * ROW;
  // element p of the block: lane (p / VEC) % 32, slot (p / (32 VEC)) VEC + p % VEC
  auto pos_of = [](int l, int s) { return (s / VEC) * (32 * VEC) + l * VEC + s % VEC; };
  auto at = [](int p) { return ((p / VEC) % 32) * ROW + (p / (32 * VEC)) * VEC + p % VEC; };
  const unsigned lt = (1u << lane) - 1u;

  // 1. load into this lane's row; the lane's max magnitude
  unsigned lmax = 0;
  if (whole) {
    uint4 w[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      w[j] = __ldcs(reinterpret_cast<const uint4*>(x + j * 32 * VEC + lane * VEC));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      *reinterpret_cast<uint4*>(row + j * VEC) = w[j];
      lmax = max(lmax, Tr::max_mag(w[j]));
    }
  } else {
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      const int p = pos_of(lane, s);
      const Bits b = p < left ? x[p] : Bits(0);  // the zero-padded tail
      row[s] = b;
      lmax = max(lmax, Tr::mag(b));
    }
  }
  __syncwarp();

  // 2-3. tau and the candidates above it (warp-uniform control throughout)
  bool fallback = k > FAST_K;
  int above = 0;  // candidates: entries > tau
  unsigned tau = 0;
  if (!fallback) {
    const int kt = k < 32 ? k + 1 : 32;
    tau = __shfl_sync(FULL, sort32_desc(lmax, lane), kt - 1);
    unsigned lanes = __ballot_sync(FULL, lmax > tau);
    while (lanes) {
      const int l = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const unsigned m = Tr::mag(sx[l * ROW + lane]);  // lane l's slot `lane`
      const unsigned vote = __ballot_sync(FULL, m > tau);
      if (above + __popc(vote) > CAP) {
        fallback = true;
        break;
      }
      if (m > tau)
        s_cand[warp][above + __popc(vote & lt)] =
            (static_cast<unsigned long long>(m) << 32) | unsigned(BLOCK - 1 - pos_of(l, lane));
      above += __popc(vote);
    }
  }
  if (path != nullptr && lane == 0) path[blk] = fallback;  // 1: the rounds

  if (!fallback) {
    // 4. the lowest-index entries equal to tau, when fewer than k are above it
    const int need = k - above;
    for (int m = 0, taken = 0; m < PER_LANE && taken < need; ++m) {
      const int p = m * 32 + lane;
      const bool eq = Tr::mag(sx[at(p)]) == tau;
      const unsigned vote = __ballot_sync(FULL, eq);
      const int rank = taken + __popc(vote & lt);
      if (eq && rank < need) s_tie[warp][rank] = static_cast<short>(p);
      taken += __popc(vote);
    }
    __syncwarp();
    // 5. sort the candidates; lane i < k takes the i-th kept entry
    unsigned long long k0 = lane < above ? s_cand[warp][lane] : 0ull;
    if (above > 32) {
      unsigned long long k1 = lane + 32 < above ? s_cand[warp][lane + 32] : 0ull;
      sort64_desc(k0, k1, lane);
    } else if (above > 1) {
      k0 = sort32_desc(k0, lane);
    }
    if (lane < k) {
      const int p = lane < above ? BLOCK - 1 - int(k0 & 0xffffffffu) : s_tie[warp][lane - above];
      const long long o = blk * k + lane;
      vals[o] = Tr::value(sx[at(p)]);
      idx[o] = p;
      sx[at(p)] = Bits(0);  // +0 in the residual
    }
  } else {
    // the fallback: k rounds of argmax-and-clear (magnitude -1 once taken)
    int a[PER_LANE];
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) a[s] = static_cast<int>(Tr::mag(row[s]));
    for (int r = 0; r < k; ++r) {
      int bm = -2, bs = 0;  // below every magnitude and the -1 of a taken slot
#pragma unroll
      for (int s = 0; s < PER_LANE; ++s) {
        if (a[s] > bm) {  // strictly greater: the lane's lowest position
          bm = a[s];
          bs = s;
        }
      }
      int bp = pos_of(lane, bs);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int om = __shfl_xor_sync(FULL, bm, off);
        const int op = __shfl_xor_sync(FULL, bp, off);
        if (om > bm || (om == bm && op < bp)) {
          bm = om;
          bp = op;
        }
      }
      if ((bp / VEC) % 32 == lane) {
        const int sel = (bp / (32 * VEC)) * VEC + bp % VEC;
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s)
          if (s == sel) a[s] = -1;
      }
      if (lane == 0) {
        const long long o = blk * k + r;
        vals[o] = Tr::value(sx[at(bp)]);
        idx[o] = bp;
        sx[at(bp)] = Bits(0);
      }
    }
  }
  __syncwarp();

  // the residual, from this lane's row
  if (whole) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      __stcs(reinterpret_cast<uint4*>(res + j * 32 * VEC + lane * VEC),
             *reinterpret_cast<const uint4*>(row + j * VEC));
  } else {
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      const int p = pos_of(lane, s);
      if (p < left) res[p] = row[s];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long n, int k, void* vals, void* idx, void* res,
                   void* path, cudaStream_t stream) {
  const long long nb = (n + BLOCK - 1) / BLOCK;
  const long long grid = (nb + WARPS - 1) / WARPS;
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(res) % 16 == 0);
  topk_kernel<T><<<(unsigned)grid, NT, 0, stream>>>(
      static_cast<const T*>(x), n, nb, k, vec_ok, static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<T*>(res), static_cast<unsigned char*>(path));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  1 <= k <= 1024, n >= 1.  path, when not
// null, gets one byte a top-k block: 1 where it took the rounds, 0 where the
// fast path.  Returns the cudaError_t of the launch (0 on success); the kernel
// runs asynchronously.
extern "C" int repro_topk_compress(const void* x, long long n, int k, void* vals, void* idx,
                                   void* res, void* path, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > BLOCK || n < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, n, k, vals, idx, res, path, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, n, k, vals, idx, res, path, s);
  return cudaErrorInvalidValue;
}

// The selection's constants, which the wrapper's plain model of the fallback
// decision (topk_compress.fallback_blocks) repeats: BLOCK, FAST_K, CAP.
extern "C" int repro_topk_compress_layout(int which) {
  return which == 0 ? BLOCK : which == 1 ? FAST_K : CAP;
}
