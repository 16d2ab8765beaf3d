// The NVM blade's log work on Hopper (sm_90a): checksum verify and log replay
// over a blade arena that lives in device memory.
//
// No TPU kernel stands behind these two: the JAX package's simulator keeps the
// blade's arena in a host bytearray (repro/core/backend.py).  The port keeps
// the arena on the card, so the work the paper puts on the blade runs here.
//
// K1 repro_fletcher64_segments: Fletcher-64 over little-endian 32-bit words of
//   each byte segment of the arena, the segment zero-padded to whole words from
//   its own start: s1 = sum w_j, s2 = sum (L - j) w_j, both mod M = 2^32 - 1,
//   L the segment's word count; out = (s2 << 32) | s1, bitwise the value of
//   repro/core/oplog.py:fletcher64.  Segments start at any byte, so a word is
//   assembled from the two aligned words around it by a funnel shift, and bytes
//   past the segment's end are masked to zero.  A lane keeps sum w (below 2^51)
//   and sum (L - j) w folded mod M after each term (each product is below 2^64
//   while L < 2^32), reduces both mod M, and the warp (then the block) adds the
//   lanes' reduced sums, which stay below 2^45.  Layout: a warp a segment for
//   short segments, a block a segment for long ones (the wrapper splits them).
//   Bound: bytes, each read once (64 MB in 0.02 ms at 3.35 TB/s).
//
// K2 repro_apply_runs: for each run i in order, dst[addrs[i] : +lens[i]] =
//   src[offs[i] : +lens[i]], for every destination arena (the blade and its
//   synchronous mirrors).  Runs overlap (several transactions write one node),
//   and the serial loop's last writer wins.  The wrapper merges the runs'
//   intervals on the host; a run alone in its merged interval writes its bytes
//   as they are, and the bytes of intervals with several runs are numbered in a
//   compact space (comp[i], -1 for a lone run).  Pass 1 (apply_claim) takes an
//   atomicMax of the run index into an int32 owner per compact byte; pass 2
//   (apply_copy) copies each byte from its owner run only.  The result is the
//   serial loop's, whatever order the blocks run in.  A warp a run, 8 runs a
//   block, bytes strided over the lanes.  Bound: the bytes read once and written
//   once to each destination.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long M = 0xFFFFFFFFull;
constexpr int NT = 256;            // 8 warps
constexpr int WARPS = NT / 32;

// x mod (2^32 - 1) for any 64-bit x: 2^32 is 1 mod M, so fold twice, subtract once
__device__ __forceinline__ unsigned long long mod_m(unsigned long long x) {
  x = (x & M) + (x >> 32);
  x = (x & M) + (x >> 32);
  return x >= M ? x - M : x;
}

// the little-endian word of arena bytes s .. s+3, bytes from s + rem on read as 0
__device__ __forceinline__ unsigned int word_at(const unsigned char* __restrict__ base,
                                                long long nbase, long long s, long long rem) {
  const long long a = s & ~3LL;
  if (rem >= 4 && a + 8 <= nbase) {
    const unsigned int lo = *reinterpret_cast<const unsigned int*>(base + a);
    const unsigned int hi = *reinterpret_cast<const unsigned int*>(base + a + 4);
    return __funnelshift_r(lo, hi, 8 * (int)(s & 3));
  }
  unsigned int w = 0;
  for (int k = 0; k < 4 && k < rem; ++k) w |= (unsigned int)base[s + k] << (8 * k);
  return w;
}

// lane `t` of `nt` threads: its share of one segment's (sum w, sum (L - j) w), both mod M
__device__ __forceinline__ void segment_sums(const unsigned char* __restrict__ base,
                                             long long nbase, long long start, long long len,
                                             int t, int nt, unsigned long long& s1,
                                             unsigned long long& s2) {
  const long long words = (len + 3) >> 2;
  unsigned long long a = 0, b = 0;
  for (long long j = t; j < words; j += nt) {
    const unsigned long long w = word_at(base, nbase, start + 4 * j, len - 4 * j);
    a += w;
    b = mod_m(b + mod_m((unsigned long long)(words - j) * w));
  }
  s1 = mod_m(a);
  s2 = b;
}

__device__ __forceinline__ void warp_add(unsigned long long& x, unsigned long long& y) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
}

// a warp a segment: segments idx[0 .. n)
__global__ void __launch_bounds__(NT)
fletcher64_warp(const unsigned char* __restrict__ base, long long nbase,
                const long long* __restrict__ starts, const long long* __restrict__ lens,
                const long long* __restrict__ idx, int n, unsigned long long* __restrict__ out) {
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= n) return;
  const long long seg = idx[k];
  unsigned long long s1, s2;
  segment_sums(base, nbase, starts[seg], lens[seg], lane, 32, s1, s2);
  warp_add(s1, s2);
  if (lane == 0) out[seg] = (mod_m(s2) << 32) | mod_m(s1);
}

// a block a segment: segments idx[0 .. n)
__global__ void __launch_bounds__(NT)
fletcher64_block(const unsigned char* __restrict__ base, long long nbase,
                 const long long* __restrict__ starts, const long long* __restrict__ lens,
                 const long long* __restrict__ idx, unsigned long long* __restrict__ out) {
  const long long seg = idx[blockIdx.x];
  unsigned long long s1, s2;
  segment_sums(base, nbase, starts[seg], lens[seg], threadIdx.x, NT, s1, s2);
  warp_add(s1, s2);
  __shared__ unsigned long long r1[WARPS], r2[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    r1[warp] = s1;
    r2[warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < WARPS; ++w) {
      a += r1[w];
      b += r2[w];
    }
    out[seg] = (mod_m(b) << 32) | mod_m(a);
  }
}

// table: int64 [ndst + 4n]: the destination pointers, then addrs, offs, lens, comp
__global__ void __launch_bounds__(NT)
apply_claim(const long long* __restrict__ table, int ndst, int n, int* __restrict__ owner) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long* lens = table + ndst + 2 * (long long)n;
  const long long comp = table[ndst + 3 * (long long)n + i];
  if (comp < 0) return;
  for (long long j = threadIdx.x & 31; j < lens[i]; j += 32) atomicMax(owner + comp + j, i);
}

__global__ void __launch_bounds__(NT)
apply_copy(const long long* __restrict__ table, int ndst, int n,
           const unsigned char* __restrict__ src, const int* __restrict__ owner) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long addr = table[ndst + i];
  const long long off = table[ndst + (long long)n + i];
  const long long len = table[ndst + 2 * (long long)n + i];
  const long long comp = table[ndst + 3 * (long long)n + i];
  for (long long j = threadIdx.x & 31; j < len; j += 32) {
    if (comp >= 0 && owner[comp + j] != i) continue;
    const unsigned char v = src[off + j];
    for (int d = 0; d < ndst; ++d) reinterpret_cast<unsigned char*>(table[d])[addr + j] = v;
  }
}

}  // namespace

// base: the arena (4-byte aligned), nbase its bytes.  starts, lens: int64 [nseg]
// on the device, byte offsets into the arena.  widx: int64 [nwarp] segments a
// warp each; bidx: int64 [nblock] segments a block each.  out: uint64 [nseg].
// Returns the first cudaError_t of the launches (0 on success); they run
// asynchronously, in order, on `stream`.
extern "C" int repro_fletcher64_segments(const void* base, long long nbase, const void* starts,
                                         const void* lens, const void* widx, int nwarp,
                                         const void* bidx, int nblock, void* out,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwarp < 0 || nblock < 0 || (reinterpret_cast<uintptr_t>(base) & 3)) {
    return cudaErrorInvalidValue;
  }
  const unsigned char* b = static_cast<const unsigned char*>(base);
  const long long* st = static_cast<const long long*>(starts);
  const long long* ln = static_cast<const long long*>(lens);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  if (nwarp > 0) {
    fletcher64_warp<<<(nwarp + WARPS - 1) / WARPS, NT, 0, s>>>(
        b, nbase, st, ln, static_cast<const long long*>(widx), nwarp, o);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nblock > 0) {
    fletcher64_block<<<nblock, NT, 0, s>>>(b, nbase, st, ln, static_cast<const long long*>(bidx),
                                           o);
  }
  return cudaGetLastError();
}

// table: int64 [ndst + 4n] on the device (see apply_claim).  owner: int32
// [ucount] scratch, the compact bytes of the runs that share an interval
// (none when ucount is 0).  src: the bytes the offsets index.
extern "C" int repro_apply_runs(const void* table, int ndst, int n, const void* src, void* owner,
                                long long ucount, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ndst < 1 || ucount < 0) return cudaErrorInvalidValue;
  const long long* tab = static_cast<const long long*>(table);
  int* own = static_cast<int*>(owner);
  const unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  if (ucount > 0) {
    cudaError_t err = cudaMemsetAsync(own, 0xFF, (size_t)ucount * sizeof(int), s);  // -1
    if (err != cudaSuccess) return err;
    apply_claim<<<grid, NT, 0, s>>>(tab, ndst, n, own);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  apply_copy<<<grid, NT, 0, s>>>(tab, ndst, n, static_cast<const unsigned char*>(src), own);
  return cudaGetLastError();
}
