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
// K2 repro_apply_small / repro_apply_runs: for each run i in order,
//   dst[addrs[i] : +lens[i]] = src[offs[i] : +lens[i]], for every destination
//   arena (the blade and its synchronous mirrors), the serial loop's last writer
//   winning where runs overlap.  The blade's replay calls it with 2-9 runs of
//   8-240 bytes (a transaction's memory logs), and a batched window with up to
//   ~2,000: a few hundred bytes, whose bytes bound is nanoseconds.  What bounds
//   such a call is the launch and the host work around it, so the design is two
//   routes, chosen by the wrapper from the run table's size:
//   * small (repro_apply_small): a table that fits the kernel's parameter space
//     (SMALL_WORDS int64 words: the destination pointers, then addrs, offs,
//     lens; 32,764 bytes with CUDA >= 12.1) goes with the launch, by value, as
//     a __grid_constant__ struct: no host-to-device copy, no scratch, one
//     launch.  The last writer is found on the card: a byte of run i is written
//     only where no later run j > i covers it.  A warp a run walks j in
//     lockstep, so each step is one uniform read of the parameter bank, and
//     masks a 16-byte chunk at once.
//   * large (repro_apply_runs): a longer table is copied to the card (the
//     wrapper stages it in a kept pinned buffer), with the plan of shared bytes
//     the wrapper makes on the host: a run alone in its merged interval writes
//     its bytes as they are; the bytes of intervals with several runs are
//     numbered in a compact space (comp[i], -1 for a lone run).  Pass 1
//     (apply_claim) takes an atomicMax of the run index into an int32 owner per
//     compact byte; pass 2 (apply_copy) writes each byte from its owner only.
//     Its bound is the bytes: each run read once and written once to each
//     destination (at 1e5 runs, tens of MB).
//   Both copy a run in 16-byte chunks aligned in the first destination's
//   address space, a lane a chunk: where the source and the destination agree
//   mod 16, one 16-byte load and store; otherwise the aligned source blocks
//   around the chunk, funnel-shifted into place (as K1's word_at), and stores of
//   whole words where aligned, bytes at the ragged ends.  Every destination is
//   written from the same registers.  The result is the serial loop's,
//   whatever order the blocks run in: each byte is written by one run only.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// the run table that fits the kernel's parameter space (32,764 bytes) beside
// the source pointer and the two counts
constexpr int SMALL_WORDS = 4093;

template <int W>
struct SmallTable {
  const unsigned char* src;
  int ndst;
  int n;
  long long w[W];  // the destination pointers, then addrs[n], offs[n], lens[n]
};
static_assert(sizeof(SmallTable<SMALL_WORDS>) <= 32764, "the parameter space holds 32,764 bytes");

// bits [lo, hi) of a chunk's 16-bit byte mask, lo and hi clamped to [0, 16]
__device__ __forceinline__ unsigned range_mask(long long lo, long long hi) {
  lo = lo < 0 ? 0 : lo > 16 ? 16 : lo;
  hi = hi < 0 ? 0 : hi > 16 ? 16 : hi;
  return hi <= lo ? 0u : ((1u << hi) - 1u) ^ ((1u << lo) - 1u);
}

// bytes p .. p+15, of which bytes [lo, hi) are needed (0 <= lo < hi <= 16): the
// aligned 16-byte blocks that hold those, funnel-shifted into place
__device__ __forceinline__ uint4 load16(uintptr_t p, int lo, int hi) {
  const uintptr_t a = p & ~uintptr_t(15);
  const int r = (int)(p & 15);
  if (r == 0) return *reinterpret_cast<const uint4*>(a);
  uint4 b0 = make_uint4(0u, 0u, 0u, 0u), b1 = b0;
  if (r + lo < 16) b0 = *reinterpret_cast<const uint4*>(a);
  if (r + hi > 16) b1 = *reinterpret_cast<const uint4*>(a + 16);
  const unsigned u[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const int q = r >> 2, sh = 8 * (r & 3);
  unsigned s[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) s[k] = q == 0 ? u[k] : q == 1 ? u[k + 1] : q == 2 ? u[k + 2] : u[k + 3];
  return make_uint4(__funnelshift_r(s[0], s[1], sh), __funnelshift_r(s[1], s[2], sh),
                    __funnelshift_r(s[2], s[3], sh), __funnelshift_r(s[3], s[4], sh));
}

// the bytes of `mask` from v to q .. q+15: one 16-byte store for a whole aligned
// chunk, else a word store for each whole aligned word, bytes for the rest
__device__ __forceinline__ void store16(uintptr_t q, uint4 v, unsigned mask) {
  if (mask == 0xFFFFu && !(q & 15)) {
    *reinterpret_cast<uint4*>(q) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = (mask >> (4 * k)) & 15u;
    const uintptr_t p = q + 4 * k;
    if (m == 15u && !(p & 3)) {
      *reinterpret_cast<unsigned*>(p) = w[k];
    } else if (m) {
      for (int b = 0; b < 4; ++b)
        if ((m >> b) & 1u) *reinterpret_cast<unsigned char*>(p + b) = (unsigned char)(w[k] >> (8 * b));
    }
  }
}

// lane `lane` of the warp that copies one run (arena offsets [addr, addr + len)
// from src + off): 16-byte chunks aligned in the first destination's address
// space, a lane a chunk; live(x, mask) keeps the bytes of the chunk at arena
// offset x (bit b: byte x + b) that this run must write
template <class Live>
__device__ __forceinline__ void copy_run(const long long* dsts, int ndst, const unsigned char* src,
                                         long long addr, long long off, long long len, int lane,
                                         Live live) {
  if (len <= 0) return;
  const long long first = addr - (long long)((uintptr_t)(dsts[0] + addr) & 15);
  const long long end = addr + len;
  const long long chunks = (end - first + 15) >> 4;
  const uintptr_t from = (uintptr_t)src + (uintptr_t)(off - addr);  // arena offset x reads from + x
  for (long long c = lane; c < chunks; c += 32) {
    const long long x = first + 16 * c;
    const unsigned mask = live(x, range_mask(addr - x, end - x));
    if (!mask) continue;
    const uint4 v = load16(from + (uintptr_t)x, __ffs(mask) - 1, 32 - __clz(mask));
    for (int d = 0; d < ndst; ++d) store16((uintptr_t)dsts[d] + (uintptr_t)x, v, mask);
  }
}

// small route: a warp a run, the table in the parameter bank; a byte is written
// by the last run that covers it
template <int W>
__global__ void __launch_bounds__(NT) apply_small(const __grid_constant__ SmallTable<W> t) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int n = t.n;
  if (i >= n) return;
  const long long* addrs = t.w + t.ndst;
  const long long* lens = addrs + 2 * n;
  copy_run(t.w, t.ndst, t.src, addrs[i], addrs[n + i], lens[i], threadIdx.x & 31,
           [&](long long x, unsigned mask) {
             for (int j = i + 1; j < n && mask; ++j)
               mask &= ~range_mask(addrs[j] - x, addrs[j] + lens[j] - x);
             return mask;
           });
}

// large route, table: int64 [ndst + 4n] on the card: the destination
// pointers, then addrs, offs, lens, comp
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
apply_copy(const long long* __restrict__ table, int ndst, int n, const unsigned char* src,
           const int* __restrict__ owner) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long addr = table[ndst + i];
  const long long comp = table[ndst + 3 * (long long)n + i];
  copy_run(table, ndst, src, addr, table[ndst + (long long)n + i],
           table[ndst + 2 * (long long)n + i], threadIdx.x & 31, [&](long long x, unsigned mask) {
             if (comp >= 0) {
               for (unsigned m = mask; m; m &= m - 1) {
                 const int b = __ffs(m) - 1;
                 if (owner[comp + x + b - addr] != i) mask &= ~(1u << b);
               }
             }
             return mask;
           });
}

__global__ void apply_floor() {}

// the calling thread's current device set to `device` for a scope
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && device != cur) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

template <int W>
int launch_small(const long long* table, int ndst, int n, const void* src, cudaStream_t s) {
  SmallTable<W> t;
  t.src = static_cast<const unsigned char*>(src);
  t.ndst = ndst;
  t.n = n;
  memcpy(t.w, table, sizeof(long long) * (size_t)(ndst + 3 * n));
  const int warps = n < WARPS ? n : WARPS;
  apply_small<W><<<(n + warps - 1) / warps, 32 * warps, 0, s>>>(t);
  return cudaGetLastError();
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

// The small route.  table: int64 [ndst + 3n] in host memory, the destination
// pointers, then addrs, offs, lens; copied into the launch's parameters, so the
// caller may reuse it as soon as this returns.  src: the bytes the offsets
// index.  The launch runs asynchronously on `stream`, on `device`.
extern "C" int repro_apply_small(const void* table, int ndst, int n, const void* src, int device,
                                 void* stream) {
  if (n < 1 || ndst < 1 || ndst + 3LL * n > SMALL_WORDS) return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  const long long* tab = static_cast<const long long*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = ndst + 3 * n;
  if (words <= 32) return launch_small<32>(tab, ndst, n, src, s);
  if (words <= 256) return launch_small<256>(tab, ndst, n, src, s);
  if (words <= 1024) return launch_small<1024>(tab, ndst, n, src, s);
  return launch_small<SMALL_WORDS>(tab, ndst, n, src, s);
}

// the small route's largest table, in int64 words (the wrapper checks its own)
extern "C" int repro_apply_small_words() { return SMALL_WORDS; }

// The large route.  table: int64 [ndst + 4n] on the device (see apply_claim).
// owner: int32 [ucount] scratch, the compact bytes of the runs that share an
// interval (none when ucount is 0).  src: the bytes the offsets index.
extern "C" int repro_apply_runs(const void* table, int ndst, int n, const void* src, void* owner,
                                long long ucount, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || ndst < 1 || ucount < 0) return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
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

// An empty kernel's launch on `stream`: the floor under a small call's time.
extern "C" int repro_apply_floor(int device, void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  apply_floor<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
