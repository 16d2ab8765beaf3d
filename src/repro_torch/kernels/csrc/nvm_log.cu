// The NVM blade's log work on Hopper (sm_90a): checksum verify and log replay
// over a blade arena that lives in device memory.
//
// No TPU kernel stands behind these two: the JAX package's simulator keeps the
// blade's arena in a host bytearray (repro/core/backend.py).  The port keeps
// the arena on the card, so the work the paper puts on the blade runs here.
//
// K1 repro_fletcher64_small / repro_fletcher64_large: Fletcher-64 over
//   little-endian 32-bit words of each byte segment of the arena, the segment
//   zero-padded to whole words from its own start: s1 = sum w_j, s2 = sum
//   (L - j) w_j, both mod M = 2^32 - 1, L the segment's word count; out = (s2 <<
//   32) | s1, bitwise the value of repro/core/oplog.py:fletcher64.  The blade's
//   reboot and replay call it on the bodies its checksum memo misses: 400
//   bodies of 21-1440 bytes after a 400-transaction log, one of 480 bytes after
//   a power loss mid-replay.  Their bytes take nanoseconds, so the launch bounds
//   such a call, and its time was the host's plan, a pinned allocation and a
//   copy around two launches.  At 1e5 segments of 0-4 KB (200 MB) the bytes
//   bound it.  The design answers both:
//   * one launch: the first blocks take the segments of up to LONG_BYTES, a
//     group of `lanes` lanes a segment, each group walking consecutive
//     segments, in at most as many blocks as the card holds at once; the last
//     `nlong` blocks one longer segment each.  32 lanes a segment while the
//     table fits one wave of the card at that width: the reboot's bodies then
//     wait on one segment's chain of loads and sums, which the widest group
//     shortens most (400 bodies: 0.0074 ms at 32 lanes, 0.0082 at 16, 0.0121
//     at 4), though a body under 128 bytes leaves lanes idle.  8 lanes past a
//     wave, where bytes bound and runs 4x as long a lane beat 32 lanes (1e5
//     bodies: 0.1047 ms against 0.129; H100 80GB HBM3 at 700 W);
//   * two routes for the segment table: small (repro_fletcher64_small) packs up
//     to SMALL_SEGMENTS segments, of which up to SMALL_LONG long, into the
//     launch's parameters as a __grid_constant__ struct (a start relative to
//     the span's lowest and a length, two uint32 a word): no copy, no
//     allocation.  large (repro_fletcher64_large): int64 starts, lens and long
//     indices on the card, staged by the wrapper in a kept pinned buffer;
//   * a lane owns a contiguous run of `per` words (a multiple of 4) and reads it
//     in 16-byte aligned chunks; five aligned words, of a chunk and the next
//     (carried in registers to the next step), give four unaligned ones by
//     selects and a funnel shift, and the ragged end is masked.  The lane sums S = sum w and
//     T = sum i w, i its local index, with one mul.wide a word and no modulo: a
//     run of at most RUN_WORDS = 2^14 words keeps S < 2^46 and T < 2^59.  Each
//     run is folded once, ((L - b) S - T) mod M for a run from word b, and the
//     group (or the block) adds the lanes' folded sums.
//   Bound: the launch at the reboot's shapes; bytes at 1e5 (each read once).
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
//   around the chunk, funnel-shifted into place (as K1's words4), and stores of
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

// segments longer than this take a block each (the wrapper's LONG_SEGMENT)
constexpr long long LONG_BYTES = 16 << 10;
// the small route's long segments, and the segments its parameters hold
constexpr int SMALL_LONG = 64;
constexpr int SMALL_SEGMENTS = 4075;
// the most words one lane sums before it folds them mod M
constexpr long long RUN_WORDS = 1 << 14;

__device__ __forceinline__ uint4 chunk_at(const uint4* __restrict__ c, long long i, long long n) {
  return i < n ? __ldg(c + i) : make_uint4(0u, 0u, 0u, 0u);
}

// the four words of the segment that start at aligned word q (0-3) of `cur`,
// byte shift sh: aligned words q .. q+4 of cur, nxt, funnel-shifted
__device__ __forceinline__ void words4(uint4 cur, uint4 nxt, int q, int sh, unsigned w[4]) {
  const unsigned u[8] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z, nxt.w};
  unsigned v[6], s[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = (q & 2) ? u[k + 2] : u[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) s[k] = (q & 1) ? v[k + 1] : v[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(s[k], s[k + 1], sh);
}

__device__ __forceinline__ void add4(const unsigned w[4], unsigned i, unsigned long long& S,
                                     unsigned long long& T) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    S += w[k];
    T += (unsigned long long)(i + k) * w[k];  // mul.wide.u32
  }
}

// lane `t` of `nt` lanes: its share of the segment p[0 .. len) as (sum w mod M,
// sum (L - j) w mod M); a lane's runs start at words t * per + r * per * nt
__device__ __forceinline__ void segment_sums(const unsigned char* p, long long len, int t, int nt,
                                             unsigned long long& s1, unsigned long long& s2) {
  s1 = s2 = 0;
  const long long L = (len + 3) >> 2;
  const long long full = len >> 2;  // words wholly inside the segment
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15);
  const uint4* chunks = reinterpret_cast<const uint4*>(a);
  const int r = (int)(reinterpret_cast<uintptr_t>(p) & 15);
  const int q = r >> 2, sh = 8 * (r & 3);
  const long long nchunk = (long long)((reinterpret_cast<uintptr_t>(p) + len - a + 15) >> 4);
  long long per = (((L + nt - 1) / nt) + 3) & ~3LL;
  if (per > RUN_WORDS) per = RUN_WORDS;
  const unsigned tail = (len & 3) ? (1u << (8 * (len & 3))) - 1u : ~0u;
  unsigned long long a1 = 0, a2 = 0;
  for (long long b = per * t; b < L; b += per * nt) {
    const long long e = b + per < L ? b + per : L;
    const int groups = (int)((e - b + 3) >> 2);
    const int fast = (int)(((e < full ? e : full) - b) >> 2);  // groups of whole words
    const long long c0 = b >> 2;                                 // the run's first chunk
    unsigned long long S = 0, T = 0;
    uint4 cur = chunk_at(chunks, c0, nchunk);
    int g = 0;
    for (; g + 4 <= fast; g += 4) {  // four chunks in flight
      uint4 nxt[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) nxt[u] = chunk_at(chunks, c0 + g + 1 + u, nchunk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unsigned w[4];
        words4(cur, nxt[u], q, sh, w);
        add4(w, 4u * (g + u), S, T);
        cur = nxt[u];
      }
    }
    for (; g < fast; ++g) {
      const uint4 nxt = chunk_at(chunks, c0 + g + 1, nchunk);
      unsigned w[4];
      words4(cur, nxt, q, sh, w);
      add4(w, 4u * g, S, T);
      cur = nxt;
    }
    if (g < groups) {  // the run's last group: words past its end, the segment's ragged word
      unsigned w[4];
      words4(cur, chunk_at(chunks, c0 + g + 1, nchunk), q, sh, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long j = b + 4LL * g + k;
        w[k] = j >= e ? 0u : j == full ? w[k] & tail : w[k];
      }
      add4(w, 4u * g, S, T);
    }
    a1 += mod_m(S);
    a2 = mod_m(a2 + mod_m(mod_m((unsigned long long)(L - b)) * mod_m(S)) + (M - mod_m(T)));
  }
  s1 = mod_m(a1);
  s2 = a2;
}

// sums over an aligned group of `g` lanes (a power of two, up to 32), the
// group's lanes `mask`
__device__ __forceinline__ void group_add(unsigned long long& x, unsigned long long& y, int g,
                                          unsigned mask) {
  for (int off = g >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(mask, x, off);
    y += __shfl_xor_sync(mask, y, off);
  }
}

// the small route's segment table, passed by value: segment k is base[start(k)
// .. + len(k)); longs: the segments longer than LONG_BYTES, in order
template <int S>
struct SegTable {
  const unsigned char* base;
  unsigned long long* out;
  int n, lanes, nlong, unused;
  unsigned short longs[SMALL_LONG];
  unsigned long long w[S];  // start relative to base | len << 32
  __device__ long long start(long long k) const { return (long long)(w[k] & 0xFFFFFFFFull); }
  __device__ long long len(long long k) const { return (long long)(w[k] >> 32); }
  __device__ long long long_seg(int i) const { return longs[i]; }
};
static_assert(sizeof(SegTable<SMALL_SEGMENTS>) <= 32764, "the parameter space holds 32,764 bytes");

// the large route's: int64 starts[n], lens[n], long indices[nlong] on the card
struct SegArray {
  const unsigned char* base;
  unsigned long long* out;
  long long n;
  int lanes, nlong;
  const long long* tab;
  __device__ long long start(long long k) const { return tab[k]; }
  __device__ long long len(long long k) const { return tab[n + k]; }
  __device__ long long long_seg(int i) const { return tab[2 * n + i]; }
};

// blocks [0, grid - nlong): a group of `lanes` lanes walks consecutive
// segments, the long ones skipped, the groups splitting the table evenly;
// the last nlong blocks: one long segment each
template <class Tab>
__global__ void __launch_bounds__(NT, 4) fletcher64_segments(const __grid_constant__ Tab t) {
  const int short_blocks = (int)gridDim.x - t.nlong;
  unsigned long long s1, s2;
  if ((int)blockIdx.x >= short_blocks) {
    const long long k = t.long_seg((int)blockIdx.x - short_blocks);
    segment_sums(t.base + t.start(k), t.len(k), threadIdx.x, NT, s1, s2);
    group_add(s1, s2, 32, 0xffffffffu);
    __shared__ unsigned long long r1[WARPS], r2[WARPS];
    if ((threadIdx.x & 31) == 0) {
      r1[threadIdx.x >> 5] = s1;
      r2[threadIdx.x >> 5] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long a = 0, b = 0;
      for (int w = 0; w < WARPS; ++w) {
        a += r1[w];
        b += r2[w];
      }
      t.out[k] = (mod_m(b) << 32) | mod_m(a);
    }
    return;
  }
  const int g = t.lanes;
  const long long groups = (long long)short_blocks * (NT / g);
  const long long group = (long long)blockIdx.x * (NT / g) + threadIdx.x / g;
  const long long each = ((long long)t.n + groups - 1) / groups;
  const long long end = (group + 1) * each < t.n ? (group + 1) * each : (long long)t.n;
  const int lane = threadIdx.x & (g - 1);
  const unsigned mask = g == 32 ? 0xffffffffu : ((1u << g) - 1u) << ((threadIdx.x & 31) & ~(g - 1));
  for (long long k = group * each; k < end; ++k) {  // the same walk for every lane of a group
    const long long len = t.len(k);
    if (len > LONG_BYTES) continue;
    segment_sums(t.base + t.start(k), len, lane, g, s1, s2);
    group_add(s1, s2, g, mask);
    if (lane == 0) t.out[k] = (mod_m(s2) << 32) | mod_m(s1);
  }
}

// the blocks of 256 threads the card holds at once, found at the first launch
template <class Tab>
int resident_blocks() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fletcher64_segments<Tab>, NT, 0) !=
            cudaSuccess)
      return -1;
    resident = sms * (per > 0 ? per : 1);
  }
  return resident;
}

// K1's grid for `n` segments of which `nlong` long: the short segments' groups
// in at most the blocks the card holds at once, then a block a long segment;
// lanes: the groups' width, 32 while the short segments, 32 lanes each, fit
// the threads the card holds at once (one wave: the launch waits on one
// segment's chain of loads and sums, which 32 lanes shorten most), else 8
// (more than a wave: the bytes bound, and runs 4x as long a lane beat 32
// lanes).  -1 where the card could not be asked.
template <class Tab>
long long segment_grid(long long n, int nlong, int& lanes) {
  const int resident = resident_blocks<Tab>();
  if (resident < 0) return -1;
  lanes = 32 * (n - nlong) <= (long long)resident * NT ? 32 : 8;
  const long long need = (n + NT / lanes - 1) / (NT / lanes);
  return (need < resident ? need : resident) + nlong;
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

// the small route's launch: the table (start relative to base | len << 32, in
// host memory) copied into the parameters with the long segments' indices and
// the groups' width; the kernel reads nothing else of the host
template <int S>
int launch_segments(const unsigned long long* table, int n, const void* base, void* out,
                    cudaStream_t s) {
  SegTable<S> t;
  t.base = static_cast<const unsigned char*>(base);
  t.out = static_cast<unsigned long long*>(out);
  t.n = n;
  t.unused = 0;
  int nlong = 0;
  for (int k = 0; k < n; ++k) {
    t.w[k] = table[k];
    if ((long long)(table[k] >> 32) <= LONG_BYTES) continue;
    if (nlong == SMALL_LONG) return cudaErrorInvalidValue;
    t.longs[nlong++] = (unsigned short)k;
  }
  t.nlong = nlong;
  const long long grid = segment_grid<SegTable<S>>(n, nlong, t.lanes);
  if (grid < 0) return cudaGetLastError();
  fletcher64_segments<SegTable<S>><<<(unsigned)grid, NT, 0, s>>>(t);
  return cudaGetLastError();
}

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

// K1's small route.  table: uint64 [n] in host memory, segment k's start
// relative to `base` in the low 32 bits and its length in the high 32; at most
// SMALL_LONG of them longer than LONG_BYTES.  out: uint64 [n] on the device.  The
// table is copied into the launch's parameters, so the caller may reuse it as
// soon as this returns; the launch runs asynchronously on `stream`, on `device`.
extern "C" int repro_fletcher64_small(const void* table, int n, const void* base, void* out,
                                      int device, void* stream) {
  if (n < 1 || n > SMALL_SEGMENTS) return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  const unsigned long long* tab = static_cast<const unsigned long long*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch_segments<16>(tab, n, base, out, s);
  if (n <= 128) return launch_segments<128>(tab, n, base, out, s);
  if (n <= 1024) return launch_segments<1024>(tab, n, base, out, s);
  return launch_segments<SMALL_SEGMENTS>(tab, n, base, out, s);
}

// K1's large route.  tab: int64 [2n + nlong] on the device, the starts (byte
// offsets from `base`), the lengths, then the indices of the nlong segments
// longer than LONG_BYTES.
extern "C" int repro_fletcher64_large(const void* tab, long long n, int nlong, const void* base,
                                      void* out, int device, void* stream) {
  if (n < 1 || nlong < 0 || nlong > n) return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  SegArray t;
  const long long grid = segment_grid<SegArray>(n, nlong, t.lanes);
  if (grid < 0) return cudaGetLastError();
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  t.base = static_cast<const unsigned char*>(base);
  t.out = static_cast<unsigned long long*>(out);
  t.n = n;
  t.nlong = nlong;
  t.tab = static_cast<const long long*>(tab);
  fletcher64_segments<SegArray><<<(unsigned)grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}

// K1's layout, for the wrapper's check: SMALL_SEGMENTS, SMALL_LONG, LONG_BYTES,
// RUN_WORDS
extern "C" void repro_fletcher64_layout(long long* out) {
  out[0] = SMALL_SEGMENTS;
  out[1] = SMALL_LONG;
  out[2] = LONG_BYTES;
  out[3] = RUN_WORDS;
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
