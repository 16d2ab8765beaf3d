// Segmented Fletcher-32 for Hopper (sm_90a): many byte strings in one call.
//
// Replaces the Pallas TPU kernels repro/kernels/log_checksum.py:fletcher32 and
// :fletcher32_wave (fletcher32 is the wave with one segment).  Contract: each
// segment is a byte string in device memory, read as little-endian 16-bit words
// (an odd tail's high byte is zero) and zero-padded to a multiple of 1024 words;
// its checksum is (s2 << 16) | s1, the value of the blade's fletcher32_padded.
//
// The TPU kernel threads an (s1, s2) carry through a sequential grid.  Hopper
// needs no carry: over a stream padded to N words, s1 = sum w_t and
// s2 = sum (N - t) w_t = N s1 - sum t w_t, both mod 65535.  So:
//   1. fletcher_tiles: one warp per 1024-word tile (2048 bytes), the tiles of
//      all segments numbered in one grid; a tile finds its segment by binary
//      search over the segments' first tiles.  Each lane reads four 16-byte
//      chunks (the warp reads 512 contiguous bytes at a time; bytes one at a
//      time at a segment's ragged or unaligned end) and sums w and t*w in
//      integers; a shuffle reduction gives the tile's sum w and sum t w (t the
//      word's offset in its segment), both reduced mod 65535.
//   2. fletcher_combine: one 1024-thread block per segment adds its tiles'
//      pairs and forms s1 and s2.
// Every sum is an exact integer, so the result is exact and the same on every
// run, whatever the order.  Partial sums stay far inside 64 bits: a lane's
// sum t w is below 2^36 before the mod, a segment's sum of reduced pairs below
// 2^16 times its tile count.
//
// What bounds it: bytes (each byte read once, 16 bytes a tile pair written and
// read back): 1 GiB in 0.32 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long MOD = 65535;
constexpr int TILE_BYTES = 2048;  // 1024 words: the padding unit
constexpr int NT = 256;           // 8 warps: 8 tiles per block
constexpr int NC = 1024;          // threads of a segment's combine block

__global__ void __launch_bounds__(NT)
fletcher_tiles(const long long* __restrict__ table, int nseg, long long ntiles,
               unsigned long long* __restrict__ part) {
  const long long* ptrs = table;
  const long long* nbytes = table + nseg;
  const long long* tile0 = table + 2 * nseg;
  const long long tile = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= ntiles) return;

  int lo = 0, hi = nseg - 1;  // the last segment whose first tile is <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile0[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const long long t_in_seg = tile - tile0[lo];
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(ptrs[lo]) + t_in_seg * TILE_BYTES;
  const long long rem = nbytes[lo] - t_in_seg * TILE_BYTES;  // bytes of the segment from p on
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;

  unsigned int a = 0;            // sum of w: < 32 * 2^16
  unsigned long long c = 0;      // sum of t w, t the word's offset in the tile
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int chunk = lane + 32 * r;  // 16-byte chunk of the tile: words chunk*8 ..
    const long long off = (long long)chunk * 16;
    unsigned int w[8];
    if (aligned && off + 16 <= rem) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + off);
      const unsigned int u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[2 * e] = u[e] & 0xFFFFu;
        w[2 * e + 1] = u[e] >> 16;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long b = off + 2 * e;
        const unsigned int lo_b = b < rem ? p[b] : 0u;
        const unsigned int hi_b = b + 1 < rem ? p[b + 1] : 0u;
        w[e] = lo_b | (hi_b << 8);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a += w[e];
      c += (unsigned long long)(chunk * 8 + e) * w[e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    // sum over the tile of (base + t) w, base the tile's first word in its segment
    const unsigned long long base = (unsigned long long)t_in_seg * (TILE_BYTES / 2);
    const unsigned long long am = a % MOD;
    part[2 * tile] = am;
    part[2 * tile + 1] = (c % MOD + (base % MOD) * am) % MOD;
  }
}

__global__ void __launch_bounds__(NC)
fletcher_combine(const long long* __restrict__ table, int nseg,
                 const unsigned long long* __restrict__ part, long long* __restrict__ out) {
  const long long* nbytes = table + nseg;
  const long long* tile0 = table + 2 * nseg;
  const int seg = blockIdx.x;
  const long long first = tile0[seg];
  const long long n = (nbytes[seg] + TILE_BYTES - 1) / TILE_BYTES;
  const long long tiles = n > 0 ? n : 1;  // an empty segment is one tile of zeros
  unsigned long long s1 = 0, st = 0;
  // unrolled so that a thread keeps several loads in flight: a 1 GiB segment
  // has 2^19 tiles, 512 a thread
#pragma unroll 8
  for (long long t = threadIdx.x; t < tiles; t += NC) {
    s1 += part[2 * (first + t)];
    st += part[2 * (first + t) + 1];
  }
  __shared__ unsigned long long r1[NC], rt[NC];
  r1[threadIdx.x] = s1;
  rt[threadIdx.x] = st;
  __syncthreads();
  for (int half = NC / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      r1[threadIdx.x] += r1[threadIdx.x + half];
      rt[threadIdx.x] += rt[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const unsigned long long a = r1[0] % MOD, sumtw = rt[0] % MOD;
    const unsigned long long words = (unsigned long long)tiles * (TILE_BYTES / 2);  // N
    const unsigned long long s2 = ((words % MOD) * a % MOD + MOD - sumtw) % MOD;
    out[seg] = (long long)((s2 << 16) | a);
  }
}

}  // namespace

// table: int64 [3, nseg] on the device: each segment's address, byte length and
// first tile (tiles numbered over all segments; a segment has
// max(1, ceil(bytes / 2048)) tiles, ntiles in all).  part: uint64 scratch
// [ntiles, 2].  out: int64 [nseg] checksums.  Returns the first cudaError_t of
// the two launches (0 on success); they run asynchronously, in order, on `stream`.
extern "C" int repro_fletcher32_wave(const void* table, int nseg, long long ntiles, void* part,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nseg < 1 || ntiles < nseg) return cudaErrorInvalidValue;
  const long long* tab = static_cast<const long long*>(table);
  unsigned long long* pt = static_cast<unsigned long long*>(part);
  fletcher_tiles<<<(unsigned)((ntiles + NT / 32 - 1) / (NT / 32)), NT, 0, s>>>(tab, nseg, ntiles,
                                                                              pt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fletcher_combine<<<nseg, NC, 0, s>>>(tab, nseg, pt, static_cast<long long*>(out));
  return cudaGetLastError();
}
