// Single-query decode attention for Hopper (sm_90a), bf16: products on the
// tensor cores (mma.sync m16n8k16), K/V by cp.async into a three-stage ring.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:decode_attention
// for bf16 (fp32 goes to csrc/decode_attention.cu, whose products run in full
// fp32 on CUDA cores).  Contract: q [B,Hq,D], k/v [B,Hkv,S,D] bf16, contiguous;
// length [B] int32, key j of sequence b is visible when j < min(length[b], S);
// o [B,Hq,D] bf16, 0 for a row with no visible key (as the Pallas kernel).
// Query head h reads KV head h / (Hq / Hkv).
//
// What bounds it: bytes.  One query row per head does ~1 FLOP per byte of K/V,
// far below the card's ridge, so the least time is the live K/V bytes over
// 3.35 TB/s: ~17 MB at llama3.2-3b's decode (5 us), 8.4 MB at
// recurrentgemma-9b's (2.5 us).  The design is about bytes in flight:
//
//  - Parallelism that does not depend on S.  The split pass's grid is
//    (n_split, Hkv * row groups, B); the host picks n_split from B * Hkv and
//    the SM count so that the grid fills the SMs' resident blocks in one
//    wave (never more blocks than that, so no second wave), and each block
//    reads length[b] on the card and takes its even share of the live keys.
//    A 32768-slot cache with ~1056 live keys launches no empty block, and one
//    KV head with a 2048-slot ring (recurrentgemma-9b, B=4) runs 264 blocks.
//  - K/V stay bf16 in shared memory, in a ring of three stages of TK keys,
//    filled by 16-byte cp.async; the next two tiles load while one computes,
//    with one __syncthreads a tile.  Rows are stored with a 16-byte-chunk XOR
//    swizzle, so ldmatrix reads them without bank conflicts.
//  - Products on the tensor cores.  The (up to) 16 query heads of a KV group
//    are the 16 rows of m16n8k16 (recurrentgemma's G=16 fills them, llama's
//    G=3 is zero-padded; a group of more than 16 heads takes several row
//    groups).  Each warp owns 16 keys of a tile: S = Q K^T (fp32
//    accumulators), an online softmax in registers (exp2 of logits scaled by
//    scale * log2 e), P rounded to bf16 as the A operand of O += P V, which is
//    the rounding point of the bf16 flash kernels.  Q is read by ldmatrix
//    from shared memory each tile rather than held: at D=256 the 16 x 256
//    fp32 output already takes 128 registers a thread.
//  - At the end the block's warps merge their (m, l, O) in shared memory and
//    write one fp32 partial per (query head, split); a second, small kernel
//    merges the splits, eight warps each taking every eighth split so the
//    partials' loads are in flight together (66 splits at recurrentgemma-9b's
//    shape).  It is a programmatic dependent launch: its
//    blocks are scheduled while the split pass runs and wait on
//    griddepcontrol.wait, so no launch gap separates the two.  A split with
//    no keys writes (NEG_INF, 0) and a zero partial, which the merge weighs 0.
//
// Head dims 32, 64, 112, 128, 160 and 256: TK = 64 keys and four warps (32
// at D=160 and 256, two warps), so the ring is 96 KB at D=128 and 256 and two
// blocks fit an SM.  A row of 112 or 160 columns is 14 or 20 chunks of 16
// bytes: its row in shared memory takes whole groups of 8 chunks (16, 24), so
// the swizzle c ^ (r & 7) stays inside the row; the chunks past the real ones
// are never written or read.
#include "sm90.cuh"
#include "tile.cuh"

namespace {

using repro::NEG_INF;
using repro::sm90::pack_bf16;
using repro::sm90::smem_u32;

constexpr int STAGES = 3;
constexpr int ROWS = 16;  // query heads of a block: mma's M
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int TK = D > 128 ? 32 : 64;   // keys a stage
  static constexpr int NW = TK / 16;             // warps, 16 keys each
  static constexpr int NT = NW * 32;
  static constexpr int CPR = D / 8;              // 16-byte chunks a row
  static constexpr int ROW = (D >= 64 ? (CPR + 7) / 8 * 8 : CPR) * 16;  // bytes a row takes
  static constexpr int TILE = TK * ROW;          // bytes of a K or V tile
  static constexpr int QBYTES = ROWS * ROW;
  static constexpr int LDM = D + 4;              // fp32 row stride of the merge area
  static constexpr size_t SMEM = QBYTES + (size_t)STAGES * 2 * TILE;
  static_assert((size_t)NW * ROWS * (LDM + 2) * 4 <= (size_t)STAGES * 2 * TILE,
                "the merge area reuses the ring");
};

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile: chunk
// c ^ f(r), so the 8 rows an ldmatrix reads hit 8 different bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int x = D >= 64 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)(r * Cfg<D>::ROW + ((c ^ x) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8 fp32) += a (16 x 16 bf16) b (16 x 8 bf16).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (NT, 1): without the explicit minimum, ptxas capped D=64 at 96 registers
// and spilled; with it, 106 and no spill.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, int Hq, int Hkv,
                    int S, int n_split, float scale_log2) {
  using C = Cfg<D>;
  const int G = Hq / Hkv, RG = (G + ROWS - 1) / ROWS;
  const int split = blockIdx.x, hk = blockIdx.y / RG, rg = blockIdx.y % RG, b = blockIdx.z;
  const int h0 = hk * G + rg * ROWS;           // first query head of the block
  const int nrows = min(ROWS, G - rg * ROWS);  // its real rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Q (the block's heads, rows past nrows zero) into registers first: its
  // loads overlap the read of length[b], which everything else waits for
  constexpr int QPT = (ROWS * C::CPR + C::NT - 1) / C::NT;
  const __nv_bfloat16* qb = q + ((size_t)b * Hq + h0) * D;
  uint4 qv[QPT];
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = tid + e * C::NT, r = i / C::CPR, c = i % C::CPR;
    qv[e] = i < ROWS * C::CPR && r < nrows
                ? *reinterpret_cast<const uint4*>(qb + (size_t)r * D + c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  const int len = min(length[b], S);
  // the merge kernel may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int start = (int)((long long)len * split / n_split);
  const int end = (int)((long long)len * (split + 1) / n_split);
  if (start >= end) {  // no keys: (NEG_INF, 0) and a zero partial, which the merge weighs 0
    for (int i = tid; i < nrows * D; i += C::NT) {
      const size_t row = ((size_t)b * Hq + h0 + i / D) * n_split + split;
      part_acc[row * D + i % D] = 0.f;
      if (i % D == 0) {
        part_ml[row * 2] = NEG_INF;
        part_ml[row * 2 + 1] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = smem + C::QBYTES;  // stage s: K at 2 s TILE, V at (2 s + 1) TILE

  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * S * D;
  const int n_tiles = (end - start + C::TK - 1) / C::TK;
  auto load_tile = [&](int t, int stage) {
    unsigned char* ks = ring + (size_t)(2 * stage) * C::TILE;
    unsigned char* vs = ks + C::TILE;
    const int key0 = start + t * C::TK;
    for (int i = tid; i < C::TK * C::CPR; i += C::NT) {
      const int r = i / C::CPR, c = i % C::CPR;
      const bool ok = key0 + r < end;
      const size_t off = (size_t)(ok ? key0 + r : start) * D + c * 8;
      repro::cp_async16(ks + swz<D>(r, c), kb + off, ok ? 16 : 0);
      repro::cp_async16(vs + swz<D>(r, c), vb + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    repro::cp_async_commit();
  }
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = tid + e * C::NT;
    if (i < ROWS * C::CPR) *reinterpret_cast<uint4*>(Qs + swz<D>(i / C::CPR, i % C::CPR)) = qv[e];
  }

  // the warp's state for rows g = lane / 4 and g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t q_addr = smem_u32(Qs);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix rows of Q and V
  const int k_row = (lane & 7) + ((lane >> 4) & 1) * 8;   // and of K

  for (int t = 0; t < n_tiles; ++t) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1's stage is free
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    repro::cp_async_commit();

    const int kbase = start + t * C::TK + warp * 16;
    if (kbase >= end) continue;  // this warp's 16 keys are all past the split
    const uint32_t k_addr = smem_u32(ring + (size_t)(2 * (t % STAGES)) * C::TILE);
    const uint32_t v_addr = k_addr + C::TILE;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, q_addr + swz<D>(a_row, 2 * kk + (lane >> 4)));
      ldsm_x4(bk, k_addr + swz<D>(warp * 16 + k_row, 2 * kk + ((lane >> 3) & 1)));
      mma16816(s[0], a, bk[0], bk[1]);
      mma16816(s[1], a, bk[2], bk[3]);
    }

    // online softmax over the warp's 16 keys; element e of n-tile nt is row
    // g + 8 (e / 2), key kbase + 8 nt + 2 t4 + e % 2
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kbase + 8 * nt + 2 * t4 + (e & 1) < end;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG_INF ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // P (16 rows x 16 keys) in bf16: the S accumulators are its A fragment
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t bv[4];
      ldsm_x4_t(bv, v_addr + swz<D>(warp * 16 + a_row, 2 * j + (lane >> 4)));
      mma16816(acc[2 * j], pa, bv[0], bv[1]);
      mma16816(acc[2 * j + 1], pa, bv[2], bv[3]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the merge area

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* macc = reinterpret_cast<float*>(ring);      // [NW][ROWS][LDM]
  float* mml = macc + C::NW * ROWS * C::LDM;          // [NW][ROWS][2]
  float* wa = macc + warp * ROWS * C::LDM;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(wa + g * C::LDM + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(wa + (g + 8) * C::LDM + col) = make_float2(acc[j][2], acc[j][3]);
  }
  if (t4 == 0) {
    float* ml = mml + warp * ROWS * 2;
    ml[2 * g] = m[0];
    ml[2 * g + 1] = l[0];
    ml[2 * (g + 8)] = m[1];
    ml[2 * (g + 8) + 1] = l[1];
  }
  __syncthreads();
  // each row's weights once: mml's m becomes exp2(m - M), 0 for a warp with
  // no keys, and the row's (M, L) go out
  if (tid < nrows) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) M = fmaxf(M, mml[(w * ROWS + tid) * 2]);
#pragma unroll
    for (int w = 0; w < C::NW; ++w) {
      float* ml = mml + (w * ROWS + tid) * 2;
      ml[0] = exp2f(ml[0] - M);
      L = fmaf(ml[1], ml[0], L);
    }
    float* out = part_ml + (((size_t)b * Hq + h0 + tid) * n_split + split) * 2;
    out[0] = M;
    out[1] = L;
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += C::NT) {
    const int r = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < C::NW; ++w)
      a = fmaf(macc[(w * ROWS + r) * C::LDM + d], mml[(w * ROWS + r) * 2], a);
    part_acc[(((size_t)b * Hq + h0 + r) * n_split + split) * D + d] = a;
  }
}

// One block of 256 threads per (query head, batch) merges the splits.  Their
// m are log2-domain maxima.  The weights exp2(m - M) go to shared memory; then
// each warp takes every eighth split's partial, each lane VPL adjacent
// columns (D / 32 rounded up to a power of two: the lanes past D / VPL idle
// at D = 112 and 160), so the partials' loads are in flight together, and the
// eight warps' sums meet in shared memory.  A split with no keys (l = 0, a zero
// partial) weighs 0, so a row with no visible key gives 0.
constexpr int MERGE_NT = 256;

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < MERGE_NT / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is free again
  return v;
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

template <int D>
__global__ void __launch_bounds__(MERGE_NT)
decode_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    __nv_bfloat16* __restrict__ o, int Hq, int n_split) {
  constexpr int NW = MERGE_NT / 32, VPL = pow2_at_least((D + 31) / 32);
  extern __shared__ float wts[];  // [n_split]
  __shared__ float red[NW];
  __shared__ float sums[NW][D];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // launched early (programmatic dependent launch): wait for the split
  // pass to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t row = (size_t)b * Hq + h;
  const float* ml = part_ml + row * n_split * 2;
  float mx = NEG_INF;
  for (int c = tid; c < n_split; c += MERGE_NT)
    if (ml[2 * c + 1] > 0.f) mx = fmaxf(mx, ml[2 * c]);
  const float M = block_reduce(mx, true, red);
  float ls = 0.f;
  for (int c = tid; c < n_split; c += MERGE_NT) {
    const float l = ml[2 * c + 1], w = l > 0.f ? exp2f(ml[2 * c] - M) : 0.f;
    wts[c] = w;
    ls = fmaf(l, w, ls);
  }
  const float L = block_reduce(ls, false, red);  // its barrier also publishes wts

  float a[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) a[i] = 0.f;
  const bool active = D % (32 * VPL) == 0 || lane * VPL < D;  // a lane with columns
  const float* pa = part_acc + row * n_split * D + lane * VPL;
#pragma unroll 4
  for (int c = warp; active && c < n_split; c += NW) {
    const float w = wts[c];
    float v[VPL];
    if constexpr (VPL >= 4) {
#pragma unroll
      for (int i = 0; i < VPL; i += 4)
        *reinterpret_cast<float4*>(v + i) =
            *reinterpret_cast<const float4*>(pa + (size_t)c * D + i);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) v[i] = pa[(size_t)c * D + i];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) a[i] = fmaf(v[i], w, a[i]);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) sums[warp][lane * VPL + i] = a[i];
  }
  __syncthreads();
  for (int d = tid; d < D; d += MERGE_NT) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += sums[w][d];
    o[row * D + d] = __float2bfloat16(L > 0.f ? t / L : 0.f);
  }
}

// Raises the split kernel's dynamic shared-memory limit, once a device.
template <int D>
cudaError_t set_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg<D>::SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D>
int blocks_per_sm() {
  int n = 0;
  if (set_smem<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_split_kernel<D>, Cfg<D>::NT,
                                                    Cfg<D>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length, void* o,
                   float* part_ml, float* part_acc, int B, int Hq, int Hkv, int S, int n_split,
                   float scale, cudaStream_t stream) {
  cudaError_t err = set_smem<D>();
  if (err != cudaSuccess) return err;
  const int RG = (Hq / Hkv + ROWS - 1) / ROWS;
  decode_split_kernel<D><<<dim3(n_split, Hkv * RG, B), Cfg<D>::NT, Cfg<D>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), length, part_ml, part_acc, Hq, Hkv, S, n_split,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge kernel as a programmatic dependent launch: its blocks are
  // scheduled while the split pass runs, so no launch gap separates the two
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, B);
  cfg.blockDim = dim3(MERGE_NT);
  cfg.dynamicSmemBytes = n_split * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_merge_kernel<D>, static_cast<const float*>(part_ml),
                            static_cast<const float*>(part_acc),
                            static_cast<__nv_bfloat16*>(o), Hq, n_split);
}

}  // namespace

// Split blocks of head dim D that one SM holds at once (-1 on error): the
// wrapper picks n_split from it.
extern "C" int repro_decode_sm90_blocks_per_sm(int D) {
  switch (D) {
    case 32: return blocks_per_sm<32>();
    case 64: return blocks_per_sm<64>();
    case 112: return blocks_per_sm<112>();
    case 128: return blocks_per_sm<128>();
    case 160: return blocks_per_sm<160>();
    case 256: return blocks_per_sm<256>();
    default: return -1;
  }
}

// bf16 q, k, v, o; part_ml [B,Hq,n_split,2] and part_acc [B,Hq,n_split,D] are
// fp32 scratch.  Returns the cudaError_t of the launches (0 on success); the
// kernels run asynchronously.
extern "C" int repro_decode_attention_sm90(const void* q, const void* k, const void* v,
                                           const void* length, void* o, void* part_ml,
                                           void* part_acc, int B, int Hq, int Hkv, int S, int D,
                                           int n_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  switch (D) {
    case 32: return launch<32>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    case 64: return launch<64>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    case 112: return launch<112>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    case 128: return launch<128>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    case 160: return launch<160>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    case 256: return launch<256>(q, k, v, len, o, ml, acc, B, Hq, Hkv, S, n_split, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
