// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile format's constants, the head-dim class a kernel is built for,
// exponentials on the special-function unit, operand conversions to
// wgmma's register-A form, the fp32 tf32 splits and transposes in shared
// memory, the named barriers by which two multiplying warpgroups take
// turns, and the clock counters of the diagnostic builds.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kRow = 128;        // bytes of a staged row: a 128-byte chunk of D (or of keys)
constexpr float kNeg = -1e30f;   // a masked score and an empty row's max; its logsumexp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The head-dim class an input of head dim d runs as: 16, 32, 64, 128 or
// 256. Columns d .. class - 1 are the TMA copy's zero fill; products over
// them add zero and the epilogues store only the first d.
inline int head_class(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// registers a multiplying thread may give to its accumulators, S (and dP)
// fragments and A operands (setmaxnreg gives it 232; the rest holds
// addresses, row statistics and loop state); mirrored by
// _kernels.FLASH_BWD_REG_BUDGET
constexpr int kRegBudget = 176;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0; 2^-inf is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An accumulator fragment (64 x N fp32: f[4j + e] is row 16 warp + g + 8
// (e >> 1), column 8j + 2 t4 + (e & 1)) as the register-A operand of the
// product over its N columns. bf16: K step k takes columns 16k .. 16k + 15
// as they are, rounded to bf16.
template <int N>
__device__ __forceinline__ void frag_to_bf16(const float (&f)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[k][i] = pack_bf16(f[8 * k + 2 * i], f[8 * k + 2 * i + 1]);
}
// tf32: K step j takes columns 8j .. 8j + 7 as tf32 hi and lo, column 2t
// fed as the A operand's column t and 2t + 1 as t + 4 (A's (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4)); B's K rows are permuted to match
// (key_pos)
template <int N>
__device__ __forceinline__ void frag_to_tf32(const float (&f)[N / 2], uint32_t (&hi)[N / 8][4],
                                             uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float v[4] = {f[4 * j], f[4 * j + 2], f[4 * j + 1], f[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[j][i] = to_tf32(v[i]);
      lo[j][i] = to_tf32(v[i] - __uint_as_float(hi[j][i]));
    }
  }
}

// fp32: `cells` 16-byte cells of hi, split in place into tf32 hi and, at
// the same offsets of lo, tf32(x - hi)
__device__ void split_cells(uint8_t* hi, uint8_t* lo, int cells, int tid, int nthr) {
  for (int i = tid; i < cells; i += nthr) {
    float4 v = reinterpret_cast<float4*>(hi)[i], r;
    float* a = reinterpret_cast<float*>(&v);
    float* b = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = __uint_as_float(to_tf32(a[e]));
      b[e] = __uint_as_float(to_tf32(a[e] - h));
      a[e] = h;
    }
    reinterpret_cast<float4*>(hi)[i] = v;
    reinterpret_cast<float4*>(lo)[i] = r;
  }
}

// fp32: rows [row0, row0 + n) of an operand landed as `chunks` chunks of
// `rows` rows, split in place into tf32 hi and, `lo_off` bytes on, lo
__device__ void split_rows(uint8_t* x, int lo_off, int chunks, int rows, int row0, int n, int tid,
                           int nthr) {
  for (int c = 0; c < chunks; ++c) {
    uint8_t* at = x + (c * rows + row0) * kRow;
    split_cells(at, at + lo_off, n * kRow / 16, tid, nthr);
  }
}

// The place of row r of a tile in a transposed copy: within each group of
// 8, row 2t goes to column t and row 2t + 1 to column t + 4, where the A
// operand of tf32 wgmma reads the fragment's columns 2t and 2t + 1
__device__ __forceinline__ int key_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// fp32: a landed tile of `rows` rows ((row, d) in DP / 32 chunks of 32 d,
// 128-byte swizzle) to its transpose as tf32 hi and lo ((d, row) rows of
// DP d in chunks of 32 rows, rows placed by key_pos, 128-byte swizzle; a
// tile of 16 rows fills half of each 128-byte row). With `lo` non-null the
// tile itself is split in place as well (hi in place, tf32(x - hi) at the
// same offsets of lo), each thread splitting the cells it transposes.
template <int DP>
__device__ void transpose_split(uint8_t* x, uint8_t* lo, uint8_t* t_hi, uint8_t* t_lo, int rows,
                                int tid, int nthr) {
  const int cells = DP / 32 * rows * 8;
  for (int i = tid; i < cells; i += nthr) {
    const int j = i & 7, r = (i >> 3) % rows, c = i / (8 * rows);
    float4* cell = reinterpret_cast<float4*>(x + c * rows * kRow + r * kRow + ((j ^ (r & 7)) << 4));
    float4 v = *cell, l;
    float* ve = reinterpret_cast<float*>(&v);
    float* le = reinterpret_cast<float*>(&l);
    const int kk = key_pos(r), kc = kk >> 5, ki = kk & 31;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 32 + 4 * j + e;
      const int off = kc * DP * kRow + d * kRow + (((ki >> 2) ^ (d & 7)) << 4) + 4 * (ki & 3);
      const float h = __uint_as_float(to_tf32(ve[e]));
      le[e] = __uint_as_float(to_tf32(ve[e] - h));
      ve[e] = h;
      *reinterpret_cast<float*>(t_hi + off) = h;
      *reinterpret_cast<float*>(t_lo + off) = le[e];
    }
    if (lo != nullptr) {
      *cell = v;
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(cell) - x + lo) = l;
    }
  }
}

// named barriers between the two multiplying warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// a barrier of one multiplying warpgroup's 128 threads (ids 3 and 4)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int s = 0; s < N; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// Clock counts of a kernel's steady passes for one thread of each
// multiplying warpgroup, summed over blocks into g[wg][0..7] (slot 7
// counts the passes): kept only in the diagnostic builds (-DFLASH_TRACE,
// -DFLASH_BWD_TRACE), a no-op otherwise.
template <bool kOn>
struct PassClock;
template <>
struct PassClock<true> {
  long long t = 0, sum[8] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void lap(int i) {
    const long long now = clock64();
    sum[i] += now - t;
    t = now;
  }
  __device__ void save(unsigned long long (*g)[8], int wg, int passes, bool keep) {
    sum[7] = passes;
    if (keep)
      for (int i = 0; i < 8; ++i) atomicAdd(&g[wg][i], (unsigned long long)sum[i]);
  }
};
template <>
struct PassClock<false> {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void save(unsigned long long (*)[8], int, int, bool) {}
};

// The sliced kernels (flash_fwd.cu flash_fwd_sliced_kernel, flash_bwd.cu
// flash_bwd_dq_sliced_kernel and flash_bwd_dkv_sliced_kernel): the head
// dims whose contraction the wgmma kernels cannot hold whole in shared
// memory (every d > 256, and d > 128 in the fp32 backward). S = Q K^T and
// dP = dO V^T are summed over slices of kCols columns of d, each slice of
// both operands staged as fp32 in shared memory, into the same fp32
// registers; the outputs are made in groups of kCols columns, one group a
// block, each block recomputing S (and dP) over the whole of d. Products on
// the CUDA cores in fp32: bf16 inputs are exact in fp32, and fp32 keeps
// fp32 accuracy without the TF32 splits. A block is 16 x 16 threads; thread
// (ty, tx) holds rows 4 ty .. 4 ty + 3 of a 64-row tile and columns tx +
// 16 j, so the 16 threads of a row are one half-warp (row reductions are
// four shuffles) and a column's 16 reads in a half-warp fall in 16 banks.
namespace sliced {

constexpr int kTile = 64;       // q rows and keys of a tile
constexpr int kCols = 128;      // columns of d in a slice, and in an output group
constexpr int kThreads = 256;
constexpr int kLd = kCols + 1;  // floats of a staged row (+1: a column's rows in distinct banks)
constexpr int kLdP = kTile + 1;
constexpr int kStage = kTile * kLd;  // floats of one staged 64 x 128 tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T (P and dS before their products, as the plain version does)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// rows [row0, row0 + 64) x columns [col0, col0 + 128) of a (rows, d)
// row-major matrix, as fp32 into dst (row stride kLd), zero outside it. d
// is a whole number of 16-byte vectors (the host's rule), so a vector lies
// wholly inside or outside the matrix.
template <typename T>
__device__ void stage(float* dst, const T* src, int row0, int rows, int col0, int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kCols / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int gr = row0 + r, gc = col0 + c;
    float* out = dst + r * kLd + c;
    if (gr < rows && gc < d) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + gc);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.f;
    }
  }
}

// s[i][j] += sum over the slice's columns of a[4 ty + i] . b[tx + 16 j]
__device__ __forceinline__ void add_products(float (&s)[4][4], const float* a, const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* ar = a + 4 * ty * kLd;
  const float* br = b + tx * kLd;
#pragma unroll 8
  for (int c = 0; c < kCols; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ar[i * kLd + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = br[16 * j * kLd + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum over the tile's 64 rows r of w[4 ty + i][r] * x[r][tx + 16 j]
// (w: a 64 x 64 tile of row stride kLdP; x: a staged group of kCols columns)
__device__ __forceinline__ void add_group(float (&acc)[4][8], const float* w, const float* x) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float wv[4], xv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(4 * ty + i) * kLdP + r];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = x[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

// the max and the sum of a row's 16 values, one per thread of a half-warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + 64) x columns [col0, col0 + 128) of acc into a (rows,
// d) matrix, what lies inside it
template <typename T>
__device__ void store_group(T* dst, const float (&acc)[4][8], int row0, int rows, int col0, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < d) dst[(size_t)r * d + c] = from_f<T>(acc[i][j]);
    }
  }
}

// shared memory of a sliced kernel, mirrored by _kernels.flash_sliced_smem
// (bytes): two staged tiles and one (forward, dQ) or two (dK/dV) 64 x 64
// tiles of P or dS, and dK/dV's per-column lse and delta
constexpr int smem_bytes(bool dkv) {
  return 4 * (2 * kStage + (dkv ? 2 : 1) * kTile * kLdP + (dkv ? 2 * kTile : 0));
}

struct Params {
  int sq, sk, d, causal, groups, n_tiles;
  float scale, scale_log2;
};

// the block's (batch*head, tile, group) of a 1-d grid: the group fastest,
// then the tile, the heaviest causal q tiles first where `reverse`
struct Block {
  long long bh;
  int tile, group;
  __device__ Block(const Params& p, bool reverse) {
    long long i = blockIdx.x;
    group = static_cast<int>(i % p.groups);
    i /= p.groups;
    const int t = static_cast<int>(i % p.n_tiles);
    tile = reverse ? p.n_tiles - 1 - t : t;
    bh = i / p.n_tiles;
  }
};

// the plan a sliced launch must be given: slices and groups of kCols
// columns covering d, and the kernel's shared memory; the grid (batch*head
// x tiles of `rows` x groups) within 2^31 blocks
inline cudaError_t check_plan(bool dkv, int bh, int rows, int d, int slices, int groups, int smem,
                              long long* blocks) {
  const int n = (d + kCols - 1) / kCols;
  if (slices != n || groups != n || smem != smem_bytes(dkv)) return cudaErrorInvalidValue;
  *blocks = (long long)bh * ((rows + kTile - 1) / kTile) * groups;
  return *blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

// raise a kernel's shared-memory limit, once per kernel (`raised` is the
// caller's, one per instantiation; never inside a graph capture)
template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool& raised) {
  if (raised) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) raised = true;
  return err;
}

}  // namespace sliced

}  // namespace
