// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile format's constants, the head-dim class a kernel is built for,
// exponentials on the special-function unit, operand conversions to
// wgmma's register-A form, the fp32 tf32 splits and transposes in shared
// memory, the forward's online softmax, the dQ kernels' P and dS and the
// dK/dV kernels' P^T and dS^T (each kernel's class and wide modes share
// them), the named barriers by which two multiplying warpgroups take
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

// fp32: the four values of v split into tf32 hi (in place) and tf32(x - hi)
__device__ __forceinline__ void split4(float4& v, float4& r) {
  float* a = reinterpret_cast<float*>(&v);
  float* b = reinterpret_cast<float*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = __uint_as_float(to_tf32(a[e]));
    b[e] = __uint_as_float(to_tf32(a[e] - h));
    a[e] = h;
  }
}
// fp32: `cells` 16-byte cells of hi, split in place into tf32 hi and, at
// the same offsets of lo, tf32(x - hi)
__device__ void split_cells(uint8_t* hi, uint8_t* lo, int cells, int tid, int nthr) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  int i = tid;
  // two cells a step: both loads in flight before either is used
  for (; i + nthr < cells; i += 2 * nthr) {
    float4 v0 = h4[i], v1 = h4[i + nthr], r0, r1;
    split4(v0, r0);
    split4(v1, r1);
    h4[i] = v0;
    l4[i] = r0;
    h4[i + nthr] = v1;
    l4[i + nthr] = r1;
  }
  if (i < cells) {
    float4 v = h4[i], r;
    split4(v, r);
    h4[i] = v;
    l4[i] = r;
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
  auto cell_at = [&](int i) {
    const int j = i & 7, r = (i >> 3) % rows, c = i / (8 * rows);
    return reinterpret_cast<float4*>(x + c * rows * kRow + r * kRow + ((j ^ (r & 7)) << 4));
  };
  auto put = [&](int i, float4* cell, float4 v) {
    const int j = i & 7, r = (i >> 3) % rows, c = i / (8 * rows);
    float4 l;
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
  };
  int i = tid;
  // two cells a step: both loads in flight before either is used
  for (; i + nthr < cells; i += 2 * nthr) {
    float4* c0 = cell_at(i);
    float4* c1 = cell_at(i + nthr);
    const float4 v0 = *c0, v1 = *c1;
    put(i, c0, v0);
    put(i + nthr, c1, v1);
  }
  if (i < cells) {
    float4* c0 = cell_at(i);
    put(i, c0, *c0);
  }
}

// The online softmax of a kv tile on a warpgroup's S fragment of 64 rows by
// N keys (sc[4j + e] is row row0 + 8 (e >> 1), key kv0 + 8j + 2 t4 + (e &
// 1)), in the log2 domain: S scaled, masked (keys from sk on; causal: keys
// after row + offset), P = 2^(S - m) into sc, the rows' running max m and
// this thread's share of their sum l updated; the rows' rescale factors
// 2^(m_old - m) through corr. first_row is the warpgroup's first q row.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float scale_log2, int kv0,
                                               int sk, bool causal, int first_row, int row0,
                                               int offset, int t4) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sc[i] *= scale_log2;
  // the mask only on tiles that cross the end of the keys or the
  // diagonal, as a branch of its own: per element one compare against
  // the row's last allowed key
  if (kv0 + N > sk || (causal && kv0 + N - 1 > first_row + offset)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int last = (causal ? min(sk - 1, row0 + 8 * h + offset) : sk - 1) - (kv0 + 2 * t4);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e > last) sc[4 * j + 2 * h + e] = kNeg;
    }
  }
  // max and sum in 4 independent chains: the softmax's latency, not its
  // issue rate, sets its pace
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[4] = {kNeg, kNeg, kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mx[j & 3] = fmaxf(mx[j & 3], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    float rmax = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
    const float m_new = fmaxf(m[h], rmax);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    // a masked score is kNeg, so exp2(kNeg - m) is 0; in a row masked so
    // far m is kNeg too, and its entries are exp2(kNeg - 0) = 0
    const float m_use = m_new == kNeg ? 0.f : m_new;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = ex2(sc[4 * j + 2 * h + e] - m_use);
        sc[4 * j + 2 * h + e] = pv;
        sum[j & 3] += pv;
      }
    // this thread's share of the row; the quad's are added at the end
    l[h] = l[h] * corr[h] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// P^T and dS^T of a q tile on a warpgroup's S^T and dP^T fragments of 64
// keys by N q rows (sc[4j + e] is key key0 + 8 (e >> 1), q row q0 + 8j + 2
// t4 + (e & 1)), from the tile's staged lse (times log2 e; +inf beyond sq)
// and delta (rv[0 .. N), rv[N .. 2N)): P^T = 2^(S^T scale - lse), masked
// before the exponential (causal: q rows before key - offset), dS^T = P^T
// (dP^T - delta) scale; both to wgmma's A form (tf32 hi and lo in fp32).
// last_key is the warpgroup's last real key.
template <int N, bool kF32, int kA, int kLo>
__device__ __forceinline__ void p_and_ds_t(float (&sc)[N / 2], float (&dp)[N / 2],
                                           uint32_t (&pa)[kA][4], uint32_t (&plo)[kLo][4],
                                           uint32_t (&da)[kA][4], uint32_t (&dlo)[kLo][4],
                                           const float* rv, float scale_log2, float scale, int q0,
                                           int key0, int last_key, int offset, bool causal,
                                           int t4) {
  float2 dl[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rv + 8 * j + 2 * t4);
    dl[j] = *reinterpret_cast<const float2*>(rv + N + 8 * j + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[4 * j + 2 * h] = fmaf(sc[4 * j + 2 * h], scale_log2, -l2.x);
      sc[4 * j + 2 * h + 1] = fmaf(sc[4 * j + 2 * h + 1], scale_log2, -l2.y);
    }
  }
  // the causal mask only on tiles that cross the diagonal, as a branch of
  // its own: per element one compare against the key's first allowed q row
  if (causal && q0 + offset < last_key) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int first = key0 + 8 * h - offset - (q0 + 2 * t4);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < first) sc[4 * j + 2 * h + e] = -INFINITY;
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i2 = 4 * j + e;
      sc[i2] = ex2(sc[i2]);
      dp[i2] = sc[i2] * (dp[i2] - ((e & 1) ? dl[j].y : dl[j].x)) * scale;
    }
  if constexpr (kF32) {
    frag_to_tf32<N>(sc, pa, plo);
    frag_to_tf32<N>(dp, da, dlo);
  } else {
    frag_to_bf16<N>(sc, pa);
    frag_to_bf16<N>(dp, da);
  }
}

// P and dS of a kv tile on a warpgroup's S and dP fragments of 64 q rows by
// N keys (sc[4j + e] is row row0 + 8 (e >> 1), key kv0 + 8j + 2 t4 + (e &
// 1)), from the thread's two rows' lse (times log2 e) and delta: P = 2^(S
// scale - lse), masked before the exponential (keys from sk on; causal:
// keys after row + offset), dS = P (dP - delta) scale into dp, then to
// wgmma's A form (bf16: rounded; fp32: tf32 hi and lo). first_row is the
// warpgroup's first q row.
template <int N, bool kF32, int kA, int kLo>
__device__ __forceinline__ void p_and_ds_rows(float (&sc)[N / 2], float (&dp)[N / 2],
                                              uint32_t (&da)[kA][4], uint32_t (&dlo)[kLo][4],
                                              const float (&lse2)[2], const float (&dlt)[2],
                                              float scale_log2, float scale, int kv0, int sk,
                                              bool causal, int first_row, int row0, int offset,
                                              int t4) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sc[i] = fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]);
  // the mask only on tiles that cross the end of the keys or the
  // diagonal, as a branch of its own: per element one compare against
  // the row's last allowed key; a masked exponent of -inf gives P = 0
  if (kv0 + N > sk || (causal && kv0 + N - 1 > first_row + offset)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int last = (causal ? min(sk - 1, row0 + 8 * h + offset) : sk - 1) - (kv0 + 2 * t4);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e > last) sc[4 * j + 2 * h + e] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dp[i] = ex2(sc[i]) * (dp[i] - dlt[(i >> 1) & 1]) * scale;
  if constexpr (kF32)
    frag_to_tf32<N>(dp, da, dlo);
  else
    frag_to_bf16<N>(dp, da);
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

}  // namespace
