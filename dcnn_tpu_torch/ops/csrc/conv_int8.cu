// int8 x int8 -> int32 2-D convolution on Hopper's int8 tensor cores
// (sm_90a: wgmma, TMA, mbarriers), with a plain C interface bound from
// Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/conv.py::conv2d_int8, the JAX package's int8 conv
// (lax.conv_general_dilated with preferred_element_type=int32, which XLA
// lowers onto the TPU's int8 matrix unit), and, in its fused mode, the
// whole int8 conv layer around it (dcnn_tpu/nn/quantize.py
// QuantConv2DLayer.apply: quantize, int8 conv, dequantize). It is no Pallas
// kernel, but no PyTorch call computes either function on the card, so the
// port writes it. One template, two functions:
//
// (A) int8 x (any strides, so NCHW and NHWC) and OIHW int8 w -> int32 y:
//   y[n, o, p, q] = sum_{c, r, s} x[n, c, p*sh + r - ph, q*sw + s - pw] * w[o, c, r, s]
// with reads outside the image taken as 0. Integer sums are exact in any
// order, so the kernel equals its plain version (a float64 conv cast to
// int32) bit for bit.
//
// (B) the fused layer: float x (fp32 or bf16) -> float y of x's type:
//   prologue: xq = clamp(rint(x / x_scale), -127, 127) as int8 (IEEE
//             division, round half to even: quantize_symmetric);
//   products: the exact int32 sums of (A) on xq;
//   epilogue: y = int2float(acc) * s[o] + b[o], s = x_scale * w_scale
//             rounded once (by the caller), each step rounded to fp32, then
//             cast to x's type (round to nearest even for bf16).
// Every float step is an explicit intrinsic (__fdiv_rn, __fmul_rn,
// __fadd_rn), so no FMA is contracted and (B) equals the unfused chain
// (quantize_symmetric -> (A) -> the layer's dequantize) bit for bit.
// Clamping before rounding equals rounding before clamping, the bounds
// being integers. The division takes a fast path (without it the fused
// mode takes about 40% longer over ResNet-18's sites at B=256 on an H100):
// x is multiplied by 1/s rounded down
// and up (by 2^-20, far more than the products' rounding), and where the
// two quotients round and clamp to the same integer, the exact quotient,
// which lies between them, does too; elsewhere (within 2^-20 of a
// half-integer) the kernel divides. A NaN input quantizes to -127 here;
// the chain's NaN -> int8 cast is undefined.
//
// Design: an implicit GEMM. Rows (M) are the output pixels n*P*Q, columns
// (N) the output channels, and the reduction (K) runs over slices of cs
// input channels (cs = C, or 128 where C is a larger multiple of 128),
// each slice over (r, s, channel) in that order, so that for channels-last
// input 16 values of K are 16 neighbouring channels of one input pixel. A
// tile is 128 pixels by BN (64 or 128) channels, and K runs in chunks of
// 128 bytes (a slice padded to whole chunks): one 128-byte row per pixel
// and per channel, in the 128-byte swizzle wgmma reads by descriptor. The
// weights come packed once by the caller in that order (pack_int8_weight:
// (Opad, Kp), zero past each slice and past O), so their copies never
// leave the tensor.
//
// One block of 512 threads: warpgroups 0-1 copy, 2-3 multiply. Each
// multiplying warpgroup owns 64 rows of the tile: per stage it waits on
// the stage's full barrier, issues 4 wgmma m64nBNk32 s8 (A and B from
// shared memory by descriptor), keeps one group in flight and frees the
// previous stage on its empty barrier. The copying thread 0 of a stage's
// warpgroup loads its weight tile by TMA (a 2-D map over the packed
// weights) onto the full barrier; its A tile comes one of two ways
// (_kernels.conv_int8_plan picks, and the ring's depth):
// - direct (int8 input, 1x1 kernels, boxes above the halo's room): the
//   copying warpgroups take the stages in turn, so two stages' loads are
//   in flight; for its stage a warpgroup loads the A tile (each thread 8 of
//   its 1024 16-byte units: one K unit of 8 pixel rows) from x through its
//   strides into registers before it waits for the stage to be free, then
//   quantizes (mode B), stores the units swizzled, fences them for the
//   async proxy and arrives;
// - from a halo (float input, kernels with more than one tap): a tile's
//   taps read overlapping input, so per slice the input box the tile reads
//   is loaded and quantized once into shared memory and each stage is
//   built from it, shifted per tap (produce_halo).
// A unit is one 16-byte load (int8), two (bf16) or four (fp32) where the
// channels are contiguous, C % 16 == 0 and the strides keep the loads
// aligned; otherwise it is gathered value by value (the stem's C = 3, NCHW
// input).
//
// Blocks are persistent over the work items (tile, K range). Where the
// tiles are fewer than the SMs (ResNet-18's layers 3-4 at B=32), K is split
// across blocks: each writes its int32 partial sums to a workspace and
// conv_int8_reduce adds them in split order and applies the epilogue.
// int32 sums are exact in any order, so the result does not depend on the
// split. The epilogue stores straight from the accumulators, two
// neighbouring channels at once where they are adjacent in memory.
//
// What bounds it on an H100: at ResNet-18's body shapes, operations (the
// int8 tensor cores' 1,979 TOP/s dense against 3.35 TB/s of HBM) for the
// products, the output's bytes at the shallow sites and the stem. It
// reaches 10-20% of that: 128x128 tiles read A and B through L2 at 64
// products a byte, and a one-chunk tile (the stem) pays a fixed cost that
// no ring depth hides (PERF.md section 6).

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kTileM = 128;                  // output pixels per tile: two 64-row slabs
constexpr int kChunk = 128;                  // bytes (int8 values) of K per stage
constexpr int kThreads = 512;                // warpgroups 0-1 copy, 2-3 multiply
constexpr int kABytes = kTileM * kChunk;     // one stage's A tile
constexpr int kUnits = kTileM * kChunk / 16 / 128;  // 16-byte units per copying thread: 8
constexpr int kMaxStages = 8;

__host__ __device__ constexpr int smem_bytes(int bn, int stages, int halo) {
  // 1024 bytes of slack to align the base for the 128-byte swizzle, then
  // the stages' A tiles, their weight tiles, two halo buffers (halo bytes
  // each, a multiple of 1024) and the barriers
  return 1024 + stages * (kABytes + bn * kChunk) + 2 * halo + 256;
}

struct Params {
  const void* x;        // input: int8 (A), fp32 or bf16 (B), through strides
  const float* xscale;  // (B): the calibrated input scale, a device scalar
  const float* scale;   // (B): x_scale * w_scale per output channel
  const float* bias;    // (B): per output channel, or null
  void* y;              // output through strides: int32 (A), x's type (B)
  int32_t* ws;          // split K: int32 partial sums (ksplit, m, o), else null
  int n, c, h, w, o, p, q, r, s, sh, sw, ph, pw;
  int xn, xc, xh, xw;   // input strides, elements (every offset below 2^31)
  int yn, yc, yh, yw;   // output strides, elements
  int k, m;             // K = r s c; M = n p q
  // K runs over slices of cs channels (cs = c, or 128 where c is a larger
  // multiple of 128), each (r, s, channel) in that order, kslice = r s cs
  // values, padded to cps whole chunks
  int cs, kslice, cps;
  int chunks, ksplit, tiles_n, works, stages;
  int halo;             // bytes of each halo buffer, 0: A read straight from x
  int ypair;            // 1: channels o, o+1 (o even) adjacent and aligned
};

struct Work {
  int mt, nt, ks, c0, c1;  // tile of M and of N, K split, its chunks [c0, c1)
};

// work = (mt * ksplit + ks) * tiles_n + nt: the channel tiles of one pixel
// tile run side by side and share its input through L2
__device__ __forceinline__ Work decode(const Params& p, int work) {
  Work k;
  k.nt = work % p.tiles_n;
  const int t = work / p.tiles_n;
  k.ks = t % p.ksplit;
  k.mt = t / p.ksplit;
  k.c0 = (int)((long long)k.ks * p.chunks / p.ksplit);
  k.c1 = (int)((long long)(k.ks + 1) * p.chunks / p.ksplit);
  return k;
}

// Where the 16 K values [k0, k0 + 16) of chunk kc, 16-byte unit `unit`, lie
// in the input: k0 within its slice, tap (r, s) and channel cl within the
// slice of the first value, the slice's first channel cb; ok = k0 < kslice
struct KPlace {
  int k0, r, s, cl, cb;
  bool ok;
};
__device__ __forceinline__ KPlace kplace(const Params& p, int kc, int unit) {
  const int slice = kc / p.cps;
  KPlace t;
  t.k0 = (kc - slice * p.cps) * kChunk + 16 * unit;
  t.cb = slice * p.cs;
  t.ok = t.k0 < p.kslice;
  t.r = t.s = t.cl = 0;
  if (t.ok) {
    const int tap = t.k0 / p.cs;
    t.cl = t.k0 - tap * p.cs;
    t.r = tap / p.s;
    t.s = tap - t.r * p.s;
  }
  return t;
}

// Mode (B)'s prologue: quantize_symmetric of one value, bit for bit (see
// the top of the file for the fast path's argument)
struct Quant {
  float s, rlo, rhi;
  bool fast;
  __device__ __forceinline__ void init(const float* xs) {
    s = *xs;
    const float r = __frcp_rn(s);
    rlo = __fmul_rn(r, 1.f - 0x1p-20f);
    rhi = __fmul_rn(r, 1.f + 0x1p-20f);
    // 1/s rounded both ways keeps its relative error only for normal r
    fast = rhi < 1e30f && rlo > 1e-30f;
  }
  __device__ __forceinline__ uint32_t operator()(float x) const {
    int a = __float2int_rn(fminf(fmaxf(__fmul_rn(x, rlo), -127.f), 127.f));
    const int b = __float2int_rn(fminf(fmaxf(__fmul_rn(x, rhi), -127.f), 127.f));
    if (a != b || !fast) a = __float2int_rn(fminf(fmaxf(__fdiv_rn(x, s), -127.f), 127.f));
    return (uint32_t)a & 0xffu;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 values (fp32 or bf16, as raw 16-byte words) -> 16 int8 in a uint4
template <typename T>
__device__ __forceinline__ uint4 quantize16(const uint4* raw, const Quant& qt) {
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte word
  uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const T* v = reinterpret_cast<const T*>(&raw[e / kPer]);
    out[e >> 2] |= qt(to_f32(v[e % kPer])) << (8 * (e & 3));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The copying thread's 8 pixel rows of the current tile: the offset of
// its image and the top-left input coordinates of its window (a row beyond
// M gets coordinates no bounds test passes)
struct Rows {
  int base[kUnits], ih[kUnits], iw[kUnits];
  __device__ __forceinline__ void set(const Params& p, int mt, int row0) {
    const int pq = p.p * p.q;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int m = mt * kTileM + row0 + 16 * i;
      base[i] = 0, ih[i] = -(1 << 29), iw[i] = 0;
      if (m < p.m) {
        const int n = m / pq, rem = m - n * pq, pp = rem / p.q, qq = rem - pp * p.q;
        base[i] = n * p.xn;
        ih[i] = pp * p.sh - p.ph;
        iw[i] = qq * p.sw - p.pw;
      }
    }
  }
};

// Vector copies: the 16-byte K unit at k0 is 16 channels c0.. of tap (r, s)
template <typename T>
struct VecUnit {
  static constexpr int kWords = sizeof(T);  // 16-byte words a unit: 1, 2, 4
  uint4 raw[kWords];
  __device__ __forceinline__ void load(const Params& p, const T* x, const Rows& rw, int i,
                                       const KPlace& kp) {
    const int ih = rw.ih[i] + kp.r, iw = rw.iw[i] + kp.s;
    if (kp.ok && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w) {
      const uint4* src = reinterpret_cast<const uint4*>(x + rw.base[i] + ih * p.xh + iw * p.xw +
                                                        kp.cb + kp.cl);
#pragma unroll
      for (int v = 0; v < kWords; ++v) raw[v] = __ldg(src + v);
    } else {
#pragma unroll
      for (int v = 0; v < kWords; ++v) raw[v] = make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void load_at(const T* src) {
#pragma unroll
    for (int v = 0; v < kWords; ++v) raw[v] = __ldg(reinterpret_cast<const uint4*>(src) + v);
  }
  __device__ __forceinline__ uint4 bytes(const Quant& qt) const {
    if constexpr (sizeof(T) == 1) return raw[0];
    else return quantize16<T>(raw, qt);
  }
};

// Gathered copies: the 16 values of K [k0, k0 + 16) one by one, through
// every stride, zero past K and outside the image
template <typename T>
struct GatherUnit {
  using V = typename std::conditional<sizeof(T) == 1, int, float>::type;
  V v[16];
  __device__ __forceinline__ void load(const Params& p, const T* x, const Rows& rw, int i,
                                       const KPlace& kp) {
    int r = kp.r, s = kp.s, c = kp.cl;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int ih = rw.ih[i] + r, iw = rw.iw[i] + s;
      v[e] = 0;
      if (kp.k0 + e < p.kslice && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w) {
        const T t = x[rw.base[i] + (kp.cb + c) * p.xc + ih * p.xh + iw * p.xw];
        if constexpr (sizeof(T) == 1) v[e] = t;
        else v[e] = to_f32(t);
      }
      if (++c == p.cs) {
        c = 0;
        if (++s == p.s) s = 0, ++r;
      }
    }
  }
  __device__ __forceinline__ uint4 bytes(const Quant& qt) const {
    uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      uint32_t b;
      if constexpr (sizeof(T) == 1) b = (uint32_t)v[e] & 0xffu;
      else b = qt(v[e]);
      out[e >> 2] |= b << (8 * (e & 3));
    }
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
};

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// the accumulators live and in place across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the epilogue's value of an int32 sum at output channel o: (A) the sum,
// (B) its dequantization, rounded step by step
__device__ __forceinline__ float dequant(const Params& p, int o, int v) {
  float f = __fmul_rn(__int2float_rn(v), __ldg(p.scale + o));
  if (p.bias != nullptr) f = __fadd_rn(f, __ldg(p.bias + o));
  return f;
}
__device__ __forceinline__ void put(int32_t* y, int v, const Params&, int) { *y = v; }
__device__ __forceinline__ void put(float* y, int v, const Params& p, int o) { *y = dequant(p, o, v); }
__device__ __forceinline__ void put(__nv_bfloat16* y, int v, const Params& p, int o) {
  *y = __float2bfloat16_rn(dequant(p, o, v));
}
__device__ __forceinline__ void put2(int32_t* y, int v0, int v1, const Params&, int) {
  *reinterpret_cast<int2*>(y) = make_int2(v0, v1);
}
__device__ __forceinline__ void put2(float* y, int v0, int v1, const Params& p, int o) {
  *reinterpret_cast<float2*>(y) = make_float2(dequant(p, o, v0), dequant(p, o + 1, v1));
}
__device__ __forceinline__ void put2(__nv_bfloat16* y, int v0, int v1, const Params& p, int o) {
  __nv_bfloat162 b;
  b.x = __float2bfloat16_rn(dequant(p, o, v0));
  b.y = __float2bfloat16_rn(dequant(p, o + 1, v1));
  *reinterpret_cast<__nv_bfloat162*>(y) = b;
}

// channels o, o+1 of one output element row (o even)
template <typename TO>
__device__ __forceinline__ void store_pair(TO* row, const Params& p, int o, int v0, int v1,
                                           int ystride, bool pair) {
  if (o >= p.o) return;
  if (pair && o + 1 < p.o) {
    put2(row + o, v0, v1, p, o);
  } else {
    put(row + (long long)o * ystride, v0, p, o);
    if (o + 1 < p.o) put(row + (long long)(o + 1) * ystride, v1, p, o + 1);
  }
}

template <typename T>
struct OutOf {
  using type = T;  // (B): x's type
};
template <>
struct OutOf<int8_t> {
  using type = int32_t;  // (A)
};

// The direct copies: the two copying warpgroups fill the stages in turn
// (stage g by warpgroup g % 2), each thread 8 units of its stage straight
// from x, loaded before the stage is free
template <typename T, int BN, bool kVec>
__device__ __forceinline__ void produce_direct(const Params& p, const CUtensorMap* wmap,
                                               uint8_t* atiles, uint8_t* btiles, uint64_t* full,
                                               uint64_t* empty, int tid) {
  const int pw = tid >> 7, ptid = tid & 127, lane = tid & 31;
  const int unit = ptid & 7, row0 = ptid >> 3;
  // every row this thread stores has the same swizzled column: row % 8 = row0 % 8
  const uint32_t col = (uint32_t)((unit ^ (row0 & 7)) << 4) + row0 * kChunk;
  const T* x = static_cast<const T*>(p.x);
  Quant qt;
  if constexpr (sizeof(T) > 1) qt.init(p.xscale);
  Rows rw;
  // units loaded per batch before they are stored: as many as keep the
  // loads in flight without spilling (fp32 vector units are 64 bytes, a
  // gathered unit 16 registers; int8 gathers keep 2 beside the bytes)
  constexpr int kB = kVec ? (sizeof(T) < 4 ? 8 : 4) : (sizeof(T) == 1 ? 2 : 4);
  using Unit = typename std::conditional<kVec, VecUnit<T>, GatherUnit<T>>::type;
  int g = 0;  // the block's stage sequence, across its work items
  for (int work = blockIdx.x; work < p.works; work += gridDim.x) {
    const Work k = decode(p, work);
    rw.set(p, k.mt, row0);
    for (int kc = k.c0; kc < k.c1; ++kc, ++g) {
      if ((g & 1) != pw) continue;
      const int st = g % p.stages;
      const uint32_t ph = (uint32_t)(g / p.stages) & 1u;
      const KPlace kp = kplace(p, kc, unit);
      const uint32_t dst = smem_u32(atiles + st * kABytes) + col;
#pragma unroll
      for (int b0 = 0; b0 < kUnits; b0 += kB) {
        Unit u[kB];
#pragma unroll
        for (int j = 0; j < kB; ++j) u[j].load(p, x, rw, b0 + j, kp);
        if (b0 == 0) {
          // the loads are in flight; now the stage must be free
          wait_or_trap(empty + st, ph ^ 1u);
          if (ptid == 0) {
            mbar_expect_tx(full + st, BN * kChunk);
            tma_load_2d(smem_u32(btiles + st * BN * kChunk), wmap, full + st, kc * kChunk,
                        k.nt * BN);
          }
        }
#pragma unroll
        for (int j = 0; j < kB; ++j) st_shared16(dst + (b0 + j) * 16 * kChunk, u[j].bytes(qt));
      }
      fence_proxy_async();  // the stores, before wgmma reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(full + st);
    }
  }
}

// The input region a tile's products read, for the halo copies: images
// n0 .. n0 + imgs - 1, input rows lo .. lo + rows - 1 of each (all of
// them where the tile spans images), every column. _kernels.int8_halo
// computes the same on the host.
struct HaloBox {
  int n0, imgs, lo, rows;
};
__host__ __device__ __forceinline__ HaloBox halo_box(const Params& p, int mt) {
  const int pq = p.p * p.q;
  const int m0 = mt * kTileM, m1 = (m0 + kTileM < p.m ? m0 + kTileM : p.m) - 1;
  const int n0 = m0 / pq, n1 = m1 / pq;
  int lo = -p.ph, hi = (p.p - 1) * p.sh - p.ph + p.r - 1;
  if (n0 == n1) {
    lo = (m0 - n0 * pq) / p.q * p.sh - p.ph;
    hi = (m1 - n1 * pq) / p.q * p.sh - p.ph + p.r - 1;
  }
  lo = lo > 0 ? lo : 0;
  hi = hi < p.h - 1 ? hi : p.h - 1;
  return {n0, n1 - n0 + 1, lo, hi >= lo ? hi - lo + 1 : 0};
}

// The halo of one slice: every value of the box's cs channels cb .. cb +
// cs - 1, quantized once, as int8 in shared memory, cs bytes a
// pixel (pixel = (image, row, column) of the box, row-major), by the 128
// threads of one copying warpgroup (tid 0..127). Vector copies move 16
// channels at once; the gather one value a thread, pixel-major where the
// channels are innermost in x, else channel-major, so neighbouring
// threads read neighbouring addresses.
template <typename T, bool kVec>
__device__ __forceinline__ void load_halo(const Params& p, const T* x, const HaloBox& hb, int cb,
                                          uint8_t* halo, int tid, const Quant& qt) {
  constexpr int kN = 128;
  const int plane = hb.rows * p.w, pixels = hb.imgs * plane;
  auto src_of = [&](int pix) {
    const int img = pix / plane, rem = pix - img * plane, hr = rem / p.w;
    return (hb.n0 + img) * p.xn + (hb.lo + hr) * p.xh + (rem - hr * p.w) * p.xw;
  };
  if constexpr (kVec) {
    const int units = p.cs >> 4, total = pixels * units;
    constexpr int kB = sizeof(T) == 4 ? 4 : 8;
    for (int u0 = tid; u0 < total; u0 += kN * kB) {
      VecUnit<T> u[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int v = u0 + kN * j, pix = v / units;
        if (v < total) u[j].load_at(x + src_of(pix) + cb + 16 * (v - pix * units));
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int v = u0 + kN * j, pix = v / units;
        if (v < total)
          *reinterpret_cast<uint4*>(halo + pix * p.cs + 16 * (v - pix * units)) = u[j].bytes(qt);
      }
    }
  } else {
    const int total = pixels * p.cs;
    const bool inner = p.xc == 1;
    constexpr int kB = 8;
    for (int e0 = tid; e0 < total; e0 += kN * kB) {
      float v[kB];
      int at[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int e = e0 + kN * j;
        const int pix = inner ? e / p.cs : e % pixels, c = inner ? e - pix * p.cs : e / pixels;
        at[j] = pix * p.cs + c;
        v[j] = 0;
        if (e < total) v[j] = to_f32(x[src_of(pix) + (cb + c) * p.xc]);
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        if (e0 + kN * j < total) halo[at[j]] = (uint8_t)qt(v[j]);
      }
    }
  }
}

// The halo copies, where the taps of a kernel (r s > 1) read overlapping
// input and the box fits (_kernels.conv_int8_plan). The block's chunks
// fall into segments, the chunks of one slice of one work item, and the
// two copying warpgroups take the segments in turn, each with a halo
// buffer of its own: for its segment a warpgroup loads the tile's halo of
// that slice once (load_halo), then builds each of the segment's stages
// from it, 8 units a thread, shifted per tap, in shared memory. So one
// warpgroup's halo loads while the other builds; a named barrier (1 or 2)
// among its own 128 threads guards each buffer. Each warpgroup fills its
// own half of the ring, in order (the multiplying warpgroups walk the
// same segments), so a warpgroup that runs a segment ahead never reuses
// a stage whose earlier fill is still unread; a half holds 2 stages, since
// the multiplying warpgroups free a stage only once the next one's
// products are issued.
template <typename T, int BN, bool kVec>
__device__ __forceinline__ void produce_halo(const Params& p, const CUtensorMap* wmap,
                                             uint8_t* atiles, uint8_t* btiles, uint8_t* halos,
                                             uint64_t* full, uint64_t* empty, int tid) {
  const int pw = tid >> 7, ptid = tid & 127, lane = tid & 31;
  const int unit = ptid & 7, row0 = ptid >> 3;
  const uint32_t col = (uint32_t)((unit ^ (row0 & 7)) << 4) + row0 * kChunk;
  const T* x = static_cast<const T*>(p.x);
  uint8_t* halo = halos + pw * p.halo;
  Quant qt;
  qt.init(p.xscale);
  const int pq = p.p * p.q;
  // this warpgroup's half of the ring, filled in order: fill n at stage
  // pw half + n % half
  const int half = p.stages / 2;
  int n = 0, seg = 0;
  for (int work = blockIdx.x; work < p.works; work += gridDim.x) {
    const Work k = decode(p, work);
    const HaloBox hb = halo_box(p, k.mt);
    // each row's first halo pixel of its image, shifted so that input
    // (ih, iw) is pixel pix + ih w + iw; its window's top-left input
    int pix[kUnits], ih0[kUnits], iw0[kUnits];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int m = k.mt * kTileM + row0 + 16 * i;
      pix[i] = 0, ih0[i] = -(1 << 29), iw0[i] = 0;
      if (m < p.m) {
        const int img = m / pq, rem = m - img * pq, pp = rem / p.q, qq = rem - pp * p.q;
        pix[i] = ((img - hb.n0) * hb.rows - hb.lo) * p.w;
        ih0[i] = pp * p.sh - p.ph;
        iw0[i] = qq * p.sw - p.pw;
      }
    }
    for (int kc = k.c0; kc < k.c1; ++seg) {
      const int slice = kc / p.cps;
      const int end = (slice + 1) * p.cps < k.c1 ? (slice + 1) * p.cps : k.c1;
      if ((seg & 1) != pw) {
        kc = end;
        continue;
      }
      // the buffer's last reads are done; load; the halo is whole
      asm volatile("bar.sync %0, 128;" ::"r"(1 + pw) : "memory");
      load_halo<T, kVec>(p, x, hb, slice * p.cs, halo, ptid, qt);
      asm volatile("bar.sync %0, 128;" ::"r"(1 + pw) : "memory");
      for (; kc < end; ++kc, ++n) {
        const int st = pw * half + n % half;
        const KPlace kp = kplace(p, kc, unit);
        uint4 v[kUnits];
#pragma unroll
        for (int i = 0; i < kUnits; ++i) {
          v[i] = make_uint4(0, 0, 0, 0);
          if constexpr (kVec) {
            const int ih = ih0[i] + kp.r, iw = iw0[i] + kp.s;
            if (kp.ok && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w)
              v[i] = *reinterpret_cast<const uint4*>(halo + (pix[i] + ih * p.w + iw) * p.cs +
                                                      kp.cl);
          } else {
            uint32_t out[4] = {0, 0, 0, 0};
            int r = kp.r, s = kp.s, c = kp.cl;
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const int ih = ih0[i] + r, iw = iw0[i] + s;
              if (kp.k0 + e < p.kslice && (unsigned)ih < (unsigned)p.h &&
                  (unsigned)iw < (unsigned)p.w)
                out[e >> 2] |= (uint32_t)halo[(pix[i] + ih * p.w + iw) * p.cs + c]
                               << (8 * (e & 3));
              if (++c == p.cs) {
                c = 0;
                if (++s == p.s) s = 0, ++r;
              }
            }
            v[i] = make_uint4(out[0], out[1], out[2], out[3]);
          }
        }
        wait_or_trap(empty + st, ((uint32_t)(n / half) & 1u) ^ 1u);
        if (ptid == 0) {
          mbar_expect_tx(full + st, BN * kChunk);
          tma_load_2d(smem_u32(btiles + st * BN * kChunk), wmap, full + st, kc * kChunk,
                      k.nt * BN);
        }
        const uint32_t dst = smem_u32(atiles + st * kABytes) + col;
#pragma unroll
        for (int i = 0; i < kUnits; ++i) st_shared16(dst + i * 16 * kChunk, v[i]);
        fence_proxy_async();  // the stores, before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
  }
}

template <typename T, int BN, bool kVec, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  using TO = typename OutOf<T>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* atiles = base;
  uint8_t* btiles = base + p.stages * kABytes;
  uint8_t* halo = btiles + p.stages * BN * kChunk;  // two buffers of p.halo bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(halo + 2 * p.halo);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 5);   // the stage's copying warpgroup's 4 warps + the weights' TMA
      mbar_init(empty + s, 8);  // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 256) {  // the copying warpgroups
    if constexpr (kHalo)
      produce_halo<T, BN, kVec>(p, &wmap, atiles, btiles, halo, full, empty, tid);
    else
      produce_direct<T, BN, kVec>(p, &wmap, atiles, btiles, full, empty, tid);
    return;
  }

  // the multiplying warpgroups: rows 64 wg .. 64 wg + 63 of the tile
  const int ctid = tid - 256, wg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
  int acc[BN / 2];
  // the stages in the order they were filled: the direct copies' ring
  // taken in turn; with the halo, each segment's from its warpgroup's half
  int g = 0, seg = 0, fills[2] = {0, 0};
  const int half = p.stages / 2;
  const int pq = p.p * p.q;
  for (int work = blockIdx.x; work < p.works; work += gridDim.x) {
    const Work k = decode(p, work);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = -1;
    int who = 0, end = k.c0;
    for (int kc = k.c0; kc < k.c1; ++kc) {
      int st;
      uint32_t ph;
      if constexpr (kHalo) {
        if (kc == end) {  // a new segment: a slice of this work item
          who = seg++ & 1;
          end = (kc / p.cps + 1) * p.cps < k.c1 ? (kc / p.cps + 1) * p.cps : k.c1;
        }
        const int n = fills[who]++;
        st = who * half + n % half;
        ph = (uint32_t)(n / half) & 1u;
      } else {
        st = g % p.stages;
        ph = (uint32_t)(g / p.stages) & 1u;
        ++g;
      }
      wait_or_trap(full + st, ph);
      const uint32_t a = smem_u32(atiles + st * kABytes) + wg * 64 * kChunk;
      const uint32_t b = smem_u32(btiles + st * BN * kChunk);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<BN>::ss_s8(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk));
      wgmma_commit();
      // one group in flight: the previous stage's products are done
      wgmma_wait1();
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = st;
    }
    wgmma_wait0();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + prev);

    // accumulator rows lane/4 and lane/4 + 8 of the warp's 16, channel
    // pairs 8 j + 2 (lane % 4): to this split's slice of the workspace, or
    // through the epilogue to the output
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = k.mt * kTileM + 64 * wg + 16 * warp + (lane >> 2) + 8 * half;
      if (m >= p.m) continue;
      if (p.ws != nullptr) {
        int32_t* row = p.ws + ((size_t)k.ks * p.m + m) * p.o;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          store_pair(row, p, k.nt * BN + 8 * j + 2 * (lane & 3), acc[4 * j + 2 * half],
                     acc[4 * j + 2 * half + 1], 1, (p.o & 1) == 0);
      } else {
        const int n = m / pq, rem = m - n * pq, pp = rem / p.q, qq = rem - pp * p.q;
        TO* row = static_cast<TO*>(p.y) + ((long long)n * p.yn + (long long)pp * p.yh +
                                           (long long)qq * p.yw);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          store_pair(row, p, k.nt * BN + 8 * j + 2 * (lane & 3), acc[4 * j + 2 * half],
                     acc[4 * j + 2 * half + 1], p.yc, p.ypair != 0);
      }
    }
  }
}

// The K split's partial sums added in split order, through the epilogue
// to the output (one element a thread, grid-stride over m * o)
template <typename TO>
__global__ void __launch_bounds__(256) conv_int8_reduce(const Params p) {
  const long long count = (long long)p.m * p.o;
  const int pq = p.p * p.q;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < count; i += (long long)gridDim.x * 256) {
    int v = p.ws[i];
    for (int k = 1; k < p.ksplit; ++k) v += p.ws[k * count + i];
    const int m = (int)(i / p.o), o = (int)(i - (long long)m * p.o);
    const int n = m / pq, rem = m - n * pq, pp = rem / p.q, qq = rem - pp * p.q;
    put(static_cast<TO*>(p.y) + ((long long)n * p.yn + (long long)pp * p.yh +
                                 (long long)qq * p.yw + (long long)o * p.yc),
        v, p, o);
  }
}

template <typename T, int BN, bool kVec, bool kHalo>
cudaError_t launch(const Params& p, const void* wk, int kp, int opad, int smem, int sms,
                   cudaStream_t st) {
  static bool raised = false;  // once per instantiation, never inside a graph capture
  const auto kernel = conv_int8_kernel<T, BN, kVec, kHalo>;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  CUtensorMap wmap = {};
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)opad};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)BN};
  if (!encode_typed(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wk, dims, strides, box))
    return cudaErrorInvalidValue;
  kernel<<<p.works < sms ? p.works : sms, kThreads, smem, st>>>(wmap, p);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_vec(const Params& p, const void* wk, int kp, int opad, int vec, int smem,
                       int sms, cudaStream_t st) {
  if constexpr (sizeof(T) > 1)  // the halo holds quantized float input only
    if (p.halo)
      return vec ? launch<T, BN, true, true>(p, wk, kp, opad, smem, sms, st)
                 : launch<T, BN, false, true>(p, wk, kp, opad, smem, sms, st);
  return vec ? launch<T, BN, true, false>(p, wk, kp, opad, smem, sms, st)
             : launch<T, BN, false, false>(p, wk, kp, opad, smem, sms, st);
}

template <typename T>
cudaError_t launch_bn(const Params& p, const void* wk, int kp, int opad, int bn, int vec,
                      int smem, int sms, cudaStream_t st) {
  return bn == 64 ? launch_vec<T, 64>(p, wk, kp, opad, vec, smem, sms, st)
                  : launch_vec<T, 128>(p, wk, kp, opad, vec, smem, sms, st);
}

}  // namespace

extern "C" {

// x: int8 (in_type 0, mode A), fp32 (1) or bf16 (2, mode B) input, logical
// (N, C, H, W) addressed by the element strides xs_* (every offset below
// 2^31); wk: int8 weights packed (opad, kp) by _kernels.pack_int8_weight:
// K in slices of cs channels (cs = c, or 128 where c is a larger multiple
// of 128), each ordered (r, s, channel) and zero-padded to whole 128-byte
// chunks, zero past o, opad a multiple of bn, 16-byte aligned; y: the output, logical (N, O, P, Q) by ys_*,
// int32 (mode A) or x's type (B). Mode B: xscale the fp32 input scale (a
// device scalar), scale the fp32 (o,) products x_scale * w_scale, bias
// fp32 (o,) or null; mode A: all three null. The plan
// (_kernels.conv_int8_plan): bn (64 or 128) output channels a tile, stages
// of the ring, ksplit (ws: int32 scratch of ksplit * n*p*q * o for ksplit
// > 1, else null; then a second launch, conv_int8_reduce, writes y), vec = 1 for 16-byte
// unit copies (channel stride 1, c % 16 == 0, the other strides and x
// 16-byte aligned in bytes), halo the bytes of each of the two halo
// buffers (a multiple of 1024 that holds every tile's box, 0 for the
// direct copies), smem the
// block's shared memory; ypair = 1
// where channel stride 1 and the other output strides are even; sms the
// persistent grid's size. Returns the launches' cudaError_t (0 = queued).
int dcnn_conv_int8(const void* x, const void* wk, void* y, void* ws, const void* xscale,
                   const void* scale, const void* bias, int n, int c, int h, int w, int o, int p,
                   int q, int r, int s, int sh, int sw, int ph, int pw, long long xs_n,
                   long long xs_c, long long xs_h, long long xs_w, long long ys_n, long long ys_c,
                   long long ys_h, long long ys_w, int kp, int opad, int in_type, int bn,
                   int stages, int ksplit, int vec, int halo, int ypair, int smem, int sms,
                   void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || o < 1 || p < 1 || q < 1 || r < 1 || s < 1 || sh < 1 ||
      sw < 1 || ph < 0 || pw < 0)
    return cudaErrorInvalidValue;
  Params g{};
  g.n = n, g.c = c, g.h = h, g.w = w, g.o = o, g.p = p, g.q = q, g.r = r, g.s = s;
  g.sh = sh, g.sw = sw, g.ph = ph, g.pw = pw;
  const long long m = (long long)n * p * q;
  const long long yspan = (n - 1) * ys_n + (o - 1) * ys_c + (p - 1) * ys_h + (q - 1) * ys_w;
  if (m * o >= (1LL << 31) || (long long)r * s * c >= (1LL << 31) - kChunk || yspan >= (1LL << 31) ||
      ys_n < 0 || ys_c < 0 || ys_h < 0 || ys_w < 0)
    return cudaErrorInvalidValue;
  g.yn = (int)ys_n, g.yc = (int)ys_c, g.yh = (int)ys_h, g.yw = (int)ys_w;
  g.k = r * s * c;
  g.m = (int)m;
  const long long xspan = (n - 1) * xs_n + (c - 1) * xs_c + (h - 1) * xs_h + (w - 1) * xs_w;
  const bool mode_b = in_type != 0;
  g.cs = c > kChunk && c % kChunk == 0 ? kChunk : c;
  g.kslice = r * s * g.cs;
  g.cps = (g.kslice + kChunk - 1) / kChunk;
  const int chunks = c / g.cs * g.cps;
  const int tiles_n = (o + bn - 1) / bn;
  const long long tiles_m = ((long long)g.m + kTileM - 1) / kTileM;
  // every tile's halo box fits the buffer
  g.halo = halo;
  bool halo_ok = halo >= 0 && halo % 1024 == 0 && (halo == 0 || (vec == 0 || g.cs % 16 == 0));
  for (long long mt = 0; halo > 0 && halo_ok && mt < tiles_m; ++mt) {
    const HaloBox hb = halo_box(g, (int)mt);
    halo_ok = (long long)hb.imgs * hb.rows * w * g.cs <= halo;
  }
  if (xspan >= (1LL << 31) || xs_n < 0 || xs_c < 0 || xs_h < 0 || xs_w < 0 || in_type < 0 ||
      in_type > 2 || (bn != 64 && bn != 128) || kp % kChunk || kp != chunks * kChunk ||
      opad % bn || opad < tiles_n * bn || stages < 2 || stages > kMaxStages || !halo_ok ||
      (halo > 0 && (stages % 2 || stages < 4 || !mode_b)) ||
      smem != smem_bytes(bn, stages, halo) || smem > kSmemMax || ksplit < 1 || ksplit > chunks ||
      (ksplit > 1) != (ws != nullptr) || mode_b != (xscale != nullptr) ||
      mode_b != (scale != nullptr) || (!mode_b && bias != nullptr) || sms < 1 ||
      tiles_m * tiles_n * ksplit >= (1LL << 31) ||
      (ksplit > 1 && (long long)ksplit * g.m * o >= (1LL << 31)))
    return cudaErrorInvalidValue;
  g.x = x;
  g.xscale = static_cast<const float*>(xscale);
  g.scale = static_cast<const float*>(scale);
  g.bias = static_cast<const float*>(bias);
  g.y = y;
  g.ws = static_cast<int32_t*>(ws);
  g.xn = (int)xs_n, g.xc = (int)xs_c, g.xh = (int)xs_h, g.xw = (int)xs_w;
  g.chunks = chunks, g.ksplit = ksplit, g.tiles_n = tiles_n, g.stages = stages;
  g.works = (int)(tiles_m * tiles_n * ksplit);
  g.ypair = ypair;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_type == 0)
    err = launch_bn<int8_t>(g, wk, kp, opad, bn, vec, smem, sms, st);
  else if (in_type == 1)
    err = launch_bn<float>(g, wk, kp, opad, bn, vec, smem, sms, st);
  else
    err = launch_bn<__nv_bfloat16>(g, wk, kp, opad, bn, vec, smem, sms, st);
  if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
  // the K split's partial sums, through the epilogue into y
  const long long count = (long long)g.m * o;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  if (in_type == 0)
    conv_int8_reduce<int32_t><<<blocks, 256, 0, st>>>(g);
  else if (in_type == 1)
    conv_int8_reduce<float><<<blocks, 256, 0, st>>>(g);
  else
    conv_int8_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
