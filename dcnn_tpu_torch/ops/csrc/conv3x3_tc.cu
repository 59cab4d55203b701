// 3x3 stride-1 SAME convolutions as implicit GEMMs on Hopper's tensor cores
// (sm_90a: TMA, mbarriers, wgmma), with a plain C interface bound from
// Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces three Pallas TPU kernels of dcnn_tpu/ops/pallas/conv.py:
//   _conv3x3_kernel        (conv3x3_s1, called at :82)            -> conv_tc_kernel<.., 9>, no scale
//   _conv3x3_pairs_kernel  (conv3x3_s1_pairs, called at :173)     -> conv_tc_kernel<.., 12>
//   _conv3x3_bn_kernel     (conv3x3_s1_bnrelu_in, called at :209) -> conv_tc_kernel<.., 9> with scale, shift
// Same functions: x (N, H, W, Cin) NHWC, weights HWIO (3, 3, Cin, Cout),
// the output (N, H, W, Cout) the sum over the 9 taps of the zero-padded
// input shifted by the tap times the tap's (Cin, Cout) weights, accumulated
// in fp32 and cast to the output type once. The BN form first maps every
// real input cell to relu(x * scale + shift) in fp32 (no FMA contraction,
// as the plain version computes it) and rounds that to x's type; halo cells
// stay 0, not relu(shift).
//
// The pairs form computes the same conv as a product of output-column
// pairs with the fused weights w2 (3, 4, Cin, 2 Cout) of fuse_pair_weights:
// out[n, i, 2p + c, o] = sum over r < 3, j < 4, ci of xpad[n, i + r, 2p + j,
// ci] * w2[r, j, ci, c Cout + o]. It reads w2 as given, all 12 taps and all
// 2 Cout lanes, zero blocks included, so it is right for any w2 and a
// wrong w2 layout shows. It is the same kernel with TAPS = 12: an output
// column is a pair (the tile's halo box is 2 tw + 2 input columns wide and
// tap (r, j) of pair p reads halo column 2p + j), its channels are the 2
// Cout lanes, and its output (n, h, w/2, 2 Cout) is (n, h, w, Cout) in
// memory, so any split of the lanes into Cout tiles stores correctly.
//
// Design. The GEMM is M = output pixels, N = Cout, K = 9 taps x Cin. An
// output tile is 128 MW pixels, b images x th rows x tw columns (small
// images share a tile), by BN = 64 or 128 output channels: MW = 2 (two
// 64-row slabs per multiplying warpgroup, each weight tile read for twice
// the pixels) for the plain bf16 conv where such tiles alone fill the
// card, else 1; _kernels.conv_plan picks b, th, tw, BN and the K split on
// the host. K runs in units of one (Cin chunk, tap): a chunk is one
// 128-byte row per pixel, 64 bf16 or 32 fp32 channels. Per chunk the
// tile's halo box (b, th+2, tw+2, chunk) is copied into shared memory
// once, by TMA where the layout allows it (the copy's out-of-bounds fill
// is the SAME padding and the zero K padding) and by cp.async with a zero
// source size elsewhere (Cin * sizeof(T) not a multiple of 16: the stem's
// Cin 3), in TMA's 128-byte swizzle either way. Each of the 9 taps then
// reads its shifted rows from that one tile with ldmatrix, per-row
// addresses into wgmma's register-A form, so the 9-fold reuse happens in
// shared memory. The weights are packed once per call (pack_weights, in
// the timed call) to K-major (tap, Cout, Cin chunk) rows and reach shared
// memory by TMA, one (chunk, tap) tile per stage, read by wgmma through a
// 128-byte-swizzle descriptor.
//
// One block of 384 threads: warpgroup 0 copies, warpgroups 1-2 multiply,
// each 64 MW rows of the tile (setmaxnreg moves registers to them from the
// copying warpgroup where they use them). In the copying warpgroup one
// thread issues every TMA (the weights and, where TMA stages it, the halo)
// as soon as its ring has a free stage, and warps 1-3 stage the halo by
// cp.async and/or apply the BN prologue. Rings of 3 (else 2) halo stages
// and up to 9 weight stages, as deep as shared memory allows, with
// full/empty mbarriers, keep the copies of the coming units in flight
// under this unit's products. bf16 keeps one group of products in flight
// while the next unit's A is loaded. The epilogue writes the tile into shared
// memory and one thread stores it by TMA (direct stores where a row of
// Cout is not a multiple of 16 bytes). Blocks are persistent over the work
// items (tile, K range). Where the tiles are fewer than the SMs
// (ResNet-18's layers 2-4 at B=32), K is split across blocks: each writes
// fp32 partial sums to a workspace and splitk_reduce adds them in a fixed
// order and casts, so reruns are bit-identical (no atomics).
//
// Products. bf16: wgmma m64nBNk16, bf16 x bf16 into fp32 registers, as the
// TPU kernel's bf16 MXU products with preferred_element_type=float32.
// fp32 keeps fp32 accuracy (TF32 is off at parity precision): each operand
// is split into hi = tf32(x) and lo = tf32(x - hi) and the kernel runs
// lo*hi + hi*lo + hi*hi on wgmma m64nBNk8 tf32 (the weights' hi and lo are
// packed in the call, the input's split in registers after ldmatrix). The
// BN prologue is applied in shared memory once per staged chunk, by warps
// 1-3 of the copying warpgroup, before any tap reads it, only to cells
// inside the image: the halo and the K padding stay 0.
//
// What bounds it on an H100. At the JAX bench's 64x64x64 shape the conv
// moves more bytes than its operations take (bf16: 268 MB, 0.080 ms at
// 3.35 TB/s); at the deeper shapes it is bound by operations (989 TFLOP/s
// bf16; fp32 runs three tf32 products at 495 TFLOP/s). The kernel itself
// reaches about half of that: ops/conv_tc_stages.py shows each unit's
// A loads, barrier waits and weight stage hand-over beside its products.

#include <cuda_bf16.h>

#include "hopper.cuh"

// The tile format is defined once, in _kernels.py (TILE_FORMAT), which plans
// the tiling and passes it to this build as -D flags.
#if !defined(CONV_TC_TILE_M) || !defined(CONV_TC_ROW_BYTES) || !defined(CONV_TC_MAX_HALO_ROWS)
#error "build through dcnn_tpu_torch/ops/_kernels.py, which defines the tile format"
#endif

namespace {

constexpr int kThreads = 384;        // warpgroup 0 copies, 1-2 multiply
constexpr int kTileM = CONV_TC_TILE_M;                // output pixels per tile
constexpr int kRow = CONV_TC_ROW_BYTES;               // bytes of one staged pixel row (a Cin chunk)
constexpr int kMaxHaloRows = CONV_TC_MAX_HALO_ROWS;   // b (th+2)(tw+2) of any plan (conv_plan)
static_assert(kTileM == 128 && kRow == 128,
              "two 64-row wgmma slabs a tile; rows in the 128-byte swizzle");
constexpr int kMaxHStages = 3;       // halo ring: 3 stages where they fit, else 2
constexpr int kMaxWStages = 9;       // weight ring: as many stages as fit, up to 9

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kChunk = 64;  // channels per 128-byte row
  static constexpr int kParts = 1;   // packed weights: as they are
};
template <>
struct Traits<float> {
  static constexpr int kChunk = 32;
  static constexpr int kParts = 2;   // packed weights: tf32 hi, then lo
};

template <typename T, int BN>
struct Smem {
  static constexpr int kW = Traits<T>::kParts * BN * kRow;  // one weight stage
  __host__ __device__ static int halo(int rows) { return (rows * kRow + 1023) / 1024 * 1024; }
  // 1024 bytes of slack to align the base for the 128-byte swizzle, the
  // output tile's staging (obytes) and the barriers
  __host__ __device__ static int total(int rows, int hst, int wst, int obytes) {
    return 1024 + hst * halo(rows) + obytes + wst * kW + 256;
  }
};

struct Params {
  const void* x;
  const float* scale;  // null: no BN prologue
  const float* shift;
  void* out;           // (n, h, w, cout), bf16 if out_bf16 else fp32
  float* ws;           // K split: fp32 partial sums (ksplit, n h w, cout)
  int n, h, w, cin, cout;  // the output (n, h, w, cout): pairs: (n, h, wi / 2, 2 cout)
  int wi;              // the input's width: w, or 2 w in pairs
  int b, th, tw;       // tile: b images x th rows x tw output columns (pairs) = 128
  int step, hw;        // input columns per output column (1, pairs 2); halo width step tw + 2
  int tiles_x, tiles_y, tiles_n;
  int units, ksplit, works;  // units = taps (9, pairs 12) x Cin chunks
  int cout_pad;        // packed weight rows per (tap, part)
  int halo_rows;       // b (th+2) hw
  int hst, wst;        // stages of the halo and weight rings
  int obytes;          // the output tile staged for TMA stores, or 0: direct stores
  int copy;            // 0: halo by TMA; else cp.async (plain for 2) unit in bytes
  int out_bf16;
};

struct Work {
  int tb, ty, tx, nt, ks, u0, u1;
};

// Per-stage clock counts for one thread of each role, kept only when built
// with -DCONV_TC_TRACE (a diagnostic build; dcnn_conv3x3_tc_trace reads
// them): [0] multiplying warps waiting for a halo tile, [1] for a weight
// stage, [2] issuing and finishing the products, [3] the epilogue, [4] the
// whole loop, [7] loading A (ldmatrix, the halo's release); [5] prologue
// warps waiting for a copy, [6] applying the prologue.
struct Clock {
#ifdef CONV_TC_TRACE
  long long t[2] = {}, sum[8] = {};
  __device__ __forceinline__ void start(int i = 0) { t[i] = clock64(); }
  __device__ __forceinline__ void add(int slot, int i = 0) { sum[slot] += clock64() - t[i]; }
#else
  __device__ __forceinline__ void start(int = 0) {}
  __device__ __forceinline__ void add(int, int = 0) {}
#endif
};
#ifdef CONV_TC_TRACE
__device__ long long g_trace[1024][8];
__device__ __forceinline__ void save_clock(const Clock& c, bool keep) {
  if (keep && blockIdx.x < 1024)
    for (int i = 0; i < 8; ++i)
      if (c.sum[i]) g_trace[blockIdx.x][i] = c.sum[i];
}
#else
__device__ __forceinline__ void save_clock(const Clock&, bool) {}
#endif

// work = ((m tile) * ksplit + ks) * tiles_n + n tile: the n tiles of one
// halo run side by side and share it through L2
__device__ __forceinline__ Work decode(const Params& p, int work) {
  Work k;
  k.nt = work % p.tiles_n;
  int t = work / p.tiles_n;
  k.ks = t % p.ksplit;
  t /= p.ksplit;
  k.tx = t % p.tiles_x;
  t /= p.tiles_x;
  k.ty = t % p.tiles_y;
  k.tb = t / p.tiles_y;
  k.u0 = k.ks * p.units / p.ksplit;  // units * ksplit < 2^31 (checked by the entry)
  k.u1 = (k.ks + 1) * p.units / p.ksplit;
  return k;
}

// Walks this block's units in order: work items blockIdx.x, + gridDim.x,
// ..., and within each its units u0 .. u1-1 (TAPS units a Cin chunk)
template <int TAPS>
struct Cursor {
  int work, u;
  Work k;
  __device__ explicit Cursor(const Params& p) : work(blockIdx.x), u(0) {
    if (work < p.works) k = decode(p, work), u = k.u0;
  }
  __device__ bool done(const Params& p) const { return work >= p.works; }
  __device__ void next(const Params& p) {
    if (++u < k.u1) return;
    work += gridDim.x;
    if (work < p.works) k = decode(p, work), u = k.u0;
  }
  // the next unit that starts a halo tile: a work item's first, or tap 0
  __device__ void next_halo(const Params& p) {
    do next(p);
    while (!done(p) && u != k.u0 && u % TAPS != 0);
  }
};

template <int G>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? G : 0;  // a zero source size writes G zero bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(G),
               "r"(n)
               : "memory");
}

// smem -> global; the copy clips what lies outside the tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3, int c4, bool five) {
  if (five)
    asm volatile(
        "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], "
        "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], "
        "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the accumulators live and in place across the asynchronous products
template <int MW, int N>
__device__ __forceinline__ void fence_acc(float (&d)[MW][N]) {
#pragma unroll
  for (int s = 0; s < MW; ++s)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[s][i])::"memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// (halo row) -> (image, input y, input x) of the tile
struct Halo {
  int img, iy, ix;
  __device__ __forceinline__ bool inside(const Params& p) const {
    return img < p.n && iy >= 0 && iy < p.h && ix >= 0 && ix < p.wi;
  }
};
__device__ __forceinline__ Halo halo_cell(const Params& p, const Work& k, int row) {
  const int hw2 = (p.th + 2) * p.hw, rr = row % hw2;
  return {k.tb * p.b + row / hw2, k.ty * p.th + rr / p.hw - 1,
          k.tx * (p.hw - 2) + rr % p.hw - 1};
}

// The halo box of chunk `chunk` without TMA, in the 128-byte swizzle TMA
// would write, zero outside the image and beyond Cin. Per 16-byte cell:
// cp.async in units of G bytes with a zero source size beyond Cin, or a
// zero store where the whole cell is padding; for G = 2 (bf16 with odd
// Cin, no cp.async unit fits) plain loads, four cells in flight per thread.
// Only the first `cols` cells of a row are written: where Cin fits one
// chunk the rest are K padding, zeroed once by the caller. Returns once this
// thread's copies have landed.
template <typename T, int G>
__device__ void stage_halo(const Params& p, const Work& k, uint8_t* dst, int chunk, int ptid,
                           int nthr, int cols) {
  constexpr int kE = 16 / sizeof(T), kU = G / sizeof(T);  // elements per cell, per unit
  constexpr int kBatch = G >= 4 ? 1 : 4;
  const T* x = static_cast<const T*>(p.x);
  const int c0 = chunk * Traits<T>::kChunk, cells = p.halo_rows * cols;
  const uint32_t base = smem_u32(dst);
  for (int i0 = ptid; i0 < cells; i0 += nthr * kBatch) {
    uint32_t d[kBatch], v[kBatch][4];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + nthr * q, row = i / cols, lc = i % cols, ch = c0 + lc * kE;
      d[q] = base + row * kRow + ((lc ^ (row & 7)) << 4);
      v[q][0] = v[q][1] = v[q][2] = v[q][3] = 0;
      const Halo c = halo_cell(p, k, row);
      if (i >= cells || ch >= p.cin || !c.inside(p)) continue;
      const T* src = x + (((size_t)c.img * p.h + c.iy) * p.wi + c.ix) * p.cin + ch;
      if constexpr (G >= 4) {
#pragma unroll
        for (int j = 0; j < 16 / G; ++j)  // a unit is all inside Cin or all beyond
          cp_async_zfill<G>(d[q] + j * G, ch + j * kU < p.cin ? src + j * kU : x,
                            ch + j * kU < p.cin);
        d[q] = 0xffffffffu;  // no store
      } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ch + e < p.cin) v[q][e / 2] |= (uint32_t)s16[e] << (16 * (e & 1));
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (d[q] != 0xffffffffu && i0 + nthr * q < cells)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(d[q]), "r"(v[q][0]),
                     "r"(v[q][1]), "r"(v[q][2]), "r"(v[q][3]));
  }
  if constexpr (G >= 4) asm volatile("cp.async.wait_all;" ::: "memory");
}

// relu(x * scale + shift) in fp32, rounded to T, of the 16-byte cell `raw`;
// beyond Cin scale and shift are 0, so the zero padding stays 0
__device__ __forceinline__ void bnrelu_cell(uint4& raw, const float* sc, const float* sh,
                                            const __nv_bfloat16*) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v[j]);
    v[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(f.x, sc[2 * j]), sh[2 * j]), 0.f),
                                 fmaxf(__fadd_rn(__fmul_rn(f.y, sc[2 * j + 1]), sh[2 * j + 1]), 0.f));
  }
}
__device__ __forceinline__ void bnrelu_cell(uint4& raw, const float* sc, const float* sh,
                                            const float*) {
  float* v = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], sc[e]), sh[e]), 0.f);
}

// The BN prologue in place on the staged chunk, by `nthr` threads (a
// multiple of 8, so each keeps one 16-byte column of cells and its
// channels' scale and shift): only cells inside the image; the halo stays
// 0. Two cells in flight per thread, the box position advanced, not divided.
template <typename T>
__device__ void bn_prologue(const Params& p, const Work& k, uint8_t* tile, int chunk, int ptid,
                            int nthr) {
  constexpr int kE = 16 / sizeof(T);
  const int lc = ptid & 7, ch0 = chunk * Traits<T>::kChunk + lc * kE;
  if (ch0 >= p.cin) return;  // K padding
  float sc[kE], sh[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    sc[e] = ch0 + e < p.cin ? __ldg(p.scale + ch0 + e) : 0.f;
    sh[e] = ch0 + e < p.cin ? __ldg(p.shift + ch0 + e) : 0.f;
  }
  // the loop's bounds in registers, and the test for a cell inside the
  // image without branches (unsigned compares take the lower bounds too)
  const int step = nthr >> 3, wd2 = p.hw, hd2 = p.th + 2, rows = p.halo_rows;
  const int img_end = p.n - k.tb * p.b, y0 = k.ty * p.th - 1, x0 = k.tx * (p.hw - 2) - 1;
  const unsigned h = p.h, wi = p.wi;
  int row = ptid >> 3, xi = row % wd2, yi = (row / wd2) % hd2, bi = row / (wd2 * hd2);
  auto inside = [&]() {
    return (bi < img_end) & ((unsigned)(y0 + yi) < h) & ((unsigned)(x0 + xi) < wi);
  };
  auto advance = [&]() {
    row += step;
    for (xi += step; xi >= wd2; xi -= wd2)
      if (++yi == hd2) yi = 0, ++bi;
  };
  while (row < rows) {
    const int row1 = row;
    const bool in1 = inside();
    advance();
    const int row2 = row;
    const bool in2 = (row2 < rows) & inside();
    advance();
    uint4* c1 = reinterpret_cast<uint4*>(tile + row1 * kRow + ((lc ^ (row1 & 7)) << 4));
    uint4* c2 = reinterpret_cast<uint4*>(tile + row2 * kRow + ((lc ^ (row2 & 7)) << 4));
    uint4 r1 = in1 ? *c1 : make_uint4(0, 0, 0, 0), r2 = in2 ? *c2 : make_uint4(0, 0, 0, 0);
    bnrelu_cell(r1, sc, sh, static_cast<const T*>(nullptr));
    bnrelu_cell(r2, sc, sh, static_cast<const T*>(nullptr));
    if (in1) *c1 = r1;
    if (in2) *c2 = r2;
  }
}

// Issue one unit's products, D += A * B, with A (the warp's 16 rows by 4 K
// steps of 32 bytes, from ldmatrix) in registers and B the stage's packed
// weights at w. bf16 reads the loaded registers as they are; fp32 splits
// them into tf32 hi and lo (w holds the weights' hi, then lo) and runs
// lo*hi + hi*lo + hi*hi, smallest first. hold() after the products are
// done keeps the registers they read live and unchanged until then.
template <typename T>
struct Frag;
template <>
struct Frag<__nv_bfloat16> {
  // mw 64-row slabs of the warpgroup share each K step's B
  template <int BN, int MW>
  __device__ __forceinline__ void mma(float (&acc)[MW][BN / 2], const uint32_t (&a)[MW][4][4],
                                      uint32_t w) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int s = 0; s < MW; ++s)
        Wgmma<BN>::template rs_bf16<0>(acc[s], a[s][k], desc_sw128(w + 32 * k));
  }
  template <int MW>
  __device__ __forceinline__ void hold(uint32_t (&a)[MW][4][4]) {
#pragma unroll
    for (int s = 0; s < MW; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][k][i])::"memory");
  }
};
template <>
struct Frag<float> {
  uint32_t hi[4][4], lo[4][4];
  template <int BN, int MW>
  __device__ __forceinline__ void mma(float (&acc)[MW][BN / 2], const uint32_t (&a)[MW][4][4],
                                      uint32_t w) {
    static_assert(MW == 1, "fp32 keeps one slab per warpgroup: its split doubles A");
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __uint_as_float(a[0][k][i]);
        hi[k][i] = to_tf32(v);
        lo[k][i] = to_tf32(v - __uint_as_float(hi[k][i]));
      }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t bhi = desc_sw128(w + 32 * k), blo = desc_sw128(w + BN * kRow + 32 * k);
      Wgmma<BN>::rs_tf32(acc[0], lo[k], bhi);
      Wgmma<BN>::rs_tf32(acc[0], hi[k], blo);
      Wgmma<BN>::rs_tf32(acc[0], hi[k], bhi);
    }
  }
  template <int MW>
  __device__ __forceinline__ void hold(uint32_t (&)[MW][4][4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(hi[k][i]), "+r"(lo[k][i])::"memory");
  }
};

__device__ __forceinline__ void store2(float* p, float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
  }
}

// Channels n, n+1 of output pixel pix: to the workspace slice of this K
// split, or cast to the output. Stores a pair where both are real and
// Cout is even (aligned), else one by one.
template <typename TO>
__device__ __forceinline__ void store_out(TO* dst, const Params& p, size_t pix, int n, float v0,
                                          float v1) {
  if (n >= p.cout) return;
  TO* q = dst + pix * p.cout + n;
  const bool two = n + 1 < p.cout;
  if (two && !(p.cout & 1)) {
    store2(q, v0, v1, true);
  } else {
    store2(q, v0, v1, false);
    if (two) store2(q + 1, v1, 0.f, false);
  }
}

template <int BN, int MW, typename TO>
__device__ __forceinline__ void epilogue(TO* dst, const Params& p, const Work& k,
                                         const float (&acc)[MW][BN / 2], int wg, int warp,
                                         int lane) {
  const int tpix = p.th * p.tw;
#pragma unroll
  for (int sh = 0; sh < 2 * MW; ++sh) {
    const int s = sh >> 1, half = sh & 1;
    const int m = 64 * (MW * wg + s) + 16 * warp + (lane >> 2) + 8 * half;
    const int img = k.tb * p.b + m / tpix, oy = k.ty * p.th + (m % tpix) / p.tw,
              ox = k.tx * p.tw + m % p.tw;
    if (img >= p.n || oy >= p.h || ox >= p.w) continue;
    const size_t pix = ((size_t)img * p.h + oy) * p.w + ox;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      store_out(dst, p, pix, k.nt * BN + 8 * j + 2 * (lane & 3), acc[s][4 * j + 2 * half],
                acc[s][4 * j + 2 * half + 1]);
  }
}

// The same by TMA: the multiplying warps write the tile into shared memory
// (per 128-byte column block, rows in tile order, 128-byte swizzle), then
// one thread stores each block to the output (or to this K split's slice
// of the workspace) and goes on; the next tile's epilogue first waits for
// those stores to have read the staging.
template <int BN, int MW, typename TO>
__device__ __forceinline__ void epilogue_tma(uint8_t* ostage, const CUtensorMap* omap,
                                             const Params& p, const Work& k,
                                             const float (&acc)[MW][BN / 2], int wg, int warp,
                                             int lane, int ctid) {
  constexpr int kEs = sizeof(TO), kBlocks = BN * kEs / 128, kM = kTileM * MW;
  if (ctid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  asm volatile("bar.sync 2, 256;" ::: "memory");
  const uint32_t base = smem_u32(ostage);
#pragma unroll
  for (int sh = 0; sh < 2 * MW; ++sh) {
    const int s = sh >> 1, half = sh & 1;
    const int m = 64 * (MW * wg + s) + 16 * warp + (lane >> 2) + 8 * half;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int byte = (8 * j + 2 * (lane & 3)) * kEs, b = byte & 127;
      const uint32_t addr = base + (byte >> 7) * (kM * kRow) + m * kRow +
                            (((b >> 4) ^ (m & 7)) << 4) + (b & 15);
      const float v0 = acc[s][4 * j + 2 * half], v1 = acc[s][4 * j + 2 * half + 1];
      if constexpr (kEs == 2) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                     "r"(*reinterpret_cast<const uint32_t*>(&v)));
      } else {
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0), "f"(v1));
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the copy
  asm volatile("bar.sync 2, 256;" ::: "memory");
  if (ctid == 0) {
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk)
      tma_store(omap, base + blk * (kM * kRow), k.nt * BN + blk * (128 / kEs),
                k.tx * p.tw, k.ty * p.th, k.tb * p.b, k.ks, p.ws != nullptr);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

template <typename T, int BN, int MW, int TAPS>
__global__ void __launch_bounds__(kThreads, 1)
    conv_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap, const Params p) {
  using Tr = Traits<T>;
  using S = Smem<T, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int halo_bytes = S::halo(p.halo_rows);
  uint8_t* halo = base;
  uint8_t* ostage = base + p.hst * halo_bytes;  // 1024-aligned: halo() rounds up
  uint8_t* wts = ostage + p.obytes;
  uint64_t* full_h = reinterpret_cast<uint64_t*>(wts + p.wst * S::kW);
  uint64_t* ready_h = full_h + kMaxHStages;  // a chunk the multiplying warps may read
  uint64_t* empty_h = ready_h + kMaxHStages;
  uint64_t* full_w = empty_h + kMaxHStages;
  uint64_t* empty_w = full_w + kMaxWStages;
  constexpr int kCols = TAPS / 3;  // taps a kernel row: 3, or 4 input columns a pair
  // the BN prologue exists only for the plain conv
  const bool tma = p.copy == 0, bn = TAPS == 9 && p.scale != nullptr;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.hst; ++s) {
      mbar_init(full_h + s, 1);      // TMA: the expected bytes
      mbar_init(ready_h + s, 96);    // warps 1-3, after the copies and the prologue
      mbar_init(empty_h + s, 8);     // one arrival per multiplying warp
    }
    for (int s = 0; s < p.wst; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Registers from the copying warpgroup to the multiplying ones where
  // these use them: two bf16 slabs (128 accumulators a thread at BN 128),
  // and fp32's split of A. Not for one bf16 slab: the BN prologue (which
  // two-slab tiles never run) would spill at 40.
  constexpr bool kRebalance = sizeof(T) == 4 || MW == 2;
  if (tid < 128) {  // the copying warpgroup
    if constexpr (kRebalance)  // all 128 threads, together
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    Clock clk;
    if (tid == 0) {
      // One thread issues every TMA: the weights, one (chunk, tap) tile per
      // stage, and (with TMA staging) the halo tiles, each as soon as its
      // ring has a free stage; two cursors walk the same units.
      Cursor<TAPS> hc(p), wc(p);
      int hs = 0, hph = 0, ws = 0, wph = 0;
      if (!tma) hc.work = p.works;  // warps 1-3 stage the halo
      while (!hc.done(p) || !wc.done(p)) {
        bool idle = true;
        if (!hc.done(p) && mbar_test(empty_h + hs, hph ^ 1)) {
          // order the prologue's stores to this stage before the copy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(full_h + hs, p.halo_rows * kRow);
          tma_load_4d(smem_u32(halo + hs * halo_bytes), &xmap, full_h + hs,
                      hc.u / TAPS * Tr::kChunk, hc.k.tx * (p.hw - 2) - 1, hc.k.ty * p.th - 1,
                      hc.k.tb * p.b);
          if (++hs == p.hst) hs = 0, hph ^= 1;
          hc.next_halo(p);
          idle = false;
        }
        if (!wc.done(p) && mbar_test(empty_w + ws, wph ^ 1)) {
          uint8_t* dst = wts + ws * S::kW;
          mbar_expect_tx(full_w + ws, S::kW);
#pragma unroll
          for (int part = 0; part < Tr::kParts; ++part)
            tma_load_2d(smem_u32(dst + part * BN * kRow), &wmap, full_w + ws,
                        wc.u / TAPS * Tr::kChunk,
                        (wc.u % TAPS * Tr::kParts + part) * p.cout_pad + wc.k.nt * BN);
          if (++ws == p.wst) ws = 0, wph ^= 1;
          wc.next(p);
          idle = false;
        }
        if (idle) __nanosleep(20);
      }
      return;
    }
    // warps 1-3: by cp.async, stage each halo tile; with the prologue,
    // apply it to each chunk once it has landed (by TMA, the multiplying
    // warps without it wait on the TMA's own barrier)
    if (tid < 32 || (tma && !bn)) return;
    const int htid = tid - 32;
    int hs = 0, hph = 0;
    // by cp.async with Cin in one chunk, the cells beyond Cin are the same
    // zeros in every tile: zero every stage once, then stage the rest
    int cols = 8;
    if (!tma && p.units == TAPS) {
      cols = (p.cin * (int)sizeof(T) + 15) / 16;
      for (int i = htid; i < p.hst * halo_bytes / 16; i += 96)
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(smem_u32(halo) + 16 * i),
                     "r"(0));
      asm volatile("bar.sync 1, 96;" ::: "memory");
    }
    for (Cursor<TAPS> hc(p); !hc.done(p); hc.next_halo(p)) {
      const Work& k = hc.k;
      const int chunk = hc.u / TAPS;
      uint8_t* dst = halo + hs * halo_bytes;
      clk.start();
      if (tma) {
        mbar_wait(full_h + hs, hph);
      } else {
        mbar_wait(empty_h + hs, hph ^ 1);
        switch (p.copy) {
          case 8: stage_halo<T, 8>(p, k, dst, chunk, htid, 96, cols); break;
          case 4: stage_halo<T, 4>(p, k, dst, chunk, htid, 96, cols); break;
          default: stage_halo<T, 2>(p, k, dst, chunk, htid, 96, cols); break;
        }
        if (bn) asm volatile("bar.sync 1, 96;" ::: "memory");  // every cell has landed
      }
      clk.add(5);
      clk.start();
      if (bn) {
        bn_prologue<T>(p, k, dst, chunk, htid, 96);
        // the stores before any later copy into this stage
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      clk.add(6);
      mbar_arrive(ready_h + hs);
      if (++hs == p.hst) hs = 0, hph ^= 1;
    }
    save_clock(clk, htid == 0);
    return;
  }

  // the multiplying warpgroups: MW slabs of 64 rows each, rows
  // 64 MW wg .. 64 MW (wg + 1) - 1 of the tile
  if constexpr (kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  uint64_t* ready = tma && !bn ? full_h : ready_h;
  const int ctid = tid - 128, wg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
  const int tpix = p.th * p.tw;
  const int khalf = lane >> 4;
  // this lane's ldmatrix row in each slab (rows 0-15 of the warp's 16, K
  // half lane/16), as a halo row at tap (0, 0): output column c reads
  // input columns step c - 1 .. step c + kCols - 2
  int hrow0[MW];
#pragma unroll
  for (int s = 0; s < MW; ++s) {
    const int lrow = 64 * (MW * wg + s) + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    hrow0[s] = ((lrow / tpix) * (p.th + 2) + (lrow % tpix) / p.tw) * p.hw +
               p.step * (lrow % p.tw);
  }
  const size_t plane = (size_t)p.n * p.h * p.w;
  float acc[MW][BN / 2];
  // A of this unit and of the next, loaded while this unit's products run;
  // fp32 reads its own split of A, so one buffer serves both
  uint32_t a0[MW][4][4], a1[MW][4][4];
  Frag<T> frag;
  int hs = 0, hph = 0, ws = 0, wph = 0;
  uint32_t hbase = 0;
  Clock clk;
#ifdef CONV_TC_TRACE
  const long long t_loop = clock64();
#endif

  // ldmatrix the warp's 16 rows of unit u (chunk u / TAPS at tap u % TAPS) from
  // its halo tile; release the tile after its last tap
  auto load_a = [&](const Work& k, int u, uint32_t(&a)[MW][4][4]) {
    clk.start(1);
    const int tap = u % TAPS;
    if (u == k.u0 || tap == 0) {
      clk.start();
      mbar_wait(ready + hs, hph);
      clk.add(0);
      hbase = smem_u32(halo + hs * halo_bytes);
    }
    const int shift = (tap / kCols) * p.hw + tap % kCols;
#pragma unroll
    for (int s = 0; s < MW; ++s) {
      const int hrow = hrow0[s] + shift;
      const uint32_t arow = hbase + hrow * kRow;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        ldsm_x4(a[s][k4], arow + (((2 * k4 + khalf) ^ (hrow & 7)) << 4));
    }
    if (u == k.u1 - 1 || tap == TAPS - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_h + hs);
      if (++hs == p.hst) hs = 0, hph ^= 1;
    }
    clk.add(7, 1);
  };
  auto release_w = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_w + stage);
  };
  // unit u's products from cur; the next unit's A into nxt under them
  auto unit = [&](const Work& k, int u, uint32_t(&cur)[MW][4][4], uint32_t(&nxt)[MW][4][4]) {
    clk.start();
    mbar_wait(full_w + ws, wph);
    clk.add(1);
    clk.start();
    fence_acc(acc);
    frag.template mma<BN, MW>(acc, cur, smem_u32(wts + ws * S::kW));
    wgmma_commit();
    if constexpr (sizeof(T) == 2) {
      // bf16: leave this unit's group in flight; the previous unit's is
      // done once at most one is pending, freeing its stage and its A (nxt)
      wgmma_wait1();
      clk.add(2);
      frag.hold(nxt);
      if (u > k.u0) release_w(ws == 0 ? p.wst - 1 : ws - 1);
      if (u + 1 < k.u1) load_a(k, u + 1, nxt);
    } else {
      // fp32: its split of A is one buffer, so the group ends here
      if (u + 1 < k.u1) load_a(k, u + 1, nxt);
      wgmma_wait0();
      clk.add(2);
      frag.hold(cur);
      fence_acc(acc);
      release_w(ws);
    }
    if (++ws == p.wst) ws = 0, wph ^= 1;
  };

  for (int work = blockIdx.x; work < p.works; work += gridDim.x) {
    const Work k = decode(p, work);
#pragma unroll
    for (int s = 0; s < MW; ++s)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.f;
    load_a(k, k.u0, a0);
    if constexpr (sizeof(T) == 2) {
      for (int u = k.u0; u < k.u1; u += 2) {
        unit(k, u, a0, a1);
        if (u + 1 < k.u1) unit(k, u + 1, a1, a0);
      }
      wgmma_wait0();
      frag.hold(a0);
      frag.hold(a1);
      fence_acc(acc);
      release_w(ws == 0 ? p.wst - 1 : ws - 1);
    } else {
      for (int u = k.u0; u < k.u1; ++u) unit(k, u, a0, a0);
    }

    clk.start();
    // accumulator rows lane/4 and lane/4 + 8 of the warp's 16, channel
    // pairs 8 j + 2 (lane % 4): to this K split's slice of the workspace,
    // or cast to the output
    if (p.obytes && (p.ws || !p.out_bf16))
      epilogue_tma<BN, MW, float>(ostage, &omap, p, k, acc, wg, warp, lane, ctid);
    else if (p.obytes)
      epilogue_tma<BN, MW, __nv_bfloat16>(ostage, &omap, p, k, acc, wg, warp, lane, ctid);
    else if (p.ws)
      epilogue<BN, MW>(p.ws + k.ks * plane * p.cout, p, k, acc, wg, warp, lane);
    else if (p.out_bf16)
      epilogue<BN, MW>(static_cast<__nv_bfloat16*>(p.out), p, k, acc, wg, warp, lane);
    else
      epilogue<BN, MW>(static_cast<float*>(p.out), p, k, acc, wg, warp, lane);
    clk.add(3);
  }
#ifdef CONV_TC_TRACE
  clk.sum[4] = clock64() - t_loop;
#endif
  // the last tile's stores done before the block's shared memory goes
  if (p.obytes && ctid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  save_clock(clk, ctid == 0);
}

// The K split's partial sums added in split order and cast once.
template <typename TO>
__global__ void splitk_reduce(const float* __restrict__ ws, TO* __restrict__ out,
                              long long count, int ksplit) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < ksplit; ++k) s += ws[k * count + i];
    from_f32(out + i, s);
  }
}

// (3, taps / 3, cin, cout) -> K-major rows ((tap * parts + part) *
// cout_pad + n, kp): zero beyond Cin and Cout; fp32 as tf32 hi (part 0) and
// lo (part 1). The conv's HWIO weights have 9 taps, the pairs form's fused
// weights 12, their lanes as cout. One block transposes a 32 x 32 (Cin, Cout) tile of one tap through
// shared memory, so reads and writes are both coalesced.
template <typename T>
__global__ void __launch_bounds__(256) pack_weights(const T* __restrict__ w, T* __restrict__ wp,
                                                    int cin, int cout, int kp, int cout_pad) {
  constexpr int kParts = Traits<T>::kParts;
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tap = blockIdx.z;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, n = n0 + tx;
    tile[r][tx] = c < cin && n < cout ? to_f32(w[((size_t)tap * cin + c) * cout + n]) : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r, c = c0 + tx;
    if (n >= cout_pad || c >= kp) continue;
    const float v = tile[tx][r];
    const size_t row = (size_t)tap * kParts * cout_pad + n;
    if constexpr (kParts == 1) {
      from_f32(wp + row * kp + c, v);  // bf16 -> fp32 -> bf16 is exact
    } else {
      const uint32_t hi = to_tf32(v);
      wp[row * kp + c] = __uint_as_float(hi);
      wp[(row + cout_pad) * kp + c] = __uint_as_float(to_tf32(v - __uint_as_float(hi)));
    }
  }
}

int grid_for(long long count) {
  return (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
}

template <typename T, int BN, int MW, int TAPS>
cudaError_t launch(Params p, const void* w, void* wpack, int kp, int sms, cudaStream_t s) {
  using Tr = Traits<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  const auto kernel = conv_tc_kernel<T, BN, MW, TAPS>;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  pack_weights<T><<<dim3(kp / 32, p.cout_pad / 32, TAPS), 256, 0, s>>>(
      static_cast<const T*>(w), static_cast<T*>(wpack), p.cin, p.cout, kp, p.cout_pad);
  CUtensorMap xmap = {}, wmap = {};
  const int es = (int)sizeof(T);
  if (p.copy == 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)p.cin, (cuuint64_t)p.wi, (cuuint64_t)p.h,
                                (cuuint64_t)p.n};
    const cuuint64_t strides[3] = {(cuuint64_t)p.cin * es, (cuuint64_t)p.wi * p.cin * es,
                                   (cuuint64_t)p.h * p.wi * p.cin * es};
    const cuuint32_t box[4] = {(cuuint32_t)Tr::kChunk, (cuuint32_t)p.hw,
                               (cuuint32_t)p.th + 2, (cuuint32_t)p.b};
    if (!encode(&xmap, kBf16, 4, p.x, dims, strides, box)) return cudaErrorInvalidValue;
  }
  const cuuint64_t wdims[2] = {(cuuint64_t)kp, (cuuint64_t)TAPS * Tr::kParts * p.cout_pad};
  const cuuint64_t wstrides[1] = {(cuuint64_t)kp * es};
  const cuuint32_t wbox[2] = {(cuuint32_t)Tr::kChunk, (cuuint32_t)BN};
  if (!encode(&wmap, kBf16, 2, wpack, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  // The output by TMA where its rows of Cout are 16-byte multiples (and the
  // base aligned): the output itself, or the fp32 workspace of the K split
  // as (ksplit, n, h, w, cout); else direct stores.
  CUtensorMap omap = {};
  const bool split = p.ksplit > 1, obf16 = p.out_bf16 && !split;
  const int eo = obf16 ? 2 : 4;
  const void* dst = split ? static_cast<const void*>(p.ws) : p.out;
  p.obytes = 0;
  if ((p.cout * eo) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const cuuint64_t row = (cuuint64_t)p.cout * eo;
    const cuuint64_t dims[5] = {(cuuint64_t)p.cout, (cuuint64_t)p.w, (cuuint64_t)p.h,
                                (cuuint64_t)p.n, (cuuint64_t)p.ksplit};
    const cuuint64_t strides[4] = {row, row * p.w, row * p.w * p.h, row * p.w * p.h * p.n};
    const cuuint32_t box[5] = {(cuuint32_t)(128 / eo), (cuuint32_t)p.tw, (cuuint32_t)p.th,
                               (cuuint32_t)p.b, 1};
    if (encode(&omap, obf16, split ? 5 : 4, dst, dims, strides, box))
      p.obytes = BN * eo * kTileM * MW;
  }
  // the rings as deep as the shared memory allows (without the staging
  // where two weight stages would not fit beside it)
  using Sm = Smem<T, BN>;
  if (Sm::total(p.halo_rows, 2, 2, p.obytes) > kSmemMax) p.obytes = 0;
  auto wstages = [&](int hst) {
    const int n = (kSmemMax - Sm::total(p.halo_rows, hst, 0, p.obytes)) / Sm::kW;
    return n < kMaxWStages ? n : kMaxWStages;
  };
  // a third halo stage where 4 weight stages still fit beside it
  p.hst = wstages(kMaxHStages) >= 4 ? kMaxHStages : 2;
  p.wst = wstages(p.hst);
  if (p.wst < 2) return cudaErrorInvalidValue;
  kernel<<<p.works < sms ? p.works : sms, kThreads,
           Sm::total(p.halo_rows, p.hst, p.wst, p.obytes), s>>>(xmap, wmap, omap, p);
  if (p.ksplit > 1) {
    const long long count = (long long)p.n * p.h * p.w * p.cout;
    if (p.out_bf16)
      splitk_reduce<<<grid_for(count), 256, 0, s>>>(
          p.ws, static_cast<__nv_bfloat16*>(p.out), count, p.ksplit);
    else
      splitk_reduce<<<grid_for(count), 256, 0, s>>>(p.ws, static_cast<float*>(p.out), count,
                                                      p.ksplit);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous (n, h, wd, cin); w: contiguous (3, 3, cin, cout), or with
// pairs = 1 the fused weights (3, 4, cin, 2 cout) of fuse_pair_weights and
// wd even; both fp32 (in_bf16 = 0) or bf16 (in_bf16 = 1). out: contiguous
// (n, h, wd, cout) fp32 (out_bf16 = 0) or bf16. scale, shift: contiguous
// (cin,) fp32 for the BN prologue, or both null (always null in pairs). The
// plan (_kernels.conv_plan): tile b x th x tw output columns (pixels, or
// pairs of pixels in pairs; 128 of them, or 256 for the bf16 conv), bn (64
// or 128) of the cout output channels (pairs: of the 2 cout lanes), K split
// ksplit, copy 0 (the halo by TMA: cin * sizeof(T) and x 16-byte aligned) or
// the cp.async unit in bytes (8, 4; 2 = plain loads, bf16 only). wpack:
// scratch for the packed weights, taps * parts * cout_pad * kp elements of
// x's type (taps 9, pairs 12; parts 1 for bf16, 2 for fp32; cout_pad = bn *
// ceil(lanes / bn), lanes cout or pairs 2 cout; kp = chunk * ceil(cin /
// chunk), chunk 64 for bf16 and 32 for fp32). ws: fp32 scratch of ksplit *
// n * h * wd * cout for ksplit > 1, else null. sms: the persistent grid's
// size. Returns the launches' cudaError_t (0 = queued).
int dcnn_conv3x3_tc(const void* x, const void* w, const void* scale, const void* shift, void* out,
                    void* wpack, void* ws, int n, int h, int wd, int cin, int cout, int b, int th,
                    int tw, int bn, int ksplit, int copy, int in_bf16, int out_bf16, int pairs,
                    int sms, void* stream) {
  const int es = in_bf16 ? 2 : 4, chunk = kRow / es;
  const int chunks = (cin + chunk - 1) / chunk;
  const int taps = pairs ? 12 : 9, step = pairs ? 2 : 1;
  const long long units = (long long)taps * chunks;
  const long long hw = (long long)step * tw + 2;
  const long long rows = (long long)b * (th + 2) * hw;
  // 128 output columns a tile (one 64-row slab per multiplying warpgroup)
  // or, for the bf16 conv only, 256 (two)
  const int mw = b * th * tw == kTileM ? 1 : b * th * tw == 2 * kTileM ? 2 : 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool copy_ok =
      copy == 0 ? (cin * es) % 16 == 0 && xa % 16 == 0
                : (copy == 8 || copy == 4 || (copy == 2 && in_bf16)) &&
                      (cin * es) % copy == 0 && xa % copy == 0;
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || b < 1 || th < 1 || tw < 1 ||
      (pairs != 0 && pairs != 1) || (pairs && (wd % 2 || scale != nullptr)) ||
      (mw != 1 && !(mw == 2 && in_bf16 && !pairs)) || rows > kMaxHaloRows || hw > 256 ||
      th + 2 > 256 || b > 256 || (bn != 64 && bn != 128) || ksplit < 1 || ksplit > units ||
      units * ksplit > 0x7fffffff || (ksplit > 1) != (ws != nullptr) ||
      (scale == nullptr) != (shift == nullptr) || !copy_ok || sms < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  // pairs: the output (n, h, wd, cout) as (n, h, wd / 2, 2 cout), the same memory
  p.n = n, p.h = h, p.w = wd / step, p.wi = wd, p.cin = cin, p.cout = cout * step;
  p.b = b, p.th = th, p.tw = tw, p.step = step, p.hw = (int)hw;
  p.tiles_x = (p.w + tw - 1) / tw;
  p.tiles_y = (h + th - 1) / th;
  p.tiles_n = (p.cout + bn - 1) / bn;
  p.units = (int)units;
  p.ksplit = ksplit;
  const long long works =
      (long long)((n + b - 1) / b) * p.tiles_y * p.tiles_x * ksplit * p.tiles_n;
  if (works > 0x7fffffff) return cudaErrorInvalidValue;
  p.works = (int)works;
  p.cout_pad = p.tiles_n * bn;
  p.halo_rows = (int)rows;
  p.copy = copy;
  p.out_bf16 = out_bf16;
  const int kp = chunks * chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (pairs && in_bf16)
    return static_cast<int>(bn == 64 ? launch<BF, 64, 1, 12>(p, w, wpack, kp, sms, s)
                                     : launch<BF, 128, 1, 12>(p, w, wpack, kp, sms, s));
  if (pairs)
    return static_cast<int>(bn == 64 ? launch<float, 64, 1, 12>(p, w, wpack, kp, sms, s)
                                     : launch<float, 128, 1, 12>(p, w, wpack, kp, sms, s));
  if (in_bf16 && mw == 2)
    return static_cast<int>(bn == 64 ? launch<BF, 64, 2, 9>(p, w, wpack, kp, sms, s)
                                     : launch<BF, 128, 2, 9>(p, w, wpack, kp, sms, s));
  if (in_bf16)
    return static_cast<int>(bn == 64 ? launch<BF, 64, 1, 9>(p, w, wpack, kp, sms, s)
                                     : launch<BF, 128, 1, 9>(p, w, wpack, kp, sms, s));
  return static_cast<int>(bn == 64 ? launch<float, 64, 1, 9>(p, w, wpack, kp, sms, s)
                                   : launch<float, 128, 1, 9>(p, w, wpack, kp, sms, s));
}

#ifdef CONV_TC_TRACE
// the diagnostic build's per-block clock counts (1024 x 8), zeroed after
int dcnn_conv3x3_tc_trace(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess) {
    static long long zeros[1024][8];
    err = cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));
  }
  return static_cast<int>(err);
}
#endif

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
