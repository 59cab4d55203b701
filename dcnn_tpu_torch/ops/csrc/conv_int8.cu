// int8 x int8 -> int32 2-D convolution for Hopper (sm_90a), with a plain C
// interface bound from Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/conv.py::conv2d_int8, the JAX package's int8 conv
// (lax.conv_general_dilated with preferred_element_type=int32, which XLA
// lowers onto the TPU's int8 matrix unit). It is no Pallas kernel, but no
// PyTorch call computes this function on the card, so the port writes it.
// Same function:
//   y[n, o, p, q] = sum_{c, r, s} x[n, c, p*sh + r - ph, q*sw + s - pw] * w[o, c, r, s]
// with reads outside the image taken as 0, int8 operands, int32 sums and an
// int32 result. Integer sums are exact in any order, so the kernel equals its
// plain version (a float64 conv cast to int32) bit for bit.
//
// Design: an implicit GEMM. Rows (M) are the output pixels n*P*Q, columns (N)
// the output channels, and the reduction (K) runs over (r, s, c) in that
// order, so that for channels-last input the 16 bytes of one K chunk are 16
// neighbouring channels of one input pixel. The weights come packed by the
// wrapper as (O, Kp): OIHW permuted to (O, R, S, C), each row zero-padded to
// Kp, a multiple of 16. A block computes a 128 x 64 tile of y with 8 warps,
// each a 32 x 32 sub-tile of 2 x 4 mma.sync m16n8k32 s8.s8.s32 products. K is
// walked 64 bytes at a time through two shared-memory buffers: the global
// loads of the next chunk are issued into registers before the current chunk
// is multiplied, then stored to the other buffer, one barrier a chunk. Shared
// rows are 80 bytes, so the fragment loads of a warp hit 32 distinct banks.
// The image edge, K's tail and the ragged M and N edges are zero-filled in
// the loads and masked in the stores. Input and output are addressed through
// their four strides, so NCHW and NHWC both run; when the input's channels
// are contiguous, C is a multiple of 16 and every stride is too, a K chunk is
// one 16-byte load (kVec), otherwise it is gathered byte by byte (the stem's
// C = 3, NCHW input).
//
// What bounds it on an H100: at ResNet-18's body shapes, operations (the
// int8 tensor cores' 1,979 TOP/s dense against 3.35 TB/s of HBM); the stem and
// the 1x1 shortcuts are closer to bytes. mma.sync reaches only part of the
// tensor cores' rate on Hopper, and the loads are not overlapped beyond one
// chunk: wgmma with TMA-fed multi-stage rings is the redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 64;         // bytes of K per chunk
constexpr int kRow = kBK + 16;  // shared row, bytes: conflict-free fragment loads
constexpr int kThreads = 256;

struct Geometry {
  int h, w, c;                        // input
  int o, p, q;                        // output channels and spatial size
  int r, s, sh, sw, ph, pw;           // kernel, stride, padding
  long long xn, xc, xh, xw;           // input strides, elements
  long long yn, yc, yh, yw;           // output strides, elements
  int k, kp;                          // K = r*s*c; packed weight row length
  int m;                              // n*p*q
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output pixel's place in the input, for a row of the A tile.
struct PixelRow {
  long long base;  // offset of image n
  int ih, iw;      // top-left input coordinates of its window
  bool ok;         // the row is inside M
};

__device__ __forceinline__ PixelRow pixel_row(const Geometry& g, int m) {
  PixelRow pr{0, 0, 0, m < g.m};
  if (pr.ok) {
    const int pq = g.p * g.q;
    const int n = m / pq, rem = m - n * pq;
    const int pp = rem / g.q, qq = rem - pp * g.q;
    pr.base = (long long)n * g.xn;
    pr.ih = pp * g.sh - g.ph;
    pr.iw = qq * g.sw - g.pw;
  }
  return pr;
}

// The 16 bytes of K [k0, k0 + 16) of one A row.
template <bool kVec>
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ x, const Geometry& g,
                                        const PixelRow& pr, int k0) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!pr.ok || k0 >= g.k) return v;
  if (kVec) {  // C % 16 == 0: the chunk is 16 channels of one input pixel
    const int rs = k0 / g.c, c0 = k0 - rs * g.c;
    const int r = rs / g.s, s = rs - r * g.s;
    const int ih = pr.ih + r, iw = pr.iw + s;
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
      v = *reinterpret_cast<const uint4*>(x + pr.base + ih * g.xh + iw * g.xw + c0);
    return v;
  }
  uint32_t word[4] = {0, 0, 0, 0};
  int rs = k0 / g.c, c = k0 - rs * g.c;
  int r = rs / g.s, s = rs - r * g.s;
  for (int j = 0; j < 16 && k0 + j < g.k; ++j) {
    const int ih = pr.ih + r, iw = pr.iw + s;
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
      const uint32_t b = (uint8_t)x[pr.base + c * g.xc + ih * g.xh + iw * g.xw];
      word[j >> 2] |= b << (8 * (j & 3));
    }
    if (++c == g.c) {
      c = 0;
      if (++s == g.s) { s = 0; ++r; }
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                 int32_t* __restrict__ y, const Geometry g) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // loaders: A is 128 rows x 4 chunks of 16 bytes (two chunks a thread,
  // rows tid/4 and tid/4 + 64), B 64 rows x 4 chunks (one a thread)
  const int ld_row = tid >> 2, ld_k = (tid & 3) * 16;
  const PixelRow pr0 = pixel_row(g, m0 + ld_row);
  const PixelRow pr1 = pixel_row(g, m0 + ld_row + 64);
  const bool b_ok = n0 + ld_row < g.o;
  const int8_t* b_src = wk + (long long)(n0 + ld_row) * g.kp;

  uint4 ra0, ra1, rb;
  auto fetch = [&](int kt) {
    const int k0 = kt * kBK + ld_k;
    ra0 = load_a<kVec>(x, g, pr0, k0);
    ra1 = load_a<kVec>(x, g, pr1, k0);
    rb = (b_ok && k0 < g.kp) ? *reinterpret_cast<const uint4*>(b_src + k0)
                             : make_uint4(0, 0, 0, 0);
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&sa[buf][ld_row * kRow + ld_k]) = ra0;
    *reinterpret_cast<uint4*>(&sa[buf][(ld_row + 64) * kRow + ld_k]) = ra1;
    *reinterpret_cast<uint4*>(&sb[buf][ld_row * kRow + ld_k]) = rb;
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int gid = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = (g.k + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < chunks; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < chunks) fetch(kt + 1);
    const int8_t* A = sa[buf];
    const int8_t* B = sb[buf];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = A + (wm + i * 16 + gid) * kRow + kk + tig * 4;
        const int8_t* r8 = r0 + 8 * kRow;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* col = B + (wn + j * 8 + gid) * kRow + kk + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    if (kt + 1 < chunks) stash(buf ^ 1);
    __syncthreads();
  }

  // epilogue: acc[i][j] holds rows wm + 16i + gid (+8) and columns
  // wn + 8j + 2 tig (+1) of the tile
  const int pq = g.p * g.q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= g.m) continue;
      const int n = m / pq, rem = m - n * pq;
      const int pp = rem / g.q, qq = rem - pp * g.q;
      int32_t* yrow = y + n * g.yn + pp * g.yh + qq * g.yw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + wn + j * 8 + tig * 2 + e;
          if (o < g.o) yrow[o * g.yc] = acc[i][j][half * 2 + e];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: int8 input (N, C, H, W) addressed by the element strides xs_*; wk: int8
// weights packed (O, kp), K ordered (r, s, c) and zero past r*s*c, 16-byte
// aligned; y: int32 output (N, O, P, Q) addressed by ys_*. vec = 1 asks for
// 16-byte input loads: channel stride 1, c % 16 == 0, the other input
// strides multiples of 16 and x 16-byte aligned (the wrapper checks).
// Returns the launch's cudaError_t (0 = queued).
int dcnn_conv_int8(const void* x, const void* wk, void* y, int n, int c, int h, int w,
                   int o, int p, int q, int r, int s, int sh, int sw, int ph, int pw,
                   long long xs_n, long long xs_c, long long xs_h, long long xs_w,
                   long long ys_n, long long ys_c, long long ys_h, long long ys_w,
                   int kp, int vec, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || o < 1 || p < 1 || q < 1 || r < 1 || s < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0 || kp % 16 || kp < r * s * c)
    return cudaErrorInvalidValue;
  const long long m = (long long)n * p * q;
  if (m >= (1LL << 31) - kBM) return cudaErrorInvalidValue;
  Geometry g{h, w, c, o, p, q, r, s, sh, sw, ph, pw, xs_n, xs_c, xs_h, xs_w,
             ys_n, ys_c, ys_h, ys_w, r * s * c, kp, (int)m};
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((o + kBN - 1) / kBN));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wk);
  int32_t* yi = static_cast<int32_t*>(y);
  if (vec)
    conv_int8_kernel<true><<<grid, kThreads, 0, st>>>(xi, wi, yi, g);
  else
    conv_int8_kernel<false><<<grid, kThreads, 0, st>>>(xi, wi, yi, g);
  return static_cast<int>(cudaGetLastError());
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
