// 3x3 stride-1 SAME convolutions as implicit GEMMs for Hopper (sm_90a),
// with a plain C interface bound from Python through ctypes
// (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces the three Pallas TPU kernels of dcnn_tpu/ops/pallas/conv.py:
//   _conv3x3_kernel        (conv3x3_s1)           -> conv3x3_kernel<T, TO, false, false>
//   _conv3x3_bn_kernel     (conv3x3_s1_bnrelu_in) -> conv3x3_kernel<T, TO, true, false>
//   _conv3x3_pairs_kernel  (conv3x3_s1_pairs)     -> conv3x3_kernel<T, TO, false, true>
// Same functions: x (N, H, W, Cin) NHWC, weights HWIO (3, 3, Cin, Cout), the
// output (N, H, W, Cout) the sum over the 9 taps of the zero-padded input
// shifted by the tap times the tap's (Cin, Cout) weights, accumulated in
// fp32 and cast to the output type once. The BN variant first maps every
// real input cell to relu(x * scale + shift) in fp32 (no FMA contraction,
// as the plain version computes it), rounds that to x's type and only then
// pads: halo cells are 0, not relu(shift). The pairs variant consumes the
// block-sparse fused weights w2 (3, 4, Cin, 2 * Cout) of fuse_pair_weights:
// output pair (2p, 2p+1) of a row is one product of the 4 padded input
// columns 2p..2p+3 against w2, lanes [0, Cout) giving column 2p and lanes
// [Cout, 2 Cout) column 2p+1, 12 products per pair where the plain conv has
// 9 per pixel, so a wrong w2 layout gives a wrong result.
//
// Design. One kernel template serves all three. One block of 256 threads
// computes one output tile of one image: 8 x 8 pixels (the pairs form: 8
// rows x 8 pairs = 16 columns) x 64 output channels (the pairs form: 64 of
// the 2 Cout lanes). Each thread
// holds a 4 x 4 (pixels x channels) fp32 accumulator in registers. The
// block walks Cin in chunks of 32: per chunk it stages the input tile with
// its 1-pixel halo in shared memory, zero-filled beyond the image edge and
// beyond Cin (the Pallas "pad in VMEM": no padded copy in HBM), and the
// chunk's weights of all taps, both widened to fp32 on load, then runs the
// taps x channels loop of FMAs. Shared memory is 86.5 KB (plain, BN) and
// 121 KB (pairs), above the 48 KB default, so the launch raises the
// kernel's dynamic shared-memory limit once per instantiation, never
// inside a CUDA-graph capture after the first call. The TPU kernels'
// batch_tile and h_tile are TPU tilings; the wrappers validate them as the
// JAX functions do, and this tiling is the kernel's own.
//
// What bounds it on an H100. At ResNet-18's shapes the work is 2 N H W 9
// Cin Cout FLOPs over a few MB, far above the card's ops:byte line, so
// the conv is bound by operations. These kernels run their FMAs on the CUDA
// cores (67 TFLOP/s fp32), not on the tensor cores (989 TFLOP/s bf16): the
// simple, correct version. Moving the products onto wgmma with TMA-fed
// tiles is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;          // output rows per tile
constexpr int kTW = 8;          // output columns (plain) or pairs (pairs) per tile
constexpr int kNT = 64;         // output channels (or pair lanes) per tile
constexpr int kCK = 32;         // input channels per staged chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// the cast the Pallas BN kernel makes after its prologue: to x's type
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// What differs between the plain conv and the pairs conv, as constants: a
// tile's output unit is one pixel (plain) or one pair of adjacent columns
// (pairs); the weights have 3 x 3 taps (plain) or 3 x 4 (pairs, padded
// input columns 2p .. 2p+3 of pair p).
template <bool kPairs>
struct Form {
  static constexpr int kStep = kPairs ? 2 : 1;        // image columns per unit
  static constexpr int kTapCols = kPairs ? 4 : 3;     // taps per kernel row
  static constexpr int kTaps = 3 * kTapCols;
  static constexpr int kCols = kStep * kTW;           // staged columns, halo aside
  static constexpr int kIn = (kTH + 2) * (kCols + 2) * kCK;  // staged input floats
  static constexpr size_t kSmem = (kIn + kTaps * kCK * kNT) * sizeof(float);
};

// Stage input rows y0-1 .. y0+kTH and columns x0-1 .. x0+kCols of channels
// c0 .. c0+kCK-1 of one image, zero outside the image and beyond Cin.
template <typename T, int kCols, bool kBN>
__device__ __forceinline__ void stage_input(float* sX, const T* __restrict__ xn,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift, int y0,
                                            int x0, int c0, int h, int wd, int cin) {
  constexpr int kRowLen = kCols + 2;
  for (int e = threadIdx.x; e < (kTH + 2) * kRowLen * kCK; e += kThreads) {
    const int c = e % kCK, pix = e / kCK;
    const int iy = y0 - 1 + pix / kRowLen, ix = x0 - 1 + pix % kRowLen, ci = c0 + c;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd && ci < cin) {
      v = to_f32(xn[((size_t)iy * wd + ix) * cin + ci]);
      if (kBN) v = round_as(fmaxf(__fadd_rn(__fmul_rn(v, scale[ci]), shift[ci]), 0.f), xn);
    }
    sX[e] = v;
  }
}

// Stage taps x channels c0 .. c0+kCK-1 x lanes n0 .. n0+kNT-1 of weights laid
// out (taps, cin, lanes), zero beyond Cin and beyond the lanes.
template <typename T, int kTaps>
__device__ __forceinline__ void stage_weights(float* sW, const T* __restrict__ w, int c0,
                                              int n0, int cin, int lanes) {
  for (int e = threadIdx.x; e < kTaps * kCK * kNT; e += kThreads) {
    const int k = e % kNT, c = (e / kNT) % kCK, tap = e / (kNT * kCK);
    const int ci = c0 + c, n = n0 + k;
    sW[e] = (ci < cin && n < lanes) ? to_f32(w[((size_t)tap * cin + ci) * lanes + n]) : 0.f;
  }
}

// One block: kTH rows x kTW units of one image by kNT lanes. Lanes are the
// output channels (plain) or the 2 Cout lanes of w2 (pairs: lane n < Cout
// is column 2p, lane Cout + n column 2p+1).
template <typename T, typename TO, bool kBN, bool kPairs>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               TO* __restrict__ out, int h, int wd, int cin, int cout, int tiles_w) {
  using F = Form<kPairs>;
  extern __shared__ float smem[];
  float* sX = smem;
  float* sW = sX + F::kIn;
  const int tp = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int lanes = F::kStep * cout, units = wd / F::kStep;
  const int y0 = (blockIdx.x / tiles_w) * kTH, u0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kNT;
  const size_t img = blockIdx.z;
  const T* xn = x + img * h * wd * cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCK) {
    __syncthreads();  // the previous chunk's readers are done
    stage_input<T, F::kCols, kBN>(sX, xn, scale, shift, y0, F::kStep * u0, c0, h, wd, cin);
    stage_weights<T, F::kTaps>(sW, w, c0, n0, cin, lanes);
    __syncthreads();
    const int kc = min(kCK, cin - c0);
#pragma unroll 1
    for (int tap = 0; tap < F::kTaps; ++tap) {
      const int kh = tap / F::kTapCols, kw = tap % F::kTapCols;
      const float* wt = sW + tap * kCK * kNT + tc;
      int base[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tp + 16 * i;
        base[i] = ((p / kTW + kh) * (F::kCols + 2) + F::kStep * (p % kTW) + kw) * kCK;
      }
#pragma unroll 4
      for (int c = 0; c < kc; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sX[base[i] + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[c * kNT + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i, oy = y0 + p / kTW, unit = u0 + p % kTW;
    if (oy >= h || unit >= units) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 16 * j;
      if (n >= lanes) continue;
      const int odd = kPairs && n >= cout, co = n - odd * cout;
      store(out + ((img * h + oy) * wd + F::kStep * unit + odd) * cout + co, acc[i][j]);
    }
  }
}

// raise a kernel's dynamic shared-memory limit once per instantiation (a
// repeat is harmless), never inside a CUDA-graph capture after the first call
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* raised) {
  if (bytes <= 48 * 1024 || *raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *raised = true;
  return err;
}

template <typename T, typename TO, bool kBN, bool kPairs>
cudaError_t launch_conv(const void* x, const void* w, const void* scale, const void* shift,
                        void* out, int n, int h, int wd, int cin, int cout,
                        cudaStream_t stream) {
  using F = Form<kPairs>;
  static bool raised = false;
  const auto kernel = conv3x3_kernel<T, TO, kBN, kPairs>;
  const cudaError_t err = allow_smem(kernel, F::kSmem, &raised);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd / F::kStep + kTW - 1) / kTW, tiles_h = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_h * tiles_w, (F::kStep * cout + kNT - 1) / kNT, n);
  kernel<<<grid, kThreads, F::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<TO*>(out), h, wd, cin, cout, tiles_w);
  return cudaGetLastError();
}

template <bool kBN, bool kPairs>
cudaError_t dispatch_conv(const void* x, const void* w, const void* scale, const void* shift,
                          void* out, int n, int h, int wd, int cin, int cout, int in_bf16,
                          int out_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (in_bf16)
    return out_bf16
               ? launch_conv<BF, BF, kBN, kPairs>(x, w, scale, shift, out, n, h, wd, cin, cout, s)
               : launch_conv<BF, float, kBN, kPairs>(x, w, scale, shift, out, n, h, wd, cin,
                                                     cout, s);
  return out_bf16
             ? launch_conv<float, BF, kBN, kPairs>(x, w, scale, shift, out, n, h, wd, cin, cout,
                                                   s)
             : launch_conv<float, float, kBN, kPairs>(x, w, scale, shift, out, n, h, wd, cin,
                                                      cout, s);
}

}  // namespace

extern "C" {

// x: contiguous (n, h, wd, cin); w: contiguous (3, 3, cin, cout), or with
// pairs = 1 the fused (3, 4, cin, 2 cout) of fuse_pair_weights and wd even;
// both fp32 (in_bf16 = 0) or bf16 (in_bf16 = 1). out: contiguous (n, h, wd,
// cout) fp32 (out_bf16 = 0) or bf16. scale and shift: contiguous (cin,)
// fp32 for the BN prologue (not with pairs), or both null. Returns the
// launch's cudaError_t (0 = queued).
int dcnn_conv3x3(const void* x, const void* w, const void* scale, const void* shift,
                 void* out, int n, int h, int wd, int cin, int cout, int pairs, int in_bf16,
                 int out_bf16, void* stream) {
  const int lanes = pairs ? 2 * cout : cout;
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 ||
      (lanes + kNT - 1) / kNT > 65535 || (scale == nullptr) != (shift == nullptr) ||
      (pairs && (wd % 2 || scale != nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pairs)
    err = dispatch_conv<false, true>(x, w, nullptr, nullptr, out, n, h, wd, cin, cout, in_bf16,
                                     out_bf16, s);
  else if (scale)
    err = dispatch_conv<true, false>(x, w, scale, shift, out, n, h, wd, cin, cout, in_bf16,
                                     out_bf16, s);
  else
    err = dispatch_conv<false, false>(x, w, nullptr, nullptr, out, n, h, wd, cin, cout,
                                      in_bf16, out_bf16, s);
  return static_cast<int>(err);
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
