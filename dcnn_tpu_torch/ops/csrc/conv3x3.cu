// The 3x3 stride-1 SAME convolution in its output-column-pair form, as an
// implicit GEMM on the CUDA cores of Hopper (sm_90a), with a plain C
// interface bound from Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces the Pallas TPU kernel _conv3x3_pairs_kernel of
// dcnn_tpu/ops/pallas/conv.py (conv3x3_s1_pairs, called at :173). The plain
// conv and the BN-prologue conv run on the tensor cores in conv3x3_tc.cu.
// Same function: x (N, H, W, Cin) NHWC, W even, and the block-sparse fused
// weights w2 (3, 4, Cin, 2 * Cout) of fuse_pair_weights: output pair
// (2p, 2p+1) of a row is one product of the 4 zero-padded input columns
// 2p..2p+3 against w2, lanes [0, Cout) giving column 2p and lanes
// [Cout, 2 Cout) column 2p+1, 12 products per pair where the plain conv has
// 9 per pixel, so a wrong w2 layout gives a wrong result. Accumulated in
// fp32, cast to the output type once.
//
// Design. One block of 256 threads computes one output tile of one image:
// 8 rows x 8 pairs (16 columns) x 64 of the 2 Cout lanes. Each thread
// holds a 4 x 4 (pixels x lanes) fp32 accumulator in registers. The block
// walks Cin in chunks of 32: per chunk it stages the input tile with its
// 1-pixel halo in shared memory, zero-filled beyond the image edge and
// beyond Cin (the Pallas "pad in VMEM": no padded copy in HBM), and the
// chunk's weights of all 12 taps, both widened to fp32 on load, then runs
// the taps x channels loop of FMAs. Shared memory is 121 KB, above the
// 48 KB default, so the launch raises the kernel's dynamic shared-memory
// limit once per instantiation, never inside a CUDA-graph capture after the
// first call. The TPU kernel's batch_tile and h_tile are TPU tilings; the
// wrapper validates them as the JAX function does, and this tiling is the
// kernel's own.
//
// What bounds it on an H100. At ResNet-18's layer1 the work is 2 N H W 12
// Cin Cout FLOPs over a few MB, far above the card's ops:byte line, so the
// conv is bound by operations. It runs its FMAs on the CUDA cores
// (67 TFLOP/s fp32), not on the tensor cores: moving it onto wgmma, as
// conv3x3_tc.cu does for the plain conv, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;          // output rows per tile
constexpr int kTW = 8;          // output pairs per tile
constexpr int kNT = 64;         // pair lanes per tile
constexpr int kCK = 32;         // input channels per staged chunk
constexpr int kTapCols = 4;     // taps per kernel row: padded columns 2p .. 2p+3
constexpr int kTaps = 3 * kTapCols;
constexpr int kCols = 2 * kTW;  // staged columns, halo aside
constexpr int kIn = (kTH + 2) * (kCols + 2) * kCK;  // staged input floats
constexpr size_t kSmem = (kIn + kTaps * kCK * kNT) * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage input rows y0-1 .. y0+kTH and columns x0-1 .. x0+kCols of channels
// c0 .. c0+kCK-1 of one image, zero outside the image and beyond Cin.
template <typename T>
__device__ __forceinline__ void stage_input(float* sX, const T* __restrict__ xn, int y0,
                                            int x0, int c0, int h, int wd, int cin) {
  constexpr int kRowLen = kCols + 2;
  for (int e = threadIdx.x; e < (kTH + 2) * kRowLen * kCK; e += kThreads) {
    const int c = e % kCK, pix = e / kCK;
    const int iy = y0 - 1 + pix / kRowLen, ix = x0 - 1 + pix % kRowLen, ci = c0 + c;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd && ci < cin)
      v = to_f32(xn[((size_t)iy * wd + ix) * cin + ci]);
    sX[e] = v;
  }
}

// Stage taps x channels c0 .. c0+kCK-1 x lanes n0 .. n0+kNT-1 of weights laid
// out (taps, cin, lanes), zero beyond Cin and beyond the lanes.
template <typename T>
__device__ __forceinline__ void stage_weights(float* sW, const T* __restrict__ w, int c0,
                                              int n0, int cin, int lanes) {
  for (int e = threadIdx.x; e < kTaps * kCK * kNT; e += kThreads) {
    const int k = e % kNT, c = (e / kNT) % kCK, tap = e / (kNT * kCK);
    const int ci = c0 + c, n = n0 + k;
    sW[e] = (ci < cin && n < lanes) ? to_f32(w[((size_t)tap * cin + ci) * lanes + n]) : 0.f;
  }
}

// One block: kTH rows x kTW pairs of one image by kNT of the 2 Cout lanes
// of w2 (lane n < Cout is column 2p, lane Cout + n column 2p+1).
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
conv3x3_pairs_kernel(const T* __restrict__ x, const T* __restrict__ w, TO* __restrict__ out,
                     int h, int wd, int cin, int cout, int tiles_w) {
  extern __shared__ float smem[];
  float* sX = smem;
  float* sW = sX + kIn;
  const int tp = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int lanes = 2 * cout, units = wd / 2;
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
    stage_input<T>(sX, xn, y0, 2 * u0, c0, h, wd, cin);
    stage_weights<T>(sW, w, c0, n0, cin, lanes);
    __syncthreads();
    const int kc = min(kCK, cin - c0);
#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      const int kh = tap / kTapCols, kw = tap % kTapCols;
      const float* wt = sW + tap * kCK * kNT + tc;
      int base[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tp + 16 * i;
        base[i] = ((p / kTW + kh) * (kCols + 2) + 2 * (p % kTW) + kw) * kCK;
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
      const int odd = n >= cout, co = n - odd * cout;
      store(out + ((img * h + oy) * wd + 2 * unit + odd) * cout + co, acc[i][j]);
    }
  }
}

template <typename T, typename TO>
cudaError_t launch_pairs(const void* x, const void* w, void* out, int n, int h, int wd, int cin,
                         int cout, cudaStream_t stream) {
  // raise the dynamic shared-memory limit once per instantiation (a repeat
  // is harmless), never inside a CUDA-graph capture after the first call
  static bool raised = false;
  const auto kernel = conv3x3_pairs_kernel<T, TO>;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int tiles_w = (wd / 2 + kTW - 1) / kTW, tiles_h = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_h * tiles_w, (2 * cout + kNT - 1) / kNT, n);
  kernel<<<grid, kThreads, kSmem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<TO*>(out), h, wd, cin, cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous (n, h, wd, cin), wd even; w2: the contiguous fused weights
// (3, 4, cin, 2 cout) of fuse_pair_weights; both fp32 (in_bf16 = 0) or bf16
// (in_bf16 = 1). out: contiguous (n, h, wd, cout) fp32 (out_bf16 = 0) or
// bf16. Returns the launch's cudaError_t (0 = queued).
int dcnn_conv3x3_pairs(const void* x, const void* w2, void* out, int n, int h, int wd, int cin,
                       int cout, int in_bf16, int out_bf16, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || wd % 2 || cin < 1 || cout < 1 ||
      (2 * cout + kNT - 1) / kNT > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16)
    err = out_bf16 ? launch_pairs<BF, BF>(x, w2, out, n, h, wd, cin, cout, s)
                   : launch_pairs<BF, float>(x, w2, out, n, h, wd, cin, cout, s);
  else
    err = out_bf16 ? launch_pairs<float, BF>(x, w2, out, n, h, wd, cin, cout, s)
                   : launch_pairs<float, float>(x, w2, out, n, h, wd, cin, cout, s);
  return static_cast<int>(err);
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
