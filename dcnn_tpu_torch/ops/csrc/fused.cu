// Fused per-channel scale, bias and ReLU for Hopper (sm_90a), with a plain C
// interface bound from Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/pallas/fused.py::_kernel, the Pallas TPU kernel
// behind fused_scale_bias_relu. Same function: y = max(x * scale + bias, 0)
// with scale and bias broadcast over the last (channel) axis, in x's type.
// The product and the sum are each rounded to x's type, as the plain
// PyTorch composition rounds them (no FMA contraction; under bf16 both are
// computed in fp32 and rounded to bf16), so the two agree bit for bit.
//
// Design. The TPU kernel blocks 512 rows of (rows, C) per grid step; here
// the tensor is one flat run of elements and a grid-stride loop gives each
// thread every (grid * 256)-th element, so neighbouring threads touch
// neighbouring addresses whatever the row count or C (ragged sizes need no
// padding). A thread's channel index advances by the stride modulo C, with
// no division in the loop.
//
// What bounds it on an H100: bytes. It reads x and writes y once (plus 2C
// values of scale and bias) and does 3 operations per element, far below
// the card's ops:byte line, so the floor is (2 * bytes of x) / 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // enough resident warps to cover HBM latency

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// round an fp32 result to the storage type, as a PyTorch op on that type does
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_bias_relu_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ bias, T* __restrict__ y, long long total,
                       int c) {
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int step = (int)(stride % c);
  int ch = (int)(start % c);
  for (long long i = start; i < total; i += stride) {
    const float t = rnd(__fmul_rn(to_f32(x[i]), to_f32(scale[ch])), x);
    store(y + i, fmaxf(rnd(__fadd_rn(t, to_f32(bias[ch])), x), 0.f));
    ch += step;
    if (ch >= c) ch -= c;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   long long total, int c, cudaStream_t stream) {
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  scale_bias_relu_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), total, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: contiguous, `total` elements whose last axis has `c` channels;
// scale, bias: contiguous (c,); all fp32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1). Returns the launch's cudaError_t (0 = queued).
int dcnn_scale_bias_relu(const void* x, const void* scale, const void* bias, void* y,
                         long long total, int c, int is_bf16, void* stream) {
  if (total < 1 || c < 1 || total % c) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(x, scale, bias, y, total, c, s)
      : launch<float>(x, scale, bias, y, total, c, s);
  return static_cast<int>(err);
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
