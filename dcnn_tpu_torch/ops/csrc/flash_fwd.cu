// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/attention.py::_flash_kernel, the Pallas TPU kernel
// behind flash_attention -> _flash_forward. Same function: online softmax
// over K/V tiles with fp32 running max m, sum l and accumulator; kv padding
// mask; causal mask with diagonal offset sk - sq, whole kv tiles above the
// diagonal band skipped; l clamped at 1e-30 so fully-masked rows give 0;
// logsumexp written as m + log(l).
//
// Design. One block of 256 threads per (batch*head, 64-row q tile). The
// TPU's sequential kv grid axis becomes a loop inside the block: each
// iteration stages one 64-key K and V tile in shared memory (as fp32, bf16
// inputs are widened on load), computes the 64x64 score tile (4x4 outputs
// per thread), runs the online-softmax update with 4 threads per q row
// (their max and sum meet through warp shuffles), and adds P.V into the
// row's accumulator, which those 4 threads hold in registers (D/4 columns
// each). Q and K rows are padded by one float so column walks hit distinct
// shared-memory banks. Shared memory is 29 KB at D=16 and 113 KB at D=128;
// above 48 KB the launch raises the block's dynamic shared-memory limit.
//
// What bounds it on an H100. Both products run on the CUDA cores as fp32
// FMAs, so the ceiling is the 67 TFLOP/s fp32 rate, not the 989 TFLOP/s of
// the bf16 tensor cores: at long context this kernel is bound by operations
// and sits far below the card's bf16 bound. At the serving shape (S=32,
// D=16) the work is a few MFLOP and about a megabyte, so launch latency
// dominates. Moving the two products onto wgmma with TMA-fed tiles and warp
// specialisation is the later step; this version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBKV = 64;       // keys per staged tile
constexpr int kThreads = 256;
constexpr int kRowThreads = 4; // threads sharing one q row in the softmax/PV phases
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
struct Layout {
  static constexpr int kLdQ = D + 1;      // Q and K row stride (floats)
  static constexpr int kLdS = kBKV + 1;   // score tile row stride
  static constexpr int kFloats = kBQ * kLdQ + kBKV * kLdQ + kBKV * D + kBQ * kLdS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ bool allowed(int qi, int kj, int sk, int causal, int offset) {
  return kj < sk && (!causal || kj <= qi + offset);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 float scale) {
  static_assert(D % kRowThreads == 0, "head dim must split over the row's threads");
  using L = Layout<D>;
  constexpr int kCols = D / kRowThreads;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * L::kLdQ;
  float* sV = sK + kBKV * L::kLdQ;
  float* sS = sV + kBKV * D;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  const int offset = sk - sq;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, qi = q_start + r;
    sQ[r * L::kLdQ + c] = qi < sq ? to_f32(qb[(size_t)qi * D + c]) : 0.f;
  }

  // softmax / PV ownership: row `row`, columns part, part+4, ...
  const int row = tid / kRowThreads, part = tid % kRowThreads;
  const int q_row = q_start + row;
  float m_i = kNegInf, l_i = 0.f, acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  int n_tiles = (sk + kBKV - 1) / kBKV;
  if (causal) {  // last key any row of this q tile may see
    const int hi = q_start + kBQ - 1 + offset;
    n_tiles = hi < 0 ? 0 : min(n_tiles, hi / kBKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv_start = t * kBKV;
    __syncthreads();  // the previous tile's readers of sK, sV, sS are done
    for (int e = tid; e < kBKV * D; e += kThreads) {
      const int r = e / D, c = e % D, kj = kv_start + r;
      const bool ok = kj < sk;
      sK[r * L::kLdQ + c] = ok ? to_f32(kb[(size_t)kj * D + c]) : 0.f;
      sV[r * D + c] = ok ? to_f32(vb[(size_t)kj * D + c]) : 0.f;
    }
    __syncthreads();

    {  // S = scale * Q K^T, masked entries set to kNegInf
      const int ty = tid / 16, tx = tid % 16;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * L::kLdQ + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * L::kLdQ + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cc = tx + 16 * j;
          sS[r * L::kLdS + cc] = allowed(q_start + r, kv_start + cc, sk, causal, offset)
                                     ? s[i][j] * scale : kNegInf;
        }
    }
    __syncthreads();

    {  // online-softmax update; each thread rewrites only its own entries with p
      float* srow = sS + row * L::kLdS;
      float mx = kNegInf;
      for (int c = part; c < kBKV; c += kRowThreads) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float sum = 0.f;
      for (int c = part; c < kBKV; c += kRowThreads) {
        // masked entries are zeroed explicitly: in a row masked so far,
        // exp(kNegInf - kNegInf) would be 1
        const float p = allowed(q_row, kv_start + c, sk, causal, offset)
                            ? expf(srow[c] - m_new) : 0.f;
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l_i = l_i * corr + sum;
      m_i = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= corr;
    }
    __syncthreads();

    {  // acc += P V over the keys of this tile
      const float* prow = sS + row * L::kLdS;
      const int n_keys = min(kBKV, sk - kv_start);
      for (int j = 0; j < n_keys; ++j) {
        const float p = prow[j];
        const float* vr = sV + j * D + part;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(p, vr[kRowThreads * c], acc[c]);
      }
    }
  }

  if (q_row < sq) {
    const float l_fin = fmaxf(l_i, 1e-30f);
    T* orow = o + (bh * sq + q_row) * D + part;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + kRowThreads * c, acc[c] / l_fin);
    if (part == 0) lse[bh * sq + q_row] = m_i + logf(l_fin);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  static bool smem_raised = false;  // once per instantiation; a repeat is harmless
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int sq, int sk, int d, int causal,
                     float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, sq, sk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d) of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// lse: contiguous (bh, sq) fp32. Returns the launch's cudaError_t (0 = queued).
int dcnn_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int sq, int sk, int d, int causal, float scale,
                   int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, s)
              : dispatch<float>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, s);
  return static_cast<int>(err);
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
