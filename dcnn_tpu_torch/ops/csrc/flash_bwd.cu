// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, with a plain C interface bound from Python through ctypes
// (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel, the two Pallas TPU kernels behind
// _flash_backward. Same function (FlashAttention-2): P is rebuilt per tile
// from the saved logsumexp as P = allowed ? exp(scale*QK^T - lse) : 0,
// masked before the exponential, so rows that saw no key (lse ~ -1e30) get
// P = 0 exactly; dP = dO V^T; dS = P * (dP - delta) * scale with
// delta = rowsum(dO * O), computed by the caller; dQ = dS K, dV = P^T dO,
// dK = dS^T Q. The mask is the forward's: kv padding and the causal
// triangle with diagonal offset sk - sq. Under bf16 the kernels round dS
// (and, for dV, P) to bf16 before their products, as the Pallas kernels do.
//
// Design. The TPU runs each kernel's innermost grid axis in order and
// carries the accumulator in VMEM scratch across it; Hopper blocks run in
// parallel, so that axis becomes a loop inside one block and nothing
// carries between blocks (no atomics, no second pass).
//   dQ:   one block of 256 threads per (batch*head, 64-row q tile). Q, dO,
//         lse and delta are staged once; each iteration stages one 64-key
//         K and V tile, computes the S and dP tiles together (4x4 outputs
//         of each per thread), turns them into dS in shared memory, and adds
//         dS K into the row's accumulator, which the 4 threads that own the
//         row hold in registers (D/4 columns each). The loop stops at the
//         last kv tile the q tile's bottom row can see (the forward's
//         `live` predicate).
//   dK/dV: one block per (batch*head, 64-key kv tile). K and V are staged
//         once; each iteration stages one 64-row Q and dO tile with its lse
//         and delta, computes S and dP, writes P and dS to shared memory,
//         and adds P^T dO and dS^T Q into the key row's two accumulators
//         (registers, D/4 columns each per thread). The loop starts at the
//         first q tile whose bottom row can see this kv tile.
// All staging is fp32 (bf16 is widened on load); S, dP, dS and the
// accumulators stay fp32; dQ, dK and dV are written in the input type.
// Rows beyond sq and keys beyond sk are zero-filled and masked out. Rows of
// Q, dO, K and V are padded by one float so that column walks hit distinct
// shared-memory banks. Shared memory at D=128: dQ 149 KB, dK/dV 165 KB;
// above 48 KB the launch raises the block's dynamic shared-memory limit,
// once per instantiation (so CUDA-graph captures make no attribute call).
//
// What bounds it on an H100. The five products run on the CUDA cores as
// fp32 FMAs (3 per allowed (q, k) pair and head-dim column in dQ, 4 in
// dK/dV, with S and dP recomputed in both), so the ceiling is the
// 67 TFLOP/s fp32 rate: at long context both kernels are bound by
// operations and far below the bf16 tensor cores. At the training shape
// (S=32, D=16) the work is a few MFLOP and about a megabyte, and launch
// latency dominates. wgmma with TMA-fed tiles is the later step; this
// version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // q rows per tile
constexpr int kBKV = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kRowThreads = 4;  // threads sharing one accumulator row
constexpr int kLdT = kBKV + 1;  // row stride of the P / dS tiles (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the value a product operand has after the Pallas kernel's cast to the
// input type: identity for fp32, a round trip through bf16 otherwise
template <typename T> __device__ __forceinline__ float as_input(float x);
template <> __device__ __forceinline__ float as_input<float>(float x) { return x; }
template <> __device__ __forceinline__ float as_input<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ bool allowed(int qi, int kj, int sq, int sk, int causal,
                                        int offset) {
  return qi < sq && kj < sk && (!causal || kj <= qi + offset);
}

template <int D>
struct Layout {
  static constexpr int kLd = D + 1;  // row stride of Q, dO, K, V tiles (floats)
  // dQ: Q, dO, K, V tiles + dS tile + lse, delta
  static constexpr size_t kDqBytes =
      (4 * 64 * kLd + kBQ * kLdT + 2 * kBQ) * sizeof(float);
  // dK/dV: K, V, Q, dO tiles + P, dS tiles + lse, delta
  static constexpr size_t kDkvBytes =
      (4 * 64 * kLd + 2 * kBQ * kLdT + 2 * kBQ) * sizeof(float);
};

// rows [start, start + 64) of a (s, D) matrix into a padded fp32 tile,
// zero beyond s
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int start, int s) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D, i = start + r;
    dst[r * Layout<D>::kLd + c] = i < s ? to_f32(src[(size_t)i * D + c]) : 0.f;
  }
}

// s = A B^T and dp = C E^T over D for the 4x4 outputs (ty + 16i, tx + 16j)
// of a 64x64 tile; A, C hold the tile's rows, B, E its columns
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c_, const float* e_,
                                             int ty, int tx, float s[4][4],
                                             float dp[4][4]) {
  constexpr int kLd = Layout<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float ra[4], rb[4], rc[4], re[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ra[i] = a[(ty + 16 * i) * kLd + c];
      rc[i] = c_[(ty + 16 * i) * kLd + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rb[j] = b[(tx + 16 * j) * kLd + c];
      re[j] = e_[(tx + 16 * j) * kLd + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(ra[i], rb[j], s[i][j]);
        dp[i][j] = fmaf(rc[i], re[j], dp[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int sk, int causal, float scale) {
  static_assert(D % kRowThreads == 0, "head dim must split over the row's threads");
  using L = Layout<D>;
  constexpr int kCols = D / kRowThreads;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + 64 * L::kLd;  // dO
  float* sK = sO + 64 * L::kLd;
  float* sV = sK + 64 * L::kLd;
  float* sS = sV + 64 * L::kLd;  // dS
  float* sL = sS + kBQ * kLdT;   // lse
  float* sD = sL + kBQ;          // delta

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int offset = sk - sq;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  stage<T, D>(sQ, q + bh * sq * D, q_start, sq);
  stage<T, D>(sO, dout + bh * sq * D, q_start, sq);
  for (int r = tid; r < kBQ; r += kThreads) {
    const bool ok = q_start + r < sq;
    sL[r] = ok ? lse[bh * sq + q_start + r] : 0.f;
    sD[r] = ok ? delta[bh * sq + q_start + r] : 0.f;
  }

  const int row = tid / kRowThreads, part = tid % kRowThreads;
  const int ty = tid / 16, tx = tid % 16;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  int n_tiles = (sk + kBKV - 1) / kBKV;
  if (causal) {  // last kv tile any row of this q tile may see
    const int hi = q_start + kBQ - 1 + offset;
    n_tiles = hi < 0 ? 0 : min(n_tiles, hi / kBKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv_start = t * kBKV;
    __syncthreads();  // Q/dO staged; the previous tile's readers are done
    stage<T, D>(sK, kb, kv_start, sk);
    stage<T, D>(sV, vb, kv_start, sk);
    __syncthreads();

    {  // dS = P * (dP - delta) * scale, P rebuilt from lse, masked first
      float s[4][4], dp[4][4];
      two_products<D>(sQ, sK, sO, sV, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cc = tx + 16 * j;
          const float p = allowed(q_start + r, kv_start + cc, sq, sk, causal, offset)
                              ? expf(s[i][j] * scale - sL[r]) : 0.f;
          sS[r * kLdT + cc] = as_input<T>(p * (dp[i][j] - sD[r]) * scale);
        }
    }
    __syncthreads();

    {  // dQ += dS K over the keys of this tile
      const float* dsrow = sS + row * kLdT;
      const int n_keys = min(kBKV, sk - kv_start);
      for (int j = 0; j < n_keys; ++j) {
        const float ds = dsrow[j];
        const float* kr = sK + j * L::kLd + part;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(ds, kr[kRowThreads * c], acc[c]);
      }
    }
  }

  const int q_row = q_start + row;
  if (q_row < sq) {
    T* out = dq + (bh * sq + q_row) * D + part;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + kRowThreads * c, acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                     int causal, float scale) {
  static_assert(D % kRowThreads == 0, "head dim must split over the row's threads");
  using L = Layout<D>;
  constexpr int kCols = D / kRowThreads;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * L::kLd;
  float* sQ = sV + 64 * L::kLd;
  float* sO = sQ + 64 * L::kLd;  // dO
  float* sP = sO + 64 * L::kLd;
  float* sS = sP + kBQ * kLdT;   // dS
  float* sL = sS + kBQ * kLdT;   // lse
  float* sD = sL + kBQ;          // delta

  const int tid = threadIdx.x;
  const int kv_start = blockIdx.x * kBKV;
  const size_t bh = blockIdx.y;
  const int offset = sk - sq;
  const T* qb = q + bh * sq * D;
  const T* ob = dout + bh * sq * D;

  stage<T, D>(sK, k + bh * sk * D, kv_start, sk);
  stage<T, D>(sV, v + bh * sk * D, kv_start, sk);

  const int key = tid / kRowThreads, part = tid % kRowThreads;
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc_k[c] = acc_v[c] = 0.f;

  const int n_tiles = (sq + kBQ - 1) / kBQ;
  int t0 = 0;
  if (causal) {  // first q tile whose bottom row can see this kv tile
    const int lo = kv_start - offset - (kBQ - 1);
    t0 = lo <= 0 ? 0 : (lo + kBQ - 1) / kBQ;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int q_start = t * kBQ;
    __syncthreads();  // K/V staged; the previous tile's readers are done
    stage<T, D>(sQ, qb, q_start, sq);
    stage<T, D>(sO, ob, q_start, sq);
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool ok = q_start + r < sq;
      sL[r] = ok ? lse[bh * sq + q_start + r] : 0.f;
      sD[r] = ok ? delta[bh * sq + q_start + r] : 0.f;
    }
    __syncthreads();

    {  // P and dS for this (q tile, kv tile), rows = queries, columns = keys
      float s[4][4], dp[4][4];
      two_products<D>(sQ, sK, sO, sV, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cc = tx + 16 * j;
          const float p = allowed(q_start + r, kv_start + cc, sq, sk, causal, offset)
                              ? expf(s[i][j] * scale - sL[r]) : 0.f;
          sP[r * kLdT + cc] = as_input<T>(p);
          sS[r * kLdT + cc] = as_input<T>(p * (dp[i][j] - sD[r]) * scale);
        }
    }
    __syncthreads();

    {  // dV += P^T dO, dK += dS^T Q over the rows of this tile
      const int n_rows = min(kBQ, sq - q_start);
      for (int i = 0; i < n_rows; ++i) {
        const float p = sP[i * kLdT + key], ds = sS[i * kLdT + key];
        const float* orow = sO + i * L::kLd + part;
        const float* qrow = sQ + i * L::kLd + part;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[c] = fmaf(p, orow[kRowThreads * c], acc_v[c]);
          acc_k[c] = fmaf(ds, qrow[kRowThreads * c], acc_k[c]);
        }
      }
    }
  }

  const int kv_row = kv_start + key;
  if (kv_row < sk) {
    const size_t base = (bh * sk + kv_row) * D + part;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(dk + base + kRowThreads * c, acc_k[c]);
      store(dv + base + kRowThreads * c, acc_v[c]);
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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *g0, *g1;  // dQ; or dK, dV
  int bh, sq, sk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = Layout<D>::kDqBytes;
  static bool raised = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), a.sq, a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = Layout<D>::kDkvBytes;
  static bool raised = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + kBKV - 1) / kBKV, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.sq, a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int d, int is_bf16) {
  if (a.bh < 1 || a.bh > 65535 || a.sq < 1 || a.sk < 1) return cudaErrorInvalidValue;
  const cudaError_t err = is_bf16 ? dispatch_d<__nv_bfloat16, kDq>(a, d)
                                  : dispatch_d<float, kDq>(a, d);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, dout, dq: contiguous (bh, sq, d); k, v: contiguous (bh, sk, d); all fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1). lse, delta: contiguous (bh, sq) fp32.
// Returns the launch's cudaError_t (0 = queued).
int dcnn_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int sq,
                      int sk, int d, int causal, float scale, int is_bf16,
                      void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, is_bf16);
}

// as above; dk, dv: contiguous (bh, sk, d) of the input type
int dcnn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       int causal, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, is_bf16);
}

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
