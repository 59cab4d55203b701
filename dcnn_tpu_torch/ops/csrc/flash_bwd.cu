// Flash-attention backward on Hopper's tensor cores (sm_90a: TMA, mbarriers,
// wgmma): the dQ kernel and the dK/dV kernel, with a plain C interface
// bound from Python through ctypes (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel, the two Pallas TPU kernels behind
// _flash_backward. Same function (FlashAttention-2): P is rebuilt per tile
// from the saved logsumexp as P = allowed ? exp(scale*QK^T - lse) : 0,
// masked before the exponential, so rows that saw no key (lse -1e30) get
// P = 0 exactly; dP = dO V^T; dS = P * (dP - delta) * scale with
// delta = rowsum(dO * O), computed by the caller; dQ = dS K, dV = P^T dO,
// dK = dS^T Q, each accumulated in fp32 and written in the input type. The
// mask is the forward's: kv padding and the causal triangle with diagonal
// offset sk - sq. Under bf16 dS and P are rounded to bf16 before their
// products, as the Pallas kernels do; fp32 keeps fp32 accuracy as three
// TF32 products (hi*hi + hi*lo + lo*hi), as flash_fwd.cu does.
//
// Design. The TPU runs each kernel's innermost grid axis in order and
// carries the accumulator in VMEM scratch across it; here that axis is a
// loop inside one block, and nothing carries between blocks (no atomics:
// the result is the same from run to run). Both kernels take flash_fwd.cu's
// tile format: rows of D land by TMA as 128-byte chunks in the 128-byte
// swizzle, any head dim d <= 256 running as its class D (flash.cuh) with
// zero-filled columns; warpgroup 0 copies (one thread issues every TMA into
// a ring of full/empty mbarriers; in fp32 warps 1-3 split operands into
// tf32 hi and lo and write the transposed copies), warpgroups 1-2 multiply,
// one per 64 rows of the block, each running beside the other, so that
// one's elementwise work overlaps the other's products (the forward's turn
// protocol, two named barriers, held them in lock-step here and cost 27%
// of the dK/dV kernel's time at long context); the grid is 1-d (any
// batch*head), heaviest causal tiles first.
//   dQ:   one block per (batch*head, 64 or 128 q rows). Q and dO land once;
//         K and V tiles stream through the ring. A pass: S = Q K^T and
//         dP = dO V^T by wgmma with both operands in shared memory (K and
//         V rows are K-major as the B of both); P and dS on the accumulator
//         fragment (exponentials on ex2.approx with lse pre-scaled by
//         log2 e; the mask in a branch of its own, on edge tiles only); dQ
//         += dS K with dS converted in registers to the A operand and K read
//         MN-major (bf16: the transposed-B form; fp32: K^T as tf32 hi and lo,
//         written by warps 1-3). The kv loop ends at the last live tile
//         (_kernels.FlashBwdPlan.kv_tiles, checked against JAX's
//         _tile_geometry).
//   dK/dV: one block per (batch*head, 64 or 128 keys). K and V land once;
//         Q and dO tiles stream through the ring with their lse (times
//         log2 e; +inf beyond sq, so padded columns give P = 0) and delta,
//         which warps 1-3 stage. A pass computes the transposed scores
//         directly: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T on the
//         fragment (lse and delta per column); dV += P^T dO and dK += dS^T Q
//         with P^T and dS^T as register A and dO, Q as MN-major B. The q loop
//         starts at the first live q tile.
// The tiles are chosen by register budget (BwdTile below, mirrored by
// _kernels.flash_bwd_plan): a multiplying thread holds the accumulators,
// the S and dP fragments and the A operands within kRegBudget registers,
// so the dK/dV kernel's q tile shrinks as D grows (32 at bf16 D 128, where
// two 64 x 128 fp32 accumulators take 128 registers), and a tile shrinks
// further where two stages would not fit in shared memory beside a 64-row
// block. Where no tile keeps the accumulators within the budget (dK/dV at
// D = 256: two 64 x 256 fp32 accumulators are 256 registers), the outputs
// are cut in column groups of 128, one group a block, folded into the 1-d
// grid: each block recomputes S and dP over the whole of D (the contraction
// stays whole) and accumulates only its group's columns. fp32 above D = 128
// does not fit: its fixed operands alone as tf32 hi and lo (Q and dO, or K
// and V: 4 x 64 rows x 1 KB) fill 256 KB, above a block's shared memory;
// that and every d > 256 run the sliced kernels below, which stream the
// contraction over d in slices. The host plans rows, groups, stages and
// shared memory (or slices) and the launch refuses any other plan.
//
// What bounds it on an H100. At long context the products: per allowed
// (q, k) pair 6 D FLOPs in dQ (S, dP, dS K) and 8 D in dK/dV (S, dP, P^T
// dO, dS^T Q) at 989 TFLOP/s (bf16; fp32 as three TF32 products at 495),
// far above the bytes of the inputs. Beside them one exponential per pair
// on the special-function units. At the training shape (S = 32, D = 16)
// the work is a few MFLOP and launch latency sets the time.

#include <cuda_bf16.h>
#include <math.h>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;  // warpgroup 0 copies, 1-2 multiply
constexpr int kMaxStages = 4;
#ifdef FLASH_BWD_TRACE
constexpr bool kTrace = true;
#else
constexpr bool kTrace = false;
#endif

// Clock counts of the live passes (the -DFLASH_BWD_TRACE build;
// dcnn_flash_bwd_trace reads them), [kernel: 0 dQ, 1 dK/dV][warpgroup]:
// [0] waiting for the tile, [1] issuing, [2] waiting for S and dP, [3] P,
// dS and their A operands, [4] waiting for the accumulating products, [5]
// the release, [7] the passes
__device__ unsigned long long g_trace[2][2][8];

// The tile format for head-dim class D, mirrored by _kernels.flash_bwd_plan
template <typename T, int D>
struct BwdTile {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kChunkE = kRow / kEs;              // elements of a 128-byte chunk
  static constexpr int kDC = (D * kEs + kRow - 1) / kRow;  // chunks of a row of D
  static constexpr int kDP = kDC * kChunkE;                // D padded to whole chunks
  static constexpr int kKSteps = D * kEs / 32;             // 32-byte K steps over D
  static constexpr int kParts = kF32 ? 2 : 1;              // fp32: hi and lo
  // registers of a multiplying thread at a tile of n (keys for dQ, q rows
  // for dK/dV) with the outputs in g column groups: accumulators, S and dP
  // fragments, A operands
  __host__ __device__ static constexpr int regs(bool dq, int n, int g = 1) {
    return (dq ? kDP / 2 : kDP) / g + n + (kF32 ? (dq ? n : 2 * n) : (dq ? n / 4 : n / 2));
  }
  // the fewest column groups with which a 16-row tile fits the budget
  __host__ __device__ static constexpr int groups(bool dq) {
    return regs(dq, 16, 1) <= kRegBudget ? 1 : 2;
  }
  __host__ __device__ static constexpr int reg_tile(bool dq) {
    int n = 128;
    while (n > 16 && regs(dq, n, groups(dq)) > kRegBudget) n /= 2;
    return n;
  }
  // fp32: one part (hi or lo) of a transposed copy of a tile of n rows, the
  // group's columns
  __host__ __device__ static constexpr int t_bytes(bool dq, int n) {
    return (n + 31) / 32 * (kDP / groups(dq)) * kRow;
  }
  __host__ __device__ static constexpr int stage(bool dq, int n) {
    return kF32 ? 4 * kDC * n * kRow + (dq ? 2 : 4) * t_bytes(dq, n) : 2 * kDC * n * kRow;
  }
  // the block's fixed operands (Q and dO, or K and V; fp32 with their lo)
  __host__ __device__ static constexpr int fixed(int rows) {
    return 2 * kParts * kDC * rows * kRow;
  }
  // 1024 bytes of slack to align the base for the swizzle, the dK/dV
  // kernel's staged lse and delta, and the barriers
  __host__ __device__ static constexpr int smem(bool dq, int rows, int n, int stages) {
    return 1024 + fixed(rows) + stages * stage(dq, n) + (dq ? 0 : stages * 8 * n) + 256;
  }
  // the register tile, or the largest smaller one with which two stages
  // fit beside a 64-row block (the register tile where none does)
  __host__ __device__ static constexpr int tile(bool dq) {
    for (int n = reg_tile(dq); n >= 16; n /= 2)
      if (smem(dq, 64, n, 2) <= kSmemMax) return n;
    return reg_tile(dq);
  }
  // one stage fits beside a 64-row block (not fp32 above D = 128)
  __host__ __device__ static constexpr bool fits(bool dq) {
    return smem(dq, 64, tile(dq), 1) <= kSmemMax;
  }
};

struct Params {
  const float* lse;    // (bh, sq)
  const float* delta;  // (bh, sq)
  void* g0;            // dQ; or dK
  void* g1;            // dV
  int sq, sk, d, causal, rows, stages, n_blocks, bh;
  float scale, scale_log2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, const Params p) {
  using L = BwdTile<T, D>;
  constexpr int kN = L::tile(true);            // keys a kv tile
  constexpr int kRb = L::kDC * kN * kRow;      // one K or V tile as it lands
  constexpr int kTb = L::t_bytes(true, kN);    // fp32: K^T, one part
  constexpr int kStage = L::stage(true, kN);
  static_assert(L::groups(true) == 1, "dQ keeps its columns in one group");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int rb = L::kDC * p.rows * kRow;       // Q or dO as it lands
  uint8_t* sq_hi = base;                       // then fp32 Q's lo, dO, dO's lo
  uint8_t* so_hi = base + L::kParts * rb;
  uint8_t* ring = base + L::fixed(p.rows);
  uint64_t* full_x = reinterpret_cast<uint64_t*>(ring + p.stages * kStage);
  uint64_t* full = full_x + 2;
  uint64_t* ready = full + kMaxStages;         // fp32: the stage split, K transposed
  uint64_t* empty = ready + kMaxStages;
  const int nwg = p.rows / 64;
  const int qt = p.n_blocks - 1 - (int)(blockIdx.x / p.bh);  // the heaviest causal tiles first
  const int bh = blockIdx.x % p.bh, q0 = qt * p.rows, offset = p.sk - p.sq;
  // the kv tiles holding an allowed pair for a real row of this q tile
  int n_kv = (p.sk + kN - 1) / kN;
  if (p.causal) {
    const int hi = min(q0 + p.rows, p.sq) - 1 + offset;
    n_kv = hi < 0 ? 0 : min(n_kv, hi / kN + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_x, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);       // warps 1-3 of the copying warpgroup
      mbar_init(empty + s, 4 * nwg);  // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      if (n_kv > 0) {
        mbar_expect_tx(full_x, 2 * rb);
        for (int c = 0; c < L::kDC; ++c) {
          tma_load_3d(smem_u32(sq_hi + c * p.rows * kRow), &qmap, full_x, c * L::kChunkE, q0, bh);
          tma_load_3d(smem_u32(so_hi + c * p.rows * kRow), &omap, full_x, c * L::kChunkE, q0, bh);
        }
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % p.stages;
        mbar_wait(empty + s, ((t / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(full + s, 2 * kRb);
        for (int c = 0; c < L::kDC; ++c) {
          tma_load_3d(smem_u32(st + c * kN * kRow), &kmap, full + s, c * L::kChunkE, t * kN, bh);
          tma_load_3d(smem_u32(st + kRb + c * kN * kRow), &vmap, full + s, c * L::kChunkE, t * kN,
                      bh);
        }
      }
      return;
    }
    if constexpr (L::kF32) {  // warps 1-3: the tf32 splits
      if (tid >= 32) {
        const int st_tid = tid - 32;
        for (int t = 0; t < n_kv; ++t) {
          const int s = t % p.stages;
          mbar_wait(full + s, (t / p.stages) & 1);
          uint8_t* st = ring + s * kStage;
          // K split in place (lo after V) and transposed; V split in place
          transpose_split<L::kDP>(st, st + 2 * kRb, st + 4 * kRb, st + 4 * kRb + kTb, kN, st_tid,
                                  96);
          split_cells(st + kRb, st + 3 * kRb, kRb / 16, st_tid, 96);
          fence_proxy_async();
          mbar_arrive(ready + s);
        }
      }
    }
    return;
  }

  // the multiplying warpgroups: wg's 64 rows of the q tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int wg_first = q0 + 64 * wg, wg_last = min(wg_first + 64, p.sq) - 1;
  float lse2[2], dlt[2];  // lse * log2(e); delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const size_t i = (size_t)bh * p.sq + r;
    lse2[h] = r < p.sq ? p.lse[i] * kLog2e : 0.f;
    dlt[h] = r < p.sq ? p.delta[i] : 0.f;
  }
  uint64_t* rdy = L::kF32 ? ready : full;
  if (n_kv > 0) {
    mbar_wait(full_x, 0);
    if constexpr (L::kF32) {  // fp32: each warpgroup splits its own rows of Q and dO
      split_rows(sq_hi, rb, L::kDC, p.rows, 64 * wg, 64, ct & 127, 128);
      split_rows(so_hi, rb, L::kDC, p.rows, 64 * wg, 64, ct & 127, 128);
      fence_proxy_async();
      wg_sync(wg);
    }
  }
  const uint32_t qa = smem_u32(sq_hi) + wg * 64 * kRow, oa = smem_u32(so_hi) + wg * 64 * kRow;

  float acc[L::kDP / 2];
#pragma unroll
  for (int i = 0; i < L::kDP / 2; ++i) acc[i] = 0.f;
  float sc[kN / 2], dp[kN / 2];  // S, then P; dP, then dS
  // dS as wgmma's A operand: bf16 pairs, or tf32 hi and lo
  uint32_t da[L::kF32 ? kN / 8 : kN / 16][4], dlo[L::kF32 ? kN / 8 : 1][4];
  // the tiles this warpgroup multiplies: those up to the last one holding
  // an allowed pair for one of its real rows (a prefix of the block's)
  int n_live = wg_first <= wg_last ? n_kv : 0;
  if (p.causal && n_live) {
    const int hi = wg_last + offset;
    n_live = hi < 0 ? 0 : min(n_kv, hi / kN + 1);
  }
  auto stage_of = [&](int t) { return smem_u32(ring + (t % p.stages) * kStage); };
  auto wait_tile = [&](int t) { mbar_wait(rdy + t % p.stages, (t / p.stages) & 1); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % p.stages);
  };

  // S = Q K^T into sc and dP = dO V^T into dp, the tile at stage st
  auto issue_sdp = [&](uint32_t st) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks) {
      // chunk ks / 4 of D, 32 bytes a step within it
      const uint32_t aoff = (ks >> 2) * p.rows * kRow + 32 * (ks & 3);
      const uint32_t boff = (ks >> 2) * kN * kRow + 32 * (ks & 3);
      const uint64_t q_d = desc_sw128(qa + aoff), k_d = desc_sw128(st + boff);
      const uint64_t o_d = desc_sw128(oa + aoff), v_d = desc_sw128(st + kRb + boff);
      if constexpr (L::kF32) {
        const uint64_t q_lo = desc_sw128(qa + rb + aoff), k_lo = desc_sw128(st + 2 * kRb + boff);
        const uint64_t o_lo = desc_sw128(oa + rb + aoff), v_lo = desc_sw128(st + 3 * kRb + boff);
        Wgmma<kN>::ss_tf32(sc, q_lo, k_d);
        Wgmma<kN>::ss_tf32(sc, q_d, k_lo);
        Wgmma<kN>::ss_tf32(sc, q_d, k_d);
        Wgmma<kN>::ss_tf32(dp, o_lo, v_d);
        Wgmma<kN>::ss_tf32(dp, o_d, v_lo);
        Wgmma<kN>::ss_tf32(dp, o_d, v_d);
      } else {
        Wgmma<kN>::ss_bf16(sc, q_d, k_d);
        Wgmma<kN>::ss_bf16(dp, o_d, v_d);
      }
    }
    wgmma_commit();
  };
  // P and dS of tile t on the fragment (sc[4j + e] is row row0 + 8 (e >>
  // 1), key kv0 + 8j + 2 t4 + (e & 1)), dS to the A operand
  auto p_and_ds = [&](int t) {
    const int kv0 = t * kN;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = fmaf(sc[i], p.scale_log2, -lse2[(i >> 1) & 1]);
    // the mask only on tiles that cross the end of the keys or the
    // diagonal, as a branch of its own: per element one compare against
    // the row's last allowed key; a masked exponent of -inf gives P = 0
    if (kv0 + kN > p.sk || (p.causal && kv0 + kN - 1 > wg_first + offset)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int last = (p.causal ? min(p.sk - 1, row0 + 8 * h + offset) : p.sk - 1) -
                         (kv0 + 2 * t4);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e > last) sc[4 * j + 2 * h + e] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kN / 2; ++i)
      dp[i] = ex2(sc[i]) * (dp[i] - dlt[(i >> 1) & 1]) * p.scale;
    if constexpr (L::kF32)
      frag_to_tf32<kN>(dp, da, dlo);
    else
      frag_to_bf16<kN>(dp, da);
  };
  // dQ += dS K with dS in da (and dlo), K at stage st
  auto issue_dq = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (L::kF32) {
      const uint32_t kt_hi = st + 4 * kRb, kt_lo = kt_hi + kTb;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int off = (j >> 2) * L::kDP * kRow + 32 * (j & 3);
        const uint64_t bhi = desc_sw128(kt_hi + off), blo = desc_sw128(kt_lo + off);
        Wgmma<L::kDP>::rs_tf32(acc, dlo[j], bhi);
        Wgmma<L::kDP>::rs_tf32(acc, da[j], blo);
        Wgmma<L::kDP>::rs_tf32(acc, da[j], bhi);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN / 16; ++k)
#pragma unroll
        for (int c = 0; c < L::kDC; ++c)  // 64 columns of D a product
          Wgmma<64>::rs_bf16<1>(acc + 32 * c, da[k], desc_sw128(st + c * kN * kRow + k * 16 * kRow));
    }
    wgmma_commit();
  };

  auto acc_done = [&]() {
    fence_regs(acc);
    hold_regs(da);
    if constexpr (L::kF32) hold_regs(dlo);
  };
  // each live pass: S and dP, then P and dS (the other warpgroup's
  // products run beside them), then dQ += dS K; the tiles above this
  // warpgroup's band are released unread
  PassClock<kTrace> clk;
  for (int t = 0; t < n_live; ++t) {
    clk.start();
    wait_tile(t);
    clk.lap(0);
    issue_sdp(stage_of(t));
    clk.lap(1);
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    clk.lap(2);
    p_and_ds(t);
    clk.lap(3);
    issue_dq(stage_of(t));
    clk.lap(1);
    wgmma_wait0();
    acc_done();
    clk.lap(4);
    release(t);
    clk.lap(5);
  }
  clk.save(g_trace[0], wg, n_live, (ct & 127) == 0);

  for (int t = n_live; t < n_kv; ++t) {
    wait_tile(t);
    release(t);
  }

  // dQ of rows row0 and row0 + 8, the first d columns
  T* out = static_cast<T*>(p.g0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    T* orow = out + ((size_t)bh * p.sq + row) * p.d;
#pragma unroll
    for (int j = 0; j < L::kDP / 8; ++j)
      if (8 * j + 2 * t4 < p.d)  // d is even: a pair is stored whole or not at all
        store2(orow + 8 * j + 2 * t4, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap omap, const Params p) {
  using L = BwdTile<T, D>;
  constexpr int kN = L::tile(false);           // q rows a tile
  constexpr int kRb = L::kDC * kN * kRow;      // one Q or dO tile as it lands
  constexpr int kTb = L::t_bytes(false, kN);   // fp32: Q^T or dO^T, one part
  constexpr int kStage = L::stage(false, kN);
  constexpr int kG = L::groups(false);         // column groups of dK and dV
  constexpr int kDO = L::kDP / kG;             // columns a block accumulates
  constexpr int kDCo = L::kDC / kG;            // their chunks
  static_assert(!L::kF32 || kG == 1, "fp32 keeps dK and dV in one group");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int rb = L::kDC * p.rows * kRow;       // K or V as it lands
  uint8_t* sk_hi = base;                       // then fp32 K's lo, V, V's lo
  uint8_t* sv_hi = base + L::kParts * rb;
  uint8_t* ring = base + L::fixed(p.rows);
  float* rowv = reinterpret_cast<float*>(ring + p.stages * kStage);  // per stage: lse2, delta
  uint64_t* full_x = reinterpret_cast<uint64_t*>(rowv + p.stages * 2 * kN);
  uint64_t* full = full_x + 2;
  uint64_t* ready = full + kMaxStages;         // lse and delta staged; fp32: the splits
  uint64_t* empty = ready + kMaxStages;
  const int nwg = p.rows / 64;
  // one block per (kv tile, column group, batch*head), the heaviest causal
  // kv tiles first
  const int idx = (int)(blockIdx.x / p.bh), grp = idx % kG, kt = idx / kG;
  const int bh = blockIdx.x % p.bh, k0 = kt * p.rows, offset = p.sk - p.sq;
  const int n_q = (p.sq + kN - 1) / kN;
  // the first q tile whose last row may see key `key` (causal), else 0
  auto first_tile = [&](int key) {
    const int lo = key - offset - (kN - 1);
    return !p.causal || lo <= 0 ? 0 : (lo + kN - 1) / kN;
  };
  const int t0 = min(first_tile(k0), n_q), n_t = n_q - t0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_x, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);       // warps 1-3 of the copying warpgroup
      mbar_init(empty + s, 4 * nwg);  // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      if (n_t > 0) {
        mbar_expect_tx(full_x, 2 * rb);
        for (int c = 0; c < L::kDC; ++c) {
          tma_load_3d(smem_u32(sk_hi + c * p.rows * kRow), &kmap, full_x, c * L::kChunkE, k0, bh);
          tma_load_3d(smem_u32(sv_hi + c * p.rows * kRow), &vmap, full_x, c * L::kChunkE, k0, bh);
        }
      }
      for (int i = 0; i < n_t; ++i) {
        const int s = i % p.stages, q0 = (t0 + i) * kN;
        mbar_wait(empty + s, ((i / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(full + s, 2 * kRb);
        for (int c = 0; c < L::kDC; ++c) {
          tma_load_3d(smem_u32(st + c * kN * kRow), &qmap, full + s, c * L::kChunkE, q0, bh);
          tma_load_3d(smem_u32(st + kRb + c * kN * kRow), &omap, full + s, c * L::kChunkE, q0, bh);
        }
      }
      return;
    }
    if (tid >= 32) {  // warps 1-3: lse (times log2 e) and delta; fp32: the tf32 splits
      const int st_tid = tid - 32;
      for (int i = 0; i < n_t; ++i) {
        const int s = i % p.stages, q0 = (t0 + i) * kN;
        mbar_wait(empty + s, ((i / p.stages) & 1) ^ 1);
        float* rv = rowv + s * 2 * kN;
        for (int r = st_tid; r < kN; r += 96) {
          const int q = q0 + r;
          const size_t at = (size_t)bh * p.sq + q;
          // lse * log2(e) and delta; beyond sq: P = 2^(S - inf) = 0, delta 0
          rv[r] = q < p.sq ? p.lse[at] * kLog2e : INFINITY;
          rv[kN + r] = q < p.sq ? p.delta[at] : 0.f;
        }
        if constexpr (L::kF32) {
          mbar_wait(full + s, (i / p.stages) & 1);
          uint8_t* st = ring + s * kStage;
          // Q and dO split in place (lo after dO) and transposed
          transpose_split<L::kDP>(st, st + 2 * kRb, st + 4 * kRb, st + 4 * kRb + kTb, kN, st_tid,
                                  96);
          transpose_split<L::kDP>(st + kRb, st + 3 * kRb, st + 4 * kRb + 2 * kTb,
                                  st + 4 * kRb + 3 * kTb, kN, st_tid, 96);
          fence_proxy_async();
        }
        mbar_arrive(ready + s);
      }
    }
    return;
  }

  // the multiplying warpgroups: wg's 64 keys of the kv tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + 64 * wg + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const int wg_first = k0 + 64 * wg, wg_last = min(wg_first + 64, p.sk) - 1;
  if (n_t > 0) {
    mbar_wait(full_x, 0);
    if constexpr (L::kF32) {  // fp32: each warpgroup splits its own rows of K and V
      split_rows(sk_hi, rb, L::kDC, p.rows, 64 * wg, 64, ct & 127, 128);
      split_rows(sv_hi, rb, L::kDC, p.rows, 64 * wg, 64, ct & 127, 128);
      fence_proxy_async();
      wg_sync(wg);
    }
  }
  const uint32_t ka = smem_u32(sk_hi) + wg * 64 * kRow, va = smem_u32(sv_hi) + wg * 64 * kRow;

  float acc_k[kDO / 2], acc_v[kDO / 2];
#pragma unroll
  for (int i = 0; i < kDO / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float sc[kN / 2], dp[kN / 2];  // S^T, then P^T; dP^T, then dS^T
  // P^T and dS^T as wgmma's A operand: bf16 pairs, or tf32 hi and lo
  constexpr int kA = L::kF32 ? kN / 8 : kN / 16, kLo = L::kF32 ? kN / 8 : 1;
  uint32_t pa[kA][4], plo[kLo][4], da[kA][4], dlo[kLo][4];
  // the q tiles this warpgroup multiplies: from the first one holding an
  // allowed pair for one of its real keys (a suffix of the block's)
  const int tw = wg_first <= wg_last ? max(t0, min(first_tile(wg_first), n_q)) : n_q;
  auto stage_of = [&](int i) { return smem_u32(ring + (i % p.stages) * kStage); };
  auto wait_tile = [&](int i) {
    if constexpr (!L::kF32) mbar_wait(full + i % p.stages, (i / p.stages) & 1);
    mbar_wait(ready + i % p.stages, (i / p.stages) & 1);
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % p.stages);
  };

  // S^T = K Q^T into sc and dP^T = V dO^T into dp, the tile at stage st
  auto issue_sdp = [&](uint32_t st) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks) {
      const uint32_t aoff = (ks >> 2) * p.rows * kRow + 32 * (ks & 3);
      const uint32_t boff = (ks >> 2) * kN * kRow + 32 * (ks & 3);
      const uint64_t k_d = desc_sw128(ka + aoff), q_d = desc_sw128(st + boff);
      const uint64_t v_d = desc_sw128(va + aoff), o_d = desc_sw128(st + kRb + boff);
      if constexpr (L::kF32) {
        const uint64_t k_lo = desc_sw128(ka + rb + aoff), q_lo = desc_sw128(st + 2 * kRb + boff);
        const uint64_t v_lo = desc_sw128(va + rb + aoff), o_lo = desc_sw128(st + 3 * kRb + boff);
        Wgmma<kN>::ss_tf32(sc, k_lo, q_d);
        Wgmma<kN>::ss_tf32(sc, k_d, q_lo);
        Wgmma<kN>::ss_tf32(sc, k_d, q_d);
        Wgmma<kN>::ss_tf32(dp, v_lo, o_d);
        Wgmma<kN>::ss_tf32(dp, v_d, o_lo);
        Wgmma<kN>::ss_tf32(dp, v_d, o_d);
      } else {
        Wgmma<kN>::ss_bf16(sc, k_d, q_d);
        Wgmma<kN>::ss_bf16(dp, v_d, o_d);
      }
    }
    wgmma_commit();
  };
  // P^T and dS^T of the tile at ring index i on the fragment (sc[4j + e]
  // is key key0 + 8 (e >> 1), q row q0 + 8j + 2 t4 + (e & 1)), both to A
  // operands
  auto p_and_ds = [&](int i) {
    const int q0 = (t0 + i) * kN;
    const float* rv = rowv + (i % p.stages) * 2 * kN;
    float2 dl[kN / 8];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(rv + 8 * j + 2 * t4);
      dl[j] = *reinterpret_cast<const float2*>(rv + kN + 8 * j + 2 * t4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sc[4 * j + 2 * h] = fmaf(sc[4 * j + 2 * h], p.scale_log2, -l2.x);
        sc[4 * j + 2 * h + 1] = fmaf(sc[4 * j + 2 * h + 1], p.scale_log2, -l2.y);
      }
    }
    // the causal mask only on tiles that cross the diagonal, as a branch
    // of its own: per element one compare against the key's first allowed
    // q row
    if (p.causal && q0 + offset < wg_last) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int first = key0 + 8 * h - offset - (q0 + 2 * t4);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e < first) sc[4 * j + 2 * h + e] = -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = 4 * j + e;
        sc[i2] = ex2(sc[i2]);
        dp[i2] = sc[i2] * (dp[i2] - ((e & 1) ? dl[j].y : dl[j].x)) * p.scale;
      }
    if constexpr (L::kF32) {
      frag_to_tf32<kN>(sc, pa, plo);
      frag_to_tf32<kN>(dp, da, dlo);
    } else {
      frag_to_bf16<kN>(sc, pa);
      frag_to_bf16<kN>(dp, da);
    }
  };
  // dV += P^T dO and dK += dS^T Q, dO and Q at stage st
  auto issue_kv = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (L::kF32) {
      const uint32_t qt_hi = st + 4 * kRb, qt_lo = qt_hi + kTb;
      const uint32_t ot_hi = qt_hi + 2 * kTb, ot_lo = qt_hi + 3 * kTb;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int off = (j >> 2) * L::kDP * kRow + 32 * (j & 3);
        const uint64_t ohi = desc_sw128(ot_hi + off), olo = desc_sw128(ot_lo + off);
        const uint64_t qhi = desc_sw128(qt_hi + off), qlo = desc_sw128(qt_lo + off);
        Wgmma<L::kDP>::rs_tf32(acc_v, plo[j], ohi);
        Wgmma<L::kDP>::rs_tf32(acc_v, pa[j], olo);
        Wgmma<L::kDP>::rs_tf32(acc_v, pa[j], ohi);
        Wgmma<L::kDP>::rs_tf32(acc_k, dlo[j], qhi);
        Wgmma<L::kDP>::rs_tf32(acc_k, da[j], qlo);
        Wgmma<L::kDP>::rs_tf32(acc_k, da[j], qhi);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN / 16; ++k)
#pragma unroll
        for (int c = 0; c < kDCo; ++c) {  // 64 columns of the group a product
          const uint32_t off = (grp * kDCo + c) * kN * kRow + k * 16 * kRow;
          Wgmma<64>::rs_bf16<1>(acc_v + 32 * c, pa[k], desc_sw128(st + kRb + off));
          Wgmma<64>::rs_bf16<1>(acc_k + 32 * c, da[k], desc_sw128(st + off));
        }
    }
    wgmma_commit();
  };

  // the tiles below this warpgroup's band, released unread; then each
  // live pass as in the dQ kernel
  for (int i = 0; i < tw - t0; ++i) {
    wait_tile(i);
    release(i);
  }
  auto acc_done = [&]() {
    fence_regs(acc_k);
    fence_regs(acc_v);
    hold_regs(pa);
    hold_regs(da);
    if constexpr (L::kF32) {
      hold_regs(plo);
      hold_regs(dlo);
    }
  };
  PassClock<kTrace> clk;
  const int i0 = tw - t0;
  for (int i = i0; i < n_t; ++i) {
    clk.start();
    wait_tile(i);
    clk.lap(0);
    issue_sdp(stage_of(i));
    clk.lap(1);
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    clk.lap(2);
    p_and_ds(i);
    clk.lap(3);
    issue_kv(stage_of(i));
    clk.lap(1);
    wgmma_wait0();
    acc_done();
    clk.lap(4);
    release(i);
    clk.lap(5);
  }
  clk.save(g_trace[1], wg, n_t - i0, (ct & 127) == 0);


  // dK and dV of keys key0 and key0 + 8, the first d columns
  T* out_k = static_cast<T*>(p.g0) + grp * kDO;  // the group's columns
  T* out_v = static_cast<T*>(p.g1) + grp * kDO;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.sk) continue;
    const size_t at = ((size_t)bh * p.sk + key) * p.d;
#pragma unroll
    for (int j = 0; j < kDO / 8; ++j)
      if (grp * kDO + 8 * j + 2 * t4 < p.d) {  // d is even: a pair is stored whole or not at all
        store2(out_k + at + 8 * j + 2 * t4, acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
        store2(out_v + at + 8 * j + 2 * t4, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
  }
}

template <typename T, int D, bool kDq>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const Params& p0,
                   int rows, int tile, int smem, int groups, cudaStream_t stream) {
  using L = BwdTile<T, D>;
  if (tile != L::tile(kDq) || groups != L::groups(kDq) || (rows != 64 && rows != 128) ||
      p0.stages < 1 || p0.stages > kMaxStages || smem != L::smem(kDq, rows, tile, p0.stages) ||
      smem > kSmemMax)
    return cudaErrorInvalidValue;
  const auto kernel = kDq ? flash_bwd_dq_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  // (bh, s, d) as 3-d tensors, d innermost; boxes of one 128-byte chunk of D
  // by the block's rows (dQ: Q, dO; dK/dV: K, V) or a tile's, zero beyond
  // d, beyond s
  CUtensorMap maps[4] = {};
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const cuuint64_t s = is_q ? p0.sq : p0.sk;
    const cuuint64_t dims[3] = {(cuuint64_t)p0.d, s, (cuuint64_t)p0.bh};
    const cuuint64_t strides[2] = {(cuuint64_t)p0.d * L::kEs, s * p0.d * L::kEs};
    const int box_rows = is_q == kDq ? rows : tile;
    const cuuint32_t box[3] = {(cuuint32_t)L::kChunkE, (cuuint32_t)box_rows, 1};
    if (!encode(&maps[i], !L::kF32, 3, ptrs[i], dims, strides, box)) return cudaErrorInvalidValue;
  }
  Params p = p0;
  p.rows = rows;
  p.n_blocks = ((kDq ? p.sq : p.sk) + rows - 1) / rows;
  const long long blocks = (long long)p.n_blocks * groups * p.bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 + 2 * rows, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const Params& p, int rows, int tile, int smem, int groups, cudaStream_t s) {
  switch (head_class(p.d)) {
    case 16: return launch<T, 16, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
    case 32: return launch<T, 32, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
    case 64: return launch<T, 64, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
    case 128: return launch<T, 128, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
    case 256:
      if constexpr (BwdTile<T, 256>::fits(kDq))
        return launch<T, 256, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* g0, void* g1, int bh, int sq, int sk, int d, int causal,
        float scale, int is_bf16, int rows, int tile, int stages, int smem, int groups,
        void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(g0) | reinterpret_cast<uintptr_t>(g1);
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d * (is_bf16 ? 2 : 4) % 16 || align % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = g0, p.g1 = g1;
  p.sq = sq, p.sk = sk, p.d = d, p.causal = causal, p.stages = stages, p.bh = bh;
  p.scale = scale, p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
                              ? dispatch<__nv_bfloat16, kDq>(q, k, v, dout, p, rows, tile, smem,
                                                             groups, s)
                              : dispatch<float, kDq>(q, k, v, dout, p, rows, tile, smem, groups, s);
  return static_cast<int>(err);
}

// The sliced backward (flash.cuh, namespace sliced): head dims above 256,
// and above 128 in fp32, run by the host as d itself. S and dP are summed
// over the slices of d (Q and K, then dO and V, staged in turn); P and dS
// on the registers, rounded to the input type into shared memory; then the
// output group's columns of the other operand are staged and multiplied.
//   dQ:    one block per (batch*head, 64 q rows, group of 128 of dQ's
//          columns), the heaviest causal tiles first; the kv loop ends at
//          the last live tile. dQ += dS K.
//   dK/dV: one block per (batch*head, 64 keys, group of 128 columns);
//          S^T = K Q^T and dP^T = V dO^T directly, lse and delta per column
//          staged per q tile; the q loop starts at the first live tile.
//          dV += P^T dO and dK += dS^T Q.
template <typename T>
__global__ void __launch_bounds__(sliced::kThreads)
    flash_bwd_dq_sliced_kernel(const T* q, const T* k, const T* v, const T* dout,
                               const float* lse, const float* delta, T* dq, sliced::Params p) {
  using namespace sliced;
  extern __shared__ float smem[];
  float* a = smem;
  float* b = a + kStage;
  float* dss = b + kStage;  // dS, rounded to the input type
  const Block blk(p, p.causal != 0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qo = (size_t)blk.bh * p.sq * p.d, ko = (size_t)blk.bh * p.sk * p.d;
  q += qo, dout += qo, dq += qo, k += ko, v += ko;
  lse += (size_t)blk.bh * p.sq, delta += (size_t)blk.bh * p.sq;
  const int q0 = blk.tile * kTile, c0 = blk.group * kCols;
  int n_kv = (p.sk + kTile - 1) / kTile;
  if (p.causal) {
    const int hi = min(q0 + kTile, p.sq) - 1 + p.sk - p.sq;
    n_kv = hi < 0 ? 0 : min(n_kv, hi / kTile + 1);
  }
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    row_lse[i] = row < p.sq ? lse[row] * kLog2e : 0.f;
    row_delta[i] = row < p.sq ? delta[row] : 0.f;
  }
  float acc[4][8] = {};
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < p.d; c += kCols) {
      __syncthreads();  // the last reads of a, b and dss are done
      stage(a, q, q0, p.sq, c, p.d);
      stage(b, k, k0, p.sk, c, p.d);
      __syncthreads();
      add_products(s, a, b);
    }
    for (int c = 0; c < p.d; c += kCols) {
      __syncthreads();
      stage(a, dout, q0, p.sq, c, p.d);
      stage(b, v, k0, p.sk, c, p.d);
      __syncthreads();
      add_products(dp, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = row < p.sq && key < p.sk && (!p.causal || key <= row + p.sk - p.sq);
        const float pij = ok ? exp2f(s[i][j] * p.scale_log2 - row_lse[i]) : 0.f;
        dss[(4 * ty + i) * kLdP + tx + 16 * j] =
            round_to<T>(pij * (dp[i][j] - row_delta[i]) * p.scale);
      }
    }
    __syncthreads();  // every product is summed (b is free) and dS is whole
    stage(b, k, k0, p.sk, c0, p.d);
    __syncthreads();
    add_group(acc, dss, b);
  }
  store_group(dq, acc, q0, p.sq, c0, p.d);
}

template <typename T>
__global__ void __launch_bounds__(sliced::kThreads)
    flash_bwd_dkv_sliced_kernel(const T* q, const T* k, const T* v, const T* dout,
                                const float* lse, const float* delta, T* dk, T* dv,
                                sliced::Params p) {
  using namespace sliced;
  extern __shared__ float smem[];
  float* a = smem;
  float* b = a + kStage;
  float* pt = b + kStage;          // P^T, rounded to the input type
  float* dst = pt + kTile * kLdP;  // dS^T, likewise
  float* col_lse = dst + kTile * kLdP;
  float* col_delta = col_lse + kTile;
  const Block blk(p, false);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qo = (size_t)blk.bh * p.sq * p.d, ko = (size_t)blk.bh * p.sk * p.d;
  q += qo, dout += qo, k += ko, v += ko, dk += ko, dv += ko;
  lse += (size_t)blk.bh * p.sq, delta += (size_t)blk.bh * p.sq;
  const int k0 = blk.tile * kTile, c0 = blk.group * kCols;
  const int n_q = (p.sq + kTile - 1) / kTile;
  int lo = 0;
  if (p.causal) {  // the first q tile whose last row may see key k0
    const int first = k0 - (p.sk - p.sq);
    lo = first <= 0 ? 0 : min(n_q, first / kTile);
  }
  float acc_k[4][8] = {}, acc_v[4][8] = {};
  for (int t = lo; t < n_q; ++t) {
    const int q0 = t * kTile;
    // the previous tile's elementwise phase, the last reader of col_lse and
    // col_delta, ended before the barrier ahead of its products
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      col_lse[threadIdx.x] = row < p.sq ? lse[row] * kLog2e : 0.f;
      col_delta[threadIdx.x] = row < p.sq ? delta[row] : 0.f;
    }
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < p.d; c += kCols) {
      __syncthreads();
      stage(a, k, k0, p.sk, c, p.d);
      stage(b, q, q0, p.sq, c, p.d);
      __syncthreads();
      add_products(s, a, b);
    }
    for (int c = 0; c < p.d; c += kCols) {
      __syncthreads();
      stage(a, v, k0, p.sk, c, p.d);
      stage(b, dout, q0, p.sq, c, p.d);
      __syncthreads();
      add_products(dp, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, row = q0 + qc;
        const bool ok = row < p.sq && key < p.sk && (!p.causal || key <= row + p.sk - p.sq);
        const float pij = ok ? exp2f(s[i][j] * p.scale_log2 - col_lse[qc]) : 0.f;
        pt[(4 * ty + i) * kLdP + qc] = round_to<T>(pij);
        dst[(4 * ty + i) * kLdP + qc] = round_to<T>(pij * (dp[i][j] - col_delta[qc]) * p.scale);
      }
    }
    __syncthreads();  // every product is summed (a, b are free); P^T, dS^T whole
    stage(a, dout, q0, p.sq, c0, p.d);
    stage(b, q, q0, p.sq, c0, p.d);
    __syncthreads();
    add_group(acc_v, pt, a);
    add_group(acc_k, dst, b);
  }
  store_group(dk, acc_k, k0, p.sk, c0, p.d);
  store_group(dv, acc_v, k0, p.sk, c0, p.d);
}

template <typename T, bool kDq>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* g0, void* g1, int bh,
                          int sq, int sk, int d, int causal, float scale, int slices, int groups,
                          int smem, cudaStream_t stream) {
  long long blocks = 0;
  cudaError_t err = sliced::check_plan(!kDq, bh, kDq ? sq : sk, d, slices, groups, smem, &blocks);
  if (err != cudaSuccess) return err;
  const sliced::Params p{sq, sk, d, causal, groups,
                         ((kDq ? sq : sk) + sliced::kTile - 1) / sliced::kTile, scale,
                         scale * kLog2e};
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k);
  const T *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  static bool raised = false;
  if constexpr (kDq) {
    const auto kernel = flash_bwd_dq_sliced_kernel<T>;
    err = sliced::allow_smem(kernel, smem, raised);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, sliced::kThreads, smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                                                                  static_cast<T*>(g0), p);
  } else {
    const auto kernel = flash_bwd_dkv_sliced_kernel<T>;
    err = sliced::allow_smem(kernel, smem, raised);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, sliced::kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(g0), static_cast<T*>(g1), p);
  }
  return cudaGetLastError();
}

template <bool kDq>
int run_sliced(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* g0, void* g1, int bh, int sq, int sk, int d, int causal,
               float scale, int is_bf16, int slices, int groups, int smem, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(g0) | reinterpret_cast<uintptr_t>(g1);
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d * (is_bf16 ? 2 : 4) % 16 || align % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_sliced<__nv_bfloat16, kDq>(q, k, v, dout, l, dl, g0, g1, bh, sq, sk, d,
                                                  causal, scale, slices, groups, smem, s)
              : launch_sliced<float, kDq>(q, k, v, dout, l, dl, g0, g1, bh, sq, sk, d, causal,
                                          scale, slices, groups, smem, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, dout, dq: contiguous (bh, sq, d); k, v: contiguous (bh, sk, d); all fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned, 1 <= d <= 256 (fp32:
// 128) with rows of whole 16-byte units. lse, delta: contiguous (bh, sq)
// fp32. The plan (_kernels.flash_bwd_plan, this kernel's part): rows (64 or
// 128) a block, tile keys a stage, stages of the ring, smem the block's
// dynamic shared memory in bytes, groups of the output's columns; a plan
// this build would lay out otherwise is refused. Returns the launch's cudaError_t (0 = queued).
int dcnn_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int sq, int sk, int d,
                      int causal, float scale, int is_bf16, int rows, int tile, int stages,
                      int smem, int groups, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, dq, bh, sq, sk, d, causal, scale, is_bf16, rows,
                   tile, stages, smem, groups, stream);
}

// as above; dk, dv: contiguous (bh, sk, d) of the input type; rows keys a
// block, tile q rows a stage
int dcnn_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int sk, int d, int causal, float scale, int is_bf16, int rows, int tile,
                       int stages, int smem, int groups, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal, scale, is_bf16,
                    rows, tile, stages, smem, groups, stream);
}

// The sliced kernels (head dims above 256, and above 128 in fp32): the
// tensors as above, any d >= 1 with rows of whole 16-byte units. The plan
// (_kernels.flash_bwd_plan): slices and groups of 128 columns covering d,
// smem the kernel's shared memory in bytes; any other plan is refused.
// Returns the launch's cudaError_t (0 = queued).
int dcnn_flash_bwd_dq_sliced(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                             int d, int causal, float scale, int is_bf16, int slices, int groups,
                             int smem, void* stream) {
  return run_sliced<true>(q, k, v, dout, lse, delta, dq, dq, bh, sq, sk, d, causal, scale,
                          is_bf16, slices, groups, smem, stream);
}

int dcnn_flash_bwd_dkv_sliced(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int bh,
                              int sq, int sk, int d, int causal, float scale, int is_bf16,
                              int slices, int groups, int smem, void* stream) {
  return run_sliced<false>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal, scale,
                           is_bf16, slices, groups, smem, stream);
}

#ifdef FLASH_BWD_TRACE
// the diagnostic build's clock counts (kernel x warpgroup x 8), zeroed after
int dcnn_flash_bwd_trace(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess) {
    static unsigned long long zeros[2][2][8];
    err = cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));
  }
  return static_cast<int>(err);
}
#endif

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
