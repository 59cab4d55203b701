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
// there and at every d > 256 both kernels run their wide modes
// (flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel below, on wgmma:
// 64 rows a block, the contraction over d streamed through the ring in
// slices, S and dP split between the two multiplying warpgroups and
// exchanged, each warpgroup one column group of 128 of the outputs). The
// host plans rows, tiles, groups, stages and shared memory and the launch
// refuses any other plan.
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
// dcnn_flash_bwd_trace reads them), [kernel: 0 dQ, 1 dK/dV, 2 wide dQ, 3
// wide dK/dV][warpgroup]. Class kernels: [0] waiting for the tile, [1]
// issuing, [2] waiting for S and dP, [3] P, dS and their A operands, [4]
// waiting for the accumulating products, [5] the release, [7] the passes.
// Wide kernels (a pass is one streamed tile): [0] waiting for a slice, [1]
// issuing the slices and draining their products, [2] the exchange, [3] P
// and dS (P^T and dS^T) and their A operands, [4] the group product, [5]
// the releases, [6] waiting for the group units, [7] the passes
__device__ unsigned long long g_trace[4][2][8];

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
    p_and_ds_rows<kN, L::kF32>(sc, dp, da, dlo, lse2, dlt, p.scale_log2, p.scale, t * kN, p.sk,
                               p.causal, wg_first, row0, offset, t4);
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
  // P^T and dS^T of the tile at ring index i, both to A operands
  auto p_and_ds = [&](int i) {
    p_and_ds_t<kN, L::kF32>(sc, dp, pa, plo, da, dlo, rowv + (i % p.stages) * 2 * kN,
                            p.scale_log2, p.scale, (t0 + i) * kN, key0, wg_last, offset,
                            p.causal, t4);
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

// The wide mode of the dK/dV kernel: head dims above 256, and in fp32 above
// 128 (_kernels.flash_bwd_plan's dkv.slices > 0), where the fixed K and V do
// not fit beside a ring as wgmma's operands (fp32 at d = 256: as tf32 hi and
// lo, 256 KB for 64 keys) and two accumulators over d not the registers
// (bf16 at d = 512: 512 a thread). One block per (batch*head, 64 keys, pair
// of column groups of kG = 128); multiplying warpgroup w accumulates dK and
// dV of group 2 pair + w. The two split S^T and dP^T between them: over the
// slices of d warpgroup 0 adds S^T = K Q^T, warpgroup 1 dP^T = V dO^T, each
// into one fp32 fragment; the two fragments are exchanged through shared
// memory (two named barriers), and both build P^T and dS^T (as
// flash_bwd_dkv_kernel does) and add dV += P^T dO_g and dK += dS^T Q_g for
// their group by wgmma with P^T and dS^T in registers. K and V are held for
// the whole block where they fit beside the ring (bf16 up to 11 chunks of
// d), else every slice brings its chunks of them. A q tile is ns + 2 units
// of the ring, in order: its slices (kSC chunks of Q's and dO's kN rows; K's
// and V's 64 rows where they stream; fp32: then their tf32 lo, split in
// place by warps 1-3), then one group unit for each warpgroup (Q's and dO's
// group columns; fp32: then Q^T and dO^T as tf32 hi and lo), beside the
// first of which warps 1-3 stage the q tile's lse and delta. A slice is two
// chunks where d's chunks pair up, else one: every slice is whole and both
// warpgroups run the same issues, so no branch sits among them (ptxas would
// serialize the wgmma). A group's chunks wholly beyond d are not copied;
// its columns are multiplied from stale shared memory into accumulator
// columns that are never stored (a warpgroup whose group lies beyond d
// stores nothing).
//
// What bounds it on an H100 at d = 512. The products, 8 d FLOPs per allowed
// pair; this design does 4 d for S^T and dP^T in each of the ceil(d / 256)
// blocks of a key tile and 4 * 128 for each group's dV and dK: 12 d at d =
// 512 (1.5 times the bound's), 8 d at d = 256. Beside them L2: Q and dO
// stream again for every block (and K and V for every q tile where they
// are not held); fp32 waits on warps 1-3 splitting every slice.
template <typename T, int SC>
struct WideBwd {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kChunkE = kRow / kEs;   // elements of a 128-byte chunk
  static constexpr int kG = 128;                // dK's and dV's columns a warpgroup
  static constexpr int kGC = kG / kChunkE;      // their chunks
  static constexpr int kN = kF32 ? 16 : 32;     // q rows a tile
  static constexpr int kSC = SC;                // chunks of d a slice: 2 where they pair up, else 1
  static constexpr int kParts = kF32 ? 2 : 1;   // fp32: hi and lo
  static constexpr int kT = (kN + 31) / 32 * kG * kRow;       // fp32: Q^T or dO^T, one part
  static constexpr int kGU = 2 * kGC * kN * kRow + (kF32 ? 4 * kT : 0);  // a group unit
  static constexpr int kX = 2 * 64 * kN * 4;  // the exchanged S^T and dP^T
  // K and V held for the block: 64 rows of each chunk of both
  __host__ __device__ static constexpr int kv_bytes(int n_ch) { return 2 * n_ch * 64 * kRow; }
  // a slice: Q's and dO's kSC chunks of kN rows, after K's and V's of 64
  // rows where they stream; fp32: their lo
  __host__ __device__ static constexpr int slice_bytes(bool held) {
    return kParts * kSC * 2 * (kN + (held ? 0 : 64)) * kRow;
  }
  __host__ __device__ static constexpr int stage(bool held) {
    return slice_bytes(held) > kGU ? slice_bytes(held) : kGU;
  }
  // 1024 bytes of slack to align the base for the swizzle, K and V where
  // held, the ring with each stage's lse and delta, the exchange, the
  // barriers
  __host__ __device__ static constexpr int smem(bool held, int n_ch, int stages) {
    return 1024 + (held ? kv_bytes(n_ch) : 0) + stages * (stage(held) + 8 * kN) + kX + 256;
  }
  // K and V are held where two stages fit beside them (bf16 only: as tf32
  // hi and lo they would take twice the room)
  __host__ __device__ static constexpr bool held(int n_ch) {
    return !kF32 && smem(true, n_ch, 2) <= kSmemMax;
  }
  // registers of a multiplying thread: dK's and dV's group, S^T and dP^T,
  // P^T and dS^T as A operands
  static constexpr int kRegs = kG + kN + (kF32 ? 2 * kN : kN / 2);
  static_assert(kRegs <= kRegBudget, "the wide tile does not fit the register budget");
};

template <typename T, int kSC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap omap, const Params p) {
  using W = WideBwd<T, kSC>;
  constexpr int kN = W::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_ch = (p.d * W::kEs + kRow - 1) / kRow;  // chunks of d
  const int ns = n_ch / kSC;                           // slices of a q tile
  const int per = ns + 2;                              // its units: slices, two group units
  const bool held = W::held(n_ch);
  const int stage_b = W::stage(held);
  uint8_t* kv = base;                                  // K's chunks, then V's (held)
  uint8_t* ring = base + (held ? W::kv_bytes(n_ch) : 0);
  float* xch = reinterpret_cast<float*>(ring + p.stages * stage_b);  // S^T, dP^T
  float* rowv = xch + W::kX / 4;                                     // per stage: lse2, delta
  uint64_t* full_x = reinterpret_cast<uint64_t*>(rowv + p.stages * 2 * kN);
  uint64_t* full = full_x + 2;
  uint64_t* ready = full + kMaxStages;  // lse and delta staged; fp32: the splits
  uint64_t* empty = ready + kMaxStages;
  // regions of a slice: K's, V's chunks (64 rows each, where they stream),
  // Q's, dO's (kN rows each); fp32: their lo
  const int kvs = held ? 0 : kSC * 64 * kRow, qo = 2 * kvs, oo = qo + kSC * kN * kRow;
  const int lo = W::slice_bytes(held) / 2;
  const int n_grp = (p.d + W::kG - 1) / W::kG, n_pair = (n_grp + 1) / 2;
  // one block per (kv tile, pair of column groups, batch*head), the
  // heaviest causal kv tiles first
  const int idx = (int)(blockIdx.x / p.bh), pair = idx % n_pair, kt = idx / n_pair;
  const int bh = blockIdx.x % p.bh, k0 = kt * 64, offset = p.sk - p.sq;
  const int n_q = (p.sq + kN - 1) / kN;
  // the first q tile whose last row may see key k0 (causal), else 0
  int t0 = 0;
  if (p.causal) {
    const int lo_row = k0 - offset - (kN - 1);
    t0 = lo_row <= 0 ? 0 : min((lo_row + kN - 1) / kN, n_q);
  }
  const int n_t = n_q - t0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_x, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);  // warps 1-3 of the copying warpgroup
      mbar_init(empty + s, 8);   // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      if (held && n_t > 0) {
        mbar_expect_tx(full_x, W::kv_bytes(n_ch));
        for (int c = 0; c < n_ch; ++c) {
          tma_load_3d(smem_u32(kv + c * 64 * kRow), &kmap, full_x, c * W::kChunkE, k0, bh);
          tma_load_3d(smem_u32(kv + (n_ch + c) * 64 * kRow), &vmap, full_x, c * W::kChunkE, k0,
                      bh);
        }
      }
      for (int u = 0; u < n_t * per; ++u) {
        const int c = u % per, s = u % p.stages, q0 = (t0 + u / per) * kN;
        wait_or_trap(empty + s, ((u / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * stage_b;
        if (c < ns) {  // slice c: chunks c0 ..
          const int c0 = c * kSC;
          mbar_expect_tx(full + s, kSC * 2 * (kN + (held ? 0 : 64)) * kRow);
          for (int j = 0; j < kSC; ++j) {
            const int x = (c0 + j) * W::kChunkE;
            if (!held) {
              tma_load_3d(smem_u32(st + j * 64 * kRow), &kmap, full + s, x, k0, bh);
              tma_load_3d(smem_u32(st + kvs + j * 64 * kRow), &vmap, full + s, x, k0, bh);
            }
            tma_load_3d(smem_u32(st + qo + j * kN * kRow), &qmap, full + s, x, q0, bh);
            tma_load_3d(smem_u32(st + oo + j * kN * kRow), &omap, full + s, x, q0, bh);
          }
        } else {  // the group unit of warpgroup c - ns: its chunks below d
          const int g0 = (2 * pair + c - ns) * W::kGC, nch = max(0, min(W::kGC, n_ch - g0));
          mbar_expect_tx(full + s, 2 * nch * kN * kRow);
          for (int j = 0; j < nch; ++j) {
            tma_load_3d(smem_u32(st + j * kN * kRow), &qmap, full + s, (g0 + j) * W::kChunkE, q0,
                        bh);
            tma_load_3d(smem_u32(st + (W::kGC + j) * kN * kRow), &omap, full + s,
                        (g0 + j) * W::kChunkE, q0, bh);
          }
        }
      }
      return;
    }
    if (tid >= 32) {  // warps 1-3: lse (times log2 e) and delta; fp32: the tf32 splits
      const int st_tid = tid - 32;
      for (int u = 0; u < n_t * per; ++u) {
        const int c = u % per, s = u % p.stages, q0 = (t0 + u / per) * kN;
        uint8_t* st = ring + s * stage_b;
        wait_or_trap(empty + s, ((u / p.stages) & 1) ^ 1);
        if (c == ns) {
          float* rv = rowv + s * 2 * kN;
          for (int r = st_tid; r < kN; r += 96) {
            const int q = q0 + r;
            const size_t at = (size_t)bh * p.sq + q;
            // beyond sq: P = 2^(S - inf) = 0, delta 0
            rv[r] = q < p.sq ? p.lse[at] * kLog2e : INFINITY;
            rv[kN + r] = q < p.sq ? p.delta[at] : 0.f;
          }
        }
        if constexpr (W::kF32) {
          wait_or_trap(full + s, (u / p.stages) & 1);
          if (c < ns) {
            split_cells(st, st + lo, lo / 16, st_tid, 96);
          } else {
            const int gl = 2 * W::kGC * kN * kRow;
            transpose_split<W::kG>(st, nullptr, st + gl, st + gl + W::kT, kN, st_tid, 96);
            transpose_split<W::kG>(st + W::kGC * kN * kRow, nullptr, st + gl + 2 * W::kT,
                                   st + gl + 3 * W::kT, kN, st_tid, 96);
          }
          fence_proxy_async();
        }
        mbar_arrive(ready + s);
      }
    }
    return;
  }

  // the multiplying warpgroups: both take the block's 64 keys; wg's group
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, wt = ct & 127;
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const int last_key = min(k0 + 64, p.sk) - 1;
  const int grp = 2 * pair + wg;
  const bool has_grp = grp < n_grp;

  float acc_k[W::kG / 2], acc_v[W::kG / 2];
#pragma unroll
  for (int i = 0; i < W::kG / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float xs[kN / 2];              // this warpgroup's product: S^T (0) or dP^T (1)
  float sc[kN / 2], dp[kN / 2];  // S^T, then P^T; dP^T, then dS^T
  constexpr int kA = W::kF32 ? kN / 8 : kN / 16, kLo = W::kF32 ? kN / 8 : 1;
  uint32_t pa[kA][4], plo[kLo][4], da[kA][4], dlo[kLo][4];
  auto unit_at = [&](int u) { return smem_u32(ring + (u % p.stages) * stage_b); };
  auto wait_unit = [&](int u) {
    if constexpr (!W::kF32) mbar_wait(full + u % p.stages, (u / p.stages) & 1);
    mbar_wait(ready + u % p.stages, (u / p.stages) & 1);
  };
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + u % p.stages);
  };
  // A: K's (warpgroup 0) or V's (1) rows of a chunk, held or in the slice
  const uint32_t a_held = smem_u32(kv) + wg * n_ch * 64 * kRow;
  const int a_unit = wg * kvs, b_unit = wg ? oo : qo;

  // S^T += K Q^T (warpgroup 0) or dP^T += V dO^T (1) over slice c's
  // chunks, the unit at st
  auto issue_slice = [&](uint32_t st, int c) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSC; ++j) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 32 bytes a step
        const uint32_t a = (held ? a_held + (c * kSC + j) * 64 * kRow : st + a_unit + j * 64 * kRow) +
                           32 * ks;
        const uint32_t b = st + b_unit + j * kN * kRow + 32 * ks;
        if constexpr (W::kF32) {
          Wgmma<kN>::ss_tf32(xs, desc_sw128(a + lo), desc_sw128(b));
          Wgmma<kN>::ss_tf32(xs, desc_sw128(a), desc_sw128(b + lo));
          Wgmma<kN>::ss_tf32(xs, desc_sw128(a), desc_sw128(b));
        } else {
          Wgmma<kN>::ss_bf16(xs, desc_sw128(a), desc_sw128(b));
        }
      }
    }
    wgmma_commit();
  };
  // dV += P^T dO_g and dK += dS^T Q_g, the group unit at st
  auto issue_kv = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (W::kF32) {
      const uint32_t qt_hi = st + 2 * W::kGC * kN * kRow, qt_lo = qt_hi + W::kT;
      const uint32_t ot_hi = qt_hi + 2 * W::kT, ot_lo = qt_hi + 3 * W::kT;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int off = (j >> 2) * W::kG * kRow + 32 * (j & 3);
        const uint64_t ohi = desc_sw128(ot_hi + off), olo = desc_sw128(ot_lo + off);
        const uint64_t qhi = desc_sw128(qt_hi + off), qlo = desc_sw128(qt_lo + off);
        Wgmma<W::kG>::rs_tf32(acc_v, plo[j], ohi);
        Wgmma<W::kG>::rs_tf32(acc_v, pa[j], olo);
        Wgmma<W::kG>::rs_tf32(acc_v, pa[j], ohi);
        Wgmma<W::kG>::rs_tf32(acc_k, dlo[j], qhi);
        Wgmma<W::kG>::rs_tf32(acc_k, da[j], qlo);
        Wgmma<W::kG>::rs_tf32(acc_k, da[j], qhi);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN / 16; ++k)
#pragma unroll
        for (int c = 0; c < W::kGC; ++c) {  // 64 columns of the group a product
          const uint32_t off = c * kN * kRow + k * 16 * kRow;
          Wgmma<64>::rs_bf16<1>(acc_v + 32 * c, pa[k], desc_sw128(st + W::kGC * kN * kRow + off));
          Wgmma<64>::rs_bf16<1>(acc_k + 32 * c, da[k], desc_sw128(st + off));
        }
    }
    wgmma_commit();
  };

  if (held && n_t > 0) mbar_wait(full_x, 0);
  // each q tile: its slices, each slice's product issued and the unit
  // before it released once that completed; the exchange; P^T and dS^T;
  // the group's products, waited for before the next q tile
  PassClock<kTrace> clk;
  for (int i = 0; i < n_t; ++i) {
    clk.start();
    int pend = -1;  // the slice whose product may still run
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) xs[e] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int u = i * per + c;
      wait_unit(u);
      clk.lap(0);
      issue_slice(unit_at(u), c);
      wgmma_wait1();
      clk.lap(1);
      if (pend >= 0) release(pend);
      pend = u;
      clk.lap(5);
    }
    wgmma_wait0();
    fence_regs(xs);
    clk.lap(1);
    release(pend);
    clk.lap(5);
    // S^T from warpgroup 0, dP^T from warpgroup 1, to both
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) xch[(wg * (kN / 2) + e) * 128 + wt] = xs[e];
    named_sync(5);
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      sc[e] = xch[e * 128 + wt];
      dp[e] = xch[(kN / 2 + e) * 128 + wt];
    }
    named_sync(5);  // both read before the next q tile's writes
    clk.lap(2);
    // the group units: the first carries the lse and delta; warpgroup w
    // multiplies from unit w (a group beyond d: into accumulators that are
    // never stored) and releases the other one unread
    const int g0u = i * per + ns;
    wait_unit(g0u);
    clk.lap(6);
    p_and_ds_t<kN, W::kF32>(sc, dp, pa, plo, da, dlo, rowv + (g0u % p.stages) * 2 * kN,
                            p.scale_log2, p.scale, (t0 + i) * kN, key0, last_key, offset,
                            p.causal, t4);
    clk.lap(3);
    if (wg == 1) release(g0u);
    wait_unit(g0u + 1);
    if (wg == 0) release(g0u + 1);
    clk.lap(6);
    issue_kv(unit_at(g0u + wg));
    wgmma_wait0();
    fence_regs(acc_k);
    fence_regs(acc_v);
    hold_regs(pa);
    hold_regs(da);
    if constexpr (W::kF32) {
      hold_regs(plo);
      hold_regs(dlo);
    }
    clk.lap(4);
    release(g0u + wg);
    clk.lap(5);
  }
  clk.save(g_trace[3], wg, n_t, wt == 0);

  // dK and dV of keys key0 and key0 + 8, the group's columns below d
  if (!has_grp) return;
  T* out_k = static_cast<T*>(p.g0) + grp * W::kG;
  T* out_v = static_cast<T*>(p.g1) + grp * W::kG;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.sk) continue;
    const size_t at = ((size_t)bh * p.sk + key) * p.d;
#pragma unroll
    for (int j = 0; j < W::kG / 8; ++j)
      if (grp * W::kG + 8 * j + 2 * t4 < p.d) {  // d is even: a pair is stored whole or not at all
        store2(out_k + at + 8 * j + 2 * t4, acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
        store2(out_v + at + 8 * j + 2 * t4, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
  }
}

// The wide mode of the dQ kernel: head dims above 256, and in fp32 above
// 128 (_kernels.flash_bwd_plan's dq.slices > 0), where Q and dO do not fit
// whole beside a ring as wgmma's operands (fp32 at d = 256: as tf32 hi and
// lo, 256 KB for 64 rows) and dQ's accumulator over d not the registers
// (bf16 at d = 512: 256 a thread). flash_bwd_dkv_wide_kernel turned
// around: one block per (batch*head, 64 q rows, pair of column groups of
// kG = 128); multiplying warpgroup w accumulates dQ's group 2 pair + w. The
// two split S and dP between them: over the slices of d warpgroup 0 adds S
// = Q K^T, warpgroup 1 dP = dO V^T, each into one fp32 fragment; the two
// fragments are exchanged through shared memory (named barrier 5), and
// both build P and dS on them (as flash_bwd_dq_kernel does, the rows' lse
// and delta loaded once a block) and add dQ_g += dS K_g for their group by
// wgmma with dS in registers. Q and dO are held for the block where two
// stages fit beside them (bf16 up to 10 chunks of d), else every slice
// brings its chunk of them. A kv tile is n_ch + 2 units of the ring, in
// order: its slices, one 128-byte chunk of d each (K's and V's kN rows,
// after Q's and dO's 64 rows where they stream; fp32: then their tf32 lo,
// split in place by warps 1-3), then one group unit for each warpgroup (K's
// group columns, read MN-major as the transposed B in bf16; fp32: then
// K_g^T as tf32 hi and lo, written by warps 1-3). One-chunk slices keep
// the units alike in size, so the ring holds four (two-chunk slices, as the
// dK/dV kernel takes where d's chunks pair up, measured 13% slower on an
// H100 at d = 512 in bf16 and 14% at d = 256 in fp32). The group units follow
// flash_bwd_dkv_wide_kernel's rules: the same issues in both warpgroups (no
// branch among the wgmma), a group's chunks beyond d not copied and its
// columns never stored.
//
// What bounds it on an H100 at d = 512. The products, 6 d FLOPs per allowed
// pair; this design does 4 d for S and dP in each of the ceil(d / 256)
// blocks of a q tile and 2 d for dQ once: 10 d at d = 512 (1.67 times the
// bound's), 6 d at d = 256 (1.0 times). Beside them L2: K and V stream
// again for every block (and Q and dO for every kv tile where they are not
// held); fp32 waits on warps 1-3 splitting every slice.
__host__ __device__ constexpr int wide_dq_regs(bool f32, int n) {
  // dQ's group (64 x 128 fp32), the slice product, S and dP after the
  // exchange, dS as A operand (bf16 pairs; fp32 tf32 hi and lo)
  return 64 + n / 2 + n + (f32 ? n : n / 4);
}
// the largest kv tile (a power of two up to 128) within the register budget
__host__ __device__ constexpr int wide_dq_tile(bool f32) {
  int n = 128;
  while (n > 16 && wide_dq_regs(f32, n) > kRegBudget) n /= 2;
  return n;
}

template <typename T>
struct WideDq {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kChunkE = kRow / kEs;   // elements of a 128-byte chunk
  static constexpr int kG = 128;                // dQ's columns a warpgroup
  static constexpr int kGC = kG / kChunkE;      // their chunks
  static constexpr int kN = wide_dq_tile(kF32);  // keys a kv tile: bf16 64, fp32 32
  static constexpr int kParts = kF32 ? 2 : 1;   // fp32: hi and lo
  static constexpr int kT = (kN + 31) / 32 * kG * kRow;                  // fp32: K_g^T, one part
  static constexpr int kGU = kGC * kN * kRow + (kF32 ? 2 * kT : 0);     // a group unit
  static constexpr int kX = 2 * 64 * kN * 4;  // the exchanged S and dP
  static_assert(wide_dq_regs(kF32, kN) <= kRegBudget, "the wide tile does not fit the budget");
  // Q and dO held for the block: 64 rows of each chunk of both
  __host__ __device__ static constexpr int qo_bytes(int n_ch) { return 2 * n_ch * 64 * kRow; }
  // a slice: K's and V's chunk of kN rows, after Q's and dO's of 64 rows
  // where they stream; fp32: their lo
  __host__ __device__ static constexpr int slice_bytes(bool held) {
    return kParts * 2 * (kN + (held ? 0 : 64)) * kRow;
  }
  __host__ __device__ static constexpr int stage(bool held) {
    return slice_bytes(held) > kGU ? slice_bytes(held) : kGU;
  }
  // 1024 bytes of slack to align the base for the swizzle, Q and dO where
  // held, the ring, the exchange, the barriers
  __host__ __device__ static constexpr int smem(bool held, int n_ch, int stages) {
    return 1024 + (held ? qo_bytes(n_ch) : 0) + stages * stage(held) + kX + 256;
  }
  // Q and dO are held where two stages fit beside them (bf16 only: as tf32
  // hi and lo they would take twice the room)
  __host__ __device__ static constexpr bool held(int n_ch) {
    return !kF32 && smem(true, n_ch, 2) <= kSmemMax;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap omap, const Params p) {
  using W = WideDq<T>;
  constexpr int kN = W::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ns = (p.d * W::kEs + kRow - 1) / kRow;  // chunks of d: the slices of a kv tile
  const int per = ns + 2;                           // its units: slices, two group units
  const bool held = W::held(ns);
  const int stage_b = W::stage(held);
  uint8_t* qo = base;                                  // Q's chunks, then dO's (held)
  uint8_t* ring = base + (held ? W::qo_bytes(ns) : 0);
  float* xch = reinterpret_cast<float*>(ring + p.stages * stage_b);  // S, dP
  uint64_t* full_x = reinterpret_cast<uint64_t*>(xch + W::kX / 4);
  uint64_t* full = full_x + 2;
  uint64_t* ready = full + kMaxStages;  // fp32: the splits
  uint64_t* empty = ready + kMaxStages;
  // regions of a slice: Q's, dO's chunk (64 rows each, where they stream),
  // K's, V's (kN rows each); fp32: their lo
  const int qs = held ? 0 : 64 * kRow, ko = 2 * qs, vo = ko + kN * kRow;
  const int lo = W::slice_bytes(held) / 2;
  const int n_grp = (p.d + W::kG - 1) / W::kG, n_pair = (n_grp + 1) / 2;
  // one block per (q tile, pair of column groups, batch*head), the heaviest
  // causal q tiles first
  const int idx = (int)(blockIdx.x / p.bh), pair = idx % n_pair;
  const int qt = p.n_blocks - 1 - idx / n_pair;
  const int bh = blockIdx.x % p.bh, q0 = qt * 64, offset = p.sk - p.sq;
  // the kv tiles holding an allowed pair for a real row of this q tile
  int n_kv = (p.sk + kN - 1) / kN;
  if (p.causal) {
    const int hi = min(q0 + 64, p.sq) - 1 + offset;
    n_kv = hi < 0 ? 0 : min(n_kv, hi / kN + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_x, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);  // warps 1-3 of the copying warpgroup
      mbar_init(empty + s, 8);   // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      if (held && n_kv > 0) {
        mbar_expect_tx(full_x, W::qo_bytes(ns));
        for (int c = 0; c < ns; ++c) {
          tma_load_3d(smem_u32(qo + c * 64 * kRow), &qmap, full_x, c * W::kChunkE, q0, bh);
          tma_load_3d(smem_u32(qo + (ns + c) * 64 * kRow), &omap, full_x, c * W::kChunkE, q0, bh);
        }
      }
      for (int u = 0; u < n_kv * per; ++u) {
        const int c = u % per, s = u % p.stages, k0 = (u / per) * kN;
        wait_or_trap(empty + s, ((u / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * stage_b;
        if (c < ns) {  // slice c: chunk c
          const int x = c * W::kChunkE;
          mbar_expect_tx(full + s, 2 * (kN + (held ? 0 : 64)) * kRow);
          if (!held) {
            tma_load_3d(smem_u32(st), &qmap, full + s, x, q0, bh);
            tma_load_3d(smem_u32(st + qs), &omap, full + s, x, q0, bh);
          }
          tma_load_3d(smem_u32(st + ko), &kmap, full + s, x, k0, bh);
          tma_load_3d(smem_u32(st + vo), &vmap, full + s, x, k0, bh);
        } else {  // the group unit of warpgroup c - ns: K's chunks below d
          const int g0 = (2 * pair + c - ns) * W::kGC, nch = max(0, min(W::kGC, ns - g0));
          mbar_expect_tx(full + s, nch * kN * kRow);
          for (int j = 0; j < nch; ++j)
            tma_load_3d(smem_u32(st + j * kN * kRow), &kmap, full + s, (g0 + j) * W::kChunkE, k0,
                        bh);
        }
      }
      return;
    }
    if constexpr (W::kF32) {  // warps 1-3: the tf32 splits
      if (tid >= 32) {
        const int st_tid = tid - 32;
        for (int u = 0; u < n_kv * per; ++u) {
          const int c = u % per, s = u % p.stages;
          uint8_t* st = ring + s * stage_b;
          wait_or_trap(full + s, (u / p.stages) & 1);
          if (c < ns) {  // the slice split in place, lo after it
            split_cells(st, st + lo, lo / 16, st_tid, 96);
          } else {  // K_g transposed as tf32 hi and lo
            const int gl = W::kGC * kN * kRow;
            transpose_split<W::kG>(st, nullptr, st + gl, st + gl + W::kT, kN, st_tid, 96);
          }
          fence_proxy_async();
          mbar_arrive(ready + s);
        }
      }
    }
    return;
  }

  // the multiplying warpgroups: both take the block's 64 q rows; wg's group
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = tid - 128, wg = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, wt = ct & 127;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int grp = 2 * pair + wg;
  float lse2[2], dlt[2];  // lse * log2(e); delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const size_t i = (size_t)bh * p.sq + r;
    lse2[h] = r < p.sq ? p.lse[i] * kLog2e : 0.f;
    dlt[h] = r < p.sq ? p.delta[i] : 0.f;
  }

  float acc[W::kG / 2];
#pragma unroll
  for (int i = 0; i < W::kG / 2; ++i) acc[i] = 0.f;
  float xs[kN / 2];              // this warpgroup's product: S (0) or dP (1)
  float sc[kN / 2], dp[kN / 2];  // S, then P; dP, then dS
  // dS as wgmma's A operand: bf16 pairs, or tf32 hi and lo
  uint32_t da[W::kF32 ? kN / 8 : kN / 16][4], dlo[W::kF32 ? kN / 8 : 1][4];
  uint64_t* rdy = W::kF32 ? ready : full;
  auto unit_at = [&](int u) { return smem_u32(ring + (u % p.stages) * stage_b); };
  auto wait_unit = [&](int u) { mbar_wait(rdy + u % p.stages, (u / p.stages) & 1); };
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + u % p.stages);
  };
  // A: Q's (warpgroup 0) or dO's (1) rows of a chunk, held or in the slice;
  // B: K's or V's
  const uint32_t a_held = smem_u32(qo) + wg * ns * 64 * kRow;
  const int a_unit = wg * qs, b_unit = ko + wg * kN * kRow;

  // S += Q K^T (warpgroup 0) or dP += dO V^T (1) over slice c's chunk, the
  // unit at st
  auto issue_slice = [&](uint32_t st, int c) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 32 bytes a step
      const uint32_t a = (held ? a_held + c * 64 * kRow : st + a_unit) + 32 * ks;
      const uint32_t b = st + b_unit + 32 * ks;
      if constexpr (W::kF32) {
        Wgmma<kN>::ss_tf32(xs, desc_sw128(a + lo), desc_sw128(b));
        Wgmma<kN>::ss_tf32(xs, desc_sw128(a), desc_sw128(b + lo));
        Wgmma<kN>::ss_tf32(xs, desc_sw128(a), desc_sw128(b));
      } else {
        Wgmma<kN>::ss_bf16(xs, desc_sw128(a), desc_sw128(b));
      }
    }
    wgmma_commit();
  };
  // dQ_g += dS K_g, the group unit at st
  auto issue_dq = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (W::kF32) {
      const uint32_t kt_hi = st + W::kGC * kN * kRow, kt_lo = kt_hi + W::kT;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int off = (j >> 2) * W::kG * kRow + 32 * (j & 3);
        const uint64_t bhi = desc_sw128(kt_hi + off), blo = desc_sw128(kt_lo + off);
        Wgmma<W::kG>::rs_tf32(acc, dlo[j], bhi);
        Wgmma<W::kG>::rs_tf32(acc, da[j], blo);
        Wgmma<W::kG>::rs_tf32(acc, da[j], bhi);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kN / 16; ++k)
#pragma unroll
        for (int c = 0; c < W::kGC; ++c)  // 64 columns of the group a product
          Wgmma<64>::rs_bf16<1>(acc + 32 * c, da[k], desc_sw128(st + c * kN * kRow + k * 16 * kRow));
    }
    wgmma_commit();
  };

  if (held && n_kv > 0) mbar_wait(full_x, 0);
  // each kv tile: its slices, each slice's product issued and the unit
  // before it released once that completed; the exchange; P and dS; the
  // group's products, waited for before the next kv tile
  PassClock<kTrace> clk;
  for (int t = 0; t < n_kv; ++t) {
    clk.start();
    int pend = -1;  // the slice whose product may still run
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) xs[e] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int u = t * per + c;
      wait_unit(u);
      clk.lap(0);
      issue_slice(unit_at(u), c);
      wgmma_wait1();
      clk.lap(1);
      if (pend >= 0) release(pend);
      pend = u;
      clk.lap(5);
    }
    wgmma_wait0();
    fence_regs(xs);
    clk.lap(1);
    release(pend);
    clk.lap(5);
    // S from warpgroup 0, dP from warpgroup 1, to both
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) xch[(wg * (kN / 2) + e) * 128 + wt] = xs[e];
    named_sync(5);
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      sc[e] = xch[e * 128 + wt];
      dp[e] = xch[(kN / 2 + e) * 128 + wt];
    }
    named_sync(5);  // both read before the next kv tile's writes
    clk.lap(2);
    p_and_ds_rows<kN, W::kF32>(sc, dp, da, dlo, lse2, dlt, p.scale_log2, p.scale, t * kN, p.sk,
                               p.causal, q0, row0, offset, t4);
    clk.lap(3);
    // the group units: warpgroup w multiplies from unit w (a group beyond
    // d: into an accumulator that is never stored) and releases the other
    // one unread
    const int g0u = t * per + ns;
    wait_unit(g0u);
    if (wg == 1) release(g0u);
    wait_unit(g0u + 1);
    if (wg == 0) release(g0u + 1);
    clk.lap(6);
    issue_dq(unit_at(g0u + wg));
    wgmma_wait0();
    fence_regs(acc);
    hold_regs(da);
    if constexpr (W::kF32) hold_regs(dlo);
    clk.lap(4);
    release(g0u + wg);
    clk.lap(5);
  }
  clk.save(g_trace[2], wg, n_kv, wt == 0);

  // dQ of rows row0 and row0 + 8, the group's columns below d
  if (grp >= n_grp) return;
  T* out = static_cast<T*>(p.g0) + grp * W::kG;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    T* orow = out + ((size_t)bh * p.sq + row) * p.d;
#pragma unroll
    for (int j = 0; j < W::kG / 8; ++j)
      if (grp * W::kG + 8 * j + 2 * t4 < p.d)  // d is even: a pair is stored whole or not at all
        store2(orow + 8 * j + 2 * t4, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// the (bh, s, d) tensor maps of q, k, v and dout: boxes of one 128-byte
// chunk of d by q_box rows (q, dout) or kv_box rows (k, v), zero beyond d
// and s
template <typename T>
bool bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
              const void* dout, const Params& p, int q_box, int kv_box) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const cuuint64_t s = is_q ? p.sq : p.sk;
    const cuuint64_t dims[3] = {(cuuint64_t)p.d, s, (cuuint64_t)p.bh};
    const cuuint64_t strides[2] = {(cuuint64_t)p.d * sizeof(T), s * p.d * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)(kRow / sizeof(T)), (cuuint32_t)(is_q ? q_box : kv_box),
                               1};
    if (!encode(&maps[i], sizeof(T) == 2, 3, ptrs[i], dims, strides, box)) return false;
  }
  return true;
}

template <typename T, int kSC>
cudaError_t launch_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const Params& p0, int rows, int tile, int smem, int groups,
                            cudaStream_t stream) {
  using W = WideBwd<T, kSC>;
  // 64 keys a block; two stages at least: a slice's product is issued
  // before the unit before it is released
  const int n_ch = (p0.d * W::kEs + kRow - 1) / kRow;
  if (tile != W::kN || groups != (p0.d + W::kG - 1) / W::kG || rows != 64 || p0.stages < 2 ||
      p0.stages > kMaxStages || smem != W::smem(W::held(n_ch), n_ch, p0.stages) ||
      smem > kSmemMax)
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_dkv_wide_kernel<T, kSC>;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  CUtensorMap maps[4] = {};
  if (!bwd_maps<T>(maps, q, k, v, dout, p0, tile, rows)) return cudaErrorInvalidValue;
  Params p = p0;
  p.rows = rows;
  p.n_blocks = (p.sk + rows - 1) / rows;
  const long long blocks = (long long)p.n_blocks * ((groups + 1) / 2) * p.bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// the wide mode in slices of two chunks where d's chunks pair up, else one
template <typename T>
cudaError_t launch_wide_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const Params& p0, int rows, int tile, int smem, int groups,
                            cudaStream_t stream) {
  const int n_ch = (p0.d * (int)sizeof(T) + kRow - 1) / kRow;
  return n_ch % 2 ? launch_wide_dkv<T, 1>(q, k, v, dout, p0, rows, tile, smem, groups, stream)
                  : launch_wide_dkv<T, 2>(q, k, v, dout, p0, rows, tile, smem, groups, stream);
}

template <typename T>
cudaError_t launch_wide_dq(const void* q, const void* k, const void* v, const void* dout,
                           const Params& p0, int rows, int tile, int smem, int groups,
                           cudaStream_t stream) {
  using W = WideDq<T>;
  // 64 q rows a block; two stages at least: a slice's product is issued
  // before the unit before it is released
  const int n_ch = (p0.d * W::kEs + kRow - 1) / kRow;
  if (tile != W::kN || groups != (p0.d + W::kG - 1) / W::kG || rows != 64 || p0.stages < 2 ||
      p0.stages > kMaxStages || smem != W::smem(W::held(n_ch), n_ch, p0.stages) ||
      smem > kSmemMax)
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_dq_wide_kernel<T>;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  CUtensorMap maps[4] = {};
  if (!bwd_maps<T>(maps, q, k, v, dout, p0, rows, tile)) return cudaErrorInvalidValue;
  Params p = p0;
  p.rows = rows;
  p.n_blocks = (p.sq + rows - 1) / rows;
  const long long blocks = (long long)p.n_blocks * ((groups + 1) / 2) * p.bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
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
  CUtensorMap maps[4] = {};
  if (!bwd_maps<T>(maps, q, k, v, dout, p0, kDq ? rows : tile, kDq ? tile : rows))
    return cudaErrorInvalidValue;
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
  const int dc = head_class(p.d);
  if (dc == 0 || (dc == 256 && !BwdTile<T, 256>::fits(kDq))) {  // the wide modes
    if constexpr (kDq)
      return launch_wide_dq<T>(q, k, v, dout, p, rows, tile, smem, groups, s);
    else
      return launch_wide_dkv<T>(q, k, v, dout, p, rows, tile, smem, groups, s);
  }
  switch (dc) {
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

}  // namespace

extern "C" {

// q, dout, dq: contiguous (bh, sq, d); k, v: contiguous (bh, sk, d); all fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned, d >= 1 with rows of
// whole 16-byte units (above 256, and in fp32 above 128, the wide mode).
// lse, delta: contiguous (bh, sq) fp32. The plan (_kernels.flash_bwd_plan,
// this kernel's part): rows (64 or 128) a block, tile keys a stage, stages
// of the ring, smem the block's dynamic shared memory in bytes, groups of
// the output's columns; a plan this build would lay out otherwise is
// refused. Returns the launch's cudaError_t (0 = queued).
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

#ifdef FLASH_BWD_TRACE
// the diagnostic build's clock counts (kernel x warpgroup x 8), zeroed after
int dcnn_flash_bwd_trace(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess) {
    static unsigned long long zeros[4][2][8];
    err = cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));
  }
  return static_cast<int>(err);
}
#endif

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
