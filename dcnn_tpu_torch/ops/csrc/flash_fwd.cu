// Flash-attention forward on Hopper's tensor cores (sm_90a: TMA, mbarriers,
// wgmma), with a plain C interface bound from Python through ctypes
// (dcnn_tpu_torch/ops/_kernels.py).
//
// Replaces: dcnn_tpu/ops/attention.py::_flash_kernel, the Pallas TPU kernel
// behind flash_attention -> _flash_forward. Same function: S = (Q K^T)
// scale in fp32; a kv-padding mask and a causal mask with diagonal offset
// sk - sq; the online softmax with fp32 running max m and sum l; P = exp(S -
// m), masked, rounded to V's type before P V (l sums P before that
// rounding); l clamped at 1e-30, so a fully masked row gives O exactly 0;
// O = acc / l in q's type and logsumexp m + log(l) as (bh, sq) fp32, -1e30
// for a fully masked row (the backward kernels read it).
//
// Design. One block per (batch*head, tile of q_rows = 64 or 128 q rows,
// group of O's columns), on a 1-d grid (any batch*head), the heaviest
// causal tiles first. Any head dim d <= 256 runs as its class D (16, 32,
// 64, 128 or 256; flash.cuh): columns d .. D - 1 are the copy's zero fill;
// a head dim above 256 runs the wide mode (flash_fwd_wide_kernel below),
// which streams the contraction over d through the ring in slices.
// Where O's fp32 accumulator over D would not fit the register budget with
// S and P (bf16 at D = 256: 128 registers for O alone), or a stage would not
// fit beside 64 q rows (fp32 at D = 256), O's columns are cut in groups of
// 128, one group a block: each block computes S over the whole
// of D and lands only its group's columns of V; group 0 writes the
// logsumexp. Warpgroup 0 copies, warpgroups 1-2 (one
// per 64 q rows) multiply. One thread issues every TMA: the Q tile once,
// then each kv tile's K and V into a ring of up to 4 stages with full/empty
// mbarriers; the copy's out-of-bounds zero fill covers ragged Sq, Sk and D.
// Rows of D land as 128-byte chunks in the 128-byte swizzle. A multiplying
// warpgroup computes S = Q K^T by wgmma with both operands in shared memory
// (K's (key, d) rows are already K-major as K^T's B), runs the online
// softmax on the accumulator fragment (a row lives in one quad: two
// shuffles give its max; the sum stays per thread until the end), and adds
// P V by wgmma with P converted in registers to the A operand. Pass t
// issues S of tile t and P V of tile t - 1 together and runs the softmax of
// tile t while P V is in flight; only O's rescale waits for it. The two
// warpgroups take turns to issue (two named barriers), so one's softmax
// runs beside the other's products. Tiles above the causal band are
// skipped (the kv loop ends at the last tile holding an allowed pair for a
// real row; a warpgroup releases unread the tiles above its own rows); the
// mask is applied only on tiles that cross the diagonal or the end of the
// keys, in a branch of its own. The tiling is planned on the host
// (_kernels.flash_plan) and checked here.
//
// Products. bf16: wgmma m64n128k16 for S (128-key tiles); P V m64n64k16
// per 64-column chunk of D, V read MN-major (the transposed-B form of
// 16-bit types). fp32 keeps fp32 accuracy (TF32 is off at parity
// precision): each operand is split into hi = tf32(x) and lo = tf32(x -
// hi) and both products run lo*hi + hi*lo + hi*hi on wgmma m64nNk8 tf32.
// TF32 takes only K-major B, so for fp32 warps 1-3 of the copying
// warpgroup split Q, K and V in shared memory once per tile and write V
// transposed (keys contiguous) as V^T's hi and lo, its keys permuted
// within each group of 8 to match the order in which the accumulator
// fragment holds P (columns 2t, 2t+1 of a group are fed as the A operand's
// columns t, t+4). fp32 uses 64-key tiles, and at D = 128 32-key tiles and
// 64 q rows, so two stages fit. At D = 256 fp32 Q's hi and lo alone take
// 128 KB: 16-key tiles (V^T still takes a 128-byte row per column) and O's
// columns in two groups, in one stage, so a pass runs S, the softmax and P
// V in turn (kSerial) instead of overlapping S of one tile with P V of the
// one before.
//
// What bounds it on an H100. At long context the two products: 4 D FLOPs
// per allowed (q, k) pair at 989 TFLOP/s (bf16; fp32 as three TF32
// products at 495), far above the bytes of Q, K, V and O. Beside them the
// softmax's exponentials: one per pair on the special-function units (16
// a clock per SM), as much time as the products at D = 64. The softmax is
// the longest phase of a pass (clock counts in PERF.md); fp32 waits on its
// splits in shared memory. At the serving shape (S = 32, D = 16) the work
// is a few MFLOP and launch latency sets the time.

#include <cuda_bf16.h>
#include <math.h>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;      // warpgroup 0 copies, 1-2 multiply
constexpr int kMaxStages = 4;
#ifdef FLASH_TRACE
constexpr bool kTrace = true;
#else
constexpr bool kTrace = false;
#endif

// The tile format for head-dim class D, mirrored by _kernels.flash_plan
// (which sizes the block's shared memory from the same formula)
template <typename T, int D>
struct Tile {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kChunkE = kRow / kEs;              // elements of a 128-byte chunk
  static constexpr int kDC = (D * kEs + kRow - 1) / kRow;  // chunks of a row of D
  static constexpr int kDP = kDC * kChunkE;                // D padded to whole chunks
  static constexpr int kBKV = !kF32 ? 128 : D == 256 ? 16 : D == 128 ? 32 : 64;  // keys a kv tile
  static constexpr int kKSteps = D * kEs / 32;             // 32-byte K steps of Q K^T
  static constexpr int kParts = kF32 ? 2 : 1;              // fp32: hi and lo
  __host__ __device__ static constexpr int q_bytes(int q_rows) { return kDC * q_rows * kRow * kParts; }
  // registers of a multiplying thread with O's columns in g groups: O, S,
  // and P as the A operand (_kernels.flash_fwd_regs)
  static constexpr int regs(int g) { return kDP / g / 2 + kBKV / 2 + (kF32 ? kBKV : kBKV / 4); }
  // fp32: one part (hi or lo) of V^T over g groups' columns: a row of 128
  // bytes per column for each 32 keys
  static constexpr int vt_bytes(int g) { return (kBKV + 31) / 32 * (kDP / g) * kRow; }
  // a stage with O's columns in g groups: K, the group's columns of V;
  // fp32: then K's lo, V^T's hi and lo
  static constexpr int stage_bytes(int g) {
    return kDC * kBKV * kRow * (kF32 ? 2 : 1) + kDC / g * kBKV * kRow + (kF32 ? 2 * vt_bytes(g) : 0);
  }
  // the fewest groups whose registers fit the budget and whose stage fits
  // beside 64 q rows (fp32 at D = 256: 2, for shared memory)
  static constexpr bool fits(int g) {
    return regs(g) <= kRegBudget && 1024 + q_bytes(64) + stage_bytes(g) + 256 <= kSmemMax;
  }
  static constexpr int kGroups = fits(1) ? 1 : 2;          // groups of O's columns
  static constexpr int kDO = kDP / kGroups;                // O's columns a block
  static constexpr int kDCo = kDC / kGroups;               // chunks of V a stage holds
  static constexpr int kKV = kDC * kBKV * kRow;            // one K tile as it lands
  static constexpr int kVV = kDCo * kBKV * kRow;           // the group's columns of a V tile
  static constexpr int kVt = vt_bytes(kGroups);            // fp32: V^T, one part
  static constexpr int kStage = stage_bytes(kGroups);      // K, V; fp32: K's lo, V^T hi, lo
  static_assert(fits(kGroups), "no tile format for this class");
  // 1024 bytes of slack to align the base for the swizzle, and the barriers
  __host__ __device__ static constexpr int smem(int q_rows, int stages) {
    return 1024 + q_bytes(q_rows) + stages * kStage + 256;
  }
  // two stages do not fit beside 64 q rows: one stage, serial passes
  static constexpr bool kSerial = smem(64, 2) > kSmemMax;
};

// Clock counts of the steady passes (the -DFLASH_TRACE build;
// dcnn_flash_fwd_trace reads them): [0] waiting for the tile, [1] for the
// turn, [2] issuing S and P V, [3] waiting for S, [4] the softmax, [5]
// waiting for P V, [6] O's rescale and P to the A form, [7] the passes
__device__ unsigned long long g_trace[2][8];

struct Params {
  void* o;
  float* lse;
  int sq, sk, d, causal, q_rows, stages, n_qtiles, bh;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Tile<T, D>;
  constexpr int kBKV = L::kBKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq_hi = base;  // Q: kDC chunks of q_rows rows; fp32: then Q's lo
  uint8_t* sq_lo = base + L::kDC * p.q_rows * kRow;
  uint8_t* ring = base + L::q_bytes(p.q_rows);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ring + p.stages * L::kStage);
  uint64_t* ready_q = full_q + 1;  // fp32: Q split
  uint64_t* full = full_q + 2;
  uint64_t* ready = full + kMaxStages;  // fp32: the stage split and V transposed
  uint64_t* empty = ready + kMaxStages;
  const int nwg = p.q_rows / 64;
  // one block per (q tile, column group, batch*head), the heaviest causal
  // q tiles first
  const int idx = (int)(blockIdx.x / p.bh), grp = idx % L::kGroups;
  const int qt = p.n_qtiles - 1 - idx / L::kGroups;
  const int bh = blockIdx.x % p.bh, q0 = qt * p.q_rows, offset = p.sk - p.sq;
  // the kv tiles holding an allowed pair for a real row of this q tile
  int n_kv = (p.sk + kBKV - 1) / kBKV;
  if (p.causal) {
    const int hi = min(q0 + p.q_rows, p.sq) - 1 + offset;
    n_kv = hi < 0 ? 0 : min(n_kv, hi / kBKV + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_q, 1);
    mbar_init(ready_q, 96);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);         // warps 1-3 of the copying warpgroup
      mbar_init(empty + s, 4 * nwg);    // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(full_q, L::kDC * p.q_rows * kRow);
      for (int c = 0; c < L::kDC; ++c)
        tma_load_3d(smem_u32(sq_hi + c * p.q_rows * kRow), &qmap, full_q, c * L::kChunkE, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % p.stages;
        mbar_wait(empty + s, ((t / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * L::kStage;
        mbar_expect_tx(full + s, L::kKV + L::kVV);
        for (int c = 0; c < L::kDC; ++c)
          tma_load_3d(smem_u32(st + c * kBKV * kRow), &kmap, full + s, c * L::kChunkE, t * kBKV, bh);
        for (int c = 0; c < L::kDCo; ++c)  // the group's chunks of V
          tma_load_3d(smem_u32(st + L::kKV + c * kBKV * kRow), &vmap, full + s,
                      (grp * L::kDCo + c) * L::kChunkE, t * kBKV, bh);
      }
      return;
    }
    if constexpr (L::kF32) {  // warps 1-3: the tf32 splits
      if (tid >= 32) {
        const int st_tid = tid - 32;
        mbar_wait(full_q, 0);
        split_cells(sq_hi, sq_lo, L::kDC * p.q_rows * kRow / 16, st_tid, 96);
        fence_proxy_async();
        mbar_arrive(ready_q);
        for (int t = 0; t < n_kv; ++t) {
          const int s = t % p.stages;
          mbar_wait(full + s, (t / p.stages) & 1);
          uint8_t* st = ring + s * L::kStage;
          uint8_t* vt = st + 2 * L::kKV + L::kVV;
          split_cells(st, st + L::kKV + L::kVV, L::kKV / 16, st_tid, 96);
          transpose_split<L::kDO>(st + L::kKV, nullptr, vt, vt + L::kVt, kBKV, st_tid, 96);
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
  uint64_t* rdy = L::kF32 ? ready : full;
  mbar_wait(L::kF32 ? ready_q : full_q, 0);
  const uint32_t qa = smem_u32(sq_hi) + wg * 64 * kRow;
  const uint32_t qa_lo = smem_u32(sq_lo) + wg * 64 * kRow;

  float o[L::kDO / 2];
#pragma unroll
  for (int i = 0; i < L::kDO / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sc[kBKV / 2];  // S of the tile, then its P in fp32
  // P of the previous tile as wgmma's A operand: bf16 pairs, or tf32 hi and lo
  uint32_t pa[L::kF32 ? kBKV / 8 : kBKV / 16][4], plo[L::kF32 ? kBKV / 8 : 1][4];
  // the tiles this warpgroup multiplies: those up to the last one holding
  // an allowed pair for one of its real rows (a prefix of the block's)
  int n_live = wg_first <= wg_last ? n_kv : 0;
  if (p.causal && n_live) {
    const int hi = wg_last + offset;
    n_live = hi < 0 ? 0 : min(n_kv, hi / kBKV + 1);
  }
  // Two warpgroups take turns to issue their products (named barriers 1
  // and 2, "wg may issue"), so one's softmax runs beside the other's
  // products. Both pass their turn n_kv + 1 times.
  const bool turns = nwg == 2;
  if (turns && wg == 1) named_arrive(1);
  auto turn_begin = [&]() { if (turns) named_sync(1 + wg); };
  auto turn_end = [&]() { if (turns) named_arrive(2 - wg); };
  auto stage_of = [&](int t) { return smem_u32(ring + (t % p.stages) * L::kStage); };
  auto wait_tile = [&](int t) { mbar_wait(rdy + t % p.stages, (t / p.stages) & 1); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % p.stages);
  };

  // S = Q K^T of the tile at stage st into sc
  auto issue_s = [&](uint32_t st) {
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks) {
      // chunk ks / 4 of D, 32 bytes a step within it
      const uint32_t qoff = (ks >> 2) * p.q_rows * kRow + 32 * (ks & 3);
      const uint32_t koff = (ks >> 2) * kBKV * kRow + 32 * (ks & 3);
      const uint64_t a = desc_sw128(qa + qoff), b = desc_sw128(st + koff);
      if constexpr (L::kF32) {
        const uint64_t alo = desc_sw128(qa_lo + qoff);
        const uint64_t blo = desc_sw128(st + L::kKV + L::kVV + koff);
        Wgmma<kBKV>::ss_tf32(sc, alo, b);
        Wgmma<kBKV>::ss_tf32(sc, a, blo);
        Wgmma<kBKV>::ss_tf32(sc, a, b);
      } else {
        Wgmma<kBKV>::ss_bf16(sc, a, b);
      }
    }
    wgmma_commit();
  };
  // O += P V with P in pa (and plo) and V at stage st
  auto issue_pv = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (L::kF32) {
      const uint32_t vt_hi = st + 2 * L::kKV + L::kVV, vt_lo = vt_hi + L::kVt;
      constexpr int kNW = L::kDO > 128 ? 128 : L::kDO;  // O's columns a product
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int n = 0; n < L::kDO / kNW; ++n) {
          const int off = (j >> 2) * L::kDO * kRow + 32 * (j & 3) + n * kNW * kRow;
          const uint64_t bhi = desc_sw128(vt_hi + off), blo = desc_sw128(vt_lo + off);
          Wgmma<kNW>::rs_tf32(o + n * kNW / 2, plo[j], bhi);
          Wgmma<kNW>::rs_tf32(o + n * kNW / 2, pa[j], blo);
          Wgmma<kNW>::rs_tf32(o + n * kNW / 2, pa[j], bhi);
        }
    } else {
      const uint32_t vb = st + L::kKV;
#pragma unroll
      for (int k = 0; k < kBKV / 16; ++k)
#pragma unroll
        for (int c = 0; c < L::kDCo; ++c)  // 64 columns of the group a product
          Wgmma<64>::rs_bf16<1>(o + 32 * c, pa[k], desc_sw128(vb + c * kBKV * kRow + k * 16 * kRow));
    }
    wgmma_commit();
  };
  // the online softmax of tile t on the fragment (sc[4j + e] is row row0 +
  // 8 (e >> 1), key kv0 + 8j + 2 t4 + (e & 1)): P into sc, m and l
  // updated; returns the rows' rescale factors through corr
  auto softmax = [&](int t, float (&corr)[2]) {
    online_softmax<kBKV>(sc, m, l, corr, p.scale_log2, t * kBKV, p.sk, p.causal, wg_first, row0,
                         offset, t4);
  };
  // once no P V is in flight: O rescaled, and P in sc to wgmma's A form
  auto to_operand = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < L::kDO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
    if constexpr (L::kF32) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
        // A's (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4) take
        // the fragment's keys 2t, 2t, 2t + 1, 2t + 1 (see key_pos)
        const float v[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[j][i] = to_tf32(v[i]);
          plo[j][i] = to_tf32(v[i] - __uint_as_float(pa[j][i]));
        }
      }
    } else {
      // the accumulator's columns 16k .. 16k + 15 are the A operand of K
      // step k as they are, rounded to bf16
#pragma unroll
      for (int k = 0; k < kBKV / 16; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[k][i] = pack_bf16(sc[8 * k + 2 * i], sc[8 * k + 2 * i + 1]);
    }
  };
  auto pv_done = [&]() {
    wgmma_wait0();
    fence_regs(o);
    hold_regs(pa);
    if constexpr (L::kF32) hold_regs(plo);
  };

  // tile 0; then each pass t issues S of tile t and P V of tile t - 1 and
  // runs the softmax of tile t while P V is in flight; then P V of the last
  // live tile; then the tiles above this warpgroup's band, released unread.
  // With one stage (kSerial, one warpgroup) each pass runs S, the softmax
  // and P V of its tile in turn.
  if constexpr (L::kSerial) {
    for (int t = 0; t < n_live; ++t) {
      float corr[2];
      wait_tile(t);
      issue_s(stage_of(t));
      wgmma_wait0();
      fence_regs(sc);
      softmax(t, corr);
      to_operand(corr);
      issue_pv(stage_of(t));
      pv_done();
      release(t);
    }
  } else if (n_live > 0) {
    float corr[2];
    wait_tile(0);
    turn_begin();
    issue_s(stage_of(0));
    turn_end();
    wgmma_wait0();
    fence_regs(sc);
    softmax(0, corr);
    to_operand(corr);
    PassClock<kTrace> clk;
    for (int t = 1; t < n_live; ++t) {
      clk.start();
      wait_tile(t);
      clk.lap(0);
      turn_begin();
      clk.lap(1);
      issue_s(stage_of(t));
      issue_pv(stage_of(t - 1));
      turn_end();
      clk.lap(2);
      wgmma_wait1();  // S done; P V may still run
      fence_regs(sc);
      clk.lap(3);
      softmax(t, corr);
      fence_regs(sc);  // the softmax done before P V's wait
      clk.lap(4);
      pv_done();
      clk.lap(5);
      release(t - 1);
      to_operand(corr);
      clk.lap(6);
    }
    clk.save(g_trace, wg, n_live - 1, (ct & 127) == 0);
    turn_begin();
    issue_pv(stage_of(n_live - 1));
    turn_end();
    pv_done();
    release(n_live - 1);
  } else {
    turn_begin();  // the pass that has no tile
    turn_end();
  }
  for (int t = n_live; t < n_kv; ++t) {
    wait_tile(t);
    turn_begin();
    turn_end();
    release(t);
  }
  if (turns && wg == 0) named_sync(1);  // the turn warpgroup 1 passed last

  // O = acc / max(l, 1e-30) and the logsumexp of rows row0 and row0 + 8
  T* out = static_cast<T*>(p.o) + grp * L::kDO;  // the group's columns
  constexpr int kCols = L::kGroups == 1 ? D : L::kDO;        // columns a block may store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    const float l_fin = fmaxf(sum, 1e-30f);
    T* orow = out + ((size_t)bh * p.sq + row) * p.d;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      if (grp * L::kDO + 8 * j + 2 * t4 < p.d)  // d is even: a pair is stored whole or not at all
        store2(orow + 8 * j + 2 * t4, o[4 * j + 2 * h] / l_fin, o[4 * j + 2 * h + 1] / l_fin);
    if (t4 == 0 && grp == 0)
      p.lse[(size_t)bh * p.sq + row] = m[h] == kNeg ? kNeg : m[h] * kLn2 + logf(l_fin);
  }
}

// The wide mode: head dims above 256 (_kernels.flash_plan's slices > 0), any
// d in whole 16-byte units. Neither Q's nor K's rows of d fit a stage whole
// (bf16 at d = 512: a 128-key K tile is 128 KB), nor O's fp32 accumulator
// over d the registers (256 a thread at d = 512), so the contraction of S =
// Q K^T streams through the ring in slices of kSC 128-byte chunks of d, and
// O's columns are cut in groups of kG = 256, one group a block (each block
// recomputes S over the whole of d; group 0 writes the logsumexp). A slice
// is two chunks where d's chunks pair up, else one: every slice is whole,
// so no branch sits among the wgmma issues (ptxas would serialize them). A
// kv tile is ns + 1 units of the ring, in order: its slices (Q's q_rows
// rows and K's kBKV keys of kSC chunks; fp32: then their tf32 lo, split in
// place by warps 1-3), then the group's columns of V (fp32: then V^T as
// tf32 hi and lo). Q streams again with every kv tile: held for the block
// instead (bf16, where it fits) it measured no faster (PERF.md). A
// multiplying warpgroup (64 q rows) adds each slice's products into the
// same fp32 S fragment, releasing the slice before it once the slice's
// wgmma is issued and the one before has completed; runs the online softmax
// on S; and adds P V for the group by wgmma with P in registers, as
// flash_fwd_kernel does, left to run beside the next tile's first slice.
// The two multiplying warpgroups run independently over the same units, so
// one's softmax runs beside the other's products. A group's chunks wholly
// beyond d are not copied; their columns are multiplied from stale shared
// memory into accumulator columns that are never stored.
//
// What bounds it on an H100 at d = 512. The products, 4 d FLOPs per allowed
// pair; this design does 2 d for S in each of the ceil(d / 256) groups and
// 2 * 256 for P V: 6 d at d = 512 (1.5 times the bound's), 10 d at d = 1024.
// Q is read again from L2 for every kv tile (Q, K and the V group: 224 KB
// per 128 x 64 tile pair at d = 512 bf16, 56 FLOPs a byte), which puts L2
// bandwidth beside the products.
template <typename T, int SC>
struct Wide {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kF32 = kEs == 4;
  static constexpr int kChunkE = kRow / kEs;  // elements of a 128-byte chunk
  static constexpr int kBKV = kF32 ? 32 : 64;  // keys a kv tile
  static constexpr int kG = 256;               // O's columns a block
  static constexpr int kGC = kG / kChunkE;     // their chunks
  static constexpr int kSC = SC;               // chunks of d a slice: 2 where they pair up, else 1
  static constexpr int kParts = kF32 ? 2 : 1;  // fp32: hi and lo
  static constexpr int kVL = kGC * kBKV * kRow;              // the group's columns of V
  static constexpr int kVt = (kBKV + 31) / 32 * kG * kRow;   // fp32: V^T, one part
  static constexpr int kVU = kVL + (kF32 ? 2 * kVt : 0);     // a V unit
  // a slice unit: Q's kSC chunks of q_rows rows, K's of kBKV; fp32: their lo
  __host__ __device__ static constexpr int qk_bytes(int q_rows) {
    return kParts * kSC * (q_rows + kBKV) * kRow;
  }
  __host__ __device__ static constexpr int stage(int q_rows) {
    return qk_bytes(q_rows) > kVU ? qk_bytes(q_rows) : kVU;
  }
  // 1024 bytes of slack to align the base for the swizzle, and the barriers
  __host__ __device__ static constexpr int smem(int q_rows, int stages) {
    return 1024 + stages * stage(q_rows) + 256;
  }
  // registers of a multiplying thread: O's group, S, P as the A operand
  static constexpr int kRegs = kG / 2 + kBKV / 2 + (kF32 ? kBKV : kBKV / 4);
  static_assert(kRegs <= kRegBudget, "the wide tile does not fit the register budget");
};

template <typename T, int kSC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Params p) {
  using W = Wide<T, kSC>;
  constexpr int kBKV = W::kBKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_ch = (p.d * W::kEs + kRow - 1) / kRow;  // chunks of d
  const int stage_b = W::stage(p.q_rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_b);
  uint64_t* ready = full + kMaxStages;  // fp32: the unit split (V transposed)
  uint64_t* empty = ready + kMaxStages;
  const int nwg = p.q_rows / 64;
  const int ns = n_ch / kSC;                           // slices of a kv tile
  const int per = ns + 1;                              // its units: slices, then V
  const int n_grp = (p.d + W::kG - 1) / W::kG;
  // one block per (q tile, column group, batch*head), the heaviest causal
  // q tiles first
  const int idx = (int)(blockIdx.x / p.bh), grp = idx % n_grp;
  const int qt = p.n_qtiles - 1 - idx / n_grp;
  const int bh = blockIdx.x % p.bh, q0 = qt * p.q_rows, offset = p.sk - p.sq;
  int n_kv = (p.sk + kBKV - 1) / kBKV;
  if (p.causal) {
    const int hi = min(q0 + p.q_rows, p.sq) - 1 + offset;
    n_kv = hi < 0 ? 0 : min(n_kv, hi / kBKV + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
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
      for (int u = 0; u < n_kv * per; ++u) {
        const int t = u / per, c = u % per, s = u % p.stages;
        wait_or_trap(empty + s, ((u / p.stages) & 1) ^ 1);
        fence_proxy_async();  // fp32: the split's stores to this stage before the copy
        uint8_t* st = ring + s * stage_b;
        if (c < ns) {  // slice c: Q's and K's chunks c0 ..
          const int c0 = c * kSC;
          mbar_expect_tx(full + s, kSC * (p.q_rows + kBKV) * kRow);
          for (int j = 0; j < kSC; ++j) {
            tma_load_3d(smem_u32(st + j * p.q_rows * kRow), &qmap, full + s,
                        (c0 + j) * W::kChunkE, q0, bh);
            tma_load_3d(smem_u32(st + kSC * p.q_rows * kRow + j * kBKV * kRow), &kmap, full + s,
                        (c0 + j) * W::kChunkE, t * kBKV, bh);
          }
        } else {  // the group's chunks of V that hold columns below d
          const int g0 = grp * W::kGC, nch = min(W::kGC, n_ch - g0);
          mbar_expect_tx(full + s, nch * kBKV * kRow);
          for (int j = 0; j < nch; ++j)
            tma_load_3d(smem_u32(st + j * kBKV * kRow), &vmap, full + s, (g0 + j) * W::kChunkE,
                        t * kBKV, bh);
        }
      }
      return;
    }
    if constexpr (W::kF32) {  // warps 1-3: the tf32 splits
      if (tid >= 32) {
        const int half = W::qk_bytes(p.q_rows) / 2;
        for (int u = 0; u < n_kv * per; ++u) {
          const int s = u % p.stages;
          wait_or_trap(full + s, (u / p.stages) & 1);
          uint8_t* st = ring + s * stage_b;
          if (u % per < ns)
            split_cells(st, st + half, half / 16, tid - 32, 96);
          else
            transpose_split<W::kG>(st, nullptr, st + W::kVL, st + W::kVL + W::kVt, kBKV, tid - 32,
                                   96);
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
  uint64_t* rdy = W::kF32 ? ready : full;
  const int qo = wg * 64 * kRow, ko = kSC * p.q_rows * kRow, lo = W::qk_bytes(p.q_rows) / 2;

  float o[W::kG / 2];
#pragma unroll
  for (int i = 0; i < W::kG / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sc[kBKV / 2];  // S of the tile, then its P in fp32
  uint32_t pa[W::kF32 ? kBKV / 8 : kBKV / 16][4], plo[W::kF32 ? kBKV / 8 : 1][4];
  int n_live = wg_first <= wg_last ? n_kv : 0;
  if (p.causal && n_live) {
    const int hi = wg_last + offset;
    n_live = hi < 0 ? 0 : min(n_kv, hi / kBKV + 1);
  }
  auto unit_at = [&](int u) { return smem_u32(ring + (u % p.stages) * stage_b); };
  auto wait_unit = [&](int u) { mbar_wait(rdy + u % p.stages, (u / p.stages) & 1); };
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + u % p.stages);
  };

  // S += Q K^T over a slice's chunks, the unit at st
  auto issue_slice = [&](uint32_t st) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSC; ++j) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 32 bytes a step
        const uint32_t qa = st + j * p.q_rows * kRow + qo + 32 * ks;
        const uint32_t kb = st + ko + j * kBKV * kRow + 32 * ks;
        if constexpr (W::kF32) {
          Wgmma<kBKV>::ss_tf32(sc, desc_sw128(qa + lo), desc_sw128(kb));
          Wgmma<kBKV>::ss_tf32(sc, desc_sw128(qa), desc_sw128(kb + lo));
          Wgmma<kBKV>::ss_tf32(sc, desc_sw128(qa), desc_sw128(kb));
        } else {
          Wgmma<kBKV>::ss_bf16(sc, desc_sw128(qa), desc_sw128(kb));
        }
      }
    }
    wgmma_commit();
  };
  // O += P V over the group's columns, P in pa (and plo), the V unit at st
  auto issue_pv = [&](uint32_t st) {
    wgmma_fence();
    if constexpr (W::kF32) {
      const uint32_t vt_hi = st + W::kVL, vt_lo = vt_hi + W::kVt;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int n = 0; n < W::kG / 128; ++n) {
          const int off = (j >> 2) * W::kG * kRow + 32 * (j & 3) + n * 128 * kRow;
          const uint64_t bhi = desc_sw128(vt_hi + off), blo = desc_sw128(vt_lo + off);
          Wgmma<128>::rs_tf32(o + 64 * n, plo[j], bhi);
          Wgmma<128>::rs_tf32(o + 64 * n, pa[j], blo);
          Wgmma<128>::rs_tf32(o + 64 * n, pa[j], bhi);
        }
    } else {
#pragma unroll
      for (int k = 0; k < kBKV / 16; ++k)
#pragma unroll
        for (int c = 0; c < W::kGC; ++c)  // 64 columns of the group a product
          Wgmma<64>::rs_bf16<1>(o + 32 * c, pa[k], desc_sw128(st + c * kBKV * kRow + k * 16 * kRow));
    }
    wgmma_commit();
  };

  // each live tile: its slices, each slice's products issued and the unit
  // before it released once those completed; the softmax; P V, left to run
  // beside the next tile's first slice. The tiles above this warpgroup's
  // band are released unread.
  int pv_unit = -1;  // the V unit whose P V may still run
  for (int t = 0; t < n_live; ++t) {
    int pend = pv_unit;  // the unit whose products may still run
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    for (int c = 0; c < ns; ++c) {
      const int u = t * per + c;
      wait_unit(u);
      issue_slice(unit_at(u));
      wgmma_wait1();
      if (pend >= 0) release(pend);
      pend = u;
    }
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(o);
    hold_regs(pa);
    if constexpr (W::kF32) hold_regs(plo);
    release(pend);
    float corr[2];
    online_softmax<kBKV>(sc, m, l, corr, p.scale_log2, t * kBKV, p.sk, p.causal, wg_first, row0,
                         offset, t4);
#pragma unroll
    for (int i = 0; i < W::kG / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    if constexpr (W::kF32)
      frag_to_tf32<kBKV>(sc, pa, plo);
    else
      frag_to_bf16<kBKV>(sc, pa);
    const int uv = t * per + ns;
    wait_unit(uv);
    issue_pv(unit_at(uv));
    pv_unit = uv;
  }
  wgmma_wait0();
  fence_regs(o);
  hold_regs(pa);
  if constexpr (W::kF32) hold_regs(plo);
  if (pv_unit >= 0) release(pv_unit);
  for (int u = n_live * per; u < n_kv * per; ++u) {
    wait_unit(u);
    release(u);
  }

  // O = acc / max(l, 1e-30) for the group's columns below d; the logsumexp
  T* out = static_cast<T*>(p.o) + grp * W::kG;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    const float l_fin = fmaxf(sum, 1e-30f);
    T* orow = out + ((size_t)bh * p.sq + row) * p.d;
#pragma unroll
    for (int j = 0; j < W::kG / 8; ++j)
      if (grp * W::kG + 8 * j + 2 * t4 < p.d)  // d is even: a pair is stored whole or not at all
        store2(orow + 8 * j + 2 * t4, o[4 * j + 2 * h] / l_fin, o[4 * j + 2 * h + 1] / l_fin);
    if (t4 == 0 && grp == 0)
      p.lse[(size_t)bh * p.sq + row] = m[h] == kNeg ? kNeg : m[h] * kLn2 + logf(l_fin);
  }
}

// the (bh, s, d) tensor maps of q, k and v: boxes of one 128-byte chunk of d
// by q_rows (q) or kv_tile (k, v) rows, zero beyond d and s
template <typename T>
bool fwd_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int bh, int sq,
              int sk, int d, int q_rows, int kv_tile) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t rows = i == 0 ? sq : sk;
    const cuuint64_t dims[3] = {(cuuint64_t)d, rows, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T), rows * d * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)(kRow / sizeof(T)), (cuuint32_t)(i == 0 ? q_rows : kv_tile),
                               1};
    if (!encode(&maps[i], sizeof(T) == 2, 3, ptrs[i], dims, strides, box)) return false;
  }
  return true;
}

template <typename T, int kSC>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                        int sq, int sk, int d, int causal, float scale, int q_rows, int kv_tile,
                        int stages, int smem, int groups, cudaStream_t stream) {
  using W = Wide<T, kSC>;
  // two stages at least: a slice's products are issued before the unit
  // before it is released
  if (kv_tile != W::kBKV || groups != (d + W::kG - 1) / W::kG || (q_rows != 64 && q_rows != 128) ||
      stages < 2 || stages > kMaxStages || smem != W::smem(q_rows, stages) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_wide_kernel<T, kSC>;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  CUtensorMap maps[3] = {};
  if (!fwd_maps<T>(maps, q, k, v, bh, sq, sk, d, q_rows, kv_tile)) return cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = sq, p.sk = sk, p.d = d, p.causal = causal, p.q_rows = q_rows, p.stages = stages;
  p.n_qtiles = (sq + q_rows - 1) / q_rows;
  p.bh = bh;
  p.scale_log2 = scale * kLog2e;
  const long long blocks = (long long)p.n_qtiles * groups * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 + 2 * q_rows, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// the wide mode in slices of two chunks where d's chunks pair up, else one
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                        int sq, int sk, int d, int causal, float scale, int q_rows, int kv_tile,
                        int stages, int smem, int groups, cudaStream_t stream) {
  const int n_ch = (d * (int)sizeof(T) + kRow - 1) / kRow;
  return n_ch % 2 ? launch_wide<T, 1>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile,
                                      stages, smem, groups, stream)
                  : launch_wide<T, 2>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile,
                                      stages, smem, groups, stream);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
                   int sk, int d, int causal, float scale, int q_rows, int kv_tile, int stages,
                   int smem, int groups, cudaStream_t stream) {
  using L = Tile<T, D>;
  // two stages at least where there are two kv tiles: a pass holds the
  // previous tile's stage while it waits for the next; a serial plan has
  // one stage and one warpgroup
  if (kv_tile != L::kBKV || groups != L::kGroups || (q_rows != 64 && q_rows != 128) ||
      stages < 1 || (!L::kSerial && stages < 2 && sk > kv_tile) ||
      (L::kSerial && (stages != 1 || q_rows != 64)) || stages > kMaxStages ||
      smem != L::smem(q_rows, stages) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_kernel<T, D>;
  static bool raised = false;  // once per instantiation, never inside a graph capture
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  CUtensorMap maps[3] = {};
  if (!fwd_maps<T>(maps, q, k, v, bh, sq, sk, d, q_rows, kv_tile)) return cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = sq, p.sk = sk, p.d = d, p.causal = causal, p.q_rows = q_rows, p.stages = stages;
  p.n_qtiles = (sq + q_rows - 1) / q_rows;
  p.bh = bh;
  p.scale_log2 = scale * kLog2e;
  const long long blocks = (long long)p.n_qtiles * L::kGroups * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 + 2 * q_rows, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int sq, int sk, int d, int causal, float scale, int q_rows, int kv_tile,
                     int stages, int smem, int groups, cudaStream_t s) {
  switch (head_class(d)) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
    default: return launch_wide<T>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile, stages, smem, groups, s);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (bh, s, d) of fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1), 16-byte aligned, d >= 1 with rows of whole 16-byte units (the TMA
// copy's rule; above 256 the wide mode); lse: contiguous (bh, sq) fp32. The
// plan (_kernels.flash_plan): q_rows (64 or 128) a block, kv_tile keys a
// kv tile, stages of the ring, smem the block's dynamic shared memory in
// bytes, groups of O's columns; a plan this build would lay out otherwise
// is refused. Returns the launch's cudaError_t (0 = queued).
int dcnn_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
                   int sk, int d, int causal, float scale, int is_bf16, int q_rows, int kv_tile,
                   int stages, int smem, int groups, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d * (is_bf16 ? 2 : 4) % 16 || align % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows,
                                        kv_tile, stages, smem, groups, s)
              : dispatch<float>(q, k, v, o, lse, bh, sq, sk, d, causal, scale, q_rows, kv_tile,
                                stages, smem, groups, s);
  return static_cast<int>(err);
}

#ifdef FLASH_TRACE
// the diagnostic build's clock counts (2 x 8), zeroed after
int dcnn_flash_fwd_trace(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess) {
    static unsigned long long zeros[2][8];
    err = cudaMemcpyToSymbol(g_trace, zeros, sizeof(g_trace));
  }
  return static_cast<int>(err);
}
#endif

const char* dcnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
