// Chunk-parallel row gather: dst[i] = src[idx[i]] for arbitrary row sizes.
//
// The host side of the streaming feed (data/streaming.py) permutes the
// dataset every epoch and gathers each shard's rows with numpy fancy
// indexing — a single-threaded memcpy loop that costs real wall time on the
// multi-MB uint8 shards the transfer engine ships (data/transfer.py). This
// kernel is the same gather, blocked over rows and spread across hardware
// threads, writing straight into the caller's (numpy) destination buffer.
// Dtype-agnostic: rows are opaque byte spans (row_bytes = itemsize *
// trailing-dim product), so one symbol serves uint8 images and int32 labels
// alike. Bit-identical to src[idx] by construction (pure memcpy).
//
// Exposed as a plain C ABI for ctypes, like dataio.cpp.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned gather_hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : n;
}

// Run fn(block_index) over [0, blocks) on up to hw threads (work-stealing
// counter, same shape as dataio.cpp's parallel_chunks — duplicated here
// because that helper lives in dataio.cpp's anonymous namespace).
template <typename F>
void gather_parallel(std::size_t blocks, F fn) {
  unsigned workers = std::min<std::size_t>(gather_hw_threads(), blocks);
  if (workers <= 1) {
    for (std::size_t i = 0; i < blocks; ++i) fn(i);
    return;
  }
  std::atomic<std::size_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (unsigned w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        std::size_t i = next.fetch_add(1);
        if (i >= blocks) return;
        fn(i);
      }
    });
  }
  for (auto &t : pool) t.join();
}

}  // namespace

extern "C" {

// Gather n_out rows of row_bytes each: dst[i*row_bytes ..] =
// src[idx[i]*row_bytes ..]. Returns 0 on success, -1 if any index falls
// outside [0, n_src) — checked before any byte is written, so a failed call
// leaves dst untouched.
int dcnn_gather_rows(const std::uint8_t *src, const std::int64_t *idx,
                     std::uint8_t *dst, std::int64_t n_out,
                     std::int64_t row_bytes, std::int64_t n_src) {
  if (n_out < 0 || row_bytes <= 0) return -1;
  std::atomic<bool> ok{true};
  // validate first (cheap scan) so partial output can never alias a failure
  gather_parallel(static_cast<std::size_t>((n_out + 65535) / 65536),
                  [&](std::size_t b) {
    const std::int64_t lo = static_cast<std::int64_t>(b) << 16;
    const std::int64_t hi = std::min(n_out, lo + 65536);
    for (std::int64_t i = lo; i < hi; ++i)
      if (idx[i] < 0 || idx[i] >= n_src) { ok.store(false); return; }
  });
  if (!ok.load()) return -1;
  // block rows so each task moves ~1 MiB — enough to amortize thread
  // handoff, small enough to load-balance ragged index distributions
  std::int64_t rows_per_block = (1 << 20) / row_bytes;
  if (rows_per_block < 1) rows_per_block = 1;
  const std::int64_t blocks = (n_out + rows_per_block - 1) / rows_per_block;
  gather_parallel(static_cast<std::size_t>(blocks), [&](std::size_t b) {
    const std::int64_t lo = static_cast<std::int64_t>(b) * rows_per_block;
    const std::int64_t hi = std::min(n_out, lo + rows_per_block);
    for (std::int64_t i = lo; i < hi; ++i)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  static_cast<std::size_t>(row_bytes));
  });
  return 0;
}

}  // extern "C"
