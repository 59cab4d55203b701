// Native data-loading kernels for the host side of the input pipeline
// (the port's copy of dcnn_tpu/native/src/dataio.cpp).
//
// Reference equivalent: the reference's data layer is C++ throughout
// (include/data_loading/*.hpp, src/data_loading/) — CSV parsing, binary
// decode, normalization all native. Feeding an accelerator moves the bottleneck
// entirely onto the host input pipeline (SURVEY.md §7 hard part 5), so the
// decode/normalize path is native here too: one pass over the bytes,
// chunk-parallel across std::thread workers, writing float32 directly into
// the caller's (numpy) buffer.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build (dcnn_tpu_torch/native/__init__.py, with the other sources):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread *.cpp -o libdcnn_native-<hash>.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : n;
}

// Run fn(chunk_index) over [0, chunks) on up to hw_threads() workers.
template <typename F>
void parallel_chunks(std::size_t chunks, F fn) {
  unsigned workers = std::min<std::size_t>(hw_threads(), chunks);
  if (workers <= 1) {
    for (std::size_t i = 0; i < chunks; ++i) fn(i);
    return;
  }
  std::atomic<std::size_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (unsigned w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        std::size_t i = next.fetch_add(1);
        if (i >= chunks) return;
        fn(i);
      }
    });
  }
  for (auto &t : pool) t.join();
}

}  // namespace

extern "C" {

// u8 → f32 with scale (the /255 normalize): dst[i] = src[i] * scale.
void dcnn_u8_to_f32(const std::uint8_t *src, float *dst, std::int64_t n,
                    float scale) {
  const std::int64_t chunk = 1 << 20;
  const std::int64_t chunks = (n + chunk - 1) / chunk;
  parallel_chunks(static_cast<std::size_t>(chunks), [&](std::size_t c) {
    const std::int64_t lo = static_cast<std::int64_t>(c) * chunk;
    const std::int64_t hi = std::min(n, lo + chunk);
    for (std::int64_t i = lo; i < hi; ++i)
      dst[i] = static_cast<float>(src[i]) * scale;
  });
}

// Decode CIFAR-style records: n records of
//   [skip_bytes label bytes][img_bytes pixels], label at index label_index.
// Writes normalized float images (img_bytes floats per record, scaled by
// 1/255) and int32 labels. Returns 0 on success.
int dcnn_decode_label_records(const std::uint8_t *raw, std::int64_t raw_len,
                              std::int64_t n, std::int32_t skip_bytes,
                              std::int32_t label_index, std::int64_t img_bytes,
                              float *out_images, std::int32_t *out_labels) {
  const std::int64_t rec = skip_bytes + img_bytes;
  if (raw_len < n * rec) return 1;
  parallel_chunks(static_cast<std::size_t>(n), [&](std::size_t i) {
    const std::uint8_t *r = raw + static_cast<std::int64_t>(i) * rec;
    out_labels[i] = static_cast<std::int32_t>(r[label_index]);
    float *dst = out_images + static_cast<std::int64_t>(i) * img_bytes;
    const std::uint8_t *px = r + skip_bytes;
    for (std::int64_t j = 0; j < img_bytes; ++j)
      dst[j] = static_cast<float>(px[j]) * (1.0f / 255.0f);
  });
  return 0;
}

// Parse a label,pix0,...,pixK CSV (MNIST format). `text` need not be
// NUL-terminated; newlines delimit rows; the first row is skipped when
// `skip_header` != 0. Rows are located serially (newline scan), parsed in
// parallel. Returns the number of rows parsed, or -1 on malformed input.
std::int64_t dcnn_parse_label_csv(const char *text, std::int64_t len,
                                  std::int32_t pixels_per_row,
                                  std::int32_t skip_header, float scale,
                                  std::int64_t max_rows, float *out_pixels,
                                  std::int32_t *out_labels) {
  // index row start offsets
  std::vector<std::int64_t> starts;
  starts.reserve(1 << 16);
  std::int64_t pos = 0;
  bool first = true;
  while (pos < len && static_cast<std::int64_t>(starts.size()) < max_rows) {
    std::int64_t eol = pos;
    while (eol < len && text[eol] != '\n') ++eol;
    if (eol > pos) {
      if (first && skip_header) {
        first = false;
      } else {
        first = false;
        starts.push_back(pos);
      }
    }
    pos = eol + 1;
  }
  const std::int64_t rows = static_cast<std::int64_t>(starts.size());
  std::atomic<bool> ok{true};
  parallel_chunks(static_cast<std::size_t>(rows), [&](std::size_t r) {
    const char *p = text + starts[r];
    const char *end = text + len;
    // label
    std::int32_t label = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      label = label * 10 + (*p - '0');
      ++p;
      any = true;
    }
    if (!any) { ok.store(false); return; }
    out_labels[r] = label;
    float *dst = out_pixels + static_cast<std::int64_t>(r) * pixels_per_row;
    for (std::int32_t j = 0; j < pixels_per_row; ++j) {
      if (p >= end || *p != ',') { ok.store(false); return; }
      ++p;  // comma
      std::int32_t v = 0;
      bool digit = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
        digit = true;
      }
      if (!digit) { ok.store(false); return; }
      dst[j] = static_cast<float>(v) * scale;
    }
    // The row must be fully consumed: extra columns mean the file does not
    // match the expected pixels_per_row layout — reject rather than silently
    // training on misaligned pixels.
    if (p < end && *p == '\r') ++p;
    if (p < end && *p != '\n') { ok.store(false); return; }
  });
  return ok.load() ? rows : -1;
}

}  // extern "C"
