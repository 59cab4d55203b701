// Byte-shuffle filter (the transform at the heart of Blosc): for elements of
// size T, gather byte-plane i of every element contiguously —
// dst[i*n + j] = src[j*T + i]. Numeric arrays (exponent/sign bytes highly
// correlated across elements) compress far better after this transform;
// paired with zstd it fills the reference's BloscCompressor slot
// (include/pipeline/compression_impl/internal_compressor.hpp:5-15) with a
// host-native implementation. The inverse restores element order.

#include <cstdint>
#include <cstring>

extern "C" {

// n_bytes must be a multiple of typesize; returns -1 otherwise.
int dcnn_byte_shuffle(const std::uint8_t *src, std::uint8_t *dst,
                      std::int64_t n_bytes, std::int32_t typesize) {
  if (typesize <= 0 || n_bytes % typesize) return -1;
  const std::int64_t n = n_bytes / typesize;
  for (std::int32_t i = 0; i < typesize; ++i) {
    const std::uint8_t *s = src + i;
    std::uint8_t *d = dst + std::int64_t(i) * n;
    for (std::int64_t j = 0; j < n; ++j) d[j] = s[j * typesize];
  }
  return 0;
}

int dcnn_byte_unshuffle(const std::uint8_t *src, std::uint8_t *dst,
                        std::int64_t n_bytes, std::int32_t typesize) {
  if (typesize <= 0 || n_bytes % typesize) return -1;
  const std::int64_t n = n_bytes / typesize;
  for (std::int32_t i = 0; i < typesize; ++i) {
    const std::uint8_t *s = src + std::int64_t(i) * n;
    std::uint8_t *d = dst + i;
    for (std::int64_t j = 0; j < n; ++j) d[j * typesize] = s[j];
  }
  return 0;
}

}  // extern "C"
