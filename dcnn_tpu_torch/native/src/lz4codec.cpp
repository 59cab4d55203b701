// LZ4 block-format codec (compress + decompress), implemented from the
// public LZ4 block specification. Fills the reference's Lz4hcCompressor slot
// (include/pipeline/compression_impl/internal_compressor.hpp:5-15) in the
// meta-compressor dispatch: same wire role (a fast byte codec behind a codec
// id), host-native implementation.
//
// The compressor is the classic greedy single-probe hash-table matcher
// (64 Ki entries). It emits streams any spec-conforming LZ4 block
// decompressor accepts: token = [lit-len nibble | match-len nibble], 15 in a
// nibble extends with 255-run bytes, match offset is 2 bytes little-endian,
// minimum match 4, final sequence is literals-only, and matches never start
// within the last 12 bytes (the spec's end-of-block rule for encoders).
// The decompressor accepts any conforming stream (it does not require the
// encoder-side end rules) and hard-checks every bound, returning -1 on
// malformed input rather than reading/writing out of range.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinMatch = 4;
constexpr std::int64_t kEndLiterals = 5;   // last 5 bytes must be literals
constexpr std::int64_t kMatchGuard = 12;   // no match may start in last 12
constexpr int kHashLog = 16;
constexpr std::int64_t kMaxOffset = 65535;

inline std::uint32_t read32(const std::uint8_t *p) {
  std::uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline std::uint32_t hash32(std::uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (token + 255-run literal
// length bytes + the literals themselves + terminator slack).
std::int64_t dcnn_lz4_compress_bound(std::int64_t n) {
  return n + n / 255 + 16;
}

// Compress src[0..n) into dst (capacity cap). Returns the compressed size,
// or -1 if dst is too small. n == 0 emits the canonical 1-byte empty block.
std::int64_t dcnn_lz4_compress(const std::uint8_t *src, std::int64_t n,
                               std::uint8_t *dst, std::int64_t cap) {
  std::vector<std::int64_t> table(std::size_t(1) << kHashLog, -1);
  std::int64_t ip = 0, anchor = 0, op = 0;
  const std::int64_t match_limit = n - kMatchGuard;  // may be negative
  const std::int64_t extend_limit = n - kEndLiterals;

  auto emit_run = [&](std::uint8_t *token, int shift, std::int64_t len) {
    // Encode len into the token nibble at `shift`, extending with 255-runs.
    if (len < 15) {
      *token |= std::uint8_t(len << shift);
    } else {
      *token |= std::uint8_t(15 << shift);
      len -= 15;
      while (len >= 255) { dst[op++] = 255; len -= 255; }
      dst[op++] = std::uint8_t(len);
    }
  };

  while (ip < match_limit) {
    const std::uint32_t h = hash32(read32(src + ip));
    const std::int64_t ref = table[h];
    table[h] = ip;
    if (ref < 0 || ip - ref > kMaxOffset || read32(src + ref) != read32(src + ip)) {
      ++ip;
      continue;
    }
    // Extend the match; stop so the last kEndLiterals bytes stay literal.
    std::int64_t mlen = kMinMatch;
    while (ip + mlen < extend_limit && src[ref + mlen] == src[ip + mlen]) ++mlen;
    const std::int64_t litlen = ip - anchor;
    if (op + 1 + litlen + litlen / 255 + 1 + 2 + mlen / 255 + 1 > cap) return -1;
    std::uint8_t *token = dst + op;
    *token = 0;
    ++op;
    emit_run(token, 4, litlen);
    std::memcpy(dst + op, src + anchor, std::size_t(litlen));
    op += litlen;
    const std::uint16_t off = std::uint16_t(ip - ref);
    dst[op++] = std::uint8_t(off & 0xff);
    dst[op++] = std::uint8_t(off >> 8);
    emit_run(token, 0, mlen - kMinMatch);
    // Seed the table inside the match so runs keep matching.
    if (ip + 2 < match_limit) table[hash32(read32(src + ip + 2))] = ip + 2;
    ip += mlen;
    anchor = ip;
  }

  // Final literals-only sequence.
  const std::int64_t litlen = n - anchor;
  if (op + 1 + litlen + litlen / 255 + 1 > cap) return -1;
  std::uint8_t *token = dst + op;
  *token = 0;
  ++op;
  emit_run(token, 4, litlen);
  std::memcpy(dst + op, src + anchor, std::size_t(litlen));
  op += litlen;
  return op;
}

// HC (high-compression) variant: hash-chain match search + one-byte lazy
// evaluation, the same algorithmic family as the reference's Lz4hc slot
// (include/pipeline/compression_impl/internal_compressor.hpp:10-15). Emits
// the identical block format — dcnn_lz4_decompress reads both — so the codec
// id on the wire is unchanged; only the encoder-side search is deeper.
// `level` scales the chain-walk budget: attempts = 1 << clamp(level, 1, 13).
std::int64_t dcnn_lz4_compress_hc(const std::uint8_t *src, std::int64_t n,
                                  std::uint8_t *dst, std::int64_t cap,
                                  std::int32_t level) {
  if (level < 1) level = 1;
  if (level > 13) level = 13;
  const int max_attempts = 1 << level;

  // head[h]: most recent position with hash h. chain[p & 0xffff]: previous
  // position sharing p's hash. An entry for position p is only overwritten
  // by position p + 65536, which is outside every window that could still
  // reach p — so entries are always valid while reachable, and chains are
  // strictly decreasing (no cycles).
  std::vector<std::int64_t> head(std::size_t(1) << kHashLog, -1);
  std::vector<std::int64_t> chain(65536, -1);
  std::int64_t ip = 0, anchor = 0, op = 0, next_insert = 0;
  const std::int64_t match_limit = n - kMatchGuard;  // may be negative
  const std::int64_t extend_limit = n - kEndLiterals;

  auto insert_upto = [&](std::int64_t limit) {
    if (limit > match_limit) limit = match_limit;
    for (; next_insert < limit; ++next_insert) {
      const std::uint32_t h = hash32(read32(src + next_insert));
      chain[next_insert & 0xffff] = head[h];
      head[h] = next_insert;
    }
  };

  // Longest match for src[pos..] over the chain (nearest-first, so ties keep
  // the smallest offset). Returns 0 if nothing reaches kMinMatch.
  auto best_match = [&](std::int64_t pos, std::int64_t *best_ref) {
    std::int64_t best_len = 0;
    std::int64_t ref = head[hash32(read32(src + pos))];
    int tries = max_attempts;
    while (ref >= 0 && pos - ref <= kMaxOffset && tries-- > 0) {
      // quick reject: a candidate can only improve on best_len if it also
      // matches at the byte best_len — O(1) filter before the O(len) extend
      // (without it, low-entropy runs degrade to O(attempts × run_length))
      if (ref < pos && src[ref + best_len] == src[pos + best_len] &&
          read32(src + ref) == read32(src + pos)) {
        std::int64_t len = kMinMatch;
        while (pos + len < extend_limit && src[ref + len] == src[pos + len])
          ++len;
        if (len > best_len) {
          best_len = len;
          *best_ref = ref;
          if (pos + len >= extend_limit) break;  // cannot be beaten
        }
      }
      ref = chain[ref & 0xffff];
    }
    return best_len;
  };

  auto emit_run = [&](std::uint8_t *token, int shift, std::int64_t len) {
    if (len < 15) {
      *token |= std::uint8_t(len << shift);
    } else {
      *token |= std::uint8_t(15 << shift);
      len -= 15;
      while (len >= 255) { dst[op++] = 255; len -= 255; }
      dst[op++] = std::uint8_t(len);
    }
  };

  while (ip < match_limit) {
    insert_upto(ip + 1);
    std::int64_t ref = -1;
    std::int64_t mlen = best_match(ip, &ref);
    if (mlen == 0) {
      ++ip;
      continue;
    }
    // One-byte lazy evaluation: if starting one byte later yields a strictly
    // longer match, ship this byte as a literal and move on.
    while (ip + 1 < match_limit) {
      insert_upto(ip + 2);
      std::int64_t ref2 = -1;
      const std::int64_t mlen2 = best_match(ip + 1, &ref2);
      if (mlen2 > mlen) {
        ++ip;
        mlen = mlen2;
        ref = ref2;
      } else {
        break;
      }
    }
    const std::int64_t litlen = ip - anchor;
    if (op + 1 + litlen + litlen / 255 + 1 + 2 + mlen / 255 + 1 > cap)
      return -1;
    std::uint8_t *token = dst + op;
    *token = 0;
    ++op;
    emit_run(token, 4, litlen);
    std::memcpy(dst + op, src + anchor, std::size_t(litlen));
    op += litlen;
    const std::uint16_t off = std::uint16_t(ip - ref);
    dst[op++] = std::uint8_t(off & 0xff);
    dst[op++] = std::uint8_t(off >> 8);
    emit_run(token, 0, mlen - kMinMatch);
    insert_upto(ip + mlen);  // full interior insertion (the HC ratio lever)
    ip += mlen;
    anchor = ip;
  }

  const std::int64_t litlen = n - anchor;
  if (op + 1 + litlen + litlen / 255 + 1 > cap) return -1;
  std::uint8_t *token = dst + op;
  *token = 0;
  ++op;
  emit_run(token, 4, litlen);
  std::memcpy(dst + op, src + anchor, std::size_t(litlen));
  op += litlen;
  return op;
}

// Decompress src[0..n) into dst (capacity cap = exact raw size known from
// the frame header). Returns bytes written, or -1 on malformed input.
std::int64_t dcnn_lz4_decompress(const std::uint8_t *src, std::int64_t n,
                                 std::uint8_t *dst, std::int64_t cap) {
  std::int64_t ip = 0, op = 0;
  while (ip < n) {
    const std::uint8_t token = src[ip++];
    std::int64_t litlen = token >> 4;
    if (litlen == 15) {
      std::uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        litlen += b;
      } while (b == 255);
    }
    if (litlen > n - ip || litlen > cap - op) return -1;
    std::memcpy(dst + op, src + ip, std::size_t(litlen));
    ip += litlen;
    op += litlen;
    if (ip >= n) break;  // literals-only terminator
    if (n - ip < 2) return -1;
    const std::int64_t offset = src[ip] | (std::int64_t(src[ip + 1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    std::int64_t mlen = token & 15;
    if (mlen == 15) {
      std::uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += kMinMatch;
    if (mlen > cap - op) return -1;
    // Byte-wise copy: offsets < mlen legitimately overlap (RLE encoding).
    for (std::int64_t i = 0; i < mlen; ++i, ++op) dst[op] = dst[op - offset];
  }
  return op;
}

}  // extern "C"
