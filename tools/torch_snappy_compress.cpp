// A small greedy raw-Snappy compressor, for the test files that
// tools/torch_lineitem_parquet.py writes (the card's machine has no
// compression library for Python).  Raw Snappy is what a Parquet SNAPPY
// page holds: a little-endian varint of the uncompressed length, then
// literals and copies (the public format_description.txt).
//
// Greedy: a hash of the next 4 bytes finds the last position that began
// with the same hash; a match of at least 4 bytes becomes copy elements of
// at most 64 bytes (a 1-byte offset for 4-11 bytes within 2 KiB, else a
// 2-byte offset within 64 KiB, else a 4-byte one for 8 bytes or more),
// and the bytes between matches become literals.  A run of one byte matches one byte back, an
// overlapping copy.  The output is valid Snappy, not the smallest.
// Built with the host compiler at first use.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kHashBits = 16;

inline uint32_t load32(const unsigned char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

unsigned char* put_varint(unsigned char* op, uint64_t v) {
  while (v >= 0x80) {
    *op++ = static_cast<unsigned char>(v | 0x80);
    v >>= 7;
  }
  *op++ = static_cast<unsigned char>(v);
  return op;
}

unsigned char* put_literal(unsigned char* op, const unsigned char* src,
                           int64_t len) {
  while (len > 0) {
    int64_t n = len < (int64_t(1) << 32) ? len : (int64_t(1) << 32);
    uint64_t m = static_cast<uint64_t>(n - 1);
    if (m < 60) {
      *op++ = static_cast<unsigned char>(m << 2);
    } else {
      int bytes = m < (1u << 8) ? 1 : m < (1u << 16) ? 2 : m < (1u << 24) ? 3 : 4;
      *op++ = static_cast<unsigned char>((59 + bytes) << 2);
      for (int k = 0; k < bytes; ++k) *op++ = static_cast<unsigned char>(m >> (8 * k));
    }
    std::memcpy(op, src, size_t(n));
    op += n;
    src += n;
    len -= n;
  }
  return op;
}

unsigned char* put_copy(unsigned char* op, int64_t off, int64_t len) {
  while (len > 0) {
    // leave at least 4 bytes for the last element of a long match
    int64_t n = len > 64 ? (len - 64 < 4 ? len - 4 : 64) : len;
    if (n >= 4 && n <= 11 && off < 2048) {
      *op++ = static_cast<unsigned char>(1 | ((n - 4) << 2) | ((off >> 8) << 5));
      *op++ = static_cast<unsigned char>(off & 0xFF);
    } else if (off < 65536) {
      *op++ = static_cast<unsigned char>(2 | ((n - 1) << 2));
      *op++ = static_cast<unsigned char>(off & 0xFF);
      *op++ = static_cast<unsigned char>(off >> 8);
    } else {
      *op++ = static_cast<unsigned char>(3 | ((n - 1) << 2));
      for (int k = 0; k < 4; ++k) *op++ = static_cast<unsigned char>(off >> (8 * k));
    }
    len -= n;
  }
  return op;
}

}  // namespace

extern "C" {

// The most bytes srjt_snappy_compress writes for n input bytes.
int64_t srjt_snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

// Compress src[0:n] into dst (at least srjt_snappy_max_compressed(n)
// bytes) and return the compressed size.  table holds 2^16 int64 slots.
int64_t srjt_snappy_compress(const unsigned char* src, int64_t n,
                             unsigned char* dst, int64_t* table) {
  for (int64_t i = 0; i < (int64_t(1) << kHashBits); ++i) table[i] = -1;
  unsigned char* op = put_varint(dst, static_cast<uint64_t>(n));
  int64_t lit = 0, ip = 0;
  while (ip + 4 <= n) {
    uint32_t h = hash4(load32(src + ip));
    int64_t cand = table[h];
    table[h] = ip;
    int64_t off = ip - cand;
    if (cand < 0 || off > 0xFFFFFFFFll || load32(src + cand) != load32(src + ip)) {
      ++ip;
      continue;
    }
    int64_t len = 4;
    while (ip + len < n && src[cand + len] == src[ip + len]) ++len;
    if (off >= 65536 && len < 8) {       // a 5-byte copy would not pay
      ++ip;
      continue;
    }
    op = put_literal(op, src + lit, ip - lit);
    op = put_copy(op, off, len);
    ip += len;
    lit = ip;
  }
  op = put_literal(op, src + lit, n - lit);
  return op - dst;
}

}  // extern "C"
