// Raw Snappy block decompression for the device Parquet scan, on the host.
//
// Parquet SNAPPY pages hold one raw Snappy block each (no framing): a
// little-endian varint of the uncompressed length, then tagged elements,
// whose low two tag bits select a literal or a copy with a 1-, 2- or 4-byte
// offset (the public format_description.txt).  The walk runs here in C,
// before the page's bytes reach the slab; parquet/snappy.py is its Python
// twin, which the tests hold it against.  Adapted from the JAX package's
// srjt_snappy_decompress (spark_rapids_jni_tpu/native/snappy_native.cpp:
// 19-93); this copy belongs to the port and is built with the host compiler
// at first use.
//
// Hardened for untrusted input: every read and write is bounds-checked, and
// a copy whose offset is shorter than its length (an RLE-style run, which
// the format allows) advances one byte at a time.

#include <cstdint>
#include <cstring>

extern "C" {

// Decompress src[0:src_len] into dst[0:dst_len].  Returns dst_len, or a
// negative code: -1 truncated or garbled input (or output past dst_len),
// -2 dst_len differs from the block's own length varint, -3 a copy offset
// of 0 or before the start of the output.
int64_t srjt_snappy_decompress(const unsigned char* src, int64_t src_len,
                               unsigned char* dst, int64_t dst_len) {
  int64_t ip = 0;
  uint64_t expect = 0;
  int shift = 0;
  while (true) {
    if (ip >= src_len || shift > 35) return -1;
    unsigned char b = src[ip++];
    expect |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (dst_len < 0 || static_cast<uint64_t>(dst_len) != expect) return -2;

  int64_t op = 0;
  while (ip < src_len) {
    unsigned char tag = src[ip++];
    unsigned kind = tag & 3u;
    if (kind == 0) {                       // literal
      int64_t len = (tag >> 2) + 1;
      if (len > 60) {
        int extra = static_cast<int>(len - 60);   // 1..4 length bytes
        if (ip + extra > src_len) return -1;
        uint32_t l = 0;
        for (int k = 0; k < extra; ++k) l |= uint32_t(src[ip + k]) << (8 * k);
        ip += extra;
        len = int64_t(l) + 1;
      }
      if (ip + len > src_len || op + len > dst_len) return -1;
      std::memcpy(dst + op, src + ip, size_t(len));
      ip += len;
      op += len;
      continue;
    }
    int64_t len, off;
    if (kind == 1) {                       // copy, 1-byte offset
      if (ip >= src_len) return -1;
      len = ((tag >> 2) & 7) + 4;
      off = (int64_t(tag >> 5) << 8) | src[ip++];
    } else if (kind == 2) {                // copy, 2-byte offset
      if (ip + 2 > src_len) return -1;
      len = (tag >> 2) + 1;
      off = int64_t(src[ip]) | (int64_t(src[ip + 1]) << 8);
      ip += 2;
    } else {                               // copy, 4-byte offset
      if (ip + 4 > src_len) return -1;
      len = (tag >> 2) + 1;
      off = int64_t(src[ip]) | (int64_t(src[ip + 1]) << 8)
          | (int64_t(src[ip + 2]) << 16) | (int64_t(src[ip + 3]) << 24);
      ip += 4;
    }
    if (off <= 0 || off > op) return -3;
    if (op + len > dst_len) return -1;
    if (off >= len) {
      std::memcpy(dst + op, dst + op - off, size_t(len));
      op += len;
    } else {
      for (int64_t k = 0; k < len; ++k, ++op) dst[op] = dst[op - off];
    }
  }
  return (op == dst_len) ? op : -1;
}

}  // extern "C"
