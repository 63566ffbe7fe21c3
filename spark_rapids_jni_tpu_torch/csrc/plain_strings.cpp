// BYTE_ARRAY page walks for the device Parquet scan, on the host.
//
// A PLAIN string page is a run of (4-byte little-endian length, bytes)
// records.  Each record's position depends on every length before it, an
// inherently sequential recurrence, so the walk runs here in C and the
// device then strips the length prefixes in one segmented copy (kernel B4).
// Adapted from the JAX package's srjt_byte_array_offsets
// (spark_rapids_jni_tpu/native/snappy_native.cpp:95-119); this copy belongs
// to the port and is built with the host compiler at first use.

#include <cstdint>
#include <cstring>

extern "C" {

// Walk n records of payload[0:size].  Writes n+1 int32 char offsets (length
// prefixes excluded) to out_offs and returns the char total; returns -1 if
// the page ends inside a record and -2 if the char total passes 2^31 - 1.
int64_t srjt_byte_array_offsets(const unsigned char* payload, int64_t size,
                                int64_t n, int32_t* out_offs) {
  // the memcpy below reads the little-endian length prefix as a host u32
#if defined(__BYTE_ORDER__) && defined(__ORDER_LITTLE_ENDIAN__)
  static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
                "srjt_byte_array_offsets assumes a little-endian host");
#endif
  int64_t pos = 0;
  int64_t total = 0;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (pos + 4 > size) return -1;
    uint32_t len;
    std::memcpy(&len, payload + pos, 4);
    pos += 4;
    if (static_cast<int64_t>(len) > size - pos) return -1;
    pos += len;
    total += len;
    if (total > INT32_MAX) return -2;
    out_offs[i + 1] = static_cast<int32_t>(total);
  }
  return total;
}

// DELTA_BYTE_ARRAY values, rebuilt: value i is the first prefix[i] bytes of
// value i-1, then the next suffix_len[i] bytes of the suffix stream, a
// sequential recurrence like the walk above.  Writes the n values back to
// back into out[0:out_len] and returns the bytes written; returns -1 if a
// prefix is longer than the value before it (the first value's must be 0),
// -2 if the suffixes run past suffix_size, -3 if the values pass out_len and
// -4 on a negative length.
int64_t srjt_delta_byte_array(const int64_t* prefix, const int64_t* suffix_len,
                              int64_t n, const unsigned char* suffix,
                              int64_t suffix_size, unsigned char* out,
                              int64_t out_len) {
  int64_t prev = 0, prev_len = 0, cursor = 0, spos = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = prefix[i], s = suffix_len[i];
    if (p < 0 || s < 0) return -4;
    if (p > prev_len) return -1;
    if (s > suffix_size - spos) return -2;
    if (p + s > out_len - cursor) return -3;
    // the prefix lies before cursor, so the ranges never overlap
    std::memcpy(out + cursor, out + prev, size_t(p));
    std::memcpy(out + cursor + p, suffix + spos, size_t(s));
    prev = cursor;
    prev_len = p + s;
    cursor += p + s;
    spos += s;
  }
  return cursor;
}

}  // extern "C"
