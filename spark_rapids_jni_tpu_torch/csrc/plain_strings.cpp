// PLAIN BYTE_ARRAY page walk for the device Parquet scan, on the host.
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

}  // extern "C"
