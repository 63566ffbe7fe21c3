// Host JCUDF row<->column transcode engine (C ABI).
//
// Native-runtime counterpart of the device path in rowconv/convert.py: the
// reference implements this transpose as CUDA kernels orchestrated by host
// C++ (src/main/cpp/src/row_conversion.cu: compute_column_information
// :1331-1370, copy_to_rows :575-693, copy_from_rows :892-993,
// copy_validity_to_rows :710-810, copy_strings_to_rows :827-875); here the
// device engine is rowconv/convert.py on the GPU, and this C++ engine is an
// independent differential oracle for it (SURVEY §4 differential strategy;
// the reference pairs two engines, tests/row_conversion.cpp:49-58), bound
// by rowconv/native.py.
//
// Layout contract (must stay bit-identical to rowconv/layout.py and the
// JCUDF spec in RowConversion.java:40-99):
//   - each fixed-width column slot aligned to its own size; string columns
//     occupy an 8-byte (offset:u32, len:u32) slot aligned to 4
//   - validity bytes appended after the data slots, bit i of byte b = column
//     b*8+i (little-endian within the byte)
//   - string chars appended at the unaligned fixed+validity cursor, in
//     column order; row padded to 8 bytes (JCUDF_ROW_ALIGNMENT)

#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t kRowAlignment = 8;

inline int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

inline void pack_validity(const uint8_t* const* col_valid, int32_t ncols,
                          int64_t row, uint8_t* dst) {
  for (int32_t b = 0; b * 8 < ncols; ++b) {
    uint8_t byte = 0;
    for (int32_t i = 0; i < 8 && b * 8 + i < ncols; ++i) {
      const uint8_t* v = col_valid[b * 8 + i];
      if (v == nullptr || v[row]) byte |= static_cast<uint8_t>(1u << i);
    }
    dst[b] = byte;
  }
}

}  // namespace

extern "C" {

// Row layout from per-column (slot size, slot alignment).  Returns 0 on
// success, -1 on bad input.  Mirrors compute_row_layout (layout.py) /
// compute_column_information (row_conversion.cu:1331-1370).
int32_t srjt_layout(const int32_t* sizes, const int32_t* aligns, int32_t ncols,
                    int32_t* out_starts, int32_t* out_validity_offset,
                    int32_t* out_fixed_plus_validity, int32_t* out_row_size) {
  if (ncols < 0) return -1;
  int64_t offset = 0;
  for (int32_t i = 0; i < ncols; ++i) {
    if (sizes[i] <= 0 || aligns[i] <= 0) return -1;
    offset = round_up(offset, aligns[i]);
    out_starts[i] = static_cast<int32_t>(offset);
    offset += sizes[i];
  }
  int32_t validity_bytes = (ncols + 7) / 8;
  *out_validity_offset = static_cast<int32_t>(offset);
  *out_fixed_plus_validity = static_cast<int32_t>(offset) + validity_bytes;
  *out_row_size =
      static_cast<int32_t>(round_up(*out_fixed_plus_validity, kRowAlignment));
  return 0;
}

// Fixed-width pack: col_data[i] is n_rows*sizes[i] little-endian bytes;
// col_valid[i] is n_rows bool bytes or null (all valid).  out must hold
// n_rows*row_size bytes; padding bytes are zeroed.
void srjt_pack_fixed(const uint8_t* const* col_data,
                     const uint8_t* const* col_valid, const int32_t* starts,
                     const int32_t* sizes, int32_t ncols, int64_t n_rows,
                     int32_t row_size, int32_t validity_offset, uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(n_rows) * row_size);
  for (int64_t r = 0; r < n_rows; ++r) {
    uint8_t* row = out + r * row_size;
    for (int32_t c = 0; c < ncols; ++c) {
      std::memcpy(row + starts[c], col_data[c] + r * sizes[c],
                  static_cast<size_t>(sizes[c]));
    }
    pack_validity(col_valid, ncols, r, row + validity_offset);
  }
}

// Inverse of srjt_pack_fixed.  out_data[i] must hold n_rows*sizes[i] bytes;
// out_valid[i] must hold n_rows bool bytes (never null on output).
void srjt_unpack_fixed(const uint8_t* rows, int64_t n_rows, int32_t row_size,
                       const int32_t* starts, const int32_t* sizes,
                       int32_t ncols, int32_t validity_offset,
                       uint8_t* const* out_data, uint8_t* const* out_valid) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* row = rows + r * row_size;
    for (int32_t c = 0; c < ncols; ++c) {
      std::memcpy(out_data[c] + r * sizes[c], row + starts[c],
                  static_cast<size_t>(sizes[c]));
      out_valid[c][r] = (row[validity_offset + c / 8] >> (c % 8)) & 1;
    }
  }
}

// Per-row byte offsets for a table with string columns: fixed+validity plus
// the row's total chars, rounded up to 8 (build_string_row_offsets,
// row_conversion.cu:216-261).  str_offsets[v] is the Arrow int32 [n+1]
// offsets array of variable column v.  Fills out_row_offsets [n+1]; returns
// the total byte size.
int64_t srjt_var_row_offsets(const int32_t* const* str_offsets, int32_t nvar,
                             int64_t n_rows, int32_t fixed_plus_validity,
                             int64_t* out_row_offsets) {
  out_row_offsets[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t chars = 0;
    for (int32_t v = 0; v < nvar; ++v) {
      chars += str_offsets[v][r + 1] - str_offsets[v][r];
    }
    int64_t size = round_up(fixed_plus_validity + chars, kRowAlignment);
    out_row_offsets[r + 1] = out_row_offsets[r] + size;
  }
  return out_row_offsets[n_rows];
}

// Variable-width pack (copy_strings_to_rows semantics,
// row_conversion.cu:852-874).  For variable columns, col_data[c] is the
// chars buffer and var_offsets[var_index(c)] its Arrow offsets; is_var[c]
// selects the interpretation.  out must hold row_offsets[n_rows] bytes.
void srjt_pack_var(const uint8_t* const* col_data,
                   const int32_t* const* var_offsets,
                   const uint8_t* const* col_valid, const int32_t* starts,
                   const int32_t* sizes, const uint8_t* is_var, int32_t ncols,
                   int64_t n_rows, const int64_t* row_offsets,
                   int32_t validity_offset, int32_t fixed_plus_validity,
                   uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(row_offsets[n_rows]));
  for (int64_t r = 0; r < n_rows; ++r) {
    uint8_t* row = out + row_offsets[r];
    uint32_t var_cursor = static_cast<uint32_t>(fixed_plus_validity);
    int32_t vi = 0;
    for (int32_t c = 0; c < ncols; ++c) {
      if (is_var[c]) {
        const int32_t* offs = var_offsets[vi++];
        uint32_t len = static_cast<uint32_t>(offs[r + 1] - offs[r]);
        uint32_t slot[2] = {var_cursor, len};
        std::memcpy(row + starts[c], slot, 8);
        std::memcpy(row + var_cursor, col_data[c] + offs[r], len);
        var_cursor += len;
      } else {
        std::memcpy(row + starts[c], col_data[c] + r * sizes[c],
                    static_cast<size_t>(sizes[c]));
      }
    }
    pack_validity(col_valid, ncols, r, row + validity_offset);
  }
}

// Variable-width unpack, phase 1: fixed slots, validity, and per-string-
// column lengths (written as Arrow offsets after an exclusive scan).
// out_str_offsets[v] must hold n_rows+1 int32s.
void srjt_unpack_var(const uint8_t* rows, const int64_t* row_offsets,
                     int64_t n_rows, const int32_t* starts,
                     const int32_t* sizes, const uint8_t* is_var,
                     int32_t ncols, int32_t validity_offset,
                     uint8_t* const* out_data, int32_t* const* out_str_offsets,
                     uint8_t* const* out_valid) {
  for (int32_t c = 0, vi = 0; c < ncols; ++c) {
    if (is_var[c]) out_str_offsets[vi++][0] = 0;
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* row = rows + row_offsets[r];
    int32_t vi = 0;
    for (int32_t c = 0; c < ncols; ++c) {
      if (is_var[c]) {
        uint32_t slot[2];
        std::memcpy(slot, row + starts[c], 8);
        int32_t* offs = out_str_offsets[vi++];
        offs[r + 1] = offs[r] + static_cast<int32_t>(slot[1]);
      } else {
        std::memcpy(out_data[c] + r * sizes[c], row + starts[c],
                    static_cast<size_t>(sizes[c]));
      }
      out_valid[c][r] = (row[validity_offset + c / 8] >> (c % 8)) & 1;
    }
  }
}

// Variable-width unpack, phase 2: gather one string column's chars into the
// buffer sized by phase 1's offsets (copy_strings_from_rows,
// row_conversion.cu:1131-1174).  slot_start is the column's (offset,len)
// slot position within the row.
void srjt_gather_chars(const uint8_t* rows, const int64_t* row_offsets,
                       int64_t n_rows, int32_t slot_start,
                       const int32_t* out_offsets, uint8_t* out_chars) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* row = rows + row_offsets[r];
    uint32_t slot[2];
    std::memcpy(slot, row + slot_start, 8);
    std::memcpy(out_chars + out_offsets[r], row + slot[0], slot[1]);
  }
}

}  // extern "C"
