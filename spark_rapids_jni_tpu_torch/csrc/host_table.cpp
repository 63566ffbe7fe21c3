// Host column/table ownership model with a C-ABI handle surface.
//
// The reference gets its column/table object model, handle passing, and
// release protocol from libcudf + its Java bindings (SURVEY §2.9: handles
// unwrapped in RowConversionJni.cpp:27-38, released one by one into a
// jlongArray).  This is the port's native equivalent: plain host buffers
// with single ownership per handle, read by bridge.py (device_bridge.cpp's
// Python side) and uploaded to the GPU.  srjt_to_rows / srjt_from_rows are
// the host engine, reachable by those names only: no JNI entry point falls
// back to them.
//
// Handle discipline mirrors the reference's: a handle is a raw pointer
// returned as int64; the creator owns it until it is explicitly freed or
// ownership is transferred to a container that documents it.  Tables hold
// shared references so a column handle may outlive the table that used it
// (cudf Java's ColumnVector refcounting analog).

#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

constexpr int32_t kRowAlignment = 8;
constexpr int64_t kMaxBatchBytes = (1LL << 31) - 1;  // row_conversion.cu:64
constexpr int64_t kBatchRowMultiple = 32;            // row_conversion.cu:1504
// Test seam: srjt_debug_set_max_batch_bytes shrinks the limit so the
// oversized-row failure path is exercisable without 2GB allocations.
int64_t g_max_batch_bytes = kMaxBatchBytes;
constexpr int32_t kTypeString = 24;                  // TypeId.STRING (types.py)

inline int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// Fixed-width byte size per TypeId (types.py _STORAGE); 0 = variable width,
// -1 = unsupported in a host table.
int32_t type_size(int32_t type_id) {
  switch (type_id) {
    case 1: case 5: case 11: return 1;              // INT8, UINT8, BOOL8
    case 2: case 6: return 2;                       // INT16, UINT16
    case 3: case 7: case 9: case 12: case 17:       // INT32, UINT32, FLOAT32,
    case 22: return 4;                              //  TS_DAYS, DUR_DAYS, DEC32
    case 4: case 8: case 10: return 8;              // INT64, UINT64, FLOAT64
    case 13: case 14: case 15: case 16: return 8;   // timestamps
    case 18: case 19: case 20: case 21: return 8;   // durations
    case 23: return 8;                              // DECIMAL64
    case kTypeString: return 0;
    default: return -1;
  }
}

struct Column {
  int32_t type_id = 0;
  int32_t scale = 0;
  int64_t n_rows = 0;
  std::vector<uint8_t> data;        // fixed payload, or string chars
  std::vector<int32_t> offsets;     // string columns: n_rows+1 Arrow offsets
  std::vector<uint8_t> valid;       // empty = all valid, else n_rows bools

  bool is_string() const { return type_id == kTypeString; }
  int32_t slot_size() const { return is_string() ? 8 : type_size(type_id); }
  int32_t slot_align() const { return is_string() ? 4 : type_size(type_id); }
};

struct Table {
  std::vector<std::shared_ptr<Column>> cols;
  int64_t n_rows = 0;
};

// One ≤2GB JCUDF row batch — the LIST<INT8> column analog
// (row_conversion.cu:1869-1889).
struct RowBatch {
  std::vector<uint8_t> data;
  std::vector<int32_t> offsets;  // per-row, rebased to the batch start
};

struct RowBatches {
  std::vector<RowBatch> batches;
};

struct Layout {
  std::vector<int32_t> starts, sizes;
  std::vector<uint8_t> is_var;
  int32_t validity_offset = 0, fixed_plus_validity = 0, row_size = 0;
  bool fixed_only = true;
};

Layout compute_layout(const Table& t) {
  Layout L;
  int64_t off = 0;
  for (const auto& c : t.cols) {
    off = round_up(off, c->slot_align());
    L.starts.push_back(static_cast<int32_t>(off));
    L.sizes.push_back(c->slot_size());
    L.is_var.push_back(c->is_string() ? 1 : 0);
    if (c->is_string()) L.fixed_only = false;
    off += c->slot_size();
  }
  L.validity_offset = static_cast<int32_t>(off);
  L.fixed_plus_validity =
      L.validity_offset + static_cast<int32_t>((t.cols.size() + 7) / 8);
  L.row_size =
      static_cast<int32_t>(round_up(L.fixed_plus_validity, kRowAlignment));
  return L;
}

void pack_validity(const Table& t, int64_t row, uint8_t* dst) {
  int32_t ncols = static_cast<int32_t>(t.cols.size());
  for (int32_t b = 0; b * 8 < ncols; ++b) {
    uint8_t byte = 0;
    for (int32_t i = 0; i < 8 && b * 8 + i < ncols; ++i) {
      const auto& v = t.cols[b * 8 + i]->valid;
      if (v.empty() || v[row]) byte |= static_cast<uint8_t>(1u << i);
    }
    dst[b] = byte;
  }
}

// Per-row byte size (fixed layouts: constant; strings: data-dependent,
// build_string_row_offsets semantics, row_conversion.cu:216-261).
int64_t row_byte_size(const Table& t, const Layout& L, int64_t r) {
  if (L.fixed_only) return L.row_size;
  int64_t chars = 0;
  for (const auto& c : t.cols) {
    if (c->is_string()) chars += c->offsets[r + 1] - c->offsets[r];
  }
  return round_up(L.fixed_plus_validity + chars, kRowAlignment);
}

// Batch boundaries: scan row sizes, cut before 2GB, boundaries at 32-row
// multiples except the tail (build_batches, row_conversion.cu:1460-1539).
// Returns {} when any single row exceeds the batch limit — same contract as
// the Python engine (layout.build_batches raises ValueError); callers must
// treat an empty result as a failed conversion.
std::vector<int64_t> batch_bounds(const Table& t, const Layout& L) {
  std::vector<int64_t> bounds{0};
  int64_t acc = 0, r = 0;
  while (r < t.n_rows) {
    int64_t size = row_byte_size(t, L, r);
    if (acc + size > g_max_batch_bytes) {
      if (acc == 0) return {};  // one row alone blows the limit: fail
      int64_t cut = r - (r % kBatchRowMultiple);
      if (cut <= bounds.back()) cut = r;
      bounds.push_back(cut);
      acc = 0;
      r = cut;
      continue;
    }
    acc += size;
    ++r;
  }
  bounds.push_back(t.n_rows);
  return bounds;
}

void pack_rows(const Table& t, const Layout& L, int64_t row0, int64_t row1,
               RowBatch* out) {
  int64_t n = row1 - row0;
  out->offsets.resize(n + 1);
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) {
    out->offsets[r] = static_cast<int32_t>(total);
    total += row_byte_size(t, L, row0 + r);
  }
  out->offsets[n] = static_cast<int32_t>(total);
  out->data.assign(total, 0);
  int32_t ncols = static_cast<int32_t>(t.cols.size());
  for (int64_t r = 0; r < n; ++r) {
    uint8_t* row = out->data.data() + out->offsets[r];
    uint32_t cursor = static_cast<uint32_t>(L.fixed_plus_validity);
    for (int32_t c = 0; c < ncols; ++c) {
      const Column& col = *t.cols[c];
      if (col.is_string()) {
        uint32_t len =
            static_cast<uint32_t>(col.offsets[row0 + r + 1] -
                                  col.offsets[row0 + r]);
        uint32_t slot[2] = {cursor, len};
        std::memcpy(row + L.starts[c], slot, 8);
        std::memcpy(row + cursor, col.data.data() + col.offsets[row0 + r],
                    len);
        cursor += len;
      } else {
        std::memcpy(row + L.starts[c],
                    col.data.data() + (row0 + r) * L.sizes[c], L.sizes[c]);
      }
    }
    pack_validity(t, row0 + r, row + L.validity_offset);
  }
}

}  // namespace

extern "C" {

// ---- column handles -------------------------------------------------------

void* srjt_column_fixed(int32_t type_id, int32_t scale, int64_t n_rows,
                        const uint8_t* data, const uint8_t* valid) {
  int32_t size = type_size(type_id);
  if (size <= 0 || n_rows < 0) return nullptr;
  auto c = new (std::nothrow) std::shared_ptr<Column>(new Column());
  if (!c) return nullptr;
  (*c)->type_id = type_id;
  (*c)->scale = scale;
  (*c)->n_rows = n_rows;
  (*c)->data.assign(data, data + n_rows * size);
  if (valid) (*c)->valid.assign(valid, valid + n_rows);
  return c;
}

void* srjt_column_string(int64_t n_rows, const int32_t* offsets,
                         const uint8_t* chars, const uint8_t* valid) {
  if (n_rows < 0 || !offsets) return nullptr;
  auto c = new (std::nothrow) std::shared_ptr<Column>(new Column());
  if (!c) return nullptr;
  (*c)->type_id = kTypeString;
  (*c)->n_rows = n_rows;
  (*c)->offsets.assign(offsets, offsets + n_rows + 1);
  (*c)->data.assign(chars, chars + offsets[n_rows]);
  if (valid) (*c)->valid.assign(valid, valid + n_rows);
  return c;
}

int32_t srjt_column_type(void* h) {
  return (*static_cast<std::shared_ptr<Column>*>(h))->type_id;
}
int32_t srjt_column_scale(void* h) {
  return (*static_cast<std::shared_ptr<Column>*>(h))->scale;
}
int64_t srjt_column_rows(void* h) {
  return (*static_cast<std::shared_ptr<Column>*>(h))->n_rows;
}
const uint8_t* srjt_column_data(void* h) {
  return (*static_cast<std::shared_ptr<Column>*>(h))->data.data();
}
int64_t srjt_column_data_size(void* h) {
  return static_cast<int64_t>(
      (*static_cast<std::shared_ptr<Column>*>(h))->data.size());
}
const int32_t* srjt_column_offsets(void* h) {
  auto& c = *static_cast<std::shared_ptr<Column>*>(h);
  return c->offsets.empty() ? nullptr : c->offsets.data();
}
const uint8_t* srjt_column_valid(void* h) {
  auto& c = *static_cast<std::shared_ptr<Column>*>(h);
  return c->valid.empty() ? nullptr : c->valid.data();
}
void srjt_column_free(void* h) {
  delete static_cast<std::shared_ptr<Column>*>(h);
}

// ---- table handles --------------------------------------------------------

// Builds a table sharing the given columns (they remain independently owned
// by their handles — the cudf Java refcount discipline).
void* srjt_table(void* const* col_handles, int32_t ncols) {
  if (ncols <= 0) return nullptr;
  auto t = new (std::nothrow) Table();
  if (!t) return nullptr;
  for (int32_t i = 0; i < ncols; ++i) {
    auto& c = *static_cast<std::shared_ptr<Column>*>(col_handles[i]);
    if (i == 0) t->n_rows = c->n_rows;
    if (c->n_rows != t->n_rows) { delete t; return nullptr; }
    t->cols.push_back(c);
  }
  return t;
}

int64_t srjt_table_rows(void* h) { return static_cast<Table*>(h)->n_rows; }
int32_t srjt_table_cols(void* h) {
  return static_cast<int32_t>(static_cast<Table*>(h)->cols.size());
}
void* srjt_table_column(void* h, int32_t i) {
  // returns a NEW shared handle; caller frees it independently
  return new std::shared_ptr<Column>(static_cast<Table*>(h)->cols[i]);
}
void srjt_table_free(void* h) { delete static_cast<Table*>(h); }

// ---- table-level transcode (the convertToRows/convertFromRows surface) ----

// Table → ≤2GB JCUDF row batches.  Returns a RowBatches handle, null on
// unsupported schema or >1KB fixed rows (RowConversion.java:98-99).
void* srjt_to_rows(void* table_handle) {
  Table& t = *static_cast<Table*>(table_handle);
  Layout L = compute_layout(t);
  if (L.fixed_only && L.row_size > 1024) return nullptr;
  auto out = new (std::nothrow) RowBatches();
  if (!out) return nullptr;
  auto bounds = batch_bounds(t, L);
  if (bounds.size() < 2) {  // oversized single row
    delete out;
    return nullptr;
  }
  for (size_t b = 0; b + 1 < bounds.size(); ++b) {
    out->batches.emplace_back();
    pack_rows(t, L, bounds[b], bounds[b + 1], &out->batches.back());
  }
  return out;
}

int32_t srjt_rows_num_batches(void* h) {
  return static_cast<int32_t>(static_cast<RowBatches*>(h)->batches.size());
}
int64_t srjt_rows_batch_rows(void* h, int32_t b) {
  return static_cast<int64_t>(
      static_cast<RowBatches*>(h)->batches[b].offsets.size()) - 1;
}
const uint8_t* srjt_rows_batch_data(void* h, int32_t b) {
  return static_cast<RowBatches*>(h)->batches[b].data.data();
}
int64_t srjt_rows_batch_size(void* h, int32_t b) {
  return static_cast<int64_t>(
      static_cast<RowBatches*>(h)->batches[b].data.size());
}
const int32_t* srjt_rows_batch_offsets(void* h, int32_t b) {
  return static_cast<RowBatches*>(h)->batches[b].offsets.data();
}
void srjt_rows_free(void* h) { delete static_cast<RowBatches*>(h); }

// Test-only: shrink the batch byte limit (0 restores the default).
void srjt_debug_set_max_batch_bytes(int64_t v) {
  g_max_batch_bytes = v > 0 ? v : kMaxBatchBytes;
}

// Builds a RowBatches handle around caller-provided row bytes (the
// convertFromRows input path: Java hands a LIST<INT8> column's buffers).
void* srjt_rows_import(const uint8_t* data, int64_t data_size,
                       const int32_t* offsets, int64_t n_rows) {
  // Shuffle-received bytes are untrusted: reject non-monotonic / negative /
  // out-of-range offsets before they can drive reads or allocations.
  if (!data || !offsets || n_rows < 0 || data_size < 0) return nullptr;
  if (offsets[0] != 0) return nullptr;
  for (int64_t r = 0; r < n_rows; ++r) {
    if (offsets[r + 1] < offsets[r]) return nullptr;
  }
  if (offsets[n_rows] != data_size) return nullptr;
  auto rb = new (std::nothrow) RowBatches();
  if (!rb) return nullptr;
  rb->batches.emplace_back();
  rb->batches[0].data.assign(data, data + data_size);
  rb->batches[0].offsets.assign(offsets, offsets + n_rows + 1);
  return rb;
}

// Append one more ≤2GB batch to an imported RowBatches handle (the device
// bridge marshals multi-batch conversions back one batch at a time).
// Same untrusted-offset validation as srjt_rows_import; returns 0 on
// rejection.
int32_t srjt_rows_import_append(void* rows_handle, const uint8_t* data,
                                int64_t data_size, const int32_t* offsets,
                                int64_t n_rows) {
  if (!rows_handle || !data || !offsets || n_rows < 0 || data_size < 0)
    return 0;
  if (offsets[0] != 0) return 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    if (offsets[r + 1] < offsets[r]) return 0;
  }
  if (offsets[n_rows] != data_size) return 0;
  RowBatches& rb = *static_cast<RowBatches*>(rows_handle);
  rb.batches.emplace_back();
  rb.batches.back().data.assign(data, data + data_size);
  rb.batches.back().offsets.assign(offsets, offsets + n_rows + 1);
  return 1;
}

// One batch of JCUDF rows → table (exactly one input batch, matching
// convert_from_rows' contract, row_conversion.cu:2124-2139).
void* srjt_from_rows(void* rows_handle, int32_t batch,
                     const int32_t* type_ids, const int32_t* scales,
                     int32_t ncols) {
  RowBatches& rb = *static_cast<RowBatches*>(rows_handle);
  if (batch < 0 || batch >= static_cast<int32_t>(rb.batches.size()))
    return nullptr;
  const RowBatch& B = rb.batches[batch];
  int64_t n = static_cast<int64_t>(B.offsets.size()) - 1;

  auto t = new (std::nothrow) Table();
  if (!t) return nullptr;
  t->n_rows = n;
  for (int32_t c = 0; c < ncols; ++c) {
    auto col = std::make_shared<Column>();
    col->type_id = type_ids[c];
    col->scale = scales ? scales[c] : 0;
    col->n_rows = n;
    if (type_ids[c] != kTypeString && type_size(type_ids[c]) <= 0) {
      delete t;
      return nullptr;
    }
    t->cols.push_back(std::move(col));
  }
  Layout L = compute_layout(*t);

  for (int32_t c = 0; c < ncols; ++c) {
    Column& col = *t->cols[c];
    col.valid.assign(n, 1);
    if (col.is_string()) {
      col.offsets.assign(n + 1, 0);
    } else {
      col.data.resize(n * L.sizes[c]);
    }
  }
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = B.data.data() + B.offsets[r];
    int64_t span = B.offsets[r + 1] - B.offsets[r];
    // Row bytes may be shuffle-received (srjt_rows_import): every row must
    // cover the fixed+validity area, and string slots must stay in-row.
    if (span < L.fixed_plus_validity) {
      delete t;
      return nullptr;
    }
    // JCUDF packs all variable-width chars contiguously after the validity
    // bytes, in column order; enforcing that exact invariant (not just
    // per-slot in-row bounds) rejects overlapping slots, which would
    // otherwise let one crafted row claim its full tail for EVERY string
    // column and amplify the phase-2 allocation ncols-fold.
    int64_t chars_cursor = L.fixed_plus_validity;
    for (int32_t c = 0; c < ncols; ++c) {
      Column& col = *t->cols[c];
      if (col.is_string()) {
        uint32_t slot[2];
        std::memcpy(slot, row + L.starts[c], 8);
        if (slot[0] != chars_cursor ||
            static_cast<int64_t>(slot[0]) + slot[1] > span) {
          delete t;
          return nullptr;
        }
        chars_cursor += slot[1];
        int64_t next = static_cast<int64_t>(col.offsets[r]) + slot[1];
        if (next > INT32_MAX) {  // offsets are int32 (2GB column contract)
          delete t;
          return nullptr;
        }
        col.offsets[r + 1] = static_cast<int32_t>(next);
      } else {
        std::memcpy(col.data.data() + r * L.sizes[c], row + L.starts[c],
                    L.sizes[c]);
      }
      col.valid[r] = (row[L.validity_offset + c / 8] >> (c % 8)) & 1;
    }
  }
  // phase 2: gather string chars now that offsets are complete (slots were
  // bounds-checked in phase 1)
  for (int32_t c = 0; c < ncols; ++c) {
    Column& col = *t->cols[c];
    if (!col.is_string()) continue;
    col.data.resize(col.offsets[n]);
    for (int64_t r = 0; r < n; ++r) {
      const uint8_t* row = B.data.data() + B.offsets[r];
      uint32_t slot[2];
      std::memcpy(slot, row + L.starts[c], 8);
      std::memcpy(col.data.data() + col.offsets[r], row + slot[0], slot[1]);
    }
  }
  return t;
}

}  // extern "C"
