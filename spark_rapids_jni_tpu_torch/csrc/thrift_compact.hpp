// Generic Thrift Compact Protocol tree reader/writer.
//
// Native twin of ../parquet/thrift.py (see its module docstring for the design
// rationale): parses into a generic field tree rather than generated typed
// structs (the reference uses thrift codegen, NativeParquetJni.cpp:27-32),
// so unknown footer fields survive prune round trips and no thrift toolchain
// is needed at build time.  Size-bomb guards follow the reference
// (NativeParquetJni.cpp:536-540).
#pragma once

#include <cstdint>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace srjt {

constexpr uint64_t kMaxStringSize = 100ull * 1000 * 1000;
constexpr uint64_t kMaxContainerSize = 1000ull * 1000;

enum TType : uint8_t {
  T_STOP = 0,
  T_BOOL_TRUE = 1,
  T_BOOL_FALSE = 2,
  T_BYTE = 3,
  T_I16 = 4,
  T_I32 = 5,
  T_I64 = 6,
  T_DOUBLE = 7,
  T_BINARY = 8,
  T_LIST = 9,
  T_SET = 10,
  T_MAP = 11,
  T_STRUCT = 12,
};

struct ThriftError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Value;

struct Field {
  int32_t fid;
  uint8_t type;
  std::unique_ptr<Value> val;
};

struct Value {
  uint8_t type = T_STOP;
  int64_t i = 0;        // bool (0/1), byte, i16, i32, i64
  double d = 0;         // double
  std::string bin;      // binary / string
  uint8_t elem_type = 0;
  std::vector<Value> elems;                    // list / set
  uint8_t ktype = 0, vtype = 0;
  std::vector<std::pair<Value, Value>> pairs;  // map
  std::vector<Field> fields;                   // struct

  Field* find(int32_t fid) {
    for (auto& f : fields)
      if (f.fid == fid) return &f;
    return nullptr;
  }
  const Field* find(int32_t fid) const {
    for (auto const& f : fields)
      if (f.fid == fid) return &f;
    return nullptr;
  }
  int64_t get_i(int32_t fid, int64_t dflt) const {
    auto* f = find(fid);
    return f ? f->val->i : dflt;
  }
  bool has(int32_t fid) const { return find(fid) != nullptr; }
  void set_i(int32_t fid, uint8_t t, int64_t v);
};

class CompactReader {
 public:
  CompactReader(const uint8_t* buf, uint64_t len) : buf_(buf), len_(len) {}

  Value read_struct();

 private:
  uint8_t byte();
  uint64_t read_varint();
  int64_t read_zigzag();
  void read_value(uint8_t type, Value& out);

  const uint8_t* buf_;
  uint64_t len_;
  uint64_t pos_ = 0;
};

class CompactWriter {
 public:
  void write_struct(const Value& s);
  const std::vector<uint8_t>& buffer() const { return out_; }

 private:
  void write_varint(uint64_t n);
  void write_zigzag(int64_t n);
  void write_value(uint8_t type, const Value& v);

  std::vector<uint8_t> out_;
};

}  // namespace srjt
