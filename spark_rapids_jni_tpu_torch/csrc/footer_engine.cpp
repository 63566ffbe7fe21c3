// Parquet footer parse → prune → re-serialize: native engine, C ABI.
//
// Native twin of ../parquet/footer.py with identical semantics (that module's
// docstring lists the reference behaviors reproduced, all cited to
// NativeParquetJni.cpp).  Exposed through a plain C ABI (srjt_footer_*) so
// the Python layer binds via ctypes and a JVM can bind via JNI without any
// C++ ABI coupling — the handle-based surface mirrors the reference's
// jlong-handle protocol (NativeParquetJni.cpp:568-666).
//
// Case folding: ASCII-only tolower here; the reference's locale-based
// mbstowcs/towlower (NativeParquetJni.cpp:45-78) is locale-fragile, and the
// Python engine (parquet/footer.py) provides full-Unicode folding when
// needed.

#include <algorithm>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "thrift_compact.hpp"

namespace srjt {

// parquet.thrift field ids (public definition)
namespace fmd {
constexpr int32_t kSchema = 2, kNumRows = 3, kRowGroups = 4, kColumnOrders = 7;
}
namespace se {
constexpr int32_t kType = 1, kRepetitionType = 3, kName = 4, kNumChildren = 5,
                  kConvertedType = 6;
}
namespace rg {
constexpr int32_t kColumns = 1, kNumRows = 3, kFileOffset = 5,
                  kTotalCompressedSize = 6;
}
namespace cc {
constexpr int32_t kMetaData = 3;
}
namespace cmd {
constexpr int32_t kTotalCompressedSize = 7, kDataPageOffset = 9,
                  kDictionaryPageOffset = 11;
}

constexpr int64_t kConvertedMap = 1, kConvertedMapKeyValue = 2,
                  kConvertedList = 3;
constexpr int64_t kRepetitionRepeated = 2;

enum class Tag : int32_t { VALUE = 0, STRUCT = 1, LIST = 2, MAP = 3 };

static std::string ascii_lower(std::string s) {
  for (auto& c : s)
    if (c >= 'A' && c <= 'Z') c += 32;
  return s;
}

struct PruningMaps {
  std::vector<int> schema_map;
  std::vector<int> schema_num_children;
  std::vector<int> chunk_map;
};

// Expected-schema tree matcher (column_pruner, NativeParquetJni.cpp:112-437).
class ColumnPruner {
 public:
  explicit ColumnPruner(Tag tag = Tag::STRUCT) : tag_(tag) {}

  // Build from depth-first flattened (names, num_children, tags); the root
  // is excluded, parent_num_children counts its children
  // (NativeParquetJni.cpp:388-437).
  ColumnPruner(const std::vector<std::string>& names,
               const std::vector<int32_t>& num_children,
               const std::vector<int32_t>& tags, int32_t parent_num_children)
      : tag_(Tag::STRUCT) {
    if (parent_num_children == 0) return;
    std::vector<ColumnPruner*> tree_stack{this};
    std::vector<int32_t> left_stack{parent_num_children};
    for (size_t i = 0; i < names.size(); ++i) {
      auto [it, inserted] = tree_stack.back()->children_.try_emplace(
          names[i], static_cast<Tag>(tags[i]));
      (void)inserted;
      if (num_children[i] > 0) {
        tree_stack.push_back(&it->second);
        left_stack.push_back(num_children[i]);
      } else {
        while (!tree_stack.empty()) {
          if (--left_stack.back() > 0) break;
          tree_stack.pop_back();
          left_stack.pop_back();
        }
      }
    }
    if (!tree_stack.empty())
      throw std::invalid_argument("flattened schema arrays are inconsistent");
  }

  PruningMaps filter_schema(const std::vector<Value>& schema,
                            bool ignore_case) const {
    PruningMaps maps;
    size_t schema_idx = 0, chunk_idx = 0;
    filter(schema, ignore_case, schema_idx, chunk_idx, maps);
    return maps;
  }

 private:
  static std::string name_of(const Value& elem, bool fold) {
    auto* f = elem.find(se::kName);
    std::string n = f ? f->val->bin : "";
    return fold ? ascii_lower(n) : n;
  }
  static int64_t num_children_of(const Value& elem) {
    return elem.get_i(se::kNumChildren, 0);
  }
  static bool is_leaf(const Value& elem) { return elem.has(se::kType); }

  static void skip(const std::vector<Value>& schema, size_t& si, size_t& ci) {
    // skip subtree, advancing the chunk counter per leaf
    // (NativeParquetJni.cpp:160-180)
    int64_t to_skip = 1;
    while (to_skip > 0 && si < schema.size()) {
      const Value& elem = schema[si];
      if (is_leaf(elem)) ++ci;
      to_skip += num_children_of(elem) - 1;
      ++si;
    }
  }

  void filter(const std::vector<Value>& schema, bool ic, size_t& si,
              size_t& ci, PruningMaps& maps) const {
    switch (tag_) {
      case Tag::STRUCT:
        return filter_struct(schema, ic, si, ci, maps);
      case Tag::VALUE:
        return filter_value(schema, si, ci, maps);
      case Tag::LIST:
        return filter_list(schema, ic, si, ci, maps);
      case Tag::MAP:
        return filter_map(schema, ic, si, ci, maps);
    }
    throw std::runtime_error("unexpected pruner tag");
  }

  void filter_struct(const std::vector<Value>& schema, bool ic, size_t& si,
                     size_t& ci, PruningMaps& maps) const {
    const Value& elem = schema.at(si);
    if (is_leaf(elem))
      throw std::runtime_error("found a leaf node, but expected a struct");
    int64_t n = num_children_of(elem);
    maps.schema_map.push_back(si);
    size_t my_nc = maps.schema_num_children.size();
    maps.schema_num_children.push_back(0);
    ++si;
    for (int64_t c = 0; c < n && si < schema.size(); ++c) {
      auto it = children_.find(name_of(schema[si], ic));
      if (it != children_.end()) {
        ++maps.schema_num_children[my_nc];
        it->second.filter(schema, ic, si, ci, maps);
      } else {
        skip(schema, si, ci);
      }
    }
  }

  void filter_value(const std::vector<Value>& schema, size_t& si, size_t& ci,
                    PruningMaps& maps) const {
    const Value& elem = schema.at(si);
    if (!is_leaf(elem))
      throw std::runtime_error(
          "found a non-leaf entry when reading a leaf value");
    if (num_children_of(elem) != 0)
      throw std::runtime_error(
          "found an entry with children when reading a leaf value");
    maps.schema_map.push_back(si);
    maps.schema_num_children.push_back(0);
    ++si;
    maps.chunk_map.push_back(ci);
    ++ci;
  }

  void filter_list(const std::vector<Value>& schema, bool ic, size_t& si,
                   size_t& ci, PruningMaps& maps) const {
    const ColumnPruner& element = children_.at("element");
    const Value& elem = schema.at(si);
    std::string list_name = name_of(elem, false);
    if (is_leaf(elem))
      throw std::runtime_error("expected a list item, but found a single value");
    if (!elem.has(se::kConvertedType) ||
        elem.get_i(se::kConvertedType, -1) != kConvertedList)
      throw std::runtime_error("expected a list type, but it was not found");
    if (num_children_of(elem) != 1)
      throw std::runtime_error(
          "the structure of the outer list group is not standard");
    maps.schema_map.push_back(si);
    maps.schema_num_children.push_back(1);
    ++si;

    // LIST layout rules: standard 3-level vs legacy 2-level
    // (NativeParquetJni.cpp:271-299)
    const Value& rep = schema.at(si);
    if (rep.get_i(se::kRepetitionType, -1) != kRepetitionRepeated)
      throw std::runtime_error(
          "the structure of the list's child is not standard (non repeating)");
    bool rep_is_group = !is_leaf(rep);
    int64_t rep_nc = num_children_of(rep);
    std::string rep_name = name_of(rep, false);
    if (rep_is_group && rep_nc == 1 && rep_name != "array" &&
        rep_name != list_name + "_tuple") {
      maps.schema_map.push_back(si);
      maps.schema_num_children.push_back(1);
      ++si;
      element.filter(schema, ic, si, ci, maps);
    } else {
      element.filter(schema, ic, si, ci, maps);
    }
  }

  void filter_map(const std::vector<Value>& schema, bool ic, size_t& si,
                  size_t& ci, PruningMaps& maps) const {
    const ColumnPruner& key = children_.at("key");
    const ColumnPruner& value = children_.at("value");
    const Value& elem = schema.at(si);
    if (is_leaf(elem))
      throw std::runtime_error("expected a map item, but found a single value");
    int64_t conv = elem.get_i(se::kConvertedType, -1);
    if (conv != kConvertedMap && conv != kConvertedMapKeyValue)
      throw std::runtime_error("expected a map type, but it was not found");
    if (num_children_of(elem) != 1)
      throw std::runtime_error(
          "the structure of the outer map group is not standard");
    maps.schema_map.push_back(si);
    maps.schema_num_children.push_back(1);
    ++si;

    const Value& rep = schema.at(si);
    if (rep.get_i(se::kRepetitionType, -1) != kRepetitionRepeated)
      throw std::runtime_error("found non repeating map child");
    int64_t rep_nc = num_children_of(rep);
    if (rep_nc != 1 && rep_nc != 2)
      throw std::runtime_error("found map with wrong number of children");
    maps.schema_map.push_back(si);
    maps.schema_num_children.push_back(rep_nc);
    ++si;
    key.filter(schema, ic, si, ci, maps);
    if (rep_nc == 2) value.filter(schema, ic, si, ci, maps);
  }

  std::map<std::string, ColumnPruner> children_;
  Tag tag_;
};

// -- row-group filtering (NativeParquetJni.cpp:437-519) --------------------

static Value& columns_of(Value& group) {
  Field* f = group.find(rg::kColumns);
  if (!f || f->val->elems.empty())
    throw std::runtime_error("malformed footer: row group without columns");
  return *f->val;
}

static int64_t chunk_offset(const Value& chunk) {
  const Field* mdf = chunk.find(cc::kMetaData);
  if (!mdf)
    throw std::runtime_error("malformed footer: column chunk without metadata");
  const Value& md = *mdf->val;
  int64_t off = md.get_i(cmd::kDataPageOffset, 0);
  if (md.has(cmd::kDictionaryPageOffset)) {
    int64_t d = md.get_i(cmd::kDictionaryPageOffset, 0);
    if (off > d) off = d;
  }
  return off;
}

static bool invalid_file_offset(int64_t start, int64_t pre_start,
                                int64_t pre_size) {
  if (pre_start == 0 && start != 4) return true;
  return start < pre_start + pre_size;
}

static std::vector<Value> filter_groups(Value& meta, int64_t part_offset,
                                        int64_t part_length) {
  std::vector<Value> out;
  Field* gf = meta.find(fmd::kRowGroups);
  if (!gf || gf->val->elems.empty()) return out;
  auto& groups = gf->val->elems;
  bool first_has_md = columns_of(groups[0]).elems[0].has(cc::kMetaData);
  int64_t pre_start = 0, pre_size = 0;
  for (auto& group : groups) {
    auto& cols = columns_of(group).elems;
    int64_t start;
    if (first_has_md) {
      start = chunk_offset(cols[0]);
    } else {
      start = group.get_i(rg::kFileOffset, 0);
      if (invalid_file_offset(start, pre_start, pre_size))
        start = (pre_start == 0) ? 4 : pre_start + pre_size;
      pre_start = start;
      pre_size = group.get_i(rg::kTotalCompressedSize, 0);
    }
    int64_t total;
    if (group.has(rg::kTotalCompressedSize)) {
      total = group.get_i(rg::kTotalCompressedSize, 0);
    } else {
      total = 0;
      for (auto& c : cols) {
        const Field* mdf = c.find(cc::kMetaData);
        if (!mdf)
          throw std::runtime_error(
              "malformed footer: column chunk without metadata");
        total += mdf->val->get_i(cmd::kTotalCompressedSize, 0);
      }
    }
    int64_t mid = start + total / 2;
    if (mid >= part_offset && mid < part_offset + part_length)
      out.push_back(std::move(group));
  }
  return out;
}

static void filter_columns(std::vector<Value>& groups,
                           const std::vector<int>& chunk_map) {
  for (auto& group : groups) {
    auto& cols = columns_of(group).elems;
    std::vector<Value> kept;
    kept.reserve(chunk_map.size());
    for (int idx : chunk_map) kept.push_back(std::move(cols.at(idx)));
    cols = std::move(kept);
  }
}

struct FooterHandle {
  Value meta;
};

}  // namespace srjt

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

using srjt::FooterHandle;

static void fill_err(char* err, uint64_t err_len, const char* msg) {
  if (err && err_len) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

void* srjt_footer_read_and_filter(const uint8_t* buf, uint64_t len,
                                  int64_t part_offset, int64_t part_length,
                                  const char** names,
                                  const int32_t* num_children,
                                  const int32_t* tags, int32_t n,
                                  int32_t parent_num_children,
                                  int32_t ignore_case, char* err,
                                  uint64_t err_len) {
  try {
    auto handle = std::make_unique<FooterHandle>();
    srjt::CompactReader reader(buf, len);
    handle->meta = reader.read_struct();

    std::vector<std::string> names_v(names, names + n);
    std::vector<int32_t> nc_v(num_children, num_children + n);
    std::vector<int32_t> tags_v(tags, tags + n);
    srjt::ColumnPruner pruner(names_v, nc_v, tags_v, parent_num_children);

    srjt::Field* schema_f = handle->meta.find(srjt::fmd::kSchema);
    if (!schema_f) throw std::runtime_error("footer has no schema");
    auto& schema = schema_f->val->elems;
    auto maps = pruner.filter_schema(schema, ignore_case != 0);

    // gather + rewrite schema num_children (NativeParquetJni.cpp:595-605)
    std::vector<srjt::Value> new_schema;
    new_schema.reserve(maps.schema_map.size());
    for (size_t i = 0; i < maps.schema_map.size(); ++i) {
      srjt::Value elem = std::move(schema.at(maps.schema_map[i]));
      int nc = maps.schema_num_children[i];
      if (elem.has(srjt::se::kNumChildren) || nc != 0)
        elem.set_i(srjt::se::kNumChildren, srjt::T_I32, nc);
      new_schema.push_back(std::move(elem));
    }
    schema = std::move(new_schema);

    // column_orders gathered by chunk map (NativeParquetJni.cpp:606-613)
    if (auto* orders = handle->meta.find(srjt::fmd::kColumnOrders)) {
      std::vector<srjt::Value> kept;
      for (int idx : maps.chunk_map)
        kept.push_back(std::move(orders->val->elems.at(idx)));
      orders->val->elems = std::move(kept);
    }

    if (part_length >= 0) {
      auto kept = srjt::filter_groups(handle->meta, part_offset, part_length);
      if (auto* gf = handle->meta.find(srjt::fmd::kRowGroups))
        gf->val->elems = std::move(kept);
    }
    if (auto* gf = handle->meta.find(srjt::fmd::kRowGroups))
      srjt::filter_columns(gf->val->elems, maps.chunk_map);

    return handle.release();
  } catch (std::exception& e) {
    fill_err(err, err_len, e.what());
    return nullptr;
  }
}

int64_t srjt_footer_num_rows(void* h) {
  auto* handle = static_cast<FooterHandle*>(h);
  int64_t total = 0;
  if (auto* gf = handle->meta.find(srjt::fmd::kRowGroups))
    for (auto& g : gf->val->elems) total += g.get_i(srjt::rg::kNumRows, 0);
  return total;
}

int64_t srjt_footer_num_columns(void* h) {
  auto* handle = static_cast<FooterHandle*>(h);
  if (auto* sf = handle->meta.find(srjt::fmd::kSchema))
    if (!sf->val->elems.empty())
      return sf->val->elems[0].get_i(srjt::se::kNumChildren, 0);
  return 0;
}

// Serialize with full-file framing "PAR1" + thrift + u32 len + "PAR1"
// (NativeParquetJni.cpp:666-699).  Two-call protocol: pass null to size.
int64_t srjt_footer_serialize(void* h, uint8_t* out, uint64_t out_capacity,
                              char* err, uint64_t err_len) {
  try {
    auto* handle = static_cast<FooterHandle*>(h);
    srjt::CompactWriter writer;
    writer.write_struct(handle->meta);
    const auto& body = writer.buffer();
    uint64_t total = body.size() + 12;
    if (!out) return static_cast<int64_t>(total);
    if (out_capacity < total) {
      fill_err(err, err_len, "output buffer too small");
      return -1;
    }
    std::memcpy(out, "PAR1", 4);
    std::memcpy(out + 4, body.data(), body.size());
    uint32_t len32 = static_cast<uint32_t>(body.size());
    out[4 + body.size() + 0] = static_cast<uint8_t>(len32 & 0xFF);
    out[4 + body.size() + 1] = static_cast<uint8_t>((len32 >> 8) & 0xFF);
    out[4 + body.size() + 2] = static_cast<uint8_t>((len32 >> 16) & 0xFF);
    out[4 + body.size() + 3] = static_cast<uint8_t>((len32 >> 24) & 0xFF);
    std::memcpy(out + 8 + body.size(), "PAR1", 4);
    return static_cast<int64_t>(total);
  } catch (std::exception& e) {
    fill_err(err, err_len, e.what());
    return -1;
  }
}

void srjt_footer_free(void* h) { delete static_cast<FooterHandle*>(h); }

}  // extern "C"
