#include "thrift_compact.hpp"

#include <cstring>

namespace srjt {

void Value::set_i(int32_t fid, uint8_t t, int64_t v) {
  if (auto* f = find(fid)) {
    f->type = t;
    f->val->type = t;
    f->val->i = v;
    return;
  }
  auto val = std::make_unique<Value>();
  val->type = t;
  val->i = v;
  Field nf{fid, t, std::move(val)};
  // keep fields ordered by id (thrift compact writes ascending deltas)
  size_t at = 0;
  while (at < fields.size() && fields[at].fid < fid) ++at;
  fields.insert(fields.begin() + at, std::move(nf));
}

uint8_t CompactReader::byte() {
  if (pos_ >= len_) throw ThriftError("unexpected end of thrift data");
  return buf_[pos_++];
}

uint64_t CompactReader::read_varint() {
  uint64_t result = 0;
  int shift = 0;
  while (true) {
    uint8_t b = byte();
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return result;
    shift += 7;
    if (shift > 63) throw ThriftError("varint too long");
  }
}

int64_t CompactReader::read_zigzag() {
  uint64_t n = read_varint();
  return static_cast<int64_t>(n >> 1) ^ -static_cast<int64_t>(n & 1);
}

void CompactReader::read_value(uint8_t type, Value& out) {
  out.type = type;
  switch (type) {
    case T_BOOL_TRUE:
      out.i = 1;
      break;
    case T_BOOL_FALSE:
      out.i = 0;
      break;
    case T_BYTE:
      out.i = static_cast<int8_t>(byte());
      break;
    case T_I16:
    case T_I32:
    case T_I64:
      out.i = read_zigzag();
      break;
    case T_DOUBLE: {
      if (pos_ + 8 > len_) throw ThriftError("double past end");
      uint64_t bits = 0;
      std::memcpy(&bits, buf_ + pos_, 8);  // wire order is little-endian
      pos_ += 8;
      std::memcpy(&out.d, &bits, 8);
      break;
    }
    case T_BINARY: {
      uint64_t size = read_varint();
      if (size > kMaxStringSize) throw ThriftError("string size exceeds limit");
      if (pos_ + size > len_) throw ThriftError("string past end");
      out.bin.assign(reinterpret_cast<const char*>(buf_ + pos_), size);
      pos_ += size;
      break;
    }
    case T_LIST:
    case T_SET: {
      uint8_t header = byte();
      uint64_t size = (header >> 4) & 0x0F;
      out.elem_type = header & 0x0F;
      if (size == 15) size = read_varint();
      if (size > kMaxContainerSize)
        throw ThriftError("container size exceeds limit");
      out.elems.resize(size);
      if (out.elem_type == T_BOOL_TRUE || out.elem_type == T_BOOL_FALSE) {
        // in lists each bool is one byte (1=true, 2=false), unlike struct
        // fields where the value rides in the field header
        for (uint64_t i = 0; i < size; ++i) {
          out.elems[i].type = out.elem_type;
          out.elems[i].i = (byte() == 1) ? 1 : 0;
        }
      } else {
        for (uint64_t i = 0; i < size; ++i)
          read_value(out.elem_type, out.elems[i]);
      }
      break;
    }
    case T_MAP: {
      uint64_t size = read_varint();
      if (size > kMaxContainerSize) throw ThriftError("map size exceeds limit");
      if (size > 0) {
        uint8_t kv = byte();
        out.ktype = (kv >> 4) & 0x0F;
        out.vtype = kv & 0x0F;
        out.pairs.resize(size);
        for (uint64_t i = 0; i < size; ++i) {
          read_value(out.ktype, out.pairs[i].first);
          read_value(out.vtype, out.pairs[i].second);
        }
      }
      break;
    }
    case T_STRUCT: {
      Value s = read_struct();
      out.fields = std::move(s.fields);
      break;
    }
    default:
      throw ThriftError("unknown compact type " + std::to_string(type));
  }
}

Value CompactReader::read_struct() {
  Value out;
  out.type = T_STRUCT;
  int32_t last_fid = 0;
  while (true) {
    uint8_t header = byte();
    if (header == T_STOP) return out;
    uint8_t delta = (header >> 4) & 0x0F;
    uint8_t type = header & 0x0F;
    int32_t fid =
        delta ? last_fid + delta : static_cast<int32_t>(read_zigzag());
    Field f{fid, type, std::make_unique<Value>()};
    read_value(type, *f.val);
    out.fields.push_back(std::move(f));
    last_fid = fid;
  }
}

void CompactWriter::write_varint(uint64_t n) {
  while (true) {
    if ((n & ~0x7Full) == 0) {
      out_.push_back(static_cast<uint8_t>(n));
      return;
    }
    out_.push_back(static_cast<uint8_t>((n & 0x7F) | 0x80));
    n >>= 7;
  }
}

void CompactWriter::write_zigzag(int64_t n) {
  write_varint((static_cast<uint64_t>(n) << 1) ^
               static_cast<uint64_t>(n >> 63));
}

void CompactWriter::write_value(uint8_t type, const Value& v) {
  switch (type) {
    case T_BOOL_TRUE:
    case T_BOOL_FALSE:
      // only reached inside containers; structs encode bool in the header
      out_.push_back(v.i ? T_BOOL_TRUE : T_BOOL_FALSE);
      break;
    case T_BYTE:
      out_.push_back(static_cast<uint8_t>(v.i));
      break;
    case T_I16:
    case T_I32:
    case T_I64:
      write_zigzag(v.i);
      break;
    case T_DOUBLE: {
      uint64_t bits;
      std::memcpy(&bits, &v.d, 8);
      for (int b = 0; b < 8; ++b)
        out_.push_back(static_cast<uint8_t>(bits >> (8 * b)));
      break;
    }
    case T_BINARY:
      write_varint(v.bin.size());
      out_.insert(out_.end(), v.bin.begin(), v.bin.end());
      break;
    case T_LIST:
    case T_SET: {
      size_t size = v.elems.size();
      if (size < 15) {
        out_.push_back(static_cast<uint8_t>((size << 4) | v.elem_type));
      } else {
        out_.push_back(static_cast<uint8_t>(0xF0 | v.elem_type));
        write_varint(size);
      }
      for (auto const& e : v.elems) write_value(v.elem_type, e);
      break;
    }
    case T_MAP:
      write_varint(v.pairs.size());
      if (!v.pairs.empty()) {
        out_.push_back(static_cast<uint8_t>((v.ktype << 4) | v.vtype));
        for (auto const& [k, val] : v.pairs) {
          write_value(v.ktype, k);
          write_value(v.vtype, val);
        }
      }
      break;
    case T_STRUCT:
      write_struct(v);
      break;
    default:
      throw ThriftError("cannot write compact type " + std::to_string(type));
  }
}

void CompactWriter::write_struct(const Value& s) {
  int32_t last_fid = 0;
  for (auto const& f : s.fields) {
    uint8_t type = f.type;
    if (type == T_BOOL_TRUE || type == T_BOOL_FALSE)
      type = f.val->i ? T_BOOL_TRUE : T_BOOL_FALSE;
    int32_t delta = f.fid - last_fid;
    if (delta > 0 && delta <= 15) {
      out_.push_back(static_cast<uint8_t>((delta << 4) | type));
    } else {
      out_.push_back(type);
      write_zigzag(static_cast<int16_t>(f.fid));
    }
    if (type != T_BOOL_TRUE && type != T_BOOL_FALSE)
      write_value(type, *f.val);
    last_fid = f.fid;
  }
  out_.push_back(T_STOP);
}

}  // namespace srjt
