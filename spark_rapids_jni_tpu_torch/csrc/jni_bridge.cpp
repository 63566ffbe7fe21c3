// JNI bridge: the JVM-loadable surface of libsrjt.so.
//
// Equivalent of the reference's L2 bridge (RowConversionJni.cpp:24-66,
// NativeParquetJni.cpp:568-666): unwrap jlong handles, marshal schema
// arrays, translate native failures to Java exceptions, return handles.
// Underneath are host_table.cpp (the column/table/row-batch handles),
// device_bridge.cpp (row conversion on the GPU, through bridge.py) and
// footer_engine.cpp (thrift parse/prune/serialize).  Row conversion has no
// host fallback: when the device bridge fails, the native throws with the
// bridge's own text.  The host engine (srjt_to_rows / srjt_from_rows) stays
// reachable by its C names only.
//
// Compiles against a real <jni.h> when present, else the jni_min.h shim;
// tests drive these entry points through a ctypes-built mock JNIEnv
// (tests/torch_jni_env.py), standing in for the reference's JUnit tier.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "jni_min.h"

#ifdef SRJT_HAVE_REAL_JNI
#define ENV(fn, ...) env->fn(__VA_ARGS__)
#else
#define ENV(fn, ...) (*env)->fn(env, ##__VA_ARGS__)
#endif

extern "C" {

// host_table.cpp
void* srjt_table(void* const* cols, int32_t ncols);
void srjt_table_free(void* h);
int64_t srjt_table_rows(void* h);
int32_t srjt_table_cols(void* h);
void* srjt_table_column(void* h, int32_t i);
void* srjt_column_fixed(int32_t type_id, int32_t scale, int64_t n_rows,
                        const uint8_t* data, const uint8_t* valid);
void* srjt_column_string(int64_t n_rows, const int32_t* offsets,
                         const uint8_t* chars, const uint8_t* valid);
void srjt_column_free(void* h);
int64_t srjt_column_rows(void* h);
const uint8_t* srjt_column_data(void* h);
int64_t srjt_column_data_size(void* h);
const int32_t* srjt_column_offsets(void* h);
const uint8_t* srjt_column_valid(void* h);
void* srjt_rows_import(const uint8_t* data, int64_t size,
                       const int32_t* offsets, int64_t n_rows);
void srjt_rows_free(void* h);

// device_bridge.cpp
void* srjt_to_rows_device(void* table);
void* srjt_from_rows_device(void* rows, int32_t batch,
                            const int32_t* type_ids, const int32_t* scales,
                            int32_t ncols);
const char* srjt_device_last_error();

// footer_engine.cpp
void* srjt_footer_read_and_filter(const uint8_t* buf, uint64_t len,
                                  int64_t part_offset, int64_t part_length,
                                  const char** names,
                                  const int32_t* num_children,
                                  const int32_t* tags, int32_t n,
                                  int32_t parent_num_children,
                                  int32_t ignore_case, char* err,
                                  uint64_t err_len);
int64_t srjt_footer_num_rows(void* h);
int64_t srjt_footer_num_columns(void* h);
int64_t srjt_footer_serialize(void* h, uint8_t* out, uint64_t cap, char* err,
                              uint64_t err_len);
void srjt_footer_free(void* h);

namespace {

void throw_java(JNIEnv* env, const char* cls, const char* msg) {
  jclass c = ENV(FindClass, cls);
  if (c) ENV(ThrowNew, c, msg);
}

#define THROW_ILLEGAL(env, msg)                                  \
  do {                                                           \
    throw_java(env, "java/lang/IllegalArgumentException", msg);  \
    return 0;                                                    \
  } while (0)

// a failed device call as an IllegalArgumentException (the class the JAX
// package's JNI throws for the same input), carrying the bridge's reason
void throw_device(JNIEnv* env, const char* what) {
  std::string msg = std::string(what) + " failed on the device: " +
                    srjt_device_last_error();
  throw_java(env, "java/lang/IllegalArgumentException", msg.c_str());
}

}  // namespace

// ---- com.tpu.rapids.jni.HostColumn ---------------------------------------

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_makeFixed(
    JNIEnv* env, jclass, jint type_id, jint scale, jlong n_rows,
    jlong data_addr, jlong valid_addr) {
  void* h = srjt_column_fixed(type_id, scale, n_rows,
                              reinterpret_cast<const uint8_t*>(data_addr),
                              reinterpret_cast<const uint8_t*>(valid_addr));
  if (!h) THROW_ILLEGAL(env, "unsupported fixed-width column");
  return reinterpret_cast<jlong>(h);
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_makeString(
    JNIEnv* env, jclass, jlong n_rows, jlong offsets_addr, jlong chars_addr,
    jlong valid_addr) {
  void* h = srjt_column_string(
      n_rows, reinterpret_cast<const int32_t*>(offsets_addr),
      reinterpret_cast<const uint8_t*>(chars_addr),
      reinterpret_cast<const uint8_t*>(valid_addr));
  if (!h) THROW_ILLEGAL(env, "bad string column buffers");
  return reinterpret_cast<jlong>(h);
}

JNIEXPORT void JNICALL Java_com_tpu_rapids_jni_HostColumn_close(
    JNIEnv*, jclass, jlong handle) {
  srjt_column_free(reinterpret_cast<void*>(handle));
}

// Readback surface (the reference verifies through cudf's copy-to-host
// accessors; these expose the same via the srjt C API).

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_rows(
    JNIEnv*, jclass, jlong handle) {
  return srjt_column_rows(reinterpret_cast<void*>(handle));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_dataSize(
    JNIEnv*, jclass, jlong handle) {
  return srjt_column_data_size(reinterpret_cast<void*>(handle));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_dataAddress(
    JNIEnv*, jclass, jlong handle) {
  return reinterpret_cast<jlong>(
      srjt_column_data(reinterpret_cast<void*>(handle)));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_offsetsAddress(
    JNIEnv*, jclass, jlong handle) {
  return reinterpret_cast<jlong>(
      srjt_column_offsets(reinterpret_cast<void*>(handle)));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostColumn_validAddress(
    JNIEnv*, jclass, jlong handle) {
  return reinterpret_cast<jlong>(
      srjt_column_valid(reinterpret_cast<void*>(handle)));
}

// ---- com.tpu.rapids.jni.HostTable ----------------------------------------

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostTable_makeTable(
    JNIEnv* env, jclass, jlongArray col_handles) {
  jsize n = ENV(GetArrayLength, col_handles);
  std::vector<jlong> handles(n);
  ENV(GetLongArrayRegion, col_handles, 0, n, handles.data());
  std::vector<void*> cols;
  cols.reserve(n);
  for (jlong h : handles) cols.push_back(reinterpret_cast<void*>(h));
  void* t = srjt_table(cols.data(), n);
  if (!t) THROW_ILLEGAL(env, "mismatched column row counts");
  return reinterpret_cast<jlong>(t);
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_HostTable_rowCount(
    JNIEnv*, jclass, jlong handle) {
  return srjt_table_rows(reinterpret_cast<void*>(handle));
}

JNIEXPORT jlongArray JNICALL Java_com_tpu_rapids_jni_HostTable_columns(
    JNIEnv* env, jclass, jlong handle) {
  // release each column as its own handle into a jlongArray — the
  // convert_table_for_return protocol (RowConversionJni.cpp:33-38)
  void* t = reinterpret_cast<void*>(handle);
  int32_t n = srjt_table_cols(t);
  std::vector<jlong> out(n);
  for (int32_t i = 0; i < n; ++i) {
    out[i] = reinterpret_cast<jlong>(srjt_table_column(t, i));
  }
  jlongArray arr = ENV(NewLongArray, n);
  if (arr) ENV(SetLongArrayRegion, arr, 0, n, out.data());
  return arr;
}

JNIEXPORT void JNICALL Java_com_tpu_rapids_jni_HostTable_close(
    JNIEnv*, jclass, jlong handle) {
  srjt_table_free(reinterpret_cast<void*>(handle));
}

// ---- com.tpu.rapids.jni.RowConversion ------------------------------------

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_RowConversion_convertToRows(
    JNIEnv* env, jclass, jlong table_handle) {
  // the device engine, as the reference's JNI drives its own directly
  // (RowConversionJni.cpp:24-45)
  void* rows = srjt_to_rows_device(reinterpret_cast<void*>(table_handle));
  if (!rows) {
    throw_device(env, "convertToRows");
    return 0;
  }
  return reinterpret_cast<jlong>(rows);
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_RowConversion_importRows(
    JNIEnv*, jclass, jlong data_addr, jlong data_size, jlong offsets_addr,
    jlong n_rows) {
  return reinterpret_cast<jlong>(
      srjt_rows_import(reinterpret_cast<const uint8_t*>(data_addr), data_size,
                       reinterpret_cast<const int32_t*>(offsets_addr),
                       n_rows));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_RowConversion_convertFromRows(
    JNIEnv* env, jclass, jlong rows_handle, jint batch, jintArray type_ids,
    jintArray scales) {
  jsize n = ENV(GetArrayLength, type_ids);
  std::vector<jint> types(n), scl(n);
  ENV(GetIntArrayRegion, type_ids, 0, n, types.data());
  if (scales) ENV(GetIntArrayRegion, scales, 0, n, scl.data());
  // the device engine decodes every batch (one batch a call)
  void* t = srjt_from_rows_device(reinterpret_cast<void*>(rows_handle), batch,
                                  types.data(), scales ? scl.data() : nullptr,
                                  n);
  if (!t) {
    throw_device(env, "convertFromRows");
    return 0;
  }
  return reinterpret_cast<jlong>(t);
}

JNIEXPORT void JNICALL Java_com_tpu_rapids_jni_RowConversion_freeRows(
    JNIEnv*, jclass, jlong rows_handle) {
  srjt_rows_free(reinterpret_cast<void*>(rows_handle));
}

// ---- com.tpu.rapids.jni.ParquetFooter ------------------------------------

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_ParquetFooter_readAndFilter(
    JNIEnv* env, jclass, jlong buffer_addr, jlong buffer_len,
    jlong part_offset, jlong part_length, jobjectArray names,
    jintArray num_children, jintArray tags, jint parent_num_children,
    jboolean ignore_case) {
  jsize n = ENV(GetArrayLength, names);
  std::vector<std::string> name_strs;
  name_strs.reserve(n);
  for (jsize i = 0; i < n; ++i) {
    jstring s = static_cast<jstring>(ENV(GetObjectArrayElement, names, i));
    const char* c = ENV(GetStringUTFChars, s, nullptr);
    name_strs.emplace_back(c ? c : "");
    if (c) ENV(ReleaseStringUTFChars, s, c);
  }
  std::vector<const char*> name_ptrs;
  for (const auto& s : name_strs) name_ptrs.push_back(s.c_str());
  std::vector<jint> nc(n), tg(n);
  ENV(GetIntArrayRegion, num_children, 0, n, nc.data());
  ENV(GetIntArrayRegion, tags, 0, n, tg.data());

  char err[512] = {0};
  void* h = srjt_footer_read_and_filter(
      reinterpret_cast<const uint8_t*>(buffer_addr),
      static_cast<uint64_t>(buffer_len), part_offset, part_length,
      name_ptrs.data(), nc.data(), tg.data(), n, parent_num_children,
      ignore_case ? 1 : 0, err, sizeof(err));
  if (!h) {
    throw_java(env, "java/lang/RuntimeException",
               err[0] ? err : "failed to parse parquet footer");
    return 0;
  }
  return reinterpret_cast<jlong>(h);
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_ParquetFooter_getNumRows(
    JNIEnv*, jclass, jlong handle) {
  return srjt_footer_num_rows(reinterpret_cast<void*>(handle));
}

JNIEXPORT jlong JNICALL Java_com_tpu_rapids_jni_ParquetFooter_getNumColumns(
    JNIEnv*, jclass, jlong handle) {
  return srjt_footer_num_columns(reinterpret_cast<void*>(handle));
}

JNIEXPORT jlong JNICALL
Java_com_tpu_rapids_jni_ParquetFooter_serializeThriftFile(
    JNIEnv* env, jclass, jlong handle, jlong out_addr, jlong out_cap) {
  char err[512] = {0};
  int64_t written = srjt_footer_serialize(
      reinterpret_cast<void*>(handle), reinterpret_cast<uint8_t*>(out_addr),
      static_cast<uint64_t>(out_cap), err, sizeof(err));
  if (written < 0) {
    throw_java(env, "java/lang/RuntimeException",
               err[0] ? err : "failed to serialize footer");
    return 0;
  }
  return written;
}

JNIEXPORT void JNICALL Java_com_tpu_rapids_jni_ParquetFooter_close(
    JNIEnv*, jclass, jlong handle) {
  srjt_footer_free(reinterpret_cast<void*>(handle));
}

}  // extern "C"
