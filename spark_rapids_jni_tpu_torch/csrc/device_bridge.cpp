// Device bridge: routes the C/JNI surface onto the port's GPU engine.
//
// The reference's JNI surface drives its CUDA engine directly
// (RowConversionJni.cpp:24-45 → spark_rapids_jni::convert_to_rows).  The
// port's engine is PyTorch with hand-written CUDA kernels, so the bridge is
// an embedded-Python trampoline: the process hosts a CPython runtime with
// torch (a PySpark executor, a JVM that started one, the tests), and libsrjt
// forwards a host table or row-batch handle to
// spark_rapids_jni_tpu_torch.bridge, which reads it through this same
// library's C accessors, uploads it, converts it on the GPU and imports the
// result back through srjt_rows_import / srjt_table.
//
// No link-time libpython dependency: the CPython C API is resolved with
// dlsym(RTLD_DEFAULT) at first use, so the library still loads into a plain
// JVM; there every device call fails with "no Python runtime in this
// process".  There is no host fallback: a failed call returns null and
// srjt_device_last_error() gives the reason, which the JNI natives throw.

#include <cstdint>
#include <dlfcn.h>
#include <mutex>
#include <string>

namespace {

constexpr const char* kBridgeModule = "spark_rapids_jni_tpu_torch.bridge";

// minimal CPython C API surface, resolved dynamically
using PyGILState_Ensure_t = int (*)();
using PyGILState_Release_t = void (*)(int);
using PyImport_ImportModule_t = void* (*)(const char*);
using PyObject_GetAttrString_t = void* (*)(void*, const char*);
using PyObject_CallFunction_t = void* (*)(void*, const char*, ...);
using PyObject_Str_t = void* (*)(void*);
using PyUnicode_AsUTF8_t = const char* (*)(void*);
using PyLong_AsLongLong_t = long long (*)(void*);
using PyErr_Occurred_t = void* (*)();
using PyErr_Fetch_t = void (*)(void**, void**, void**);
using PyErr_Clear_t = void (*)();
using Py_DecRef_t = void (*)(void*);
using Py_IsInitialized_t = int (*)();

struct PyApi {
  PyGILState_Ensure_t gil_ensure = nullptr;
  PyGILState_Release_t gil_release = nullptr;
  PyImport_ImportModule_t import_module = nullptr;
  PyObject_GetAttrString_t getattr = nullptr;
  PyObject_CallFunction_t call = nullptr;
  PyObject_Str_t str = nullptr;
  PyUnicode_AsUTF8_t as_utf8 = nullptr;
  PyLong_AsLongLong_t as_longlong = nullptr;
  PyErr_Occurred_t err_occurred = nullptr;
  PyErr_Fetch_t err_fetch = nullptr;
  PyErr_Clear_t err_clear = nullptr;
  Py_DecRef_t decref = nullptr;
  Py_IsInitialized_t is_initialized = nullptr;
  bool ok = false;
};

template <typename F>
void resolve(F* fn, const char* name) {
  *fn = reinterpret_cast<F>(dlsym(RTLD_DEFAULT, name));
}

const PyApi& py_api() {
  static PyApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    resolve(&api.gil_ensure, "PyGILState_Ensure");
    resolve(&api.gil_release, "PyGILState_Release");
    resolve(&api.import_module, "PyImport_ImportModule");
    resolve(&api.getattr, "PyObject_GetAttrString");
    resolve(&api.call, "PyObject_CallFunction");
    resolve(&api.str, "PyObject_Str");
    resolve(&api.as_utf8, "PyUnicode_AsUTF8");
    resolve(&api.as_longlong, "PyLong_AsLongLong");
    resolve(&api.err_occurred, "PyErr_Occurred");
    resolve(&api.err_fetch, "PyErr_Fetch");
    resolve(&api.err_clear, "PyErr_Clear");
    resolve(&api.decref, "Py_DecRef");
    resolve(&api.is_initialized, "Py_IsInitialized");
    api.ok = api.gil_ensure && api.gil_release && api.import_module
             && api.getattr && api.call && api.str && api.as_utf8
             && api.as_longlong && api.err_occurred && api.err_fetch
             && api.err_clear && api.decref && api.is_initialized;
  });
  return api;
}

// why the last device call of this thread failed ("" after a success)
thread_local std::string g_last_error;

// str(obj), or "" if it cannot be had
std::string py_text(const PyApi& py, void* obj) {
  std::string out;
  void* s = obj ? py.str(obj) : nullptr;
  if (s) {
    const char* c = py.as_utf8(s);
    if (c) out = c;
    py.decref(s);
  }
  if (py.err_occurred()) py.err_clear();
  return out;
}

// "<type>: <message>" of the pending Python exception, which is cleared
std::string take_python_error(const PyApi& py) {
  void *type = nullptr, *value = nullptr, *tb = nullptr;
  py.err_fetch(&type, &value, &tb);
  std::string name;
  if (type) {
    void* n = py.getattr(type, "__name__");
    if (n) {
      name = py_text(py, n);
      py.decref(n);
    }
    if (py.err_occurred()) py.err_clear();
  }
  std::string msg = py_text(py, value);
  for (void* o : {type, value, tb}) {
    if (o) py.decref(o);
  }
  if (name.empty()) return msg.empty() ? "the device bridge raised" : msg;
  return msg.empty() ? name : name + ": " + msg;
}

inline long long as_arg(const void* p) {
  return static_cast<long long>(reinterpret_cast<intptr_t>(p));
}

// spark_rapids_jni_tpu_torch.bridge.<fn>(handle) for to_rows, else
// <fn>(handle, batch, type_ids, scales, ncols); the int it returns is the new
// handle, 0 when the bridge failed (the bridge then sets the error text
// through srjt_device_set_error)
void* call_bridge(const char* fn, void* handle, bool from_rows, int32_t batch,
                  const int32_t* type_ids, const int32_t* scales,
                  int32_t ncols) {
  g_last_error.clear();
  const PyApi& py = py_api();
  if (!py.ok || !py.is_initialized()) {
    g_last_error = "no Python runtime in this process";
    return nullptr;
  }
  int gil = py.gil_ensure();
  void* result = nullptr;
  void* mod = py.import_module(kBridgeModule);
  void* f = mod ? py.getattr(mod, fn) : nullptr;
  void* res = nullptr;
  if (f) {
    res = from_rows
        ? py.call(f, "LiLLi", as_arg(handle), static_cast<int>(batch),
                  as_arg(type_ids), as_arg(scales), static_cast<int>(ncols))
        : py.call(f, "L", as_arg(handle));
  }
  if (res) {
    long long v = py.as_longlong(res);
    if (!py.err_occurred()) {
      result = reinterpret_cast<void*>(static_cast<intptr_t>(v));
    }
    py.decref(res);
  }
  if (py.err_occurred()) {
    g_last_error = take_python_error(py);
  } else if (!result && g_last_error.empty()) {
    g_last_error = std::string(kBridgeModule) + "." + fn + " gave no handle";
  }
  if (f) py.decref(f);
  if (mod) py.decref(mod);
  py.gil_release(gil);
  return result;
}

}  // namespace

extern "C" {

// 1 when an initialized CPython runtime is reachable from this process (the
// bridge may still fail: torch missing, no CUDA device).
int32_t srjt_device_available() {
  const PyApi& py = py_api();
  return (py.ok && py.is_initialized()) ? 1 : 0;
}

// Host table handle → JCUDF RowBatches handle, converted on the GPU.  Null
// on failure; srjt_device_last_error() says why.
void* srjt_to_rows_device(void* table_handle) {
  return call_bridge("to_rows_from_handle", table_handle, false, 0, nullptr,
                     nullptr, 0);
}

// Batch `batch` of a JCUDF RowBatches handle (+ schema arrays) → host table
// handle, converted on the GPU.  Null on failure, as above.
void* srjt_from_rows_device(void* rows_handle, int32_t batch,
                            const int32_t* type_ids, const int32_t* scales,
                            int32_t ncols) {
  return call_bridge("from_rows_from_handle", rows_handle, true, batch,
                     type_ids, scales, ncols);
}

// The reason the calling thread's last device call failed, "" if it did not.
// Valid until that thread's next device call.
const char* srjt_device_last_error() { return g_last_error.c_str(); }

// Set by the bridge when it catches an exception (the calling thread's).
void srjt_device_set_error(const char* msg) { g_last_error = msg ? msg : ""; }

}  // extern "C"
