// Slots: the fixed region of JCUDF rows, columns <-> rows, on Hopper.
//
//   srjt_pack_slots    (B8) every column's value into its slot of each row,
//                      the validity bits, zeros in the gaps and the padding
//   srjt_unpack_slots  (B9) the inverse: each column's values out of the
//                      rows, contiguous, and its validity as bool bytes
//
// No TPU kernel stands behind them: the JAX package writes and reads the
// slots in plain XLA (rowconv/convert.py _to_rows_fixed_full /
// _from_rows_fixed_full).  The port did the same with torch ops: one
// strided byte copy a column each way, the validity through stacked bool
// vectors and eight shift/or passes, and a zero fill of the rows first:
// about a dozen passes over data that needs one read and one write, each
// copy a byte an element.
//
// Design: the reference's tile transpose (row_conversion.cu:575-693).  A
// CTA takes a tile of consecutive rows whose row image fits in shared
// memory (about kTileBytes; a row is at most MAX_ROW_SIZE = 1,024 bytes).
//   B8: cp.async brings the tile's slice of every column and validity
//       vector into shared memory, all loads in flight at once (each
//       slice is contiguous in device memory: coalesced 16-byte loads);
//       the CTA zeroes the row image, places each value at its slot (in
//       the widest unit the alignments allow) and composes the validity
//       bytes (a column without validity has every bit set: no tensor of
//       ones), then stores the image.  Where the rows are one contiguous
//       span (the fixed-width path: rows back to back) that is R x width
//       bytes in 16-byte stores; else (the string path's row matrix, whose
//       rows are M apart) each row's bytes in 16-byte stores where the row
//       starts allow.  An image whose rows would all start on one shared
//       memory bank (a width that is a multiple of 32 bytes) takes a
//       padded pitch instead, an odd multiple of 16 bytes, and goes out
//       row by row: the slot stores of a warp, one a row, then fall on 8
//       banks and not on one (the string path's 114-byte fixed region of
//       TPC-H lineitem, at a pitch of 128, wrote 32 to a bank).
//   B9: cp.async brings the tile's rows (one contiguous span, or each
//       row at a padded pitch as above) into shared memory; each column's
//       values and each validity bit go out from there, consecutive
//       threads on consecutive rows, so every store of a warp lands in one
//       contiguous range.
// Column descriptors travel by value in the kernel's parameters (at most
// kMaxCols columns a launch, so that the block stays under 4 KB), so a
// launch uploads nothing and a CUDA graph can capture it.  A table of more
// columns takes one launch a group of kMaxCols (a multiple of 8): each
// launch owns its columns' slots, its validity bytes and, for the last
// group, the padding, and writes only those bytes of each row.
//
// Bound: the kernels only move bytes, so the least time on an H100 SXM is
// (column bytes + validity bytes + row bytes, each read or written once) /
// 3.35 TB/s.  B9 writes a bool byte a value of validity, as its callers
// store it.
//
// Rules (as in ragged.cu): index arithmetic is int64 where it addresses
// device memory (int inside a CTA's shared buffers); the kernels allocate
// nothing and do not synchronise; they launch on the stream they are
// given; each entry returns cudaGetLastError().  A source slice is read by
// aligned 16-byte loads, each holding at least one byte of the slice, so
// none touches a page the slice does not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 128;          // columns a launch (slots.py)
constexpr int kTileBytes = 16 * 1024;  // row image a CTA, about
constexpr int kWideTileBytes = 32 * 1024;  // at most, for a row a thread
constexpr int kMinRows = 16;           // rows a CTA: a multiple of 16
constexpr int kMaxRows = 2048;
constexpr int kChunk = 16;
constexpr int kStaticSmem = 48 * 1024;

// The columns of one launch.  B8 reads data[c] (payload) and valid[c]
// (bool [n], 0 for a column without nulls); B9 writes them.
struct Columns {
  uint64_t data[kMaxCols];
  uint64_t valid[kMaxCols];
  int32_t stage[kMaxCols];   // B8: the payload slice's place in shared
  int32_t vstage[kMaxCols];  // B8: the validity slice's place
  int16_t start[kMaxCols];   // the slot's first byte in the row
  int8_t width[kMaxCols];    // 1, 2, 4, 8 or 16
};

struct Geometry {
  int64_t n;           // rows
  int64_t row_stride;  // bytes from a row to the next in device memory
  int ncols;           // columns of this launch
  int width;           // bytes of a row the launch spans
  int pitch;           // bytes of a row in the shared image
  int tile;            // rows a CTA
  int vo;              // the launch's first validity byte in the row
  int nvb;             // its validity bytes
  int own[4];          // B8: it writes bytes [own0, own1), [own2, own3)
  int span;            // B8: rows back to back and every byte owned
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// The widest power of two, at most 16, that divides x.
__device__ __forceinline__ int unit_of(uint64_t x) {
  x |= kChunk;
  return static_cast<int>(x & (~x + 1));
}

// Device bytes [addr, addr + len) into shared memory at dst + (addr % 16),
// by the whole CTA in aligned 16-byte chunks.
__device__ __forceinline__ void stage_slice(uint8_t* dst, uint64_t addr,
                                            int64_t len) {
  const uint64_t a0 = addr & ~uint64_t{15};
  const int chunks = static_cast<int>((addr + len - a0 + 15) >> 4);
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    cp_async16(dst + kChunk * k,
               reinterpret_cast<const void*>(a0 + uint64_t{16} * k));
  }
}

// How a CTA's threads cover (column, row) items: thread t takes row
// i0 + k * step of items cc, cc + cpar, ...  With at least kThreads rows
// every thread takes a row of every item; with fewer, the threads split
// into cpar groups of `rows` threads, a group an item at a time, so that
// a tile of wide rows keeps every thread busy.
struct Lanes {
  int cc, cpar, i0, step;
  __device__ explicit Lanes(int rows) {
    step = rows < kThreads ? rows : kThreads;
    cpar = kThreads / step;
    cc = static_cast<int>(threadIdx.x) / step;
    i0 = static_cast<int>(threadIdx.x) - cc * step;
    if (cc >= cpar) cc = 1 << 30;     // the threads past the last group
  }
};

// Values of len bytes: value i from src + i * ss to dst + i * ds, for rows
// i0, i0 + step, ... below rows, T at a time.
template <typename T>
__device__ __forceinline__ void move_as(uint8_t* dst, int64_t ds,
                                        const uint8_t* src, int ss, int len,
                                        int i0, int step, int rows) {
  for (int i = i0; i < rows; i += step) {
    const uint8_t* a = src + i * ss;
    uint8_t* b = dst + i * ds;
    for (int k = 0; k < len; k += static_cast<int>(sizeof(T))) {
      *reinterpret_cast<T*>(b + k) = *reinterpret_cast<const T*>(a + k);
    }
  }
}

// The same in the widest unit that divides len, both strides and both
// addresses.
__device__ __forceinline__ void move_values(uint8_t* dst, int64_t ds,
                                            const uint8_t* src, int ss,
                                            int len, int i0, int step,
                                            int rows) {
  switch (unit_of(reinterpret_cast<uint64_t>(dst) |
                  reinterpret_cast<uint64_t>(src) |
                  static_cast<uint64_t>(ds) | static_cast<uint64_t>(ss) |
                  static_cast<uint64_t>(len))) {
    case 16: move_as<uint4>(dst, ds, src, ss, len, i0, step, rows); break;
    case 8: move_as<uint64_t>(dst, ds, src, ss, len, i0, step, rows); break;
    case 4: move_as<uint32_t>(dst, ds, src, ss, len, i0, step, rows); break;
    case 2: move_as<uint16_t>(dst, ds, src, ss, len, i0, step, rows); break;
    default: move_as<uint8_t>(dst, ds, src, ss, len, i0, step, rows);
  }
}

// The len (1, 2, 4, 8 or 16) bytes at s, read T at a time, as a uint4.
template <typename T>
__device__ __forceinline__ uint4 gather_value(const uint8_t* s, int len) {
  if constexpr (sizeof(T) == 16) {
    return *reinterpret_cast<const uint4*>(s);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; k += static_cast<int>(sizeof(T))) {
      if (k < len) {
        const T v = *reinterpret_cast<const T*>(s + k);
        if constexpr (sizeof(T) == 8) {
          w[k / 4] = static_cast<uint32_t>(v);
          w[k / 4 + 1] = static_cast<uint32_t>(v >> 32);
        } else {
          w[k / 4] |= static_cast<uint32_t>(v) << (8 * (k % 4));
        }
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The first len bytes of v at d, one store (d aligned to len).
__device__ __forceinline__ void store_value(uint8_t* d, const uint4& v,
                                            int len) {
  switch (len) {
    case 16: *reinterpret_cast<uint4*>(d) = v; break;
    case 8: *reinterpret_cast<uint2*>(d) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(d) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(d) = static_cast<uint16_t>(v.x); break;
    default: *d = static_cast<uint8_t>(v.x);
  }
}

// B9's values: value i of len bytes from src + i * ss (shared, read T at a
// time) to dst + i * len (device memory, one store a value).
template <typename T>
__device__ __forceinline__ void unpack_as(uint8_t* dst, const uint8_t* src,
                                          int ss, int len, int i0, int step,
                                          int rows) {
  for (int i = i0; i < rows; i += step) {
    store_value(dst + i * len, gather_value<T>(src + i * ss, len), len);
  }
}

// dst[0, len) = src[0, len) by the whole CTA; src is 16-aligned shared.
template <typename T>
__device__ __forceinline__ void store_span_as(uint8_t* dst, const uint8_t* src,
                                              int len) {
  constexpr int U = static_cast<int>(sizeof(T));
  const int body = len / U;
  for (int k = threadIdx.x; k < body; k += kThreads) {
    reinterpret_cast<T*>(dst)[k] = reinterpret_cast<const T*>(src)[k];
  }
  for (int b = body * U + threadIdx.x; b < len; b += kThreads) dst[b] = src[b];
}

__device__ __forceinline__ void store_span(uint8_t* dst, const uint8_t* src,
                                           int len) {
  switch (unit_of(reinterpret_cast<uint64_t>(dst))) {
    case 16: store_span_as<uint4>(dst, src, len); break;
    case 8: store_span_as<uint64_t>(dst, src, len); break;
    case 4: store_span_as<uint32_t>(dst, src, len); break;
    case 2: store_span_as<uint16_t>(dst, src, len); break;
    default: store_span_as<uint8_t>(dst, src, len);
  }
}

// Bytes [lo, hi) of each of the tile's rows from the image to device
// memory, in units as wide as the row starts allow.
__device__ __forceinline__ void store_rows(uint8_t* out, int64_t r0, int rows,
                                           int64_t row_stride, int pitch,
                                           int lo, int hi,
                                           const uint8_t* img) {
  const int len = hi - lo;
  const int u = unit_of(reinterpret_cast<uint64_t>(out) |
                        static_cast<uint64_t>(row_stride) |
                        static_cast<uint64_t>(lo));
  const int per = (len + u - 1) / u;
  for (int k = threadIdx.x; k < rows * per; k += kThreads) {
    const int i = k / per;
    const int q = (k - i * per) * u;
    uint8_t* d = out + (r0 + i) * row_stride + lo + q;
    const uint8_t* s = img + i * pitch + lo + q;
    if (q + u <= len) {
      switch (u) {
        case 16: *reinterpret_cast<uint4*>(d) =
                     *reinterpret_cast<const uint4*>(s); break;
        case 8: *reinterpret_cast<uint64_t*>(d) =
                    *reinterpret_cast<const uint64_t*>(s); break;
        case 4: *reinterpret_cast<uint32_t*>(d) =
                    *reinterpret_cast<const uint32_t*>(s); break;
        case 2: *reinterpret_cast<uint16_t*>(d) =
                    *reinterpret_cast<const uint16_t*>(s); break;
        default: *d = *s;
      }
    } else {
      for (int b = 0; b < len - q; ++b) d[b] = s[b];
    }
  }
}

// B8: the fixed region [0, width) of rows [r0, r0 + tile) of out, and,
// where offsets is given, those rows' byte offsets (the last CTA also
// offsets[n]).
__global__ void __launch_bounds__(kThreads)
pack_slots_kernel(const __grid_constant__ Columns cols, const Geometry g,
                  uint8_t* __restrict__ out, int32_t* __restrict__ offsets) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * g.tile;
  const int rows = static_cast<int>(g.n - r0 < g.tile ? g.n - r0 : g.tile);
  uint8_t* img = smem;
  if (offsets != nullptr) {
    for (int i = threadIdx.x; i <= rows; i += kThreads) {
      if (i < rows || r0 + rows == g.n) {
        offsets[r0 + i] = static_cast<int32_t>((r0 + i) * g.row_stride);
      }
    }
  }
  for (int c = 0; c < g.ncols; ++c) {
    const int w = cols.width[c];
    stage_slice(smem + cols.stage[c], cols.data[c] + r0 * w,
                static_cast<int64_t>(rows) * w);
    if (cols.valid[c]) {
      stage_slice(smem + cols.vstage[c], cols.valid[c] + r0, rows);
    }
  }
  // zeros under the whole image: the gaps between slots and the padding
  const int img_chunks = (rows * g.pitch + kChunk - 1) / kChunk;
  for (int k = threadIdx.x; k < img_chunks; k += kThreads) {
    reinterpret_cast<uint4*>(img)[k] = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // every value into its slot, consecutive threads on consecutive rows
  const Lanes l(rows);
  for (int c = l.cc; c < g.ncols; c += l.cpar) {
    const int w = cols.width[c];
    move_values(img + cols.start[c], g.pitch,
                smem + cols.stage[c] + static_cast<int>(cols.data[c] & 15),
                w, w, l.i0, l.step, rows);
  }
  // the validity bytes: bit b of byte j is column 8j + b of the launch
  for (int j = l.cc; j < g.nvb; j += l.cpar) {
    for (int i = l.i0; i < rows; i += l.step) {
      unsigned byte = 0;
      for (int b = 0; b < 8 && 8 * j + b < g.ncols; ++b) {
        const int c = 8 * j + b;
        const unsigned bit =
            cols.valid[c]
                ? smem[cols.vstage[c] + static_cast<int>(cols.valid[c] & 15) +
                       i] != 0
                : 1u;
        byte |= bit << b;
      }
      img[i * g.pitch + g.vo + j] = static_cast<uint8_t>(byte);
    }
  }
  __syncthreads();

  if (g.span) {
    store_span(out + r0 * g.width, img, rows * g.width);
  } else {
    for (int r = 0; r < 4; r += 2) {
      if (g.own[r] < g.own[r + 1]) {
        store_rows(out, r0, rows, g.row_stride, g.pitch, g.own[r],
                   g.own[r + 1], img);
      }
    }
  }
}

// B9: the columns of rows [r0, r0 + tile); rows are width bytes apart.
__global__ void __launch_bounds__(kThreads)
unpack_slots_kernel(const __grid_constant__ Columns cols, const Geometry g,
                    const uint8_t* __restrict__ rows_in) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * g.tile;
  const int rows = static_cast<int>(g.n - r0 < g.tile ? g.n - r0 : g.tile);
  const uint64_t a = reinterpret_cast<uint64_t>(rows_in) + r0 * g.width;
  int shift = 0;
  if (g.span) {
    stage_slice(smem, a, static_cast<int64_t>(rows) * g.width);
    shift = static_cast<int>(a & 15);
  } else {
    // 16-aligned rows of a multiple of 16 bytes, each to its padded row
    const int per = g.width / kChunk;
    for (int k = threadIdx.x; k < rows * per; k += kThreads) {
      const int i = k / per;
      const int q = k - i * per;
      cp_async16(smem + i * g.pitch + kChunk * q,
                 reinterpret_cast<const void*>(a + static_cast<uint64_t>(i) *
                                                   g.width + kChunk * q));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const Lanes l(rows);
  for (int c = l.cc; c < g.ncols; c += l.cpar) {
    const int w = cols.width[c];
    uint8_t* dst = reinterpret_cast<uint8_t*>(cols.data[c]) + r0 * w;
    const uint8_t* src = smem + shift + cols.start[c];
    const int p = g.pitch;
    switch (unit_of(reinterpret_cast<uint64_t>(src) |
                    static_cast<uint64_t>(p | w))) {
      case 16: unpack_as<uint4>(dst, src, p, w, l.i0, l.step, rows); break;
      case 8: unpack_as<uint64_t>(dst, src, p, w, l.i0, l.step, rows); break;
      case 4: unpack_as<uint32_t>(dst, src, p, w, l.i0, l.step, rows); break;
      case 2: unpack_as<uint16_t>(dst, src, p, w, l.i0, l.step, rows); break;
      default: unpack_as<uint8_t>(dst, src, p, w, l.i0, l.step, rows);
    }
  }
  for (int c = l.cc; c < g.ncols; c += l.cpar) {
    uint8_t* v = reinterpret_cast<uint8_t*>(cols.valid[c]) + r0;
    const uint8_t* s = smem + shift + g.vo + (c >> 3);
    for (int i = l.i0; i < rows; i += l.step) {
      v[i] = static_cast<uint8_t>((s[i * g.pitch] >> (c & 7)) & 1);
    }
  }
}

int round16(int64_t x) { return static_cast<int>((x + 15) / 16 * 16); }

// A shared-memory row pitch for rows of `width` bytes: 16-aligned (the
// image goes out in 16-byte units) and an odd multiple of 16, so that a
// warp's stores down a column spread over 8 banks.
int padded_pitch(int width) {
  const int p = round16(width);
  return p % 32 == 0 ? p + kChunk : p;
}

// Rows a CTA for rows of `pitch` bytes in shared memory: kTileBytes of
// them, and at least a row a thread where kWideTileBytes allow (the
// string path's rows of about 128 bytes ran 12-15 % faster so on the
// H100, PERF.md).
int tile_rows(int pitch) {
  int rows = kTileBytes / pitch / kMinRows * kMinRows;
  const int wide = kWideTileBytes / pitch / kMinRows * kMinRows;
  if (rows < kThreads) rows = wide < kThreads ? wide : kThreads;
  if (rows < kMinRows) rows = kMinRows;
  if (rows > kMaxRows) rows = kMaxRows;
  return rows;
}

// desc: 4 int64 a column, (data, valid, slot start, width).
bool read_columns(const int64_t* desc, int ncols, Columns& cols) {
  if (ncols < 1 || ncols > kMaxCols) return false;
  for (int c = 0; c < ncols; ++c) {
    const int64_t w = desc[4 * c + 3];
    if (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) return false;
    cols.data[c] = static_cast<uint64_t>(desc[4 * c]);
    cols.valid[c] = static_cast<uint64_t>(desc[4 * c + 1]);
    cols.start[c] = static_cast<int16_t>(desc[4 * c + 2]);
    cols.width[c] = static_cast<int8_t>(w);
  }
  return true;
}

}  // namespace

extern "C" {

// B8.  Writes bytes [own0, own1) and [own2, own3) of [0, width) of each of
// n rows at out, row_stride apart: columns desc's values at their slots,
// their validity bytes from row byte vo on (nvb of them), zeros elsewhere;
// and, unless offsets is null, int32 offsets[r] = r * row_stride for r in
// [0, n] (the caller keeps n * row_stride below 2**31).
int srjt_pack_slots(const int64_t* desc, int ncols, int64_t n, int width,
                    int64_t row_stride, int vo, int nvb, int own0, int own1,
                    int own2, int own3, void* out, void* offsets,
                    void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  Columns cols;
  Geometry g;
  if (!read_columns(desc, ncols, cols) || row_stride < width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.n = n;
  g.row_stride = row_stride;
  g.ncols = ncols;
  g.width = width;
  g.vo = vo;
  g.nvb = nvb;
  if (own1 == own2) {            // one range: [own0, own3)
    own1 = own3;
    own2 = own3 = 0;
  }
  g.own[0] = own0;
  g.own[1] = own1;
  g.own[2] = own2;
  g.own[3] = own3;
  // the image is the output span only where its rows do not all start on
  // one shared-memory bank (width a multiple of 32 bytes puts 8 or more
  // of a warp's slot stores on a bank); else rows of a padded pitch
  g.span = own0 == 0 && own1 == width && own2 == own3 &&
           row_stride == width && width % 32 != 0;
  g.pitch = g.span ? width : padded_pitch(width);
  g.tile = tile_rows(g.pitch);
  int smem = round16(static_cast<int64_t>(g.tile) * g.pitch);
  for (int c = 0; c < ncols; ++c) {
    cols.stage[c] = smem;
    smem += round16(static_cast<int64_t>(g.tile) * cols.width[c]) + kChunk;
  }
  for (int c = 0; c < ncols; ++c) {
    cols.vstage[c] = smem;
    if (cols.valid[c]) smem += round16(g.tile) + kChunk;
  }
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((n + g.tile - 1) / g.tile);
  pack_slots_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cols, g, static_cast<uint8_t*>(out), static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// B9.  Reads n rows of `width` bytes back to back at rows: columns desc's
// values from their slots into data (contiguous, width bytes a value), and
// bit (c % 8) of row byte vo + c / 8 into valid[c] as a bool byte.
int srjt_unpack_slots(const int64_t* desc, int ncols, int64_t n, int width,
                      int vo, const void* rows, void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  Columns cols;
  Geometry g;
  if (!read_columns(desc, ncols, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.n = n;
  g.row_stride = width;
  g.ncols = ncols;
  g.width = width;
  // rows back to back in shared memory, or at a padded pitch where the
  // width would put every row on one bank (16-aligned rows only)
  g.pitch = width % 32 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0
                ? padded_pitch(width) : width;
  g.vo = vo;
  g.nvb = (ncols + 7) / 8;
  g.tile = tile_rows(g.pitch);
  g.span = g.pitch == width;
  for (int k = 0; k < 4; ++k) g.own[k] = 0;
  const int smem = round16(static_cast<int64_t>(g.tile) * g.pitch) + kChunk;
  const unsigned blocks = static_cast<unsigned>((n + g.tile - 1) / g.tile);
  unpack_slots_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      cols, g, static_cast<const uint8_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
