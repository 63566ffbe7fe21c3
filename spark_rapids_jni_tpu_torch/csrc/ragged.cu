// Ragged <-> dense byte movement for the JCUDF string path, on Hopper.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (spark_rapids_jni_tpu/rowconv/ragged.py) and of the reference's
// warp-per-row string copies (copy_strings_to_rows,
// row_conversion.cu:827-875; copy_strings_from_rows, :1131-1174):
//
//   srjt_pack_rows       <- ragged._pack_call    (ragged.py:291)
//   srjt_unpack_rows     <- ragged._unpack_call  (ragged.py:417)
//   srjt_segmented_copy  <- ragged._segcopy_call (ragged.py:559)
//
// The TPU kernels stage 512-byte aligned windows in VMEM and place bytes
// with vector rolls and masks, because TPU lanes have no byte addressing.
// Hopper addresses bytes, so here one warp copies one row (or segment)
// straight from device memory to device memory.
//
// Bound: every kernel only moves bytes, so its least time on an H100 SXM is
// (bytes read once + bytes written once) / 3.35 TB/s.  The design meets
// that bound as far as its accesses coalesce: a warp moves 8 bytes a lane
// (256 bytes a step) wherever source and destination share their alignment
// modulo 8 (JCUDF rows start on 8-byte boundaries), and falls back to one
// byte a lane otherwise.  Rows and segments of a few dozen bytes leave most
// lanes of a step idle; more rows a warp, 16-byte moves and staging through
// shared memory are left for later work.
//
// Rules shared by the three: offsets arrive as device int64 arrays; index
// arithmetic is int64; a kernel allocates nothing and does not synchronise;
// it launches on the stream it is given; every entry returns
// cudaGetLastError() so the caller sees a refused launch.  Offsets that
// break a kernel's contract never make it read or write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
// 132 SMs x 8 resident blocks of 256 threads, four waves; warps stride over
// the rest
constexpr int64_t kMaxBlocks = 132 * 8 * 4;

inline unsigned grid_for(int64_t items) {
  int64_t blocks = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// One warp copies nbytes from src to dst.  Eight bytes a lane where the two
// pointers agree modulo 8, after a byte-wise head; one byte a lane otherwise.
__device__ __forceinline__ void warp_copy(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          int64_t nbytes, int lane) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  if (((d ^ s) & 7u) == 0) {
    int64_t head = static_cast<int64_t>((8u - (d & 7u)) & 7u);
    if (head > nbytes) head = nbytes;
    if (lane < head) dst[lane] = src[lane];
    const int64_t words = (nbytes - head) >> 3;
    const uint64_t* s8 = reinterpret_cast<const uint64_t*>(src + head);
    uint64_t* d8 = reinterpret_cast<uint64_t*>(dst + head);
    for (int64_t i = lane; i < words; i += kWarp) d8[i] = s8[i];
    const int64_t done = head + (words << 3);
    if (lane < nbytes - done) dst[done + lane] = src[done + lane];
  } else {
    for (int64_t i = lane; i < nbytes; i += kWarp) dst[i] = src[i];
  }
}

// One warp writes nbytes of zeros at dst, eight bytes a lane after the head.
__device__ __forceinline__ void warp_zero(uint8_t* __restrict__ dst,
                                          int64_t nbytes, int lane) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  int64_t head = static_cast<int64_t>((8u - (d & 7u)) & 7u);
  if (head > nbytes) head = nbytes;
  if (lane < head) dst[lane] = 0;
  const int64_t words = (nbytes - head) >> 3;
  uint64_t* d8 = reinterpret_cast<uint64_t*>(dst + head);
  for (int64_t i = lane; i < words; i += kWarp) d8[i] = 0;
  const int64_t done = head + (words << 3);
  if (lane < nbytes - done) dst[done + lane] = 0;
}

__device__ __forceinline__ int64_t first_warp() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t warp_stride() {
  return static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
}

// pack: row r's first offs[r+1]-offs[r] bytes of dense[r, :M] go to
// out[offs[r]:].  Contract: offs non-decreasing, offs[0] == 0,
// offs[n] == total.  Bytes of a row past M are written as zeros.
// Replaces ragged._pack_call (spark_rapids_jni_tpu/rowconv/ragged.py:291).
// Bound: (total payload read + 8(n+1) offsets + total written) / 3.35 TB/s.
// Rows are 8-byte aligned at both ends in JCUDF, so every row moves in
// 8-byte lanes; a row shorter than 256 bytes leaves lanes of its warp idle.
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const uint8_t* __restrict__ dense, int64_t n, int64_t M,
                 const int64_t* __restrict__ offs, uint8_t* __restrict__ out,
                 int64_t total) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int64_t r = first_warp(); r < n; r += warp_stride()) {
    const int64_t lo = offs[r];
    int64_t hi = offs[r + 1];
    if (hi > total) hi = total;
    if (lo < 0 || hi <= lo) continue;
    const int64_t size = hi - lo;
    const int64_t ncopy = size < M ? size : M;
    warp_copy(out + lo, dense + r * M, ncopy, lane);
    warp_zero(out + lo + ncopy, size - ncopy, lane);
  }
}

// unpack: out[r, :M] = flat[offs[r]:offs[r+1]] cut to M bytes (the prefix
// of a longer row), zero-padded.  Every byte of out is written.
// Replaces ragged._unpack_call (spark_rapids_jni_tpu/rowconv/ragged.py:417).
// Bound: (sum of min(size_r, M) read + 8(n+1) + n*M written) / 3.35 TB/s.
// With M not a multiple of 8 (the fixed region of JCUDF rows) source and
// destination disagree modulo 8 on most rows, which then move a byte a
// lane: the main gap to the bound.
__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const uint8_t* __restrict__ flat, int64_t flat_size,
                   const int64_t* __restrict__ offs, int64_t n, int64_t M,
                   uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int64_t r = first_warp(); r < n; r += warp_stride()) {
    const int64_t lo = offs[r];
    int64_t hi = offs[r + 1];
    if (hi > flat_size) hi = flat_size;
    int64_t ncopy = (lo < 0 || hi <= lo) ? 0 : hi - lo;
    if (ncopy > M) ncopy = M;
    uint8_t* row = out + r * M;
    if (ncopy > 0) warp_copy(row, flat + lo, ncopy, lane);
    warp_zero(row + ncopy, M - ncopy, lane);
  }
}

// segmented copy: dst[dst_offs[k]:+sizes[k]] = src[src_offs[k]:+sizes[k]].
// The caller zero-fills dst; destination segments must not overlap.
// Replaces ragged._segcopy_call (spark_rapids_jni_tpu/rowconv/ragged.py:559).
// Bound: (sum of sizes read + 24k metadata + dst_size written) / 3.35 TB/s.
// Segments are strings of a few dozen bytes at byte-granular offsets: a
// warp a segment keeps most lanes idle, the main gap to the bound.
__global__ void __launch_bounds__(kThreads)
segmented_copy_kernel(const uint8_t* __restrict__ src, int64_t src_size,
                      const int64_t* __restrict__ src_offs,
                      const int64_t* __restrict__ dst_offs,
                      const int64_t* __restrict__ sizes, int64_t k,
                      uint8_t* __restrict__ dst, int64_t dst_size) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int64_t s = first_warp(); s < k; s += warp_stride()) {
    const int64_t so = src_offs[s];
    const int64_t d = dst_offs[s];
    if (so < 0 || d < 0) continue;
    int64_t len = sizes[s];
    if (len > src_size - so) len = src_size - so;
    if (len > dst_size - d) len = dst_size - d;
    if (len <= 0) continue;
    warp_copy(dst + d, src + so, len, lane);
  }
}

}  // namespace

extern "C" {

int srjt_pack_rows(const void* dense, int64_t n, int64_t M, const void* offs,
                   void* out, int64_t total, void* stream) {
  if (n > 0 && total > 0) {
    pack_rows_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dense), n, M,
        static_cast<const int64_t*>(offs), static_cast<uint8_t*>(out), total);
  }
  return static_cast<int>(cudaGetLastError());
}

int srjt_unpack_rows(const void* flat, int64_t flat_size, const void* offs,
                     int64_t n, int64_t M, void* out, void* stream) {
  if (n > 0 && M > 0) {
    unpack_rows_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), flat_size,
        static_cast<const int64_t*>(offs), n, M, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int srjt_segmented_copy(const void* src, int64_t src_size,
                        const void* src_offs, const void* dst_offs,
                        const void* sizes, int64_t k, void* dst,
                        int64_t dst_size, void* stream) {
  if (k > 0 && dst_size > 0 && src_size > 0) {
    segmented_copy_kernel<<<grid_for(k), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_size,
        static_cast<const int64_t*>(src_offs),
        static_cast<const int64_t*>(dst_offs),
        static_cast<const int64_t*>(sizes), k, static_cast<uint8_t*>(dst),
        dst_size);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
