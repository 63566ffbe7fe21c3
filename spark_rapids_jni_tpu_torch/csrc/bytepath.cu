// Byte-path kernels of the device Parquet scan, on Hopper.
//
// Three kernels, each the counterpart of one Pallas kernel of the JAX
// package (spark_rapids_jni_tpu/rowconv/xpallas.py):
//
//   srjt_extract_rows  <- xpallas._extract_call   (xpallas.py:312)
//   srjt_gather_rows   <- xpallas._gather_call    (xpallas.py:405)
//   srjt_u8_to_u32     <- xpallas._transpose_call (xpallas.py:486)
//
// The TPU kernels stage 512-byte windows and whole row blocks in VMEM,
// place bytes with vector rolls and masks, and bucket their static shapes
// against Mosaic compiles.  None of that carries over: Hopper addresses
// bytes, so each kernel here is one thread per output word (or 16-byte
// vector), reading device memory and writing device memory once.
//
// Bound: every kernel only moves bytes, so its least time on an H100 SXM is
// (bytes read once + bytes written once) / 3.35 TB/s.
//
// Rules shared by the three (as in ragged.cu): index arithmetic is int64; a
// kernel allocates nothing and does not synchronise; it launches on the
// stream it is given; every entry returns cudaGetLastError() so the caller
// sees a refused launch.  Arguments that break a kernel's contract never
// make it read or write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads, four waves; threads stride
// over the rest
constexpr int64_t kMaxBlocks = 132 * 8 * 4;

inline unsigned grid_for(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ int64_t first_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t thread_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// extract: out[r, w] holds bytes 4w..4w+3 of row r, the row being
// flat[offs[r]:offs[r+1]] cut to its first M bytes and zero-padded to
// Mw = ceil(M/4) words, little-endian.  Every word of out is written.
// Replaces xpallas._extract_call (spark_rapids_jni_tpu/rowconv/xpallas.py:312).
// Bound: (sum of min(size_r, M) read + 8(D+1) offsets + 4·D·Mw written)
// / 3.35 TB/s.  Dictionary entries are a few bytes, so one thread makes one
// output word: a warp covers 32 words of consecutive rows and no lane idles
// on a short row, which a warp per row (unpack_rows_kernel) would.
__global__ void __launch_bounds__(kThreads)
extract_rows_kernel(const uint8_t* __restrict__ flat, int64_t flat_size,
                    const int64_t* __restrict__ offs, int64_t D, int64_t M,
                    int64_t Mw, uint32_t* __restrict__ out) {
  const int64_t total = D * Mw;
  for (int64_t i = first_thread(); i < total; i += thread_stride()) {
    const int64_t r = i / Mw;
    const int64_t b0 = (i - r * Mw) * 4;
    const int64_t lo = offs[r];
    int64_t hi = offs[r + 1];
    if (hi > flat_size) hi = flat_size;
    int64_t len = (lo < 0 || hi <= lo) ? 0 : hi - lo;
    if (len > M) len = M;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (b0 + k < len) word |= static_cast<uint32_t>(flat[lo + b0 + k]) << (8 * k);
    }
    out[i] = word;
  }
}

// gather: out[i, :] = mat[idx[i], :] over rows of W 32-bit words.  Rows move
// as 16-byte vectors when W is a multiple of 4 and both matrices are
// 16-byte aligned, else word by word.  The wrapper checks idx against D;
// an index outside [0, D) writes a zero row here rather than read out of
// bounds.
// Replaces xpallas._gather_call (spark_rapids_jni_tpu/rowconv/xpallas.py:405).
// Bound: (4n index bytes + 4·n·W read + 4·n·W written) / 3.35 TB/s (each
// gathered row counted as read once; a small dictionary stays in L2).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ mat, int64_t D, int64_t W,
                   const int32_t* __restrict__ idx, int64_t n,
                   V* __restrict__ out) {
  const int64_t total = n * W;
  for (int64_t i = first_thread(); i < total; i += thread_stride()) {
    const int64_t r = i / W;
    const int64_t c = i - r * W;
    const int64_t src = idx[r];
    if (src >= 0 && src < D) {
      out[i] = mat[src * W + c];
    } else {
      out[i] = V{};
    }
  }
}

// u8 -> u32: out[i] = bytes src[4i..4i+3] as one little-endian word, for a
// source at any byte address.  Each thread reads the aligned word holding
// its first byte and, unless the source is aligned, the next one, and
// joins them with a funnel shift.  Aligned 4-byte loads keep a warp's reads
// to 128 contiguous bytes plus one word, where byte loads would issue four
// load instructions a word; a word that holds no byte of the source is
// never read.
// Replaces xpallas._transpose_call
// (spark_rapids_jni_tpu/rowconv/xpallas.py:486).
// Bound: (4N read + 4N written) / 3.35 TB/s.
__global__ void __launch_bounds__(kThreads)
u8_to_u32_kernel(const uint8_t* __restrict__ src, int64_t n_words,
                 uint32_t* __restrict__ out) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const unsigned shift = static_cast<unsigned>(addr & 3u) * 8u;
  const uint32_t* aligned = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  for (int64_t i = first_thread(); i < n_words; i += thread_stride()) {
    const uint32_t lo = aligned[i];
    if (shift == 0) {
      out[i] = lo;
    } else {
      out[i] = __funnelshift_r(lo, aligned[i + 1], shift);
    }
  }
}

}  // namespace

extern "C" {

int srjt_extract_rows(const void* flat, int64_t flat_size, const void* offs,
                      int64_t D, int64_t M, int64_t Mw, void* out,
                      void* stream) {
  if (D > 0 && Mw > 0) {
    extract_rows_kernel<<<grid_for(D * Mw), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), flat_size,
        static_cast<const int64_t*>(offs), D, M, Mw,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int srjt_gather_rows(const void* mat, int64_t D, int64_t W, const void* idx,
                     int64_t n, void* out, void* stream) {
  if (n > 0 && W > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (W % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(mat) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (vec) {
      const int64_t Wv = W / 4;
      gather_rows_kernel<uint4><<<grid_for(n * Wv), kThreads, 0, s>>>(
          static_cast<const uint4*>(mat), D, Wv,
          static_cast<const int32_t*>(idx), n, static_cast<uint4*>(out));
    } else {
      gather_rows_kernel<uint32_t><<<grid_for(n * W), kThreads, 0, s>>>(
          static_cast<const uint32_t*>(mat), D, W,
          static_cast<const int32_t*>(idx), n, static_cast<uint32_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int srjt_u8_to_u32(const void* src, int64_t n_words, void* out, void* stream) {
  if (n_words > 0) {
    u8_to_u32_kernel<<<grid_for(n_words), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), n_words,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
