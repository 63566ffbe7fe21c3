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
// Hopper addresses bytes, so none of that carries over.
//
// Bound: every kernel only moves bytes, so its least time on an H100 SXM is
// (bytes read once + bytes written once) / 3.35 TB/s.
//
// Pack (B2) takes its rows in fixed runs: its rows are dictionary strings
// of a few bytes at byte offsets (DictColumn materialize hands it
// millions), where a warp a row kept most lanes idle behind two dependent
// offset loads.  One CTA takes a run of consecutive rows, brings their
// offsets and bytes into shared memory with all loads in flight at once,
// builds its output range there and stores it in 16-byte chunks.
//
// Unpack (B3) and the segmented copy (B4) still copy one row (or segment)
// a warp straight from device memory to device memory: 8 bytes a lane
// (256 bytes a step) wherever source and destination share their
// alignment modulo 8 (JCUDF rows start on 8-byte boundaries), one byte a
// lane otherwise.  Rows and segments of a few dozen bytes leave most lanes
// of a step idle; their redesign is later work.
//
// Rules shared by the three: offsets arrive as device int64 arrays; index
// arithmetic is int64 (int only inside a CTA's shared buffers); a kernel
// allocates nothing and does not synchronise; it launches on the stream it
// is given; every entry returns cudaGetLastError() so the caller sees a
// refused launch.  Offsets that break a kernel's contract never make it
// read or write out of bounds.

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
// Rows of a few bytes at a stride of M read a whole 32-byte sector each,
// so a real floor lies above that bound (PERF.md).
//
// One CTA packs `rows` consecutive rows (rows * M at most kPackTile bytes:
// 512 rows of SF1's l_shipinstruct at M = 32), so it knows its inputs from
// its index alone and every load it needs is in flight at once, with no
// block -> row table and no search: cp.async brings the rows' offsets and,
// when rows are whole 16-byte chunks (M a multiple of 16 and dense
// 16-aligned, as materialize pads them), the rows themselves into shared
// memory.  The CTA then scatters the rows' bytes into its output range
// [offs[r0], offs[r0 + rows]), built in shared memory from the 16-byte
// boundary below its start, 2^log_tpr threads a row and 16 bytes at a time,
// and stores it: whole 16-byte chunks as one store each, the partial chunk
// at either end byte by byte (the neighbouring CTA writes the other bytes
// of those chunks).  A range longer than rows * M + 16 bytes (rows longer
// than M, whose tails are zeros, or offsets that break the contract) is
// written straight to device memory instead, the whole CTA on one row at a
// time.
constexpr int kPackThreads = 256;
constexpr int64_t kPackTile = 16 * 1024;
constexpr int kPackMaxRows = 1024;
constexpr int64_t kPackOut = kPackTile + 16;
constexpr int kChunk = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// The 16 bytes at src[j0, j0 + 16): one load where the chunk is whole and
// 16-aligned, else byte by byte up to len.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* src, int64_t j0,
                                            int64_t len, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(src + j0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (j0 + k < len) {
      w[k / 4] |= static_cast<uint32_t>(src[j0 + k]) << (8 * (k % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint8_t byte_of(const uint4& v, int k) {
  const uint32_t w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
  return static_cast<uint8_t>(w >> (8 * (k % 4)));
}

__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(const uint8_t* __restrict__ dense, int64_t n, int64_t M,
                 const int64_t* __restrict__ offs, int64_t per_cta,
                 int log_tpr, uint8_t* __restrict__ out, int64_t total) {
  __shared__ int64_t s_offs[kPackMaxRows + 1];
  __shared__ __align__(16) uint8_t s_tile[kPackTile];
  __shared__ __align__(16) uint8_t s_out[kPackOut];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int64_t rows = n - r0 < per_cta ? n - r0 : per_cta;
  const uint8_t* src = dense + r0 * M;
  const bool vec = M % kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(dense) % 16 == 0;
  const bool tiled = vec && rows * M <= kPackTile;
  for (int64_t i = threadIdx.x; i <= rows; i += kPackThreads) {
    cp_async8(s_offs + i, offs + r0 + i);
  }
  if (tiled) {
    for (int64_t v = threadIdx.x; v < rows * M / kChunk; v += kPackThreads) {
      cp_async16(s_tile + v * kChunk, src + v * kChunk);
    }
  }
  for (int64_t v = threadIdx.x; v < kPackOut / kChunk; v += kPackThreads) {
    reinterpret_cast<uint4*>(s_out)[v] = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int tpr = 1 << log_tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t o0 = s_offs[0];
  const int64_t o1 = s_offs[rows];
  const int64_t a0 = o0 & ~int64_t{15};
  const int64_t span = o1 - a0;
  if (o0 >= 0 && o0 <= o1 && o1 <= total && span <= kPackOut) {
    // scatter into s_out: row i's byte j goes to s_out[offs[i] - a0 + j]
    const uint8_t* rows_src = tiled ? s_tile : src;
    for (int64_t i = threadIdx.x >> log_tpr; i < rows;
         i += kPackThreads >> log_tpr) {
      const int64_t at = s_offs[i] - a0;
      const int64_t size = s_offs[i + 1] - s_offs[i];
      const int64_t len64 = size < M ? size : M;
      if (at < 0 || len64 <= 0 || at + len64 > span) continue;
      const int start = static_cast<int>(at);
      const int len = static_cast<int>(len64);
      const uint8_t* row = rows_src + i * M;
      for (int j0 = lane * kChunk; j0 < len; j0 += tpr * kChunk) {
        const uint4 v = load_chunk(row, j0, len, vec);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (j0 + k < len) s_out[start + j0 + k] = byte_of(v, k);
        }
      }
    }
    __syncthreads();
    for (int64_t q = a0 + threadIdx.x * kChunk; q < o1;
         q += kPackThreads * kChunk) {
      const uint8_t* b = s_out + (q - a0);
      if (q >= o0 && q + kChunk <= o1 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0) {
        *reinterpret_cast<uint4*>(out + q) = *reinterpret_cast<const uint4*>(b);
      } else {
        for (int k = 0; k < kChunk; ++k) {
          if (q + k >= o0 && q + k < o1) out[q + k] = b[k];
        }
      }
    }
    return;
  }
  // straight to device memory, one row at a time: its bytes (zeros past M)
  // in 16-byte chunks of out, whole chunks as one store
  for (int64_t i = 0; i < rows; ++i) {
    int64_t lo = s_offs[i];
    int64_t hi = s_offs[i + 1];
    if (lo < 0) lo = 0;
    if (hi > total) hi = total;
    const uint8_t* row = src + i * M;
    for (int64_t q = (lo & ~int64_t{15}) + threadIdx.x * kChunk; q < hi;
         q += kPackThreads * kChunk) {
      uint8_t b[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int64_t j = q + k - s_offs[i];
        b[k] = q + k >= lo && j < M ? row[j] : 0;
      }
      if (q >= lo && q + kChunk <= hi &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0) {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          w[k / 4] |= static_cast<uint32_t>(b[k]) << (8 * (k % 4));
        }
        *reinterpret_cast<uint4*>(out + q) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int k = 0; k < kChunk; ++k) {
          if (q + k >= lo && q + k < hi) out[q + k] = b[k];
        }
      }
    }
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
    // rows a CTA: as many as kPackTile bytes of dense hold, at most
    // kPackMaxRows; threads a row: a power of two covering its 16-byte
    // chunks, at most the CTA
    int64_t per_cta = M > 0 ? kPackTile / M : kPackMaxRows;
    if (per_cta > kPackMaxRows) per_cta = kPackMaxRows;
    if (per_cta < 1) per_cta = 1;
    const int64_t chunks = (M + kChunk - 1) / kChunk;
    int log_tpr = 0;
    while ((int64_t{1} << log_tpr) < chunks && (1 << log_tpr) < kPackThreads) {
      ++log_tpr;
    }
    const int64_t blocks = (n + per_cta - 1) / per_cta;
    pack_rows_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dense), n, M,
        static_cast<const int64_t*>(offs), per_cta, log_tpr,
        static_cast<uint8_t*>(out), total);
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
