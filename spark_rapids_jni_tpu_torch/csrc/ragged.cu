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
// Unpack (B3) and the segmented copy (B4) follow the same plan since
// their redesign: their items (rows, segments) are also a few dozen bytes
// at byte offsets, where a warp an item kept most lanes idle, moved a byte
// a lane wherever source and destination disagreed modulo 8, and waited on
// dependent offset loads.  One CTA takes a run of consecutive items, which
// own one contiguous destination range; it brings the items' offsets into
// shared memory by cp.async, builds the range there (zeros, then each
// item's bytes from aligned 16-byte source loads, a power-of-two group of
// threads an item) and stores it in 16-byte chunks (build_range).  So each
// kernel writes every byte of its output itself.
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

// Run-of-items copies (B3, B4).  A CTA's items are consecutive rows or
// segments whose destinations lie in one range [lo, hi) of the output that
// no other CTA writes (with offsets that keep the contract), so the CTA
// builds that range in shared memory and stores it whole: zeros where no
// item lands, 16-byte stores for whole chunks, bytes for the partial chunk
// at either end (the neighbouring CTA writes the rest of it).  A range
// longer than the buffer is built in windows of kCopyBuf bytes, one after
// the other; that takes a segment longer than a tile, or broken offsets.
constexpr int kCopyThreads = 256;
constexpr int64_t kCopyTile = 16 * 1024;
constexpr int64_t kCopyBuf = kCopyTile + kChunk;
constexpr int kUnpackMaxRows = 1024;
constexpr int kSegMax = 512;

// threads an item: a power of two covering an item of `bytes` in 16-byte
// chunks, at most the CTA (it measured faster on the main path's inputs
// than 32 or 64 bytes a thread, or one thread an item: PERF.md)
inline int log_group(int64_t bytes) {
  const int64_t chunks = (bytes + kChunk - 1) / kChunk;
  int log_g = 0;
  while ((int64_t{1} << log_g) < chunks && (1 << log_g) < kCopyThreads) {
    ++log_g;
  }
  return log_g;
}

// Writes every byte of dst[lo, hi): item i's bytes src[so, so + len) at
// dst[d, d + len) where they fall inside [lo, hi), zeros elsewhere.
// piece(i, so, d, len) reads item i from shared memory; it sets len <= 0
// for an item that copies nothing, and keeps [so, so + len) inside src.
// 2^log_g threads an item read its source in aligned 16-byte loads (each
// holds at least one byte of the item, so none crosses a page the source
// does not touch) and place its bytes in the window.
template <class Piece>
__device__ __forceinline__ void build_range(const uint8_t* __restrict__ src,
                                            Piece piece, int count,
                                            int64_t lo, int64_t hi,
                                            int log_g, uint8_t* s_buf,
                                            uint8_t* __restrict__ dst) {
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const bool vec = reinterpret_cast<uintptr_t>(dst) % kChunk == 0;
  for (int64_t w0 = lo & ~int64_t{15}; w0 < hi; w0 += kCopyBuf) {
    const int64_t from = w0 > lo ? w0 : lo;
    const int64_t to = w0 + kCopyBuf < hi ? w0 + kCopyBuf : hi;
    for (int v = threadIdx.x; v < kCopyBuf / kChunk; v += kCopyThreads) {
      reinterpret_cast<uint4*>(s_buf)[v] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int i = threadIdx.x >> log_g; i < count; i += kCopyThreads >> log_g) {
      int64_t so, d, len;
      piece(i, so, d, len);
      if (len <= 0) continue;
      const int64_t a = d > from ? d : from;
      const int64_t b = d + len < to ? d + len : to;
      if (a >= b) continue;
      // bytes [a, b) of the window come from p[0, n)
      const uint8_t* p = src + so + (a - d);
      const int head =
          static_cast<int>(reinterpret_cast<uintptr_t>(p) % kChunk);
      const uint4* pa = reinterpret_cast<const uint4*>(p - head);
      const int n = static_cast<int>(b - a);
      uint8_t* q = s_buf + (a - w0);
      for (int c = lane; c * kChunk < head + n; c += g) {
        const uint4 v = __ldg(pa + c);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int j = c * kChunk + k - head;
          if (j >= 0 && j < n) q[j] = byte_of(v, k);
        }
      }
    }
    __syncthreads();
    for (int64_t at = w0 + threadIdx.x * kChunk; at < to;
         at += kCopyThreads * kChunk) {
      const uint8_t* b = s_buf + (at - w0);
      if (vec && at >= from && at + kChunk <= to) {
        *reinterpret_cast<uint4*>(dst + at) =
            *reinterpret_cast<const uint4*>(b);
      } else {
        for (int k = 0; k < kChunk; ++k) {
          if (at + k >= from && at + k < to) dst[at + k] = b[k];
        }
      }
    }
    __syncthreads();
  }
}

// unpack: out[r, :M] = flat[offs[r]:offs[r+1]] cut to M bytes (the prefix
// of a longer row), zero-padded.  Every byte of out is written.
// Replaces ragged._unpack_call (spark_rapids_jni_tpu/rowconv/ragged.py:417).
// Bound: (sum of min(size_r, M) read + 8(n+1) + n*M written) / 3.35 TB/s.
// Its callers hand it JCUDF rows whose first M bytes (the fixed region, M
// not a multiple of 8) are wanted, and one string column's chars.
//
// One CTA unpacks `per_cta` consecutive rows (about 16 KiB of output, at
// most kUnpackMaxRows): their output [r0*M, (r0+rows)*M) is one range.
// Each row's prefix is read by aligned 16-byte loads of its own, so a
// narrow prefix of long rows reads only the sectors it needs.  A row whose
// offsets break the contract (negative start, end before start) comes out
// as zeros; its end is cut at flat_size.
__global__ void __launch_bounds__(kCopyThreads)
unpack_rows_kernel(const uint8_t* __restrict__ flat, int64_t flat_size,
                   const int64_t* __restrict__ offs, int64_t n, int64_t M,
                   int64_t per_cta, int log_g, uint8_t* __restrict__ out) {
  __shared__ int64_t s_offs[kUnpackMaxRows + 1];
  __shared__ __align__(16) uint8_t s_buf[kCopyBuf];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int rows = static_cast<int>(n - r0 < per_cta ? n - r0 : per_cta);
  for (int i = threadIdx.x; i <= rows; i += kCopyThreads) {
    cp_async8(s_offs + i, offs + r0 + i);
  }
  cp_async_wait_all();
  __syncthreads();
  auto piece = [&](int i, int64_t& so, int64_t& d, int64_t& len) {
    so = s_offs[i];
    const int64_t end = s_offs[i + 1] < flat_size ? s_offs[i + 1] : flat_size;
    d = (r0 + i) * M;
    len = so < 0 ? 0 : (end - so < M ? end - so : M);
  };
  build_range(flat, piece, rows, r0 * M, (r0 + rows) * M, log_g, s_buf, out);
}

// segmented copy: dst[dst_offs[s]:+sizes[s]] = src[src_offs[s]:+sizes[s]],
// every other byte of dst zero.  Destinations ascend and do not overlap;
// sources may lie anywhere.  Every byte of dst is written.
// Replaces ragged._segcopy_call (spark_rapids_jni_tpu/rowconv/ragged.py:559).
// Bound: (sum of sizes read + 24k metadata + dst_size written) / 3.35 TB/s.
// Its callers hand it strings of a few dozen bytes at byte offsets: chars
// into JCUDF rows (gaps between rows), chars out of rows (sources spread
// over the rows, column after column), PLAIN string records without their
// 4-byte prefixes.
//
// One CTA copies `per_cta` consecutive segments (per_cta times the mean
// destination span about 12 KiB, at most kSegMax) and owns dst from its
// first segment's start to the next CTA's first start (0 for the first
// CTA, dst_size for the last), so the CTAs tile dst, gaps included.  The
// CTA boundaries are clamped to [0, dst_size]; with offsets that break the
// contract, ranges may overlap (racing writes) but still cover dst, and no
// access leaves src or dst: a segment with a negative offset copies
// nothing, one past the end of src is cut there.
__global__ void __launch_bounds__(kCopyThreads)
segmented_copy_kernel(const uint8_t* __restrict__ src, int64_t src_size,
                      const int64_t* __restrict__ src_offs,
                      const int64_t* __restrict__ dst_offs,
                      const int64_t* __restrict__ sizes, int64_t k,
                      int64_t per_cta, int log_g, uint8_t* __restrict__ dst,
                      int64_t dst_size) {
  __shared__ int64_t s_so[kSegMax];
  __shared__ int64_t s_do[kSegMax + 1];
  __shared__ int64_t s_len[kSegMax];
  __shared__ __align__(16) uint8_t s_buf[kCopyBuf];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int count = static_cast<int>(k - s0 < per_cta ? k - s0 : per_cta);
  const bool last = s0 + count == k;
  for (int i = threadIdx.x; i < count; i += kCopyThreads) {
    cp_async8(s_so + i, src_offs + s0 + i);
    cp_async8(s_do + i, dst_offs + s0 + i);
    cp_async8(s_len + i, sizes + s0 + i);
  }
  if (threadIdx.x == 0 && !last) cp_async8(s_do + count, dst_offs + s0 + count);
  cp_async_wait_all();
  __syncthreads();
  auto clamp = [dst_size](int64_t x) {
    return x < 0 ? int64_t{0} : (x > dst_size ? dst_size : x);
  };
  const int64_t lo = blockIdx.x == 0 ? 0 : clamp(s_do[0]);
  const int64_t hi = last ? dst_size : clamp(s_do[count]);
  if (hi <= lo) return;
  auto piece = [&](int i, int64_t& so, int64_t& d, int64_t& len) {
    so = s_so[i];
    d = s_do[i];
    len = s_len[i];
    if (so < 0 || d < 0 || so >= src_size) len = 0;
    else if (len > src_size - so) len = src_size - so;
  };
  build_range(src, piece, count, lo, hi, log_g, s_buf, dst);
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
    int64_t per_cta = kCopyTile / M;
    if (per_cta > kUnpackMaxRows) per_cta = kUnpackMaxRows;
    if (per_cta < 1) per_cta = 1;
    unpack_rows_kernel<<<static_cast<unsigned>((n + per_cta - 1) / per_cta),
                         kCopyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), flat_size,
        static_cast<const int64_t*>(offs), n, M, per_cta,
        log_group(flat_size / n < M ? flat_size / n : M),   // the mean row
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes every byte of dst when it launches (k, dst_size and src_size all
// positive); the caller zero-fills dst otherwise.
int srjt_segmented_copy(const void* src, int64_t src_size,
                        const void* src_offs, const void* dst_offs,
                        const void* sizes, int64_t k, void* dst,
                        int64_t dst_size, void* stream) {
  if (k > 0 && dst_size > 0 && src_size > 0) {
    // the mean destination span of a segment, gaps included, sizes the run
    // of segments a CTA; the threads a segment come from the mean segment,
    // which is at most that span and the mean source span
    const int64_t span = dst_size / k > 0 ? dst_size / k : 1;
    const int64_t bytes = src_size / k < span ? src_size / k : span;
    int64_t per_cta = kCopyTile * 3 / 4 / span;
    if (per_cta > kSegMax) per_cta = kSegMax;
    if (per_cta < 1) per_cta = 1;
    segmented_copy_kernel<<<static_cast<unsigned>((k + per_cta - 1) / per_cta),
                            kCopyThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), src_size,
        static_cast<const int64_t*>(src_offs),
        static_cast<const int64_t*>(dst_offs),
        static_cast<const int64_t*>(sizes), k, per_cta, log_group(bytes),
        static_cast<uint8_t*>(dst), dst_size);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
