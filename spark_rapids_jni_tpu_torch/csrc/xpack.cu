// Pack windows: zero-padded word rows -> one flat word stream at device
// word offsets, on Hopper.  The last step of every to_rows batch of a table
// with strings.
//
//   srjt_pack_windows  <- xpallas._packwin_call (xpallas.py:186), behind
//                         xpack.pack_windows (xpack.py:207)
//
// The TPU kernel is output-centric: one grid step per 4 KiB output block
// DMAs the window of rows that overlaps the block into VMEM and ORs each
// row in with byte rolls and masks; the block -> first-row table comes from
// a segment sum on the device (_first_row_per_boundary), with no host sync.
// What carries over is the output-centric plan and the device offsets.  The
// VMEM window DMA, the byte rolls and the shape buckets do not: rows are
// 8-byte aligned, so every output word belongs to exactly one row (or to
// none), and placing it is a plain word copy.
//
// Design: two kernels.  The first, one thread per row, writes the block ->
// first-row table the TPU kernel takes from its segment sum: row r owns the
// block boundaries k*1024 that fall in [dst_w[r], dst_w[r+1]), usually none
// or one.  (A search of dst_w at the start of every CTA, by one thread or
// by all of them, cost as much as the copy: every CTA waited on its chain
// of dependent loads.)  The second runs one CTA per 4 KiB output block
// (1024 words).  It reads its first row and the row at its end from the
// table and stages those rows' offsets in shared memory (JCUDF rows are at
// least 8 bytes, so a block overlaps at most 513 rows; a block that
// overlaps more, possible only with empty rows, searches device memory
// instead).  Each thread then writes output words at coalesced addresses,
// two at a time (rows are 8-byte aligned): for word w it finds its row r
// by a binary search of the staged offsets and reads dense[r, w - dst_w[r]].
// A row wider than a block spans several CTAs, and a CTA may hold no row
// start; both follow from the table.
//
// Bound: the kernels only move bytes, so their least time on an H100 SXM is
// (row words read once + 8 bytes an offset + output words written once)
// / 3.35 TB/s.  Reads of dense are contiguous within a row and writes are
// contiguous within a block.  Above the bound: the table's pass over the
// offsets, and the per-word search in shared memory (about ten steps).
//
// Rules (as in ragged.cu): index arithmetic is int64; the kernel allocates
// nothing and does not synchronise; it launches on the stream it is given;
// the entry returns cudaGetLastError() so the caller sees a refused launch.
// Offsets that are not non-decreasing give zeros or wrong words, never a
// read or write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlockWords = 1024;            // 4 KiB of output
// word pairs a thread moves in a block
constexpr int kPairs = kBlockWords / (2 * kThreads);
// offsets staged a block: the 513 rows an 8-byte row size allows, the end
// of the last, and room for blocks of empty rows
constexpr int kStage = 2 * kBlockWords + 2;
// 132 SMs x 8 resident blocks of 256 threads, four waves; threads stride
// over the rest of the rows
constexpr int64_t kMaxTableBlocks = 132 * 8 * 4;

// First index i in [lo, hi) with a[i] > key, or hi.  Whenever the result is
// above lo, a[result - 1] <= key, whatever the order of a.
__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t lo,
                                               int64_t hi, int64_t key) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (a[mid] <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// block_rows[k] = the row r with dst_w[r] <= k*1024 < dst_w[r+1], for k in
// [0, nb]; n past the last row.  The caller fills block_rows with -1 first,
// so a boundary before the first row (or, with offsets that are not
// non-decreasing, one no row owns) stays -1.
__global__ void __launch_bounds__(kThreads)
block_rows_kernel(const int64_t* __restrict__ dst_w, int64_t n, int64_t nb,
                  int64_t* __restrict__ block_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r <= n; r += stride) {
    const int64_t lo = dst_w[r];
    // the row's boundaries: the first block start at or after lo, up to
    // its end (past the last row: every boundary left)
    const int64_t hi = r < n ? dst_w[r + 1] : (nb + 1) * kBlockWords;
    int64_t k = lo <= 0 ? 0 : (lo + kBlockWords - 1) / kBlockWords;
    for (; k <= nb && k * kBlockWords < hi; ++k) block_rows[k] = r;
  }
}

// The word at output position w: dense[r, w - offs[i]] for the staged row
// i (row r = first + i) with offs[i] <= w < offs[i+1] and w - offs[i] < Mw;
// 0 for a word no row covers.
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ dense,
                                            int64_t Mw, const int64_t* offs,
                                            int64_t count, int64_t first,
                                            int64_t w) {
  const int64_t i = upper_bound(offs, 0, count, w) - 1;
  if (i >= 0 && i < count - 1) {
    const int64_t k = w - offs[i];
    if (k < Mw && k < offs[i + 1] - offs[i]) {
      return dense[(first + i) * Mw + k];
    }
  }
  return 0;
}

// out[w] = dense[r, w - dst_w[r]] for the row r with dst_w[r] <= w <
// dst_w[r+1] and w - dst_w[r] < Mw; 0 for a word no row covers.  Threads
// take pairs of words: JCUDF rows are 8-byte aligned, so both words of a
// pair nearly always lie in one row and move as one 8-byte load and store;
// a pair that does not (odd offsets, a row's end, misaligned pointers) goes
// word by word.  Each thread's pairs are loaded before any is stored, so
// their loads are in flight together.
__global__ void __launch_bounds__(kThreads)
pack_windows_kernel(const uint32_t* __restrict__ dense, int64_t n, int64_t Mw,
                    const int64_t* __restrict__ dst_w,
                    const int64_t* __restrict__ block_rows,
                    uint32_t* __restrict__ out, int64_t total_w) {
  __shared__ int64_t s_offs[kStage];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kBlockWords;
  const int64_t b1 = b0 + kBlockWords < total_w ? b0 + kBlockWords : total_w;
  // the row holding b0 (or the first row), and the row holding the next
  // block's start, which ends at or after b1 (or the last row)
  int64_t first = block_rows[blockIdx.x];
  if (first < 0) first = 0;
  if (first > n) first = n;
  int64_t last = block_rows[blockIdx.x + 1];
  if (last > n - 1 || last < 0) last = n - 1;
  // offsets of rows first..last and the end of the last
  const int64_t count = last >= first ? last - first + 2 : 0;
  const int64_t* offs = dst_w + first;
  if (count <= kStage) {
    for (int64_t i = threadIdx.x; i < count; i += kThreads) {
      s_offs[i] = dst_w[first + i];
    }
    offs = s_offs;
  }
  __syncthreads();
  const bool vec = (Mw % 2 == 0) &&
                   ((reinterpret_cast<uintptr_t>(dense) |
                     reinterpret_cast<uintptr_t>(out)) % 8 == 0);
  uint2 v[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int64_t w = b0 + 2 * (threadIdx.x + j * kThreads);
    v[j] = make_uint2(0, 0);
    if (w >= b1) continue;
    // i: the last staged offset at or before w; row first + i holds w if
    // w lies before the row's end and within its Mw words
    const int64_t i = upper_bound(offs, 0, count, w) - 1;
    bool whole = false;
    if (vec && i >= 0 && i < count - 1) {
      const int64_t k = w - offs[i];
      const int64_t at = (first + i) * Mw + k;
      if (k + 1 < Mw && k + 1 < offs[i + 1] - offs[i] && at % 2 == 0) {
        v[j] = *reinterpret_cast<const uint2*>(dense + at);
        whole = true;
      }
    }
    if (!whole) {
      v[j].x = word_at(dense, Mw, offs, count, first, w);
      if (w + 1 < b1) v[j].y = word_at(dense, Mw, offs, count, first, w + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int64_t w = b0 + 2 * (threadIdx.x + j * kThreads);
    if (w >= b1) continue;
    if (vec && w + 1 < b1) {
      *reinterpret_cast<uint2*>(out + w) = v[j];
    } else {
      out[w] = v[j].x;
      if (w + 1 < b1) out[w + 1] = v[j].y;
    }
  }
}

}  // namespace

extern "C" {

// block_rows: int64 scratch of (total_w + 1023) / 1024 + 1 entries.
int srjt_pack_windows(const void* dense, int64_t n, int64_t Mw,
                      const void* dst_w, void* block_rows, void* out,
                      int64_t total_w, void* stream) {
  if (n > 0 && Mw > 0 && total_w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nb = (total_w + kBlockWords - 1) / kBlockWords;
    cudaError_t err = cudaMemsetAsync(block_rows, 0xFF,
                                      (nb + 1) * sizeof(int64_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int64_t table_blocks = (n + kThreads) / kThreads;
    if (table_blocks > kMaxTableBlocks) table_blocks = kMaxTableBlocks;
    block_rows_kernel<<<static_cast<unsigned>(table_blocks), kThreads, 0, s>>>(
        static_cast<const int64_t*>(dst_w), n, nb,
        static_cast<int64_t*>(block_rows));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pack_windows_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(dense), n, Mw,
        static_cast<const int64_t*>(dst_w),
        static_cast<const int64_t*>(block_rows), static_cast<uint32_t*>(out),
        total_w);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
