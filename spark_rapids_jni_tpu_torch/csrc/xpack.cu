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
// What carries over is the device offsets.  The VMEM window DMA, the byte
// rolls and the shape buckets do not: rows are 8-byte aligned, so every
// output word belongs to exactly one row (or to none), and placing it is a
// plain word copy.
//
// Design: one kernel on B2's run-of-rows plan (ragged.cu).  A CTA takes
// `per_cta` consecutive rows (about kTileBytes of dense), which it knows
// from its index alone, and their output range [dst_w[r0], dst_w[r0 +
// rows]) is contiguous: row r's word k goes to dst_w[r] + k, with no search
// and no block -> row table.  One round trip before any store: cp.async
// brings the run's offsets and its rows (whole, 16 bytes at a time) into
// shared memory together.  The CTA then builds its output range there,
// from the 16-byte boundary below its start: zeros, and each row's first
// min(size, Mw) words placed by a power-of-two group of threads a row.  It
// stores the range in 16-byte chunks, the words of the partial chunk at
// either end on their own (the neighbouring CTAs write the rest of those
// chunks).  The last CTA also zeroes the words from dst_w[n] to total_w,
// and the first those before dst_w[0], so every output word is written.
//
// Outside the tile, the direct path: a row wider than the tile, a range
// longer than the tile (rows longer than Mw, whose tails are zeros), broken
// offsets, and rows whose starts are not 16-aligned (Mw not a multiple of
// 4, or a dense or out pointer not 16-aligned).  There the group of a row
// copies its words straight from dense to out, kUnroll units a thread in
// flight before its first store, and the whole CTA zeroes the words past
// Mw of rows longer than Mw.  The straight copy was also measured as the
// only path, and lost on every input of the main path (PERF.md,
// tools/torch_bench_xpack.py).
//
// Bound: the kernel only moves bytes, so its least time on an H100 SXM is
// (payload words read once + 8 bytes an offset + total_w words written
// once) / 3.35 TB/s.  The tile brings whole rows, so the kernel reads the
// zero padding past each row's size too (rows of to_rows are padded to a
// multiple of 64 bytes): M bytes a row instead of the sectors its payload
// touches.

// Rules (as in ragged.cu): index arithmetic is int64 (int only within a
// CTA's run); the kernel allocates nothing and does not synchronise; it
// launches on the stream it is given; the entry returns cudaGetLastError()
// so the caller sees a refused launch.  Offsets that break the contract
// (negative, decreasing, past total_w) give wrong or unwritten words,
// never a read or write out of bounds: a row reads only its own Mw words,
// and writes are cut to [0, total_w).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTileBytes = 16 * 1024;     // dense a CTA
constexpr int64_t kTileWords = kTileBytes / 4;
constexpr int kMaxRows = 1024;
constexpr int kUnroll = 4;                    // direct path: units in flight

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// What a thread moves at a time: four words or one.
template <int W> struct Unit;
template <> struct Unit<4> { using T = uint4; };
template <> struct Unit<1> { using T = uint32_t; };

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j < 2 ? (j == 0 ? v.x : v.y) : (j == 2 ? v.z : v.w);
}

// The first k (1-4) words of v at out[d]: one 16-byte store where whole and
// 16-aligned, else 8-byte stores where 8-aligned, else words.  out itself
// is 16-aligned.
__device__ __forceinline__ void store_words(uint32_t* out, int64_t d,
                                            const uint4& v, int k) {
  if (k == 4 && (d & 3) == 0) {
    *reinterpret_cast<uint4*>(out + d) = v;
    return;
  }
  int j = 0;
  if ((d & 1) == 0) {
    for (; j + 2 <= k; j += 2) {
      *reinterpret_cast<uint2*>(out + d + j) =
          make_uint2(word_of(v, j), word_of(v, j + 1));
    }
  }
  for (; j < k; ++j) out[d + j] = word_of(v, j);
}

__device__ __forceinline__ void store_words(uint32_t* out, int64_t d,
                                            uint32_t v, int) {
  out[d] = v;
}

// out[a, b) = 0 by the whole CTA; 16-byte stores between the 16-byte
// boundaries when vec (out 16-aligned), words elsewhere.
__device__ void zero_words(uint32_t* out, int64_t a, int64_t b, bool vec) {
  if (a >= b) return;
  int64_t a4 = a, b4 = a;
  if (vec) {
    a4 = (a + 3) & ~int64_t{3};
    if (a4 > b) a4 = b;
    b4 = b & ~int64_t{3};
    if (b4 < a4) b4 = a4;
  }
  for (int64_t w = a + threadIdx.x; w < a4; w += kThreads) out[w] = 0;
  for (int64_t q = a4 + 4 * threadIdx.x; q < b4; q += 4 * kThreads) {
    *reinterpret_cast<uint4*>(out + q) = make_uint4(0, 0, 0, 0);
  }
  for (int64_t w = b4 + threadIdx.x; w < b; w += kThreads) out[w] = 0;
}

// The direct path: rows [0, rows) of the run (src = dense + r0 * Mw) copied
// straight from dense to out, W words a unit, 2^log_g threads a row (a row
// of more units takes several passes); then zeros past Mw of rows longer
// than Mw.  Writes are cut to [0, total_w); a row with a negative start
// writes nothing.
template <int W>
__device__ void copy_rows(const uint32_t* __restrict__ src, int rows,
                          int64_t Mw, const int64_t* s_offs, int log_g,
                          uint32_t* __restrict__ out, int64_t total_w) {
  using V = typename Unit<W>::T;
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const int slot = threadIdx.x >> log_g;
  const int rpp = kThreads >> log_g;                     // rows a pass
  const int units = static_cast<int>((Mw + W - 1) / W);  // units a row
  const int cpp = (units + g - 1) >> log_g;              // passes a row
  const int passes = (rows + rpp - 1) / rpp * cpp;
  bool long_rows = false;
  for (int p0 = 0; p0 < passes; p0 += kUnroll) {
    V v[kUnroll];
    int64_t at[kUnroll];
    int cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cnt[u] = 0;
      const int p = p0 + u;
      const int i = slot + (p / cpp) * rpp;
      if (p >= passes || i >= rows) continue;
      const int64_t lo = s_offs[i];
      const int64_t size = s_offs[i + 1] - lo;
      long_rows |= size > Mw;
      int64_t len = size < Mw ? size : Mw;
      if (len > total_w - lo) len = total_w - lo;
      const int64_t k0 = static_cast<int64_t>(lane + (p % cpp) * g) * W;
      if (lo < 0 || k0 >= len) continue;
      cnt[u] = static_cast<int>(len - k0 < W ? len - k0 : W);
      at[u] = lo + k0;
      v[u] = *reinterpret_cast<const V*>(src + i * Mw + k0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cnt[u] > 0) store_words(out, at[u], v[u], cnt[u]);
    }
  }
  if (__syncthreads_or(long_rows)) {
    for (int i = 0; i < rows; ++i) {
      const int64_t lo = s_offs[i];
      const int64_t hi = s_offs[i + 1] < total_w ? s_offs[i + 1] : total_w;
      if (lo >= 0 && hi - lo > Mw) zero_words(out, lo + Mw, hi, W == 4);
    }
  }
}

// Zeros before the first row (the first CTA) and past the last (the last).
__device__ __forceinline__ void zero_edges(const int64_t* s_offs, int rows,
                                           uint32_t* __restrict__ out,
                                           int64_t total_w, bool vec) {
  if (blockIdx.x == 0) {
    zero_words(out, 0, s_offs[0] < total_w ? s_offs[0] : total_w, vec);
  }
  if (blockIdx.x == gridDim.x - 1) {
    zero_words(out, s_offs[rows] > 0 ? s_offs[rows] : 0, total_w, vec);
  }
}

// out[w] = dense[r, w - dst_w[r]] for the row r with dst_w[r] <= w <
// dst_w[r+1] and w - dst_w[r] < Mw; 0 for every other word of [0, total_w).
// W = 4: every row start and out are 16-aligned, and runs that fit take
// the tile; W = 1: the direct path, word by word.
template <int W>
__global__ void __launch_bounds__(kThreads)
pack_windows_kernel(const uint32_t* __restrict__ dense, int64_t n, int64_t Mw,
                    const int64_t* __restrict__ dst_w, int per_cta, int log_g,
                    uint32_t* __restrict__ out, int64_t total_w) {
  __shared__ int64_t s_offs[kMaxRows + 1];
  __shared__ __align__(16) uint32_t s_tile[kTileWords];
  __shared__ __align__(16) uint32_t s_out[kTileWords + 4];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int rows = static_cast<int>(n - r0 < per_cta ? n - r0 : per_cta);
  const uint32_t* src = dense + r0 * Mw;
  const bool tiled = W == 4 && rows * Mw <= kTileWords;
  for (int i = threadIdx.x; i <= rows; i += kThreads) {
    cp_async8(s_offs + i, dst_w + r0 + i);
  }
  if (tiled) {
    for (int64_t v = threadIdx.x; v < rows * Mw / 4; v += kThreads) {
      cp_async16(s_tile + 4 * v, src + 4 * v);
    }
    for (int v = threadIdx.x; v < (kTileWords + 4) / 4; v += kThreads) {
      reinterpret_cast<uint4*>(s_out)[v] = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int64_t o0 = s_offs[0];
  const int64_t o1 = s_offs[rows];
  const int64_t a0 = o0 & ~int64_t{3};
  const int64_t span = o1 - a0;
  if (tiled && o0 >= 0 && o0 <= o1 && o1 <= total_w &&
      span <= kTileWords + 4) {
    // the range in shared memory: row i's words at s_offs[i] - a0
    const int g = 1 << log_g;
    const int lane = threadIdx.x & (g - 1);
    for (int i = threadIdx.x >> log_g; i < rows; i += kThreads >> log_g) {
      const int64_t at = s_offs[i] - a0;
      const int64_t size = s_offs[i + 1] - s_offs[i];
      const int len = static_cast<int>(size < Mw ? size : Mw);
      if (at < 0 || len <= 0 || at + len > span) continue;
      for (int k = lane; k < len; k += g) s_out[at + k] = s_tile[i * Mw + k];
    }
    __syncthreads();
    for (int64_t q = a0 + 4 * threadIdx.x; q < o1; q += 4 * kThreads) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_out + (q - a0));
      if (q >= o0 && q + 4 <= o1) {
        *reinterpret_cast<uint4*>(out + q) = v;
      } else {
        // the partial chunk at either end: its words of [o0, o1)
        const int64_t from = q > o0 ? q : o0;
        const int64_t to = q + 4 < o1 ? q + 4 : o1;
        for (int64_t w = from; w < to; ++w) out[w] = word_of(v, w - q);
      }
    }
  } else {
    copy_rows<W>(src, rows, Mw, s_offs, log_g, out, total_w);
  }
  zero_edges(s_offs, rows, out, total_w, W == 4);
}

}  // namespace

extern "C" {

int srjt_pack_windows(const void* dense, int64_t n, int64_t Mw,
                      const void* dst_w, void* out, int64_t total_w,
                      void* stream) {
  if (n > 0 && Mw > 0 && total_w > 0) {
    // rows a CTA: as many as kTileBytes of dense hold, at most kMaxRows;
    // threads a row: a power of two covering its units (16 bytes, or a word
    // off the 16-byte path), at most the CTA
    const bool vec = Mw % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(dense) |
                      reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    const int64_t W = vec ? 4 : 1;
    int64_t per_cta = kTileBytes / (4 * Mw);
    if (per_cta > kMaxRows) per_cta = kMaxRows;
    if (per_cta < 1) per_cta = 1;
    const int64_t units = (Mw + W - 1) / W;
    int log_g = 0;
    while ((int64_t{1} << log_g) < units && (1 << log_g) < kThreads) ++log_g;
    const unsigned blocks = static_cast<unsigned>((n + per_cta - 1) / per_cta);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* d = static_cast<const uint32_t*>(dense);
    const int64_t* o = static_cast<const int64_t*>(dst_w);
    uint32_t* w = static_cast<uint32_t*>(out);
    if (vec) {
      pack_windows_kernel<4><<<blocks, kThreads, 0, s>>>(
          d, n, Mw, o, static_cast<int>(per_cta), log_g, w, total_w);
    } else {
      pack_windows_kernel<1><<<blocks, kThreads, 0, s>>>(
          d, n, Mw, o, static_cast<int>(per_cta), log_g, w, total_w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
