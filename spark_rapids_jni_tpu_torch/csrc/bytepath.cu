// Byte-path kernels of the device Parquet scan, on Hopper.
//
// Two kernels, each the counterpart of one Pallas kernel of the JAX
// package (spark_rapids_jni_tpu/rowconv/xpallas.py):
//
//   srjt_gather_rows   <- xpallas._gather_call    (xpallas.py:405)
//   srjt_u8_to_u32     <- xpallas._transpose_call (xpallas.py:486)
//
// The third, xpallas._extract_call (xpallas.py:312, B5), computes what B3
// does (rows cut from flat bytes at offsets, zero-padded), so its wrapper
// (rowconv/bytepath.py extract_rows) launches B3's kernel in ragged.cu.
//
// The TPU kernels stage 512-byte windows and whole row blocks in VMEM,
// place bytes with vector rolls and masks, and bucket their static shapes
// against Mosaic compiles.  None of that carries over: Hopper addresses
// bytes, so each kernel here reads device memory and writes device memory
// once.  Gather takes one thread per output word (or 16-byte vector).
// u8 -> u32 is a copy at a byte shift, so it is built like a copy for this
// card: aligned 16-byte loads, several in flight a thread, the shift done
// in registers with a lane shuffle and funnel shifts, and a grid sized to
// the SMs.
//
// Bound: every kernel only moves bytes, so its least time on an H100 SXM is
// (bytes read once + bytes written once) / 3.35 TB/s.
//
// Rules shared by the two (as in ragged.cu): index arithmetic is int64; a
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

// The SMs of the current device, read at the first call.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
  }
  return sms > 0 ? sms : 1;
}

// Blocks of kThreads of ``kernel`` that one SM holds at once.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks > 0 ? blocks : 1;
}

__device__ __forceinline__ int64_t first_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t thread_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
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
// source at any byte address.
// Replaces xpallas._transpose_call
// (spark_rapids_jni_tpu/rowconv/xpallas.py:486).
// Bound: (4N read + 4N written) / 3.35 TB/s.
//
// The source is cut into aligned 16-byte vectors V[v] from src & ~15.  Output
// unit u (words 4u..4u+3, one 16-byte store: the wrapper's fresh output is
// 16-aligned) is bytes sh..sh+15 of V[u] V[u+1], sh = src & 15: word k is
// funnel(W[WS+k], W[WS+k+1], bs) over the eight words W of the pair, with
// WS = sh / 4 a template constant and bs = 8 (sh % 4).  Lane l of a warp
// takes units c + 32j + l for j < kUnits: it loads V[u] for each j before
// any store (kUnits 16-byte loads in flight), takes V[u+1] from lane l+1
// by __shfl_down_sync, and the warp's last lane loads that one itself.
// A 16-aligned source is a plain vector copy.
//
// No word that holds no byte of the source is read: the vector units are
// [u_lo, u_hi), those whose vectors hold source bytes only (the host
// computes the range), and the few words outside it, at the head and the
// tail, go word by word, each from the aligned word holding its first byte
// and, unless the source is word-aligned, the next.
constexpr int kUnits = 4;

template <int WS>
__global__ void __launch_bounds__(kThreads)
u8_to_u32_kernel(const uint8_t* __restrict__ src, int64_t n_words,
                 int64_t u_lo, int64_t u_hi, int64_t v_hi, int64_t head,
                 int64_t tail_start, uint32_t* __restrict__ out) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const unsigned bs = static_cast<unsigned>(addr & 3u) * 8u;
  // head and tail, word by word
  const uint32_t* aligned =
      reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  const int64_t tail = tail_start < n_words ? n_words - tail_start : 0;
  for (int64_t t = first_thread(); t < head + tail; t += thread_stride()) {
    const int64_t i = t < head ? t : tail_start + (t - head);
    const uint32_t lo = aligned[i];
    out[i] = bs == 0 ? lo : __funnelshift_r(lo, aligned[i + 1], bs);
  }
  // the vector units
  const uint4* vec = reinterpret_cast<const uint4*>(addr & ~uintptr_t{15});
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const bool shifted = WS != 0 || bs != 0;
  const int lane = threadIdx.x & 31;
  const int64_t per_warp = 32 * kUnits;
  const int64_t warp = first_thread() >> 5;
  const int64_t warps = thread_stride() >> 5;
  for (int64_t c = u_lo + warp * per_warp; c < u_hi; c += warps * per_warp) {
    uint4 v[kUnits], nx[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int64_t u = c + 32 * j + lane;
      v[j] = u < v_hi ? vec[u] : make_uint4(0, 0, 0, 0);
      nx[j] = shifted && lane == 31 && u + 1 < v_hi ? vec[u + 1]
                                                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const uint4 up = make_uint4(__shfl_down_sync(0xffffffffu, v[j].x, 1),
                                  __shfl_down_sync(0xffffffffu, v[j].y, 1),
                                  __shfl_down_sync(0xffffffffu, v[j].z, 1),
                                  __shfl_down_sync(0xffffffffu, v[j].w, 1));
      if (lane != 31) nx[j] = up;
      const int64_t u = c + 32 * j + lane;
      if (u >= u_hi) continue;
      const uint32_t w[8] = {v[j].x,  v[j].y,  v[j].z,  v[j].w,
                             nx[j].x, nx[j].y, nx[j].z, nx[j].w};
      out4[u] = make_uint4(__funnelshift_r(w[WS], w[WS + 1], bs),
                           __funnelshift_r(w[WS + 1], w[WS + 2], bs),
                           __funnelshift_r(w[WS + 2], w[WS + 3], bs),
                           __funnelshift_r(w[WS + 3], w[WS + 4], bs));
    }
  }
}

}  // namespace

extern "C" {

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
    // relative to the aligned vector at src & ~15: the source's first byte
    // sh, its last word, and the vectors [v_lo, v_hi) whose four words all
    // hold source bytes
    const int64_t sh =
        static_cast<int64_t>(reinterpret_cast<uintptr_t>(src) & 15u);
    const int64_t last_word = (sh + 4 * n_words - 1) >> 2;
    const int64_t v_lo = sh >= 4 ? 1 : 0;
    const int64_t v_hi = (last_word + 1) >> 2;
    // units need V[u] and, unless sh == 0, V[u+1]; all four words of the
    // unit lie in the output
    int64_t u_lo = v_lo;
    int64_t u_hi = n_words >> 2;
    if (u_hi > (sh ? v_hi - 1 : v_hi)) u_hi = sh ? v_hi - 1 : v_hi;
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0) u_hi = u_lo;
    if (u_hi < u_lo) u_hi = u_lo;
    const int64_t head = 4 * u_lo < n_words ? 4 * u_lo : n_words;
    const int64_t tail_start = 4 * u_hi > head ? 4 * u_hi : head;
    const int64_t edge =
        head + (tail_start < n_words ? n_words - tail_start : 0);
    auto kernel = sh < 4   ? u8_to_u32_kernel<0>
                  : sh < 8 ? u8_to_u32_kernel<1>
                  : sh < 12 ? u8_to_u32_kernel<2>
                            : u8_to_u32_kernel<3>;
    // one warp a chunk of 32 kUnits units; at most the warps the SMs hold
    // resident, which then take the same number of chunks each, so that
    // no wave runs part empty
    const int64_t chunks = (u_hi - u_lo + 32 * kUnits - 1) / (32 * kUnits);
    const int64_t warps_per_block = kThreads / 32;
    static int resident[4] = {0, 0, 0, 0};     // by sh / 4, read once
    int& per_sm = resident[sh >> 2];
    if (per_sm == 0) per_sm = resident_blocks(kernel);
    const int64_t max_warps =
        static_cast<int64_t>(sm_count()) * per_sm * warps_per_block;
    int64_t warps = chunks;
    if (warps > max_warps) {
      const int64_t rounds = (chunks + max_warps - 1) / max_warps;
      warps = (chunks + rounds - 1) / rounds;
    }
    int64_t blocks = (warps + warps_per_block - 1) / warps_per_block;
    const int64_t edge_blocks = (edge + kThreads - 1) / kThreads;
    if (blocks < edge_blocks) blocks = edge_blocks;
    if (blocks < 1) blocks = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* p = static_cast<const uint8_t*>(src);
    uint32_t* o = static_cast<uint32_t*>(out);
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, n_words, u_lo, u_hi, v_hi, head, tail_start, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
