// Byte gather from word-packed bins (kernels K7 and K8).
//
// Each row r carries its uint8 bins packed four to an int32 word (byte j of
// word w is bin 4w + j, the little-endian bytes of the bin row). For G index
// sets idx[g] (n, k) the kernel computes
//   out[g, r, j] = (packed[r, idx >> 2] >> (8 * (idx & 3))) & 0xFF,  idx = idx[g, r, j]
// and 0 where idx lies outside [0, 4 * words): the sentinel rule of the JAX
// package's compare-select contraction (_contract_gather), which matches no
// word there. Every value is an integer, so the result equals any other
// evaluation of the same gather bit for bit.
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::packed_byte_gather_many (the
// pl.pallas_call at rf_pallas.py:727, kernel K8) and, with G = 1,
// packed_byte_gather (rf_pallas.py:507, kernel K7). The TPU kernels select the
// word with one in-register lane shuffle of a (2048, W) block, so they take
// W in [64, 128] words, rows in multiples of 2,048 and idx padded to W lanes;
// their grid is (G, n / 2048), G-major, which fetches every packed row G
// times. Here any n, words and k are taken, and idx is read at its own width.
//
// What bounds it on an H100: the bytes. idx is read once and out written once
// (4 bytes each per element), the packed rows once: at the RF bench forest's
// two-hop shape (G = 8 trees, 131,072 rows, k = 63 hop-2 slots, 64 words a
// row) about 264 MB in, 264 MB out and 34 MB of rows, ~0.17 ms at 3.35 TB/s.
// At the GBT's depth-8 shape (k = 1) the launch itself dominates.
//
// Design. The G index sets are viewed as G flat arrays of n * k entries. A
// block owns one tile of TILE consecutive entries of one index set; the grid
// is tile-major with G inside (block = tile * G + g), so the G blocks of one
// row range run together and the row range's packed words, read at random
// within each row, come from L1/L2 rather than device memory G times. Each
// thread handles PER_THREAD entries THREADS apart, so every load of idx and
// every store of out is coalesced across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int64_t TILE = (int64_t)THREADS * PER_THREAD;

template <typename Index>
__global__ void __launch_bounds__(THREADS)
packed_byte_gather_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ idx,
                          int32_t* __restrict__ out, int64_t total, int words, int k, int G) {
  const int64_t b = blockIdx.x;
  const int g = (int)(b % G);
  const int64_t tile = b / G;
  const int64_t base = (int64_t)g * total;
  const int limit = 4 * words;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int64_t e = tile * TILE + (int64_t)i * THREADS + threadIdx.x;
    if (e >= total) return;
    // the row of entry e: 32-bit division where n * k fits (the usual case)
    const int64_t r = (int64_t)((Index)e / (Index)k);
    const int j = __ldg(idx + base + e);
    int v = 0;
    if (j >= 0 && j < limit) {
      const uint32_t w = (uint32_t)__ldg(packed + r * words + (j >> 2));
      v = (int)((w >> ((j & 3) * 8)) & 0xFFu);
    }
    out[base + e] = v;
  }
}

}  // namespace

// packed (n, words) int32, idx (G, n, k) int32, out (G, n, k) int32; all
// contiguous.
extern "C" int packed_byte_gather_launch(const int32_t* packed, const int32_t* idx, int32_t* out,
                                         int64_t n, int words, int k, int G, void* stream) {
  if (n <= 0 || k <= 0 || G <= 0) return 0;
  if (words < 1 || words > (1 << 29)) return (int)cudaErrorInvalidValue;
  const int64_t total = n * k;
  const int64_t tiles = (total + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL / G) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(tiles * G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total <= 0xffffffffLL) {
    packed_byte_gather_kernel<uint32_t><<<blocks, THREADS, 0, s>>>(packed, idx, out, total, words, k, G);
  } else {
    packed_byte_gather_kernel<uint64_t><<<blocks, THREADS, 0, s>>>(packed, idx, out, total, words, k, G);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
