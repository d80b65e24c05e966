// Hop 2 of the packed-forest descent for every (row, tree) (kernel K9).
//
// The forest is re-laid by pack_forest: hop 1 walks each tree's top k1
// levels (outside this kernel) and leaves i1[r, t], the heap index where row
// r stopped or the level-k1 node it reached. A row that stopped above level
// k1 (i1 < n1 = 2^k1 - 1) keeps i1. Otherwise l = i1 - n1 names one of the
// tree's 2^k1 subtrees, whose 2^k2 - 1 internal nodes sit in table row
// t * 2^k1 + l of feat2/thr2, heap-ordered along the 64 lanes (feature -1 =
// leaf). From lane m = 0 the row takes at most k2 steps:
//   f = feat2[row, m]; stop if f < 0;
//   m = 2m + 1 + (byte f of the row's packed bins > thr2[row, m])
// and the local heap slot m becomes the global heap index of the leaf,
//   delta = depth of m, pd = 2^delta,
//   id = (2^k1 * pd - 1) + l * pd + (m - (pd - 1)).
// Every value is an integer: the result is bit-identical to any other
// evaluation of the same walk.
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::packed_traverse (the
// pl.pallas_call at rf_pallas.py:676), which runs the same walk as a masked
// lockstep over all trees of a row block, selects the table row with an MXU
// one-hot product and gathers the bytes with a lane shuffle (so it takes at
// most 128 words, 512 features, a row). Here each thread walks on its own
// and stops at its leaf; rows of any width are read from global memory.
//
// What bounds it on an H100: the bytes, each input read once and the output
// written once: the packed rows (n * d/4 words), i1 and the output (n *
// T_pad int32 each) and the tables; at one transform batch of the bench
// forest (131,072 rows, 56 padded trees, 256 features) about 96 MB, ~30 us.
// A thread reads k2 table entries and k2 bytes of its row: the tables
// (T_pad * 2^k1 * 64 int32 each, 3.7 MB at 56 trees) stay in the 50 MB L2,
// and the 32 threads of a warp share one or two rows, which L1 holds.
//
// Design. One thread per (row, tree), in row-major order, so i1 and the
// output are read and written coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
packed_traverse_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ i1,
                       const int32_t* __restrict__ feat2, const int32_t* __restrict__ thr2,
                       int32_t* __restrict__ out, int64_t n, int words, int t_pad, int k1,
                       int k2, int lanes) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n * t_pad) return;
  const int64_t r = idx / t_pad;
  const int t = (int)(idx - r * t_pad);
  const int K1 = 1 << k1;
  const int n1 = K1 - 1;
  const int iv = i1[idx];
  if (iv < n1) {
    out[idx] = iv;
    return;
  }
  const int l = min(max(iv - n1, 0), K1 - 1);
  const int64_t trow = ((int64_t)t * K1 + l) * lanes;
  const int32_t* ft = feat2 + trow;
  const int32_t* tt = thr2 + trow;
  const int32_t* prow = packed + r * words;
  const int d_pad = 4 * words;
  int m = 0;
  for (int s = 0; s < k2; ++s) {
    const int f = ft[m];
    if (f < 0) break;
    const int fc = min(f, d_pad - 1);
    const int b = (prow[fc >> 2] >> ((fc & 3) * 8)) & 0xFF;
    m = 2 * m + 1 + (b > tt[m] ? 1 : 0);
  }
  int delta = 0;
  for (int j = 1; j <= k2; ++j) delta += (m + 1 >= (1 << j)) ? 1 : 0;
  const int pd = 1 << delta;
  out[idx] = (K1 * pd - 1) + l * pd + (m - (pd - 1));
}

}  // namespace

// packed (n, words) int32, i1 (n, t_pad) int32, feat2/thr2 (t_pad * 2^k1,
// lanes) int32, out (n, t_pad) int32; all contiguous. 1 <= k2 < lanes'
// depth (2^k2 - 1 <= lanes), 1 <= k1 <= 16.
extern "C" int packed_traverse_launch(const int32_t* packed, const int32_t* i1,
                                      const int32_t* feat2, const int32_t* thr2, int32_t* out,
                                      int64_t n, int words, int t_pad, int k1, int k2,
                                      int lanes, void* stream) {
  if (n <= 0 || t_pad <= 0) return 0;
  if (words < 1 || k1 < 1 || k1 > 16 || k2 < 1 || (1 << k2) - 1 > lanes)
    return (int)cudaErrorInvalidValue;
  const int64_t total = n * t_pad;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  packed_traverse_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, i1, feat2, thr2, out, n, words, t_pad, k1, k2, lanes);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
