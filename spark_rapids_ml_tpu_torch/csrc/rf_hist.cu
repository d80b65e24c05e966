// Per-sub-block histograms of the RandomForest builder (kernels K5 and K6).
//
// Rows arrive sorted by tree node, each node's run padded to a multiple of
// r_sub rows, so every aligned sub-block of r_sub rows belongs to one node
// (padding rows carry sw == 0 and any bin). For sub-block j, stat s and
// feature slot f the kernel writes
//   out[j, s, f * nb + b] = sum over rows r of sub-block j with bin(r, f) == b
//                           of sw[r, s]
// for every b in [0, nb): the whole (S, k * nb) tile, zeros included.
//   K5 (subblock_hist):     bin(r, f) = binq[r, f], int32 bins gathered
//                           beforehand; a bin outside [0, nb) adds nothing.
//   K6 (subblock_hist_sel): bin(r, f) = bq[r, featsq[j, f]], the slot's
//                           feature id looked up per sub-block and the byte
//                           read from the full uint8 row; an id outside
//                           [0, d_pad) (the sentinel n_features when
//                           n_features == d_pad) gives bin 0.
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::subblock_hist (the
// pl.pallas_call at rf_pallas.py:190) and ::subblock_hist_sel (:312), which
// build each tile as one-hot matrix products on the MXU.
//
// What bounds it on an H100: the bytes. The output tile is dense although a
// sub-block of r_sub rows touches at most r_sub of each slot's nb bins: at
// the bench forest's deepest level (r_sub = 16, k = 16, nb = 128, S = 2) a
// 16-row sub-block reads 1.2 KB and writes 16 KB, so the partials written
// (1.6 GB for 8 trees) are the whole cost. Adds are S * k per row, a few
// hundred million a level: nothing next to the writes.
//
// Design. One block per (sub-block, tile of (stat, slot) pairs). The pair
// p = s * k + f owns the nb floats at out[j, p * nb ...], so a tile of
// consecutive pairs is one contiguous run of the output row, held in shared
// memory (at most 8,192 floats, 32 KB), zero-filled, then written out whole
// with coalesced stores. One thread per pair walks the sub-block's rows in
// order and adds sw[r, s] at its bin: no two threads share a bin, so there
// are no atomics, and every bin sums its rows in row order. The result is
// bitwise repeatable from run to run, and equal to a sequential sum in row
// order (what the plain version's scatter_add_ computes on the CPU). The add
// is a plain f32 add (no product to contract), exact to IEEE rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE_FLOATS = 8192;

template <bool SEL>
__global__ void __launch_bounds__(THREADS)
subblock_hist_kernel(const int32_t* __restrict__ binq, const uint8_t* __restrict__ bq,
                     const int32_t* __restrict__ featsq, const float* __restrict__ sw,
                     float* __restrict__ out, int r_sub, int k, int nb, int S, int d_pad,
                     int pairs_per_tile) {
  extern __shared__ float h[];
  const int64_t sb = blockIdx.x;
  const int p0 = blockIdx.y * pairs_per_tile;
  const int P = min(pairs_per_tile, S * k - p0);
  const int nfl = P * nb;
  for (int i = threadIdx.x; i < nfl; i += THREADS) h[i] = 0.f;
  __syncthreads();

  const int64_t r0 = sb * r_sub;
  for (int q = threadIdx.x; q < P; q += THREADS) {
    const int p = p0 + q;
    const int s = p / k;
    const int f = p - s * k;
    float* hq = h + q * nb;
    int fid = 0;
    bool in_row = true;
    if (SEL) {
      fid = featsq[sb * k + f];
      in_row = fid >= 0 && fid < d_pad;
    }
    for (int j = 0; j < r_sub; ++j) {
      const int64_t r = r0 + j;
      int b;
      if (SEL) {
        b = in_row ? (int)bq[r * d_pad + fid] : 0;
      } else {
        b = binq[r * k + f];
      }
      const float w = sw[r * S + s];
      if (b >= 0 && b < nb) hq[b] += w;
    }
  }
  __syncthreads();

  float* o = out + sb * ((int64_t)S * k * nb) + (int64_t)p0 * nb;
  for (int i = threadIdx.x; i < nfl; i += THREADS) o[i] = h[i];
}

template <bool SEL>
int launch(const int32_t* binq, const uint8_t* bq, const int32_t* featsq, const float* sw,
           float* out, int64_t n_sb, int r_sub, int k, int nb, int S, int d_pad,
           cudaStream_t st) {
  if (n_sb <= 0) return 0;
  if (r_sub < 1 || k < 1 || nb < 1 || nb > 256 || S < 1 || n_sb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int pairs = S * k;
  const int per_tile = min(pairs, TILE_FLOATS / nb);
  const int n_tiles = (pairs + per_tile - 1) / per_tile;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)per_tile * nb * sizeof(float);
  dim3 grid((unsigned)n_sb, (unsigned)n_tiles);
  subblock_hist_kernel<SEL><<<grid, THREADS, smem, st>>>(binq, bq, featsq, sw, out, r_sub, k,
                                                         nb, S, d_pad, per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. binq (n_sb * r_sub, k) int32, sw (n_sb * r_sub, S) f32, out
// (n_sb, S, k * nb) f32; all contiguous.
extern "C" int subblock_hist_launch(const int32_t* binq, const float* sw, float* out,
                                    int64_t n_sb, int r_sub, int k, int nb, int S,
                                    void* stream) {
  return launch<false>(binq, nullptr, nullptr, sw, out, n_sb, r_sub, k, nb, S, 0,
                       static_cast<cudaStream_t>(stream));
}

// K6. bq (n_sb * r_sub, d_pad) uint8, featsq (n_sb, k) int32, sw
// (n_sb * r_sub, S) f32, out (n_sb, S, k * nb) f32; all contiguous.
extern "C" int subblock_hist_sel_launch(const uint8_t* bq, const int32_t* featsq,
                                        const float* sw, float* out, int64_t n_sb, int r_sub,
                                        int k, int nb, int S, int d_pad, void* stream) {
  if (d_pad < 1) return (int)cudaErrorInvalidValue;
  return launch<true>(nullptr, bq, featsq, sw, out, n_sb, r_sub, k, nb, S, d_pad,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
