// One UMAP SGD epoch over CSR-padded rows: for every row r (head h[r]) the
// sum over its K slots of the clipped attractive pull towards the slot's
// tail row and the clipped repulsive pushes away from `neg` negative rows,
// every term masked by the slot's Bernoulli draw u < p:
//   attractive  -2ab (d2)^(b-1) / (a (d2)^b + 1) * diff, clipped to +-4,
//               times attract_scale
//   repulsive   2 gamma b / ((0.001 + d2) (a (d2)^b + 1)) * diff, clipped
// each zero where d2 = 0. The negative of slot (r, k), sample s, is
//   src[perm[(((r - offs[s]) mod R) * K + k) mod n_tab]]
// (a permutation of the table laid cyclically over the slots and rolled by
// offs[s] rows), computed here from perm and offs: the (R, neg*K) id array
// is never written. Output: the per-row gradient sums (R, C).
//
// Replaces spark_rapids_ml_tpu/ops/umap_pallas.py::sgd_epoch_rows (the
// pl.pallas_call at umap_pallas.py:277), which keeps the whole embedding
// table resident in VMEM and streams the CSR rows through it.
//
// What bounds it on an H100: the bytes it must stream, 12 bytes a slot
// (tail id, p, u) plus the (R, C) head rows in and sums out; at the UMAP fit
// shape (~0.1M rows x K = 24) that is ~30 MB, ~9 us at 3.35 TB/s. The
// K (1 + neg) row gathers a row makes go to the table, which at
// 65,536 x 2 f32 is 512 KB and stays in the 50 MB L2: they are L2 reads,
// not device-memory traffic. A shared-memory copy of the table does not fit
// a block (227 KB), and L2 already holds it.
//
// Design. One warp per CSR row, lanes over the K slots (K <= 128 loops).
// An inactive slot (u >= p) is skipped: its terms are zero in the
// reference too. powf is the exact library function (no fast-math flag),
// so (d2)^(b-1) stays accurate at d2 near 0. Each lane sums its slots' C
// components in registers; a warp shuffle reduction gives the row's sums.
// C is a template parameter (1..8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NEG = 16;

__device__ __forceinline__ float clip4(float x) { return fminf(fmaxf(x, -4.f), 4.f); }

template <int C>
__global__ void __launch_bounds__(THREADS)
sgd_epoch_kernel(const float* __restrict__ src, const float* __restrict__ h,
                 const int* __restrict__ tails, const float* __restrict__ p,
                 const int* __restrict__ perm, const int* __restrict__ offs,
                 const float* __restrict__ u, float* __restrict__ out, int64_t R,
                 int K, int neg, int64_t n_tab, float a, float b, float bm1,
                 float c_att, float c_rep, float attract_scale) {
  __shared__ int offs_s[MAX_NEG];
  if (threadIdx.x < neg) offs_s[threadIdx.x] = offs[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= R) return;

  float hv[C], g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    hv[c] = h[r * C + c];
    g[c] = 0.f;
  }
  for (int k = lane; k < K; k += 32) {
    const int64_t e = r * K + k;
    if (!(u[e] < p[e])) continue;
    const float* t = src + (int64_t)tails[e] * C;
    float diff[C];
    float d2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      diff[c] = hv[c] - t[c];
      d2 += diff[c] * diff[c];
    }
    if (d2 > 0.f) {
      const float ac = c_att * powf(d2, bm1) / (a * powf(d2, b) + 1.f);
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] += clip4(ac * diff[c]) * attract_scale;
    }
    for (int s = 0; s < neg; ++s) {
      int64_t rr = r - offs_s[s];
      if (rr < 0) rr += R;
      const float* tn = src + (int64_t)perm[(rr * K + k) % n_tab] * C;
      float dn[C];
      float d2n = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dn[c] = hv[c] - tn[c];
        d2n += dn[c] * dn[c];
      }
      if (d2n > 0.f) {
        const float rc = c_rep / ((0.001f + d2n) * (a * powf(d2n, b) + 1.f));
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] += clip4(rc * dn[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v = g[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) out[r * C + c] = v;
  }
}

template <int C>
void launch(const float* src, const float* h, const int* tails, const float* p,
            const int* perm, const int* offs, const float* u, float* out, int64_t R,
            int K, int neg, int64_t n_tab, float a, float b, float bm1, float c_att,
            float c_rep, float attract_scale, cudaStream_t st) {
  const int64_t nb = (R + THREADS / 32 - 1) / (THREADS / 32);
  sgd_epoch_kernel<C><<<(unsigned)nb, THREADS, 0, st>>>(
      src, h, tails, p, perm, offs, u, out, R, K, neg, n_tab, a, b, bm1, c_att, c_rep,
      attract_scale);
}

}  // namespace

// a, b, gamma arrive as the f32 constants the reference multiplies by:
// bm1 = b - 1, c_att = -2ab and c_rep = 2 gamma b, each formed in double.
extern "C" int umap_sgd_epoch_launch(const float* src, const float* h, const int* tails,
                                     const float* p, const int* perm, const int* offs,
                                     const float* u, float* out, int64_t R, int K, int C,
                                     int neg, int64_t n_tab, float a, float b, float bm1,
                                     float c_att, float c_rep, float attract_scale,
                                     void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || neg < 0 || neg > MAX_NEG || n_tab < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SGD_CASE(CC)                                                                     \
  case CC:                                                                               \
    launch<CC>(src, h, tails, p, perm, offs, u, out, R, K, neg, n_tab, a, b, bm1, c_att, \
               c_rep, attract_scale, st);                                                \
    break;
  switch (C) {
    SGD_CASE(1)
    SGD_CASE(2)
    SGD_CASE(3)
    SGD_CASE(4)
    SGD_CASE(5)
    SGD_CASE(6)
    SGD_CASE(7)
    SGD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SGD_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
