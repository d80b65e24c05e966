// Shifted Gram pass: G = sum_r m_r (x_r - mu)(x_r - mu)^T and
// s = sum_r m_r (x_r - mu), in f32, for any n and d.
//
// Replaces spark_rapids_ml_tpu/ops/linalg.py::_shifted_gram_pallas (the
// pl.pallas_call at linalg.py:141), which streams row tiles through VMEM
// into one d x d accumulator carried across a sequential grid.
//
// What bounds it on an H100: at 12M x 256 the pass is 2*n*d^2 = 1.6 TFLOP
// of exact f32 FMA (half of it with the symmetric trick used here) against
// 12.3 GB read once: ~12 ms of FP32 issue at 67 TFLOP/s against ~4 ms of
// HBM at 3.35 TB/s, so the CUDA cores, not memory, are the limit. The
// products stay in plain f32 FMA (no TF32, no tensor cores) to match the
// JAX package's CPU/interpret oracle.
//
// Design. Blocks run in parallel in no order, so the TPU's resident
// accumulator becomes a grid of (upper-triangle 128x128 output tile, row
// split): each block walks its row range in 16-row stages, staging the
// shifted and masked rows (x - mu) * m of its two column panels in shared
// memory, and accumulates an 8x8 register micro-tile per thread (the
// classic SGEMM layout). Only tiles with ti <= tj are computed; the
// reduction pass mirrors them. Each block writes its partial tile to a
// scratch buffer, and a second pass sums the partials over splits in a
// fixed order: deterministic, with no float atomics. Rows past n and
// columns past d are zeroed with a select (not a multiply), as the TPU
// kernel guards its overhanging last tile. s comes from the diagonal
// tiles' staged panels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // output tile edge
constexpr int BK = 16;        // rows per shared-memory stage
constexpr int LD = TILE + 4;  // padded row stride (keeps float4 alignment)
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void upper_tile(int t, int T, int* ti, int* tj) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// micro-tile row/col i in [0, 8) of thread coordinate c in [0, 16)
__device__ __forceinline__ int micro(int c, int i) {
  return i < 4 ? c * 4 + i : 64 + c * 4 + (i - 4);
}

__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const float* __restrict__ X, const float* __restrict__ m,
                    const float* __restrict__ mu, float* __restrict__ part_G,
                    float* __restrict__ part_s, int64_t n, int d, int T,
                    int64_t rows_per_split) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];

  int ti, tj;
  upper_tile(blockIdx.x, T, &ti, &tj);
  const bool diag = ti == tj;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ci0 = ti * TILE, cj0 = tj * TILE;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ssum = 0.f;  // diagonal blocks: thread tid < TILE owns column ci0+tid

  for (int64_t rb = r0; rb < r1; rb += BK) {
#pragma unroll
    for (int i = 0; i < BK * TILE / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / TILE, c = idx % TILE;
      const int64_t r = rb + k;
      const bool rv = r < r1;
      const float mr = rv ? m[r] : 0.f;
      const int ca = ci0 + c, cb = cj0 + c;
      As[k][c] = (rv && ca < d) ? (X[r * d + ca] - mu[ca]) * mr : 0.f;
      Bs[k][c] = (rv && cb < d) ? (X[r * d + cb] - mu[cb]) * mr : 0.f;
    }
    __syncthreads();
    if (diag && tid < TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) ssum += As[k][tid];
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part_G + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE * TILE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = micro(ty, i);
    *reinterpret_cast<float4*>(&out[row * TILE + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&out[row * TILE + 64 + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (diag && tid < TILE) part_s[(int64_t)blockIdx.y * T * TILE + ci0 + tid] = ssum;
}

// Sums the per-split partials in split order and mirrors the upper tiles.
__global__ void gram_reduce_kernel(const float* __restrict__ part_G,
                                   const float* __restrict__ part_s,
                                   float* __restrict__ G, float* __restrict__ s,
                                   int d, int T, int nsplit) {
  const int t = blockIdx.y;
  const int n_up = gridDim.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < TILE * TILE) {
    int ti, tj;
    upper_tile(t, T, &ti, &tj);
    const int r = ti * TILE + e / TILE, c = tj * TILE + e % TILE;
    if (r < d && c < d) {
      float v = 0.f;
      for (int sp = 0; sp < nsplit; ++sp)
        v += part_G[((int64_t)sp * n_up + t) * TILE * TILE + e];
      G[(int64_t)r * d + c] = v;
      if (ti != tj) G[(int64_t)c * d + r] = v;
    }
  }
  if (t == 0 && e < d) {
    float v = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) v += part_s[(int64_t)sp * T * TILE + e];
    s[e] = v;
  }
}

}  // namespace

extern "C" int shifted_gram_launch(const float* X, const float* m, const float* mu,
                                   float* G, float* s, float* part_G, float* part_s,
                                   int64_t n, int d, int nsplit,
                                   int64_t rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (d + TILE - 1) / TILE;
  const int n_up = T * (T + 1) / 2;
  gram_partial_kernel<<<dim3(n_up, nsplit), THREADS, 0, st>>>(
      X, m, mu, part_G, part_s, n, d, T, rows_per_split);
  const int span = d > TILE * TILE ? d : TILE * TILE;
  gram_reduce_kernel<<<dim3((span + 255) / 256, n_up), 256, 0, st>>>(
      part_G, part_s, G, s, d, T, nsplit);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
