// Fused Lloyd step: for every row, the nearest centre by ||c||^2 - 2 x.c
// (ties to the lowest index, as jnp.argmin), then sums[a] += m*x,
// counts[a] += (m > 0) and cost += m * max(best + ||x||^2, 0), in one read
// of X. The (n, k) score and one-hot intermediates never reach device
// memory.
//
// Replaces spark_rapids_ml_tpu/ops/kmeans_pallas.py::lloyd_step_pallas (the
// pl.pallas_call at kmeans_pallas.py:174), which keeps the distance tile,
// the one-hot and the (k, d) accumulators resident in VMEM.
//
// What bounds it on an H100: the score product is 2*n*k*d operations of
// exact f32 FMA — 6.3 TFLOP per pass at 12M x 256 and k = 1024, ~94 ms at
// the 67 TFLOP/s FP32 peak — against 12.3 GB of X (~4 ms at 3.35 TB/s).
// The CUDA cores are the limit; the products stay in f32 FMA (no TF32) to
// match the JAX package's CPU/interpret oracle.
//
// Design. One block owns 128 rows. It loops over centre tiles of 128,
// and over d in stages of 16 staged in shared memory (so any k and any d
// fit), computing the 128 x 128 score tile as an 8 x 8 register
// micro-tile per thread (SGEMM layout). Each row keeps a running
// (min, argmin): within a tile the 16 threads sharing a row combine by
// shuffles with a lowest-index tie rule; across tiles a later tile (higher
// indices) wins only when strictly smaller. ||x||^2 is row-constant, so it
// joins the cost only, never the argmin. Then each warp walks rows,
// re-reads them (the block's 128 rows are still in L2), and adds m*x into
// sums[a] with f32 atomics and 1 into counts[a] with int32 atomics (exact).
// The atomics' order varies from run to run, so sums agree with a fixed-
// order sum to f32 rounding (relative ~1e-6 times the rows per cluster),
// not bitwise. The cost is summed per block and then over blocks in a
// fixed order. There is no k padding on the GPU, so the TPU kernel's +inf
// padded centres are not needed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows per block
constexpr int BN = 128;       // centres per tile
constexpr int BK = 16;        // features per shared-memory stage
constexpr int LD = BM + 4;    // padded stride, keeps float4 alignment
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 scores each

__device__ __forceinline__ int micro(int c, int i) {
  return i < 4 ? c * 4 + i : 64 + c * 4 + (i - 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
lloyd_kernel(const float* __restrict__ X, const float* __restrict__ m,
             const float* __restrict__ C, const float* __restrict__ csq,
             float* __restrict__ sums, int* __restrict__ counts,
             float* __restrict__ cost_part, int64_t n, int d, int k) {
  __shared__ __align__(16) float Xs[BK][LD];
  __shared__ __align__(16) float Cs[BK][LD];
  __shared__ float best_s[BM];
  __shared__ int arg_s[BM];
  __shared__ float warp_cost[THREADS / 32];

  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = CUDART_INF_F;
    arg[i] = 0;
  }

  // stages (centre tile, feature slice) in order; the next stage is loaded
  // into registers while this one is multiplied
  constexpr int PER = BM * BK / THREADS;
  float rx[PER], rc[PER];
  auto load = [&](int c0, int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gc = k0 + kk;
      const int64_t gr = row0 + r;
      const int cr = c0 + r;
      rx[i] = (gr < n && gc < d) ? X[gr * d + gc] : 0.f;
      rc[i] = (cr < k && gc < d) ? C[(int64_t)cr * d + gc] : 0.f;
    }
  };
  load(0, 0);

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * THREADS;
        Xs[idx % BK][idx / BK] = rx[i];
        Cs[idx % BK][idx / BK] = rc[i];
      }
      __syncthreads();
      if (k0 + BK < d)
        load(c0, k0 + BK);
      else if (c0 + BN < k)
        load(c0 + BN, 0);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Cs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Cs[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float bv = CUDART_INF_F;
      int ba = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // increasing centre index
        const int col = c0 + micro(tx, j);
        if (col < k) {
          const float sc = csq[col] - 2.f * acc[i][j];
          if (sc < bv) {
            bv = sc;
            ba = col;
          }
        }
      }
      // the 16 lanes sharing this row (same ty) sit in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oa = __shfl_xor_sync(0xffffffffu, ba, off);
        if (ov < bv || (ov == bv && oa < ba)) {
          bv = ov;
          ba = oa;
        }
      }
      if (bv < best[i]) {  // later tiles hold higher indices: strict <
        best[i] = bv;
        arg[i] = ba;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best_s[micro(ty, i)] = best[i];
      arg_s[micro(ty, i)] = arg[i];
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  float wc = 0.f;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int64_t gr = row0 + r;
    if (gr >= n) break;
    const float mr = m[gr];
    const int a = arg_s[r];
    const float* xr = X + gr * d;
    float* sa = sums + (int64_t)a * d;
    float xsq = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = xr[c];
      xsq = fmaf(v, v, xsq);
      if (mr != 0.f) atomicAdd(&sa[c], mr * v);
    }
    xsq = warp_sum(xsq);
    if (lane == 0) {
      if (mr > 0.f) atomicAdd(&counts[a], 1);
      wc += fmaxf(best_s[r] + xsq, 0.f) * mr;
    }
  }
  if (lane == 0) warp_cost[warp] = wc;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += warp_cost[w];
    cost_part[blockIdx.x] = t;
  }
}

// Fixed-order sum of the per-block costs.
__global__ void cost_reduce_kernel(const float* __restrict__ part, int64_t nb,
                                   float* __restrict__ cost) {
  __shared__ float sh[256];
  float v = 0.f;
  for (int64_t i = threadIdx.x; i < nb; i += 256) v += part[i];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[0] = sh[0];
}

}  // namespace

extern "C" int lloyd_step_launch(const float* X, const float* m, const float* C,
                                 const float* csq, float* sums, int* counts,
                                 float* cost, float* cost_part, int64_t n, int d,
                                 int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)k * d, st);
  cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)k, st);
  const int64_t nb = (n + BM - 1) / BM;
  if (nb > 0)
    lloyd_kernel<<<(unsigned)nb, THREADS, 0, st>>>(X, m, C, csq, sums, counts,
                                                   cost_part, n, d, k);
  cost_reduce_kernel<<<1, 256, 0, st>>>(cost_part, nb, cost);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
