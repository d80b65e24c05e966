// Fused logistic loss and gradient in one read of X:
//   z = X A^T + b;  loss = sum_r m_r * ll_r;  R = (p - onehot(y)) * m;
//   gA = R^T X (K x d);  gb = sum_r R_r (K)
// binomial (K = 1): ll = softplus(z) - y z, p = sigmoid(z);
// multinomial: ll = logsumexp(z) - z_y, p = softmax(z).
//
// Replaces spark_rapids_ml_tpu/ops/logreg_pallas.py::_loss_grad_pallas (the
// pl.pallas_call at logreg_pallas.py:152), the data pass behind the
// custom VJP of make_fused_data_loss: value and gradient of an L-BFGS
// evaluation cost one pass over X instead of autodiff's two.
//
// What bounds it on an H100: memory. One evaluation reads X once (12.3 GB
// at 12M x 256, ~4 ms at 3.35 TB/s) and does ~4*n*K*d f32 operations
// (~12 GFLOP at K = 1, well under a millisecond at the FP32 peak).
//
// Design. Two kernels share the output contract and the fixed-order second
// pass. For small K*d (K = 1 with d <= 1024, or K <= 8 with d <= 128; d a
// multiple of 4) logreg_rows_kernel below gives each warp whole rows held
// in registers, with no barrier in its row loop. Otherwise the general
// kernel: blocks take contiguous row ranges and walk them in tiles of RT
// rows. Per tile: (L) each warp computes logits for (row, 8-class chunk)
// pairs, lanes striding over d (coalesced row reads; A is small and read
// through the L1 cache, so any K*d fits without tiling A in shared
// memory); the RT x K logits live in shared memory. (R) a warp per row
// turns its logits into the loss and the residual row in place. There are
// no padded classes on the GPU, so the TPU kernel's -1e30 class mask is
// not needed. (G) each thread owns (8-class chunk, column) pairs, re-reads
// its column of the tile (L1/L2 hits: the tile was just read) and adds
// R^T x into the block's partial (K x (d+1), the last column being the
// intercept gradient) in a per-block scratch slice that only it touches.
// A second pass sums the block partials and the block losses in a fixed
// order: deterministic, with no float atomics.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 8;  // classes per register chunk

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(THREADS)
logreg_partial_kernel(const float* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ m, const float* __restrict__ A,
                      const float* __restrict__ b, float* __restrict__ part,
                      float* __restrict__ loss_part, int64_t n, int d, int K,
                      int multinomial, int RT, int64_t rows_per_block) {
  extern __shared__ float Z[];  // [RT][K]: logits, then residuals
  __shared__ float warp_loss[WARPS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n, r0 + rows_per_block);
  const int D1 = d + 1;
  const int nkc = (K + KC - 1) / KC;
  float* P = part + (int64_t)blockIdx.x * K * D1;  // [K][D1]

  // element e = (class chunk, column) is owned by one thread for the whole
  // kernel, so zeroing and every later update of it need no sync
  for (int e = tid; e < nkc * D1; e += THREADS) {
    const int kc = e / D1, c = e % D1;
    for (int j = 0; j < KC && kc * KC + j < K; ++j) P[(int64_t)(kc * KC + j) * D1 + c] = 0.f;
  }

  float lsum = 0.f;
  for (int64_t rb = r0; rb < r1; rb += RT) {
    const int nr = (int)min((int64_t)RT, r1 - rb);

    // (L) logits
    for (int p = warp; p < nr * nkc; p += WARPS) {
      const int rr = p / nkc, kc = p % nkc;
      const int kn = min(KC, K - kc * KC);
      const float* xr = X + (rb + rr) * d;
      const float* Ak = A + (int64_t)kc * KC * d;
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float xv = xr[c];
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kn) acc[j] = fmaf(xv, __ldg(&Ak[(int64_t)j * d + c]), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j < kn) {
          const float v = warp_sum(acc[j]);
          if (lane == 0) Z[rr * K + kc * KC + j] = v + b[kc * KC + j];
        }
      }
    }
    __syncthreads();

    // (R) loss and residuals, one warp per row
    for (int rr = warp; rr < nr; rr += WARPS) {
      const int64_t r = rb + rr;
      const float mr = m[r], yr = y[r];
      float* z = Z + rr * K;
      if (!multinomial) {
        if (lane == 0) {
          const float z1 = z[0];
          const float softplus = fmaxf(z1, 0.f) + log1pf(expf(-fabsf(z1)));
          lsum += (softplus - yr * z1) * mr;
          z[0] = (1.f / (1.f + expf(-z1)) - yr) * mr;
        }
      } else {
        const int yi = (int)yr;
        float zmax = -CUDART_INF_F;
        for (int c = lane; c < K; c += 32) zmax = fmaxf(zmax, z[c]);
        zmax = warp_max(zmax);
        float se = 0.f;
        for (int c = lane; c < K; c += 32) se += expf(z[c] - zmax);
        se = warp_sum(se);
        const float zy = (yi >= 0 && yi < K) ? z[yi] : 0.f;
        __syncwarp();  // every lane has read z before any lane overwrites it
        if (lane == 0) lsum += (logf(se) + zmax - zy) * mr;
        for (int c = lane; c < K; c += 32)
          z[c] = (expf(z[c] - zmax) / se - (c == yi ? 1.f : 0.f)) * mr;
      }
    }
    __syncthreads();

    // (G) block partial of R^T [x, 1]
    for (int e = tid; e < nkc * D1; e += THREADS) {
      const int kc = e / D1, c = e % D1;
      const int kn = min(KC, K - kc * KC);
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      for (int rr = 0; rr < nr; ++rr) {
        const float xv = c < d ? X[(rb + rr) * d + c] : 1.f;
        const float* zr = Z + rr * K + kc * KC;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kn) acc[j] = fmaf(zr[j], xv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j < kn) P[(int64_t)(kc * KC + j) * D1 + c] += acc[j];
    }
    __syncthreads();
  }

  lsum = warp_sum(lsum);
  if (lane == 0) warp_loss[warp] = lsum;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += warp_loss[w];
    loss_part[blockIdx.x] = t;
  }
}

// Row-per-warp variant for small K*d (the main path: binomial, d = 256).
// A warp owns whole rows: each lane holds NV float4 chunks of the row and
// of every class's coefficients in registers, the logits come from warp
// sums, every lane computes the loss and residuals redundantly, and the
// R^T x contribution accumulates in registers across all of the warp's
// rows; two rows are loaded per step to keep more bytes in flight. No
// shared memory or barrier inside the row loop. At the end the block's 8
// warps are summed through shared memory into the block's partial, in
// the same layout (and the same fixed-order second pass) as above.
template <int NV, int KR>
__global__ void __launch_bounds__(THREADS)
logreg_rows_kernel(const float* __restrict__ X, const float* __restrict__ y,
                   const float* __restrict__ m, const float* __restrict__ A,
                   const float* __restrict__ b, float* __restrict__ part,
                   float* __restrict__ loss_part, int64_t n, int d, int K,
                   int multinomial) {
  __shared__ __align__(16) float red[WARPS][KR * NV * 128 + 8];  // +8: gb, keeps rows 16B-aligned
  __shared__ float warp_loss[WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  const int64_t nw = (int64_t)gridDim.x * WARPS;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 a[KR][NV], g[KR][NV];
  float bk[KR], gb[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    bk[k] = k < K ? b[k] : 0.f;
    gb[k] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * 4;
      a[k][v] = (k < K && c < d) ? *reinterpret_cast<const float4*>(A + (int64_t)k * d + c) : zero4;
      g[k][v] = zero4;
    }
  }
  float lsum = 0.f;

  for (int64_t r0 = gw; r0 < n; r0 += 2 * nw) {
    float4 x[2][NV];
    float mr[2], yr[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t r = r0 + u * nw;
      const bool rv = r < n;
      mr[u] = rv ? __ldg(m + r) : 0.f;
      yr[u] = rv ? __ldg(y + r) : 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (v * 32 + lane) * 4;
        x[u][v] = (rv && c < d) ? __ldg(reinterpret_cast<const float4*>(X + r * d + c)) : zero4;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float z[KR], rk[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          s = fmaf(x[u][v].x, a[k][v].x, s);
          s = fmaf(x[u][v].y, a[k][v].y, s);
          s = fmaf(x[u][v].z, a[k][v].z, s);
          s = fmaf(x[u][v].w, a[k][v].w, s);
        }
        z[k] = (k < K) ? warp_sum(s) + bk[k] : -CUDART_INF_F;
      }
      float ll;
      if (!multinomial) {
        const float z1 = z[0];
        ll = fmaxf(z1, 0.f) + log1pf(expf(-fabsf(z1))) - yr[u] * z1;
        rk[0] = (1.f / (1.f + expf(-z1)) - yr[u]) * mr[u];
#pragma unroll
        for (int k = 1; k < KR; ++k) rk[k] = 0.f;
      } else {
        const int yi = (int)yr[u];
        float zmax = -CUDART_INF_F, zy = 0.f, se = 0.f;
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          zmax = fmaxf(zmax, z[k]);
          if (k == yi) zy = z[k];
        }
#pragma unroll
        for (int k = 0; k < KR; ++k) se += (k < K) ? expf(z[k] - zmax) : 0.f;
        ll = logf(se) + zmax - zy;
#pragma unroll
        for (int k = 0; k < KR; ++k)
          rk[k] = (k < K) ? (expf(z[k] - zmax) / se - (k == yi ? 1.f : 0.f)) * mr[u] : 0.f;
      }
      lsum += ll * mr[u];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        gb[k] += rk[k];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          g[k][v].x = fmaf(rk[k], x[u][v].x, g[k][v].x);
          g[k][v].y = fmaf(rk[k], x[u][v].y, g[k][v].y);
          g[k][v].z = fmaf(rk[k], x[u][v].z, g[k][v].z);
          g[k][v].w = fmaf(rk[k], x[u][v].w, g[k][v].w);
        }
      }
    }
  }

  // block partial: sum the 8 warps' register accumulators in warp order
  float* R = red[warp];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      *reinterpret_cast<float4*>(&R[(k * NV + v) * 128 + lane * 4]) = g[k][v];
    if (lane == 0) R[KR * NV * 128 + k] = gb[k];
  }
  if (lane == 0) warp_loss[warp] = lsum;
  __syncthreads();
  const int D1 = d + 1;
  float* P = part + (int64_t)blockIdx.x * K * D1;
  for (int e = threadIdx.x; e < K * D1; e += THREADS) {
    const int k = e / D1, c = e % D1;
    // column c < d sits in chunk v = c / 128 at lane slot c % 128
    const int slot = c < d ? (k * NV + c / 128) * 128 + c % 128 : KR * NV * 128 + k;
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += red[w][slot];
    P[e] = v;
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += warp_loss[w];
    loss_part[blockIdx.x] = t;
  }
}

// Fixed-order sum over blocks: element e < K*(d+1) -> gA / gb, the last
// element -> loss.
__global__ void logreg_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ loss_part, int nb,
                                     float* __restrict__ gA, float* __restrict__ gb,
                                     float* __restrict__ loss, int d, int K) {
  const int64_t D1 = d + 1;
  const int64_t per = (int64_t)K * D1;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < per) {
    float v = 0.f;
    for (int bk = 0; bk < nb; ++bk) v += part[bk * per + e];
    const int64_t k = e / D1, c = e % D1;
    if (c < d)
      gA[k * d + c] = v;
    else
      gb[k] = v;
  } else if (e == per) {
    float v = 0.f;
    for (int bk = 0; bk < nb; ++bk) v += loss_part[bk];
    loss[0] = v;
  }
}

}  // namespace

// Which row-per-warp instance takes (d, K), or 0 for the general kernel:
// 10 * NV + KR with NV float4 chunks per lane (d <= 128 NV, d % 4 == 0)
// and KR >= K register classes; K = 1 covers the binomial main path.
extern "C" int logreg_rows_variant(int d, int K) {
  if (d % 4 != 0 || d > 1024) return 0;
  const int nv = (d + 127) / 128;
  const int NV = nv <= 1 ? 1 : nv <= 2 ? 2 : nv <= 4 ? 4 : 8;
  if (K == 1) return 10 * NV + 1;
  if (K <= 8 && NV == 1) return 10 * NV + 8;
  return 0;
}

extern "C" int logreg_loss_grad_launch(const float* X, const float* y, const float* m,
                                       const float* A, const float* b, float* gA,
                                       float* gb, float* loss, float* part,
                                       float* loss_part, int64_t n, int d, int K,
                                       int multinomial, int RT, int nblocks,
                                       int64_t rows_per_block, int variant,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)RT * K;
#define ROWS(NV, KR)                                                     \
  case 10 * NV + KR:                                                     \
    logreg_rows_kernel<NV, KR><<<nblocks, THREADS, 0, st>>>(            \
        X, y, m, A, b, part, loss_part, n, d, K, multinomial);           \
    break;
  switch (variant) {
    ROWS(1, 1)
    ROWS(2, 1)
    ROWS(4, 1)
    ROWS(8, 1)
    ROWS(1, 8)
    default:
      logreg_partial_kernel<<<nblocks, THREADS, smem, st>>>(
          X, y, m, A, b, part, loss_part, n, d, K, multinomial, RT, rows_per_block);
  }
#undef ROWS
  const int64_t total = (int64_t)K * (d + 1) + 1;
  logreg_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, loss_part, nblocks, gA, gb, loss, d, K);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
