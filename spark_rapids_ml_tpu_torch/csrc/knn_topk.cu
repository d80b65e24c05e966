// Fused distance tile + exact running top-k: folds every item of Xi into
// each query row's k best (score, id) pairs, score = ||xi||^2 - 2 xq.xi
// (the row-constant ||xq||^2 is added back outside). Items masked or padded
// by the caller come in at +inf through csq and are never selected. The
// order is (score, id) lexicographic, so exact ties keep the lower id, as
// lax.top_k does. The state is read and written sorted in that order.
//
// Replaces spark_rapids_ml_tpu/ops/knn_pallas.py::knn_pallas_pass (the
// pl.pallas_call at knn_pallas.py:160), which carries the running top-k of
// one query block across a sequential item grid axis and extracts
// candidates from a VMEM-resident score tile under a tau gate.
//
// What bounds it on an H100: 2*nq*ni*d operations of exact f32 FMA. At the
// kNN shape (131,072 queries x 1,000,000 items x 256) that is 6.71e16,
// >= 1.00 s at the 67 TFLOP/s FP32 peak, against 1.16 GB of inputs and
// state (0.35 ms at 3.35 TB/s). At the UMAP graph shape (65,536^2 x 256,
// k = 16) the bound is 33 ms. The CUDA cores are the limit; the products
// stay in f32 FMA (no TF32) so scores agree with the f32 references.
// A block of 128 query rows re-reads the whole item matrix: 1,024 blocks x
// 1 GB = ~1 TB from L2/HBM at the kNN shape (~0.3 s at 3.35 TB/s), still
// under the compute bound.
//
// Design. One block owns 128 query rows and sweeps every item tile of 128,
// so the top-k state never leaves the block and no cross-block merge is
// needed: the loop over item tiles takes the place of the TPU's sequential
// item grid axis. The 128 x 128 score tile is the SGEMM micro-tile of
// lloyd_step.cu (d in stages of 16 through shared memory, 8 x 8 scores per
// thread in registers, any d). Each row keeps its k best as a sorted list
// in shared memory. The tau gate: every thread tests its 64 scores against
// their rows' current k-th pair; only when some score in the block passes
// (__syncthreads_or) is the tile written to shared memory, and then one warp
// per row inserts the candidates that still pass, one at a time, into the
// sorted list (position by a warp count, shift by one). Once the lists
// tighten, most tiles insert nothing and cost the product alone. Ragged
// nq, ni and d are guarded by selects; k <= 128 (the state takes
// 128 * k * 8 bytes of shared memory).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // query rows per block
constexpr int BN = 128;       // items per tile
constexpr int BK = 16;        // features per shared-memory stage
constexpr int LD = BM + 4;    // padded stride, keeps float4 alignment
constexpr int TLD = BN + 4;   // score tile stride
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 scores each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int micro(int c, int i) {
  return i < 4 ? c * 4 + i : 64 + c * 4 + (i - 4);
}

// (s, i) strictly before (t, j) in the (score, id) order
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

__global__ void __launch_bounds__(THREADS)
knn_topk_kernel(const float* __restrict__ Xq, const float* __restrict__ Xi,
                const float* __restrict__ csq, const int* __restrict__ ids,
                float* __restrict__ topd, int* __restrict__ topi, int64_t nq,
                int64_t ni, int d, int k) {
  __shared__ __align__(16) float Qs[BK][LD];
  __shared__ __align__(16) float Is[BK][LD];
  __shared__ float csq_s[BN];
  __shared__ int ids_s[BN];
  extern __shared__ __align__(16) unsigned char dyn[];
  float* tile = reinterpret_cast<float*>(dyn);  // [BM][TLD]
  float* S = tile + BM * TLD;                   // [BM][k] scores, sorted
  int* I = reinterpret_cast<int*>(S + BM * k);  // [BM][k] ids

  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < BM * k; e += THREADS) {
    const int64_t gr = row0 + e / k;
    S[e] = gr < nq ? topd[gr * k + e % k] : CUDART_INF_F;
    I[e] = gr < nq ? topi[gr * k + e % k] : -1;
  }

  // stages (item tile, feature slice) in order; the next stage is loaded
  // into registers while this one is multiplied
  constexpr int PER = BM * BK / THREADS;
  float rq[PER], ri[PER];
  auto load = [&](int64_t c0, int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gc = k0 + kk;
      const int64_t gq = row0 + r, gi = c0 + r;
      rq[i] = (gq < nq && gc < d) ? Xq[gq * d + gc] : 0.f;
      ri[i] = (gi < ni && gc < d) ? Xi[gi * d + gc] : 0.f;
    }
  };
  load(0, 0);

  for (int64_t c0 = 0; c0 < ni; c0 += BN) {
    const int nvalid = ni - c0 < BN ? (int)(ni - c0) : BN;
    if (tid < BN) {
      csq_s[tid] = tid < nvalid ? csq[c0 + tid] : CUDART_INF_F;
      ids_s[tid] = tid < nvalid ? ids[c0 + tid] : 0;
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * THREADS;
        Qs[idx % BK][idx / BK] = rq[i];
        Is[idx % BK][idx / BK] = ri[i];
      }
      __syncthreads();
      if (k0 + BK < d)
        load(c0, k0 + BK);
      else if (c0 + BN < ni)
        load(c0 + BN, 0);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Qs[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Qs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Is[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Is[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // tau gate: does any score of the block beat its row's k-th pair?
    int pass = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = micro(ty, i);
      const float ws = S[r * k + k - 1];
      const int wi = I[r * k + k - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = micro(tx, j);
        acc[i][j] = csq_s[col] - 2.f * acc[i][j];
        pass |= (col < nvalid && before(acc[i][j], ids_s[col], ws, wi));
      }
    }
    if (!__syncthreads_or(pass)) continue;

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* tr = tile + micro(ty, i) * TLD;
      *reinterpret_cast<float4*>(tr + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(tr + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

    // one warp per row: insert the passing candidates in lane order,
    // each re-tested against the row's current k-th pair
    for (int r = warp; r < BM && row0 + r < nq; r += WARPS) {
      float* Sr = S + r * k;
      int* Ir = I + r * k;
      float ws = Sr[k - 1];
      int wi = Ir[k - 1];
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        const int col = lane + 32 * q;
        const float s = tile[r * TLD + col];
        const int id = ids_s[col];
        unsigned mask = __ballot_sync(FULL, col < nvalid && before(s, id, ws, wi));
        while (mask) {
          const int srcl = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cs = __shfl_sync(FULL, s, srcl);
          const int ci = __shfl_sync(FULL, id, srcl);
          if (!before(cs, ci, ws, wi)) continue;  // uniform over the warp
          unsigned cnt = 0;
          for (int e = lane; e < k; e += 32) cnt += before(Sr[e], Ir[e], cs, ci);
          const int p = (int)__reduce_add_sync(FULL, cnt);  // p <= k - 1
          float v[MAX_K / 32];
          int vi[MAX_K / 32];
#pragma unroll
          for (int t = 0; t < MAX_K / 32; ++t) {
            const int e = lane + 32 * t;
            if (e >= p && e < k - 1) {
              v[t] = Sr[e];
              vi[t] = Ir[e];
            }
          }
          __syncwarp();
#pragma unroll
          for (int t = 0; t < MAX_K / 32; ++t) {
            const int e = lane + 32 * t;
            if (e >= p && e < k - 1) {
              Sr[e + 1] = v[t];
              Ir[e + 1] = vi[t];
            }
          }
          if (lane == 0) {
            Sr[p] = cs;
            Ir[p] = ci;
          }
          __syncwarp();
          ws = Sr[k - 1];
          wi = Ir[k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BM * k; e += THREADS) {
    const int64_t gr = row0 + e / k;
    if (gr < nq) {
      topd[gr * k + e % k] = S[e];
      topi[gr * k + e % k] = I[e];
    }
  }
}

}  // namespace

extern "C" int knn_topk_launch(const float* Xq, const float* Xi, const float* csq,
                               const int* ids, float* topd, int* topi, int64_t nq,
                               int64_t ni, int d, int k, void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * BM * TLD + (sizeof(float) + sizeof(int)) * BM * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t nb = (nq + BM - 1) / BM;
  if (nb > 0)
    knn_topk_kernel<<<(unsigned)nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        Xq, Xi, csq, ids, topd, topi, nq, ni, d, k);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
