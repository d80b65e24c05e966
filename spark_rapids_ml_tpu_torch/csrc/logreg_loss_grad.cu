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
// at 12M x 256, 3.70 ms at 3.35 TB/s) and does ~4*n*K*d f32 operations
// (~12 GFLOP at K = 1, well under a millisecond at the FP32 peak; 123
// GFLOP at K = 10, 1.83 ms: still below the bytes).
//
// Design. Five kernels and a route of two share the output contract and
// the fixed-order second pass; the caller picks one
// (ops/logreg_kernels.py::_k3_variant).
// For K = 1 (the binomial main path) with d <= 1024, d a multiple of 4,
// logreg_rows_kernel gives each warp whole rows held in registers, with no
// barrier in its row loop. For multinomial 2 <= K <= 16 with d <= 256, d a
// multiple of 4, logreg_mrows_kernel (see its note) streams X through a
// cp.async ring, so the bytes in flight do not depend on the register
// budget its K x d gradient takes, reads A from shared memory once per
// group of 2 or 4 rows, and reduces all of a group's logits together.
// Every other shape whose block gradient fits in the registers of one
// block (at most 16,384 floats of (4-class group, 4-column) items, 65,536
// at K = 1) and whose ring fits in shared memory takes logreg_tile_kernel
// (see its note): whole rows staged once in shared memory, A staged once
// a block, the gradient held on chip, one partial a resident block. Any
// d, any alignment. Past that cap, every multinomial shape takes the
// route of two 3xTF32 wgmma products (logreg_route_kernel, see its note),
// whose classes are padded to the wgmma N and masked; past 256 classes
// (up to 12,288) its class-tiled instance walks tiles of 128 classes with
// an online softmax. Binomial rows past the tile kernel's cap (16,380 < d
// <= 262,144) take logreg_cluster_kernel (see its note): each row's columns
// split over the CTAs of a thread-block cluster, staged once by
// cp.async.bulk, the partial logits exchanged through distributed shared
// memory, the gradient held in registers, X read once. Binomial d >
// 262,144 takes the general kernel: blocks take
// contiguous row ranges and walk them in tiles of RT rows. Per tile: (L)
// each warp computes logits for (row, 8-class chunk) pairs, lanes
// striding over d (A read through the L1 cache); the RT x K logits live
// in shared memory. (R) a warp per row turns its logits into the loss and
// the residual row in place. The general kernel pads no classes, so it
// needs no -1e30 class mask. (G) each thread owns
// (8-class chunk, column) pairs, re-reads its column of the tile and adds
// R^T x into the block's partial (K x (d+1), the last column being the
// intercept gradient) in a per-block scratch slice that only it touches.
// A second pass sums the block partials and the block losses in a fixed
// order: deterministic, with no float atomics.
//
// bf16 X (the JAX package's objective_dtype=bfloat16 and a bf16-placed X;
// logreg_loss_grad_bf16_launch): y, m, A, b and every sum stay f32. The
// binomial main path (K = 1, d <= 1024, d % 4 == 0) takes the bf16
// instance of logreg_rows_kernel, which loads each lane's 4 columns as one
// 8-byte group, widens them in registers and keeps 4 rows in flight (the
// bytes a row are half the f32 form's): 6.1 GB at 12M x 256, a bound of
// 1.83 ms. Every other shape (multinomial up to the f32 path's 12,288
// classes, any d, any alignment) takes the general kernel's bf16 instance:
// simple, correct, not tuned. Both follow the wrapper's numerical
// contract, one argument: round_ops = 1 where the JAX package would run its
// Pallas kernel (d % 128 == 0, d <= 2,048, K <= 120), which rounds A to
// bf16 for the logits and R to bf16 for the gradient product (the
// intercept sums and the loss from the f32 R and logits); round_ops = 0
// elsewhere, its XLA objective: X widened, A and R f32. A product of two
// bf16 values is exact in f32, so either contract's only rounding past
// the operands' is the f32 accumulation. Knock 256 (a negative control;
// the result is then wrong) leaves R unrounded under round_ops.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 8;  // classes per register chunk

// probe knock-outs (timing only: the results are then wrong): launch the
// partial kernel alone, the second pass alone; the general kernel's
// gradient stage without its re-read of X, or without its per-tile
// partial write (kept only where a sum hits a value no sum takes, so the
// sums are still computed)
constexpr int KNOCK_NO_REDUCE = 1;
constexpr int KNOCK_NO_PARTIAL = 2;
constexpr int KNOCK_G_NO_X = 4;
constexpr int KNOCK_NO_TILE_WRITE = 8;
// the bf16 instances: R not rounded for the gradient under round_ops
constexpr int KNOCK_NO_R_ROUND = 256;
// ring slots of logreg_tile_kernel (a deeper ring measured no faster)
constexpr int TILE_STAGES = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x rounded to bf16, to nearest with ties to even, as an f32 value
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// element i of X, f32 or (BF) bf16 widened to f32
template <bool BF>
__device__ __forceinline__ float x_at(const void* X, int64_t i) {
  if constexpr (BF)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(X)[i]);
  else
    return static_cast<const float*>(X)[i];
}

// four bf16 values (8 bytes, 8-byte aligned) widened to f32: a bf16 value
// is the high half of its f32
__device__ __forceinline__ float4 bf16x4_at(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// BF: X in bf16, under the wrapper's round_ops contract (see the note
// at the top).
template <bool BF>
__global__ void __launch_bounds__(THREADS)
logreg_partial_kernel(const void* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ m, const float* __restrict__ A,
                      const float* __restrict__ b, float* __restrict__ part,
                      float* __restrict__ loss_part, int64_t n, int d, int K,
                      int multinomial, int RT, int64_t rows_per_block, int knock, int round_ops) {
  const bool round_a = BF && round_ops, round_r = BF && round_ops && !(knock & KNOCK_NO_R_ROUND);
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
      const int64_t xr = (rb + rr) * d;
      const float* Ak = A + (int64_t)kc * KC * d;
      float acc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float xv = x_at<BF>(X, xr + c);
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kn) {
            const float av = __ldg(&Ak[(int64_t)j * d + c]);
            acc[j] = fmaf(xv, round_a ? bf16_round(av) : av, acc[j]);
          }
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
      const bool rz = round_r && c < d;  // the intercept column takes the f32 R
      for (int rr = 0; rr < nr; ++rr) {
        const float xv = c < d && !(knock & KNOCK_G_NO_X) ? x_at<BF>(X, (rb + rr) * d + c) : 1.f;
        const float* zr = Z + rr * K + kc * KC;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kn) acc[j] = fmaf(rz ? bf16_round(zr[j]) : zr[j], xv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j < kn && (!(knock & KNOCK_NO_TILE_WRITE) || acc[j] == 1.2345e-38f))
          P[(int64_t)(kc * KC + j) * D1 + c] += acc[j];
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

// Row-per-warp variant for K = 1 (the main path: binomial, d = 256).
// A warp owns whole rows: each lane holds NV float4 chunks of the row and
// of every class's coefficients in registers, the logits come from warp
// sums, every lane computes the loss and residuals redundantly, and the
// R^T x contribution accumulates in registers across all of the warp's
// rows; two rows are loaded per step to keep more bytes in flight. No
// shared memory or barrier inside the row loop. At the end the block's 8
// warps are summed through shared memory into the block's partial, in
// the same layout (and the same fixed-order second pass) as above.
// BF: X in bf16 (8-byte aligned), a lane's 4 columns one 8-byte load, 4
// rows a step, under the wrapper's round_ops contract (the note at the
// top).
template <int NV, int KR, bool BF>
__global__ void __launch_bounds__(THREADS)
logreg_rows_kernel(const void* __restrict__ Xv, const float* __restrict__ y,
                   const float* __restrict__ m, const float* __restrict__ A,
                   const float* __restrict__ b, float* __restrict__ part,
                   float* __restrict__ loss_part, int64_t n, int d, int K,
                   int multinomial, int round_ops, int knock) {
  constexpr int U = BF && NV <= 2 ? 4 : 2;  // rows loaded a step
  const bool round_a = BF && round_ops, round_r = BF && round_ops && !(knock & KNOCK_NO_R_ROUND);
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
      if (round_a)
        a[k][v] = make_float4(bf16_round(a[k][v].x), bf16_round(a[k][v].y), bf16_round(a[k][v].z),
                              bf16_round(a[k][v].w));
      g[k][v] = zero4;
    }
  }
  float lsum = 0.f;

  for (int64_t r0 = gw; r0 < n; r0 += U * nw) {
    float4 x[U][NV];
    float mr[U], yr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u * nw;
      const bool rv = r < n;
      mr[u] = rv ? __ldg(m + r) : 0.f;
      yr[u] = rv ? __ldg(y + r) : 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (v * 32 + lane) * 4;
        if constexpr (BF)
          x[u][v] = (rv && c < d) ? bf16x4_at(static_cast<const __nv_bfloat16*>(Xv) + r * d + c) : zero4;
        else
          x[u][v] = (rv && c < d) ? __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(Xv) + r * d + c))
                                  : zero4;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
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
        const float rg = round_r ? bf16_round(rk[k]) : rk[k];  // the intercept sum keeps the f32 R
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          g[k][v].x = fmaf(rg, x[u][v].x, g[k][v].x);
          g[k][v].y = fmaf(rg, x[u][v].y, g[k][v].y);
          g[k][v].z = fmaf(rg, x[u][v].z, g[k][v].z);
          g[k][v].w = fmaf(rg, x[u][v].w, g[k][v].w);
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

// cp.async: 16 bytes from global to shared memory, zero-filled past
// src_bytes (0 for a chunk outside X, whose address is then not read)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int MSTAGES = 4;  // X row groups a warp keeps in flight (+1 in use)

// lanes that hold one row's logits after the warp sum: 8 or 16
template <int KP>
__host__ __device__ constexpr int mrows_lanes() { return KP <= 8 ? 8 : 16; }

template <int NV, int KP>
constexpr size_t mrows_smem_floats() {
  // A, b (padded to 16 bytes), the warps' residual slots, then each
  // warp's cp.async ring of MSTAGES groups of R = 32 / LR rows, each row
  // NV * 128 floats
  return (size_t)KP * NV * 128 + (KP + 3) / 4 * 4 + WARPS * 32 +
         (size_t)WARPS * MSTAGES * (32 / mrows_lanes<KP>()) * NV * 128;
}

// One step of the warp's recursive-halving sum of 2H values a lane: the
// lane keeps the half whose index bit H equals its own lane bit H, adds
// its partner's copy of that half, and sends the other (H a template
// argument, so every index is known at compile time and s stays in
// registers)
template <int H>
__device__ __forceinline__ void halve(float (&s)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? s[j] : s[j + H];
    const float keep = up ? s[j + H] : s[j];
    s[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Multinomial register-row variant: d <= 128 NV (d % 4 == 0), K = KP
// classes, 2 <= KP <= 16. A row's logits take LR = 8 or 16 lanes
// (KP <= LR), and a warp takes groups of R = 32 / LR consecutive rows, so
// the R x LR logit slots of a group are exactly one value per lane:
//   - X streams through a per-warp ring of MSTAGES groups in shared memory
//     (cp.async, zero-filled past n and d); each lane copies and reads only
//     its own 16-byte chunks, so the ring needs no barrier. The bytes in
//     flight (3 groups a warp) do not depend on the registers the
//     gradient takes;
//   - A (zero-padded to NV*128 columns) and b sit in shared memory: one
//     float4 of a class is read once per group and serves its R rows, with
//     no bank conflicts (neighbouring lanes, neighbouring 16 bytes);
//   - the partial logits of a lane are summed across the warp by
//     recursive halving (31 shuffles), after which lane L holds the logit
//     of row L / LR, class L % LR; the softmax over a row's classes is 2
//     log2(LR) shuffles, and each lane computes one exp and one residual;
//   - the residuals are broadcast through a 32-float shared slot per warp
//     and the gradient R^T x accumulates in registers, g[KP][NV] float4
//     per lane, for all of the warp's rows.
// Every loop has compile-time bounds (one instance per class count) and no
// branch, so the compiler schedules a group as one block. At 10 classes it
// is bound by instruction issue and latency more than by bytes: the
// logit and gradient FMAs (2 K d a row), the warp sum's shuffles and
// selects, at one block (8 warps, two a scheduler) an SM for its
// registers. So the loop is software-pipelined: group it's logits and
// their shuffle chain sit beside group it - 1's softmax and gradient. The
// block partial uses the layout and the fixed-order second pass of the
// other two kernels.
template <int NV, int KP>
__global__ void __launch_bounds__(THREADS, 1)
logreg_mrows_kernel(const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ m, const float* __restrict__ A,
                    const float* __restrict__ b, float* __restrict__ part,
                    float* __restrict__ loss_part, int64_t n, int d, int K) {
  constexpr int LR = mrows_lanes<KP>();
  constexpr int R = 32 / LR;
  constexpr int ROWF = NV * 128;  // floats of one padded row
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                        // [KP][ROWF]
  float* sb = sA + KP * ROWF;              // [KP], padded to 16 bytes
  float* rslot = sb + (KP + 3) / 4 * 4;    // [WARPS][32]
  float* ring = rslot + WARPS * 32;        // [WARPS][MSTAGES][R][ROWF]
  __shared__ float warp_loss[WARPS];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < KP * ROWF; e += THREADS) {
    const int k = e / ROWF, c = e % ROWF;
    sA[e] = c < d ? A[(int64_t)k * d + c] : 0.f;
  }
  if (threadIdx.x < KP) sb[threadIdx.x] = b[threadIdx.x];

  // a warp's groups: gw, gw + nw, ... (fewer than 2^31 of them)
  const int64_t groups = (n + R - 1) / R;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  const int64_t nw = (int64_t)gridDim.x * WARPS;
  const int iters = gw < groups ? (int)((groups - gw + nw - 1) / nw) : 0;
  float* wring = ring + (size_t)warp * MSTAGES * R * ROWF;
  float* wr = rslot + warp * 32;

  auto issue = [&](int it) {  // group it of this warp into its ring slot
    const int64_t r0 = (gw + (int64_t)it * nw) * R;
    float* dst = wring + (it & (MSTAGES - 1)) * R * ROWF;
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (v * 32 + lane) * 4;
        const bool ok = it < iters && r0 + u < n && c < d;
        cp_async16(dst + u * ROWF + c, ok ? X + (r0 + u) * d + c : X, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // lane L ends up with row u = L / LR, class k = L % LR of its group
  const int my_u = lane / LR, my_k = lane % LR;
  auto row_my = [&](int it, float& mr, float& yr) {
    const int64_t r = (gw + (int64_t)it * nw) * R + my_u;
    const bool ok = it < iters && r < n;
    mr = ok ? __ldg(m + r) : 0.f;
    yr = ok ? __ldg(y + r) : 0.f;
  };

#pragma unroll
  for (int s = 0; s < MSTAGES; ++s) issue(s);
  __syncthreads();  // sA, sb

  float4 g[KP][NV];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int v = 0; v < NV; ++v) g[k][v] = zero4;
  float gb = 0.f, lsum = 0.f;
  const float4* sA4 = reinterpret_cast<const float4*>(sA);
  const bool live = my_k < KP;  // lanes of class slots KP..LR-1 idle
  const float bk = live ? sb[my_k] : 0.f;

  // the R x LR logits of a group, summed across the warp: lane L's value
  auto logits = [&](const float4 (&x)[R][NV]) -> float {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 a = sA4[k * (ROWF / 4) + v * 32 + lane];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          float t = s[u * LR + k];
          t = fmaf(x[u][v].x, a.x, t);
          t = fmaf(x[u][v].y, a.y, t);
          t = fmaf(x[u][v].z, a.z, t);
          t = fmaf(x[u][v].w, a.w, t);
          s[u * LR + k] = t;
        }
      }
    }
    halve<16>(s, lane);
    halve<8>(s, lane);
    halve<4>(s, lane);
    halve<2>(s, lane);
    halve<1>(s, lane);
    return s[0];
  };
  // softmax, loss and residual of a group's summed logit, then R^T x
  auto finish = [&](const float4 (&x)[R][NV], float zsum, float mr, float yr) {
    const float z = live ? zsum + bk : -CUDART_INF_F;
    float zmax = z;
#pragma unroll
    for (int o = 1; o < LR; o <<= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
    const float e = live ? __expf(z - zmax) : 0.f;
    float se = e;
#pragma unroll
    for (int o = 1; o < LR; o <<= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
    const bool hit = live && my_k == (int)yr;
    lsum += ((my_k == 0 ? logf(se) + zmax : 0.f) - (hit ? z : 0.f)) * mr;
    const float rk = (__fdividef(e, se) - (hit ? 1.f : 0.f)) * mr;
    gb += rk;
    __syncwarp();  // every lane has read the previous group's residuals
    wr[lane] = rk;
    __syncwarp();
    const float4* wr4 = reinterpret_cast<const float4*>(wr);
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int k4 = 0; k4 < KP; k4 += 4) {
        const float4 r4 = wr4[(u * LR + k4) / 4];
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int j = 0; j < 4 && k4 + j < KP; ++j) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            g[k4 + j][v].x = fmaf(rv[j], x[u][v].x, g[k4 + j][v].x);
            g[k4 + j][v].y = fmaf(rv[j], x[u][v].y, g[k4 + j][v].y);
            g[k4 + j][v].z = fmaf(rv[j], x[u][v].z, g[k4 + j][v].z);
            g[k4 + j][v].w = fmaf(rv[j], x[u][v].w, g[k4 + j][v].w);
          }
        }
      }
    }
  };
  auto load = [&](int it, float4 (&x)[R][NV]) {
    const float4* src = reinterpret_cast<const float4*>(wring + (it & (MSTAGES - 1)) * R * ROWF);
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) x[u][v] = src[u * (ROWF / 4) + v * 32 + lane];
  };

  // software pipeline: group it's logits and warp sum (a shuffle chain)
  // beside group it - 1's softmax and gradient, in one branch-free block
  if (iters > 0) {
    float4 xp[R][NV];
    cp_async_wait<MSTAGES - 1>();
    load(0, xp);
    float zp = logits(xp), mp, yp;
    row_my(0, mp, yp);
    for (int it = 1; it < iters; ++it) {
      issue(it + MSTAGES - 1);
      float mc, yc;
      row_my(it, mc, yc);
      cp_async_wait<MSTAGES - 1>();  // this lane's chunks of group it landed
      float4 xc[R][NV];
      load(it, xc);
      const float zc = logits(xc);
      finish(xp, zp, mp, yp);
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v) xp[u][v] = xc[u][v];
      zp = zc;
      mp = mc;
      yp = yc;
    }
    finish(xp, zp, mp, yp);
  }
  cp_async_wait<0>();  // the ring's trailing (empty) groups

  // intercept gradient: lanes k, k + LR, ... hold class k of each row slot
#pragma unroll
  for (int o = LR; o < 32; o <<= 1) gb += __shfl_xor_sync(0xffffffffu, gb, o);
  lsum = warp_sum(lsum);
  __syncthreads();  // every warp is done with its ring: reuse it

  // block partial: the warps' register accumulators added in warp order
  float* red = ring;  // [KP][ROWF] then [KP] intercepts
  float4* red4 = reinterpret_cast<float4*>(red);
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float4& t = red4[k * (ROWF / 4) + v * 32 + lane];
          if (w == 0) {
            t = g[k][v];
          } else {
            t.x += g[k][v].x;
            t.y += g[k][v].y;
            t.z += g[k][v].z;
            t.w += g[k][v].w;
          }
        }
      }
      if (lane < KP) red[KP * ROWF + lane] = (w == 0 ? 0.f : red[KP * ROWF + lane]) + gb;
      if (lane == 0) warp_loss[warp] = lsum;
    }
    __syncthreads();
  }
  const int D1 = d + 1;
  float* P = part + (int64_t)blockIdx.x * K * D1;
  for (int e = threadIdx.x; e < K * D1; e += THREADS) {
    const int k = e / D1, c = e % D1;
    P[e] = c < d ? red[k * ROWF + c] : red[KP * ROWF + k];
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += warp_loss[w];
    loss_part[blockIdx.x] = t;
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}
// Shared memory of logreg_tile_kernel, in floats (ops/logreg_kernels.py
// ::_tile_smem computes the same): A (KP x DP, zero-padded), b (KP, padded
// to 16 bytes), the logits, then TILE_STAGES slots of BM rows of LD = DP + 4
// floats (the last 4 the intercept chunk (1, 0, 0, 0)) and the tile's m
// and y.
__host__ __device__ inline int tile_z_floats(int K, int kg, int BM) {
  // the logits (binomial: and the BM x max(1, 8 / BM) partial logits),
  // padded to 16 bytes
  return kg == 1 ? (BM + (BM > WARPS ? BM : WARPS) + 3) / 4 * 4 : BM * ((K + 3) / 4 * 4);
}
__host__ __device__ inline size_t tile_smem_floats(int d, int K, int kg, int BM) {
  const size_t DP = (d + 3) / 4 * 4, KP = kg == 1 ? 1 : (K + 3) / 4 * 4;
  return KP * DP + (KP + 3) / 4 * 4 + tile_z_floats(K, kg, BM) +
         (size_t)TILE_STAGES * (BM * (DP + 4) + (2 * BM + 3) / 4 * 4);
}

// The tile kernel: every shape whose block gradient fits on chip.
// A resident block walks tiles of BM whole rows (tiles b, b + grid, ...).
// Each tile is copied once from device memory into a ring of two
// shared-memory slots by cp.async (16-byte copies when `vec`: d % 4 == 0
// and X 16-byte aligned; 4-byte copies otherwise), with its m and y, and
// nothing reads X from device memory again. A and b are staged once a
// block. Per tile:
//   (L) logits from the staged rows and A. Binomial (KG = 1): a warp per
//       row (BM >= 8), or 8 / BM warps per row each over a share of the
//       columns (BM < 8), lanes over 16-byte column chunks, one warp sum.
//       Multinomial (KG = 4, classes padded to KP = 4 ceil(K / 4)): a warp
//       per (8 rows, 4 classes) pair, 32 register sums over its lanes'
//       chunks folded by one recursive-halving warp sum, after which lane
//       L holds row L / 4, class L % 4.
//   (R) loss and residuals in shared memory: a thread per row (binomial),
//       a half warp per row (multinomial softmax over the K real classes).
//   (G) gradient R^T [x, 1] from the same staged rows. Each thread owns
//       up to IPT fixed items (a group of KG classes, a 16-byte column
//       chunk; the chunk past the last is the intercept, whose staged
//       value is (1, 0, 0, 0)) for the whole launch and accumulates them
//       in registers, rows in order, four rows' loads ahead of their FMAs.
// The block writes its K x (d + 1) partial once, at the end, and the
// second pass sums the partials in a fixed order: the card repeats itself
// bit for bit. Three barriers a tile. What holds it is the time a tile's
// stages take one after another more than the bytes (the per-tile time
// does not shrink with deeper rings), so the binomial form runs two
// resident blocks an SM where its ring fits twice, one block's stages
// beside the other's; the multinomial instances' registers allow one.
template <int KG, int IPT>
__global__ void __launch_bounds__(THREADS, KG == 1 ? 2 : 1)
logreg_tile_kernel(const float* __restrict__ X, const float* __restrict__ y,
                   const float* __restrict__ m, const float* __restrict__ A,
                   const float* __restrict__ b, float* __restrict__ part,
                   float* __restrict__ loss_part, int64_t n, int d, int K, int BM, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_loss[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int DP = (d + 3) & ~3, NC = DP / 4, NC1 = NC + 1, LD = DP + 4, LD4 = NC1;
  const int KP = KG == 1 ? 1 : (K + 3) & ~3;
  float* sA = smem;                          // [KP][DP]
  float* sb = sA + KP * DP;                  // [KP], padded to 16 bytes
  float* sZ = sb + ((KP + 3) & ~3);          // [BM][KP]: logits, then residuals
  float* sP = sZ + BM * KP;                  // binomial: [BM][wpr] partial logits
  float* ring = sZ + tile_z_floats(K, KG, BM);  // [TILE_STAGES][SF]
  const int SF = BM * LD + (2 * BM + 3) / 4 * 4;  // a slot: rows, m, y; 16-byte aligned

  for (int e = tid; e < KP * DP; e += THREADS) {
    const int k = e / DP, c = e % DP;
    sA[e] = k < K && c < d ? A[(int64_t)k * d + c] : 0.f;
  }
  for (int k = tid; k < KP; k += THREADS) sb[k] = k < K ? b[k] : 0.f;  // KP may pass THREADS
  for (int e = tid; e < TILE_STAGES * BM; e += THREADS) {
    float* ic = ring + (e / BM) * SF + (e % BM) * LD + DP;
    ic[0] = 1.f;
    ic[1] = ic[2] = ic[3] = 0.f;
  }

  const int64_t tiles = (n + BM - 1) / BM;
  const int iters = blockIdx.x < tiles ? (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) : 0;
  // copy walk: element e = tid + THREADS i of the tile's BM x W copies (W
  // = NC chunks or DP floats), as (row, column) advanced without division
  const int W = vec ? NC : DP;
  const int r_start = tid / W, c_start = tid % W, r_step = THREADS / W, c_step = THREADS % W;
  auto issue = [&](int it) {
    if (it < iters) {
      const int64_t r0 = ((int64_t)blockIdx.x + (int64_t)it * gridDim.x) * BM;
      float* st = ring + (it % TILE_STAGES) * SF;
      int r = r_start, c = c_start;
      while (r < BM) {
        const bool ok = r0 + r < n;
        if (vec) {
          cp_async16(st + r * LD + 4 * c, ok ? X + (r0 + r) * d + 4 * c : X, ok ? 16 : 0);
        } else {
          const bool in = ok && c < d;
          cp_async4(st + r * LD + c, in ? X + (r0 + r) * d + c : X, in ? 4 : 0);
        }
        r += r_step;
        c += c_step;
        if (c >= W) {
          c -= W;
          ++r;
        }
      }
      float* sm = st + BM * LD;
      for (int u = tid; u < BM; u += THREADS) {
        const bool ok = r0 + u < n;
        cp_async4(sm + u, ok ? m + r0 + u : m, ok ? 4 : 0);
        cp_async4(sm + BM + u, ok ? y + r0 + u : y, ok ? 4 : 0);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the counts even
  };

  // this thread's gradient items: (class group, chunk) = divmod(e, NC1)
  const int items = (KP / KG) * NC1;
  int gk[IPT], gj[IPT];
  float4 g[IPT][KG];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int e = tid + i * THREADS;
    gk[i] = e / NC1;
    gj[i] = e % NC1;
#pragma unroll
    for (int q = 0; q < KG; ++q) g[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float lsum = 0.f;

  for (int s = 0; s < TILE_STAGES - 1; ++s) issue(s);
  const float4* sA4 = reinterpret_cast<const float4*>(sA);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<TILE_STAGES - 2>();
    __syncthreads();  // tile it landed; every thread is done with tile it - 1
    issue(it + TILE_STAGES - 1);  // into the slot tile it - 1 held
    const float* st = ring + (it % TILE_STAGES) * SF;
    const float4* xs4 = reinterpret_cast<const float4*>(st);
    const float* sm = st + BM * LD;
    const float* sy = sm + BM;
    const int64_t r0 = ((int64_t)blockIdx.x + (int64_t)it * gridDim.x) * BM;
    const int nr = (int)min((int64_t)BM, n - r0);

    if (KG == 1) {
      // (L) a warp per row, or 8 / BM warps per row, each a share of chunks
      const int wpr = BM >= WARPS ? 1 : WARPS / BM;
      for (int rw = warp; rw < BM * wpr; rw += WARPS) {
        const int r = rw % BM, h = rw / BM;
        float s = 0.f;
        for (int j = lane + 32 * h; j < NC; j += 32 * wpr) {
          const float4 x = xs4[r * LD4 + j], a = sA4[j];
          s = fmaf(x.x, a.x, s);
          s = fmaf(x.y, a.y, s);
          s = fmaf(x.z, a.z, s);
          s = fmaf(x.w, a.w, s);
        }
        s = warp_sum(s);
        if (lane == 0) sP[r * wpr + h] = s;
      }
      __syncthreads();
      // (R) a thread per row: its partial sums in order, loss, residual
      if (tid < BM) {
        float z = sb[0];
        for (int h = 0; h < wpr; ++h) z += sP[tid * wpr + h];
        const float mr = sm[tid], yr = sy[tid];
        lsum += (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yr * z) * mr;
        sZ[tid] = (1.f / (1.f + expf(-z)) - yr) * mr;
      }
    } else {
      // (L) a warp per (8 rows, 4 classes) pair
      const int nkc = KP / 4;
      for (int p = warp; p < (BM / 8) * nkc; p += WARPS) {
        const int rb = p / nkc, kc = p % nkc;
        float sacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
        for (int j = lane; j < NC; j += 32) {
          float4 x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = xs4[(rb * 8 + u) * LD4 + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 a = sA4[(kc * 4 + k) * NC + j];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              float t = sacc[u * 4 + k];
              t = fmaf(x[u].x, a.x, t);
              t = fmaf(x[u].y, a.y, t);
              t = fmaf(x[u].z, a.z, t);
              t = fmaf(x[u].w, a.w, t);
              sacc[u * 4 + k] = t;
            }
          }
        }
        halve<16>(sacc, lane);
        halve<8>(sacc, lane);
        halve<4>(sacc, lane);
        halve<2>(sacc, lane);
        halve<1>(sacc, lane);
        const int c = kc * 4 + lane % 4;
        sZ[(rb * 8 + lane / 4) * KP + c] = sacc[0] + sb[c];
      }
      __syncthreads();
      // (R) a half warp per row, two rows a warp at once (BM is even, so
      // both halves run every step): softmax over the K real classes
      const int sub = lane % 16;
      for (int r = 2 * warp + lane / 16; r < BM; r += 2 * WARPS) {
        float* z = sZ + r * KP;
        const float mr = sm[r];
        const int yi = (int)sy[r];
        float zmax = -CUDART_INF_F;
        for (int c = sub; c < K; c += 16) zmax = fmaxf(zmax, z[c]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
        float se = 0.f;
        for (int c = sub; c < K; c += 16) se += expf(z[c] - zmax);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
        const float zy = (yi >= 0 && yi < K) ? z[yi] : 0.f;
        __syncwarp();  // every lane has read z before any lane overwrites it
        if (sub == 0) lsum += (logf(se) + zmax - zy) * mr;
        for (int c = sub; c < KP; c += 16)
          z[c] = c < K ? (expf(z[c] - zmax) / se - (c == yi ? 1.f : 0.f)) * mr : 0.f;
      }
    }
    __syncthreads();

    // (G) R^T [x, 1] into this thread's items, rows in order, four rows'
    // loads ahead of their FMAs
    auto grad_rows = [&](int i, int r, auto rows) {
      constexpr int U = decltype(rows)::value;
      float4 x[U];
      float rv[U][KG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[u] = xs4[(r + u) * LD4 + gj[i]];
        if (KG == 1) {
          rv[u][0] = sZ[r + u];
        } else {
          const float4 r4 = reinterpret_cast<const float4*>(sZ + (r + u) * KP)[gk[i]];
          rv[u][0] = r4.x;
          rv[u][KG > 1 ? 1 : 0] = r4.y;
          rv[u][KG > 2 ? 2 : 0] = r4.z;
          rv[u][KG > 3 ? 3 : 0] = r4.w;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          g[i][q].x = fmaf(rv[u][q], x[u].x, g[i][q].x);
          g[i][q].y = fmaf(rv[u][q], x[u].y, g[i][q].y);
          g[i][q].z = fmaf(rv[u][q], x[u].z, g[i][q].z);
          g[i][q].w = fmaf(rv[u][q], x[u].w, g[i][q].w);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (tid + i * THREADS < items) {
        int r = 0;
        for (; r + 4 <= nr; r += 4) grad_rows(i, r, std::integral_constant<int, 4>());
        for (; r < nr; ++r) grad_rows(i, r, std::integral_constant<int, 1>());
      }
    }
  }
  cp_async_wait<0>();  // the ring's trailing (empty) groups

  // the block partial, written once: every (class, column) of it belongs
  // to exactly one item of one thread
  const int D1 = d + 1;
  float* P = part + (int64_t)blockIdx.x * K * D1;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    if (tid + i * THREADS < items) {
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const int k = gk[i] * KG + q;
        if (k < K) {
          const float v[4] = {g[i][q].x, g[i][q].y, g[i][q].z, g[i][q].w};
          if (gj[i] < NC) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              if (4 * gj[i] + w < d) P[(int64_t)k * D1 + 4 * gj[i] + w] = v[w];
          } else {
            P[(int64_t)k * D1 + d] = v[0];
          }
        }
      }
    }
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

// Fixed-order sum over the nb block partials: element e < K*(d+1) -> gA /
// gb, the last element -> loss. A block takes 32 consecutive elements, a
// lane each; warp w sums partials w, w + 8, ... in order, then warp 0 adds
// the 8 warps' sums in order. The grid covers every element. Where `side`
// is given (the route past the tile kernel's cap), the intercept column
// and the loss come from its nside partials of K + 1 (gb, then the loss).
__global__ void __launch_bounds__(THREADS)
logreg_reduce_kernel(const float* __restrict__ part, const float* __restrict__ loss_part, int nb,
                     float* __restrict__ gA, float* __restrict__ gb, float* __restrict__ loss,
                     int d, int K, const float* __restrict__ side, int nside) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t D1 = d + 1;
  const int64_t per = (int64_t)K * D1;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (side && e <= per && (e == per || e % D1 == d)) {
    const int64_t k = e == per ? K : e / D1;
    for (int bk = warp; bk < nside; bk += WARPS) v += side[bk * (int64_t)(K + 1) + k];
  } else if (e < per) {
    for (int bk = warp; bk < nb; bk += WARPS) v += part[bk * per + e];
  } else if (e == per) {
    for (int bk = warp; bk < nb; bk += WARPS) v += loss_part[bk];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e <= per) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    if (e == per) {
      loss[0] = t;
    } else {
      const int64_t k = e / D1, c = e % D1;
      if (c < d)
        gA[k * d + c] = t;
      else
        gb[k] = t;
    }
  }
}


// ---------------------------------------------------------------------------
// The route past the tile kernel's cap: multinomial 2 <= K <= 256 whose
// block gradient does not fit on chip (K (d + 1) past 1,024 four-class
// items, e.g. 64 classes at d >= 253). At d = 1,024 and K = 64 a block
// gradient is 65,536 floats, a whole SM's register file, so no single
// fused kernel can hold it; the work is two products with the residual
// between them, each on the tensor cores in 3xTF32 as lloyd_step.cu and
// knn_topk.cu do it (hi = tf32(x), lo = tf32(x - hi), rounded to nearest,
// ties away; lo*hi' + hi*lo' + hi*hi' for each k = 8 step into a fresh
// accumulator for each 32-deep stage, folded into a running f32 sum with
// a rounded add):
//   (A) logreg_route_kernel<BN, SPLIT, false>: Z = X A^T (M = rows, N =
//       classes, the reduction over d), the rows' A fragments split in
//       registers, A's hi and lo split once a launch by route_split_kernel.
//       Its epilogue, in registers: + b, the padded classes (past K, up to
//       the wgmma N) masked out of the max and the sum (the TPU kernel's
//       -1e30 mask), each row's max and sum of exponentials across the
//       quad of lanes that holds it (and, SPLIT, across the two
//       warpgroups through shared memory), the loss m (lse - z_y), and
//       R = (softmax - onehot) m, written as R^T's hi and lo (class
//       major, rows contiguous: the K-major B operand of (B)); the
//       intercept gradient and the loss as one partial a block.
//   (B) logreg_route_kernel<BN, SPLIT, true>: gA^T (d x K) = X^T R (M =
//       columns, N = classes, the reduction over rows). tf32 wgmma reads
//       shared-memory operands K-major only (the transpose bits are for
//       f16/bf16), and X is MN-major here, so X^T is the A operand, loaded
//       from the staged X tile into registers; the column order inside a
//       64-column slab is permuted (col_of) so those loads hit 32 banks.
//       A block owns a (column tile, row range) pair and writes its
//       partial once.
// What bounds it on an H100: at 200,000 x 1,024, K = 64 the two products
// are 157 GFLOP in 3xTF32 (0.32 ms at 495 TFLOP/s) against 1.64 GB of X
// read twice (0.49 ms at 3.35 TB/s), so about 96 operations a byte: the
// bytes, nearly. R's hi and lo (2 n K floats) go out once and come back
// once a column tile, the column tiles of one row range running side by
// side so that the re-reads hit L2.
// Shape of both: a producer warpgroup (one warp issuing TMA copies, or all
// four copying 4 bytes at a time by cp.async where d % 4 != 0 or X is not
// 16-byte aligned) keeps a ring of 2-4 stages, each the X tile, the B
// operand's hi and lo (128-byte swizzled), completing one transaction
// barrier; two consumer warpgroups, given the producers' registers by
// setmaxnreg, multiply. BN is the wgmma N (16, 32, 64 or 128): rows of
// 128 (A) or columns of 128 (B) a block, a warpgroup 64 of them, all BN
// classes; SPLIT (129-256 classes): 64 rows or columns a block, each
// warpgroup 128 of the classes. Every sum has one fixed order, with no
// float atomics, and the fixed-order second pass (logreg_reduce_kernel)
// adds the partials: the card repeats itself bit for bit.
// CT, the class-tiled instance (257 to 12,288 classes, launcher code
// 3900, BN = 128 without the split): the classes go in tiles of 128.
//   (A) A block's row tile (128 rows, 64 a warpgroup, so no row crosses a
//       warpgroup) walks the class tiles, ceil(d / 32) stages each, the X
//       tile fetched again for each (from L2 where the row block's slab
//       stays there), the B operand at the class tile's rows of A. After
//       a class tile: + b, its rows' max (quads), the running (max, sum)
//       merged the FlashAttention way (the sum rescaled by exp(old max -
//       new max)), the label's logit taken into the loss, and the raw
//       logits stored to the block's own slice of the z scratch, each
//       thread's 64 values in its own coalesced columns. After the last
//       class tile the block reads its z back (written by the same
//       thread, so no barrier) and writes R^T's hi and lo once; the
//       intercept gradient of a class tile goes through a double-buffered
//       [8 warps][128] exchange into the block's side row (stored on its
//       first row tile, added after), one thread a class: fixed order.
//   (B) the (column tile, class tile, row range) tiles, the column tiles
//       of one class tile adjacent, so the R^T stage they share and the X
//       stage the class tiles share are read while in L2; each adds its
//       sums into the range's partial, zeroed by the caller, so launch
//       pairs accumulate in chunk order and the scratch does not grow
//       with n.
// What bounds it: at 100,000 x 2,048, K = 1,000 the two products are 2.46
// TFLOP in 3xTF32 (4.97 ms at 495 TFLOP/s) against 0.82 GB of X (0.25
// ms): the tensor cores. At d = 256, K = 4,096 the z and R^T scratch
// (24 bytes a logit through device memory) is as large a cost.

constexpr int RT_RB = 32;           // reduction depth of a stage: one 128-byte row
constexpr int RT_CONSUMERS = 256;   // two warpgroups multiply
constexpr int RT_PRODUCERS = 128;   // one warpgroup copies
constexpr int RT_THREADS = RT_CONSUMERS + RT_PRODUCERS;
constexpr int RT_MAX_STAGES = 4;
constexpr int RT_XCHG = 512;        // floats: [2 buffers][2 warpgroups][64 rows][max, sum]
// the probe's knock-out: the logits kernel (and A's split) alone
constexpr int KNOCK_ROUTE_NO_GRAD = 16;
// a negative control of the class-tiled instance: the tiles' sums merged
// without rescaling (the result is then wrong wherever the max moves)
constexpr int KNOCK_ROUTE_NO_RESCALE = 32;
constexpr int RT_CT_CODE = 3900;    // the class-tiled instance's launcher code
constexpr int RT_CT_MAX_K = 12288;  // its classes at most (logreg_kernels._ROUTE_TILED_MAX_K)
// named barriers: 1..4 the ring's empty slots, then the split's exchange
// (CT: the intercept's) and the consumers' end
constexpr int RT_BAR_XCHG = 1 + RT_MAX_STAGES;
constexpr int RT_BAR_END = 2 + RT_MAX_STAGES;

struct Tf32 {
  unsigned bias, mask;  // x rounded to TF32: (bits(x) + bias) & mask
  __device__ __forceinline__ unsigned round(float x) const { return (__float_as_uint(x) + bias) & mask; }
  __device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) const {
    hi = round(x);
    lo = round(x - __uint_as_float(hi));  // exact difference
  }
};

struct RouteArgs {
  const float* X;
  const float* y;
  const float* m;
  const float* b;
  float* rhi;  // R^T's hi and lo, (K, nr) each: written by (A), read by (B)
  float* rlo;
  float* part;  // (B): [ranges][K][d + 1], columns < d
  float* side;  // (A): [grid][K + 1], the intercept gradient then the loss
  float* zs;    // CT (A): [grid][nct][64][256 consumers], the raw logits
  int n, d, K, nst, tma_x, col_tiles, ranges, range_rows, nr;
  int nct, knock;  // class tiles (1 but for CT); the probe's knock bits
  Tf32 tf;
};

__host__ __device__ constexpr int route_bm(bool split) { return split ? 64 : 128; }
__host__ __device__ constexpr int route_slot(int bn, bool split) {
  return (route_bm(split) + 2 * (split ? 2 * bn : bn)) * RT_RB;  // floats: X tile, B hi, B lo
}
// dynamic shared memory of a route kernel (ops/logreg_kernels.py
// ::_route_smem computes the same): 1,024 bytes of alignment slack, the
// ring and its barriers, the warps' intercept sums (CT: two buffers), the
// split's exchange and the warps' losses
size_t route_smem_bytes(int bn, bool split, int stages, bool ct) {
  return 1024 + (size_t)stages * (route_slot(bn, split) * 4 + 8) + 4 * ((ct ? 16 : 8) * bn + RT_XCHG + 8);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra WAIT_%=;\n}\n" ::"r"(
          smem_addr(b)),
      "r"(parity)
      : "memory");
}
// the barrier's arrival once this thread's earlier cp.async copies landed
__device__ __forceinline__ void mbar_cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// a (32 x box rows) box of a row-major f32 matrix at (x, y), 128-byte
// swizzled, zero past its edges
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int x, int y, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(b))
      : "memory");
}
// shared-memory matrix descriptor of a K-major tile of 128-byte rows under
// the 128-byte swizzle: 8-row groups 1,024 bytes apart (the tile 1,024-byte
// aligned; a K offset inside the row is added to the start address)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// keep the compiler from moving register reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

// m64nBNk8 TF32 products of the warpgroup: d (+)= A (64 x 8, from
// registers: a[] as mma.m16n8k8's A fragment of the warp's 16 rows) x B
// (BN x 8)^T, K-major in shared memory under the 128-byte swizzle
// (descriptor db)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const unsigned (&a)[4], uint64_t db, int acc) {
  if constexpr (BN == 16) wgmma_n16(d, a, db, acc);
  else if constexpr (BN == 32) wgmma_n32(d, a, db, acc);
  else if constexpr (BN == 64) wgmma_n64(d, a, db, acc);
  else wgmma_n128(d, a, db, acc);
}

// (B)'s column, inside a warpgroup's 64-column slab, of accumulator row
// 16 w + 8 h + g (warp w, half h, lane group g): two 32-column boxes, the
// 16-byte chunk 4 (g / 4) + 2 (w % 2) + h, the float g % 4. A warp's
// fragment loads (8 columns x 4 rows a register) then hit 32 banks under
// the 128-byte swizzle.
__host__ __device__ constexpr int col_of(int w, int h, int g) {
  return 32 * (w >> 1) + 4 * (4 * (g >> 2) + 2 * (w & 1) + h) + (g & 3);
}

template <int BN, bool SPLIT, bool GRAD, bool CT = false>
__global__ void __launch_bounds__(RT_THREADS, 1)
logreg_route_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmh,
                    const __grid_constant__ CUtensorMap tml, const RouteArgs a) {
  static_assert(!CT || (BN == 128 && !SPLIT), "the class-tiled instance is BN = 128 without the split");
  constexpr int BM = route_bm(SPLIT), NPT = SPLIT ? 2 * BN : BN, SLOT = route_slot(BN, SPLIT);
  extern __shared__ unsigned char dyn_raw[];
  unsigned char* dyn = dyn_raw + ((1024 - (smem_addr(dyn_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(dyn);                      // [nst][SLOT]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.nst * SLOT);  // [nst]
  float* gbw = reinterpret_cast<float*>(full + a.nst);              // [CT ? 2 : 1][8 warps][BN]
  float* xchg = gbw + (CT ? 16 : 8) * BN;                           // [2][2][64][2]
  float* wloss = xchg + RT_XCHG;                                    // [8]

  const int n = a.n, d = a.d, K = a.K, nst = a.nst;
  // class tiles (CT) and stages over d
  const int nct = CT ? a.nct : 1, dst = (d + RT_RB - 1) / RT_RB;
  // (A): row blocks of BM rows, ceil(d / 32) stages each (CT: each class
  // tile's); (B): (column tile, class tile, row range) triples, the
  // column tiles of a class tile adjacent, then the class tiles of a range
  const int ntiles = GRAD ? a.col_tiles * nct * a.ranges : (n + BM - 1) / BM;
  auto stages_of = [&](int tile) -> int {
    if (!GRAD) return dst * nct;
    const int r0 = tile / (a.col_tiles * nct) * a.range_rows;
    return (min(a.range_rows, n - r0) + RT_RB - 1) / RT_RB;
  };
  const int tid = threadIdx.x, lane = tid % 32;
  const int np = a.tma_x ? 32 : RT_PRODUCERS;  // threads that fill the ring
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(full + s, a.tma_x ? 1 : 1 + RT_PRODUCERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 8 * BN; i += RT_THREADS) gbw[i] = 0.f;
  __syncthreads();

  if (tid >= RT_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int ptid = tid - RT_CONSUMERS;
    if (ptid >= np) return;
    const unsigned tx = (a.tma_x ? SLOT : 2 * NPT * RT_RB) * 4;
    const int pw = ptid / 32;
    int q = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int nstg = stages_of(tile);
      // the X tile's origin: (A) row xr; (B) column xc, rows from kb; the
      // B operand's first class cy (CT)
      const int xr = GRAD ? 0 : tile * BM;
      const int xc = GRAD ? tile % a.col_tiles * BM : 0;
      const int k0 = GRAD ? tile / (a.col_tiles * nct) * a.range_rows : 0;
      const int cy0 = GRAD ? tile / a.col_tiles % nct * NPT : 0;
      for (int s = 0; s < nstg; ++s, ++q) {
        const int sl = q % nst;
        int kb = k0 + s * RT_RB, cy = cy0;
        if constexpr (CT && !GRAD) {  // class tile s / dst, feature stage s % dst
          kb = s % dst * RT_RB;
          cy = s / dst * NPT;
        }
        if (q >= nst) bar_sync(1 + sl, RT_CONSUMERS + np);  // the consumers are done with q - nst
        float* slot = ring + sl * SLOT;
        if (ptid == 0) {
          mbar_expect(full + sl, tx);
          tma_load(slot + BM * RT_RB, &tmh, kb, cy, full + sl);
          tma_load(slot + (BM + NPT) * RT_RB, &tml, kb, cy, full + sl);
          if (a.tma_x) {
            if (GRAD) {
#pragma unroll
              for (int i = 0; i < BM / 32; ++i) tma_load(slot + i * 32 * RT_RB, &tmx, xc + 32 * i, kb, full + sl);
            } else {
              tma_load(slot, &tmx, kb, xr, full + sl);
            }
          }
        }
        if (!a.tma_x) {
          // 4-byte copies into the swizzled layout, zero past the edges:
          // lanes along the row, warps down the rows
          unsigned char* xb = reinterpret_cast<unsigned char*>(slot);
          for (int u = pw; u < BM; u += RT_PRODUCERS / 32) {
            int r, c, box;
            if (GRAD) {  // 32 rows x BM columns: row u % 32 of box u / 32
              r = u % 32;
              box = u / 32;
              c = xc + 32 * box + lane;
            } else {  // BM rows x 32 features
              r = u;
              box = 0;
              c = kb + lane;
            }
            const int64_t gr = GRAD ? (int64_t)kb + r : (int64_t)xr + r;
            const bool ok = gr < n && c < d;
            cp_async4(reinterpret_cast<float*>(xb + box * 4096 + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) +
                                               4 * (lane & 3)),
                      ok ? a.X + gr * d + c : a.X, ok ? 4 : 0);
          }
          mbar_cp_async_arrive(full + sl);
        }
      }
    }
    // take the consumers' last releases, so that no barrier is left half way
    for (int p = q > nst ? q - nst : 0; p < q; ++p) bar_sync(1 + p % nst, RT_CONSUMERS + np);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = tid / 128, w = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const int wslab = SPLIT ? 0 : 64 * wg;  // this warpgroup's rows (A) or columns (B) in the block
  const int cbase = SPLIT ? wg * BN : 0;  // and its first class
  // byte offsets in the X tile of this thread's A fragments, register c of
  // k-step 0 (a k-step adds 8 feature columns (A) or 8 rows (B))
  int foff[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int kf = t + 4 * (c >> 1);
    if (GRAD) {  // element (column colb, row kf)
      const int colb = wslab + col_of(w, c & 1, g);
      foff[c] = (colb >> 5) * 4096 + kf * 128 + ((((colb & 31) >> 2) ^ (kf & 7)) << 4) + 4 * (colb & 3);
    } else {  // element (row mr, feature kf): the chunk's swizzle is applied per k-step
      const int mr = wslab + 16 * w + g + 8 * (c & 1);
      foff[c] = mr * 128 + 4 * (kf & 3);
    }
  }
  float acc[BN / 2], run[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = run[e] = 0.f;
  float lsum = 0.f;
  // CT (A): this thread's rows' running max and sum, mask and label; its
  // slice of the z scratch; the intercept exchanges taken so far
  float rmax[2], rsum[2], rm[2];
  int ry[2], nx = 0;
  float* zb = CT ? a.zs + (size_t)blockIdx.x * nct * (BN / 2) * RT_CONSUMERS + tid : nullptr;
  int q = 0, tl = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++tl) {
    const int nstg = stages_of(tile);
    if constexpr (CT && !GRAD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tile * BM + wslab + 16 * w + g + 8 * h;
        rmax[h] = -CUDART_INF_F;
        rsum[h] = 0.f;
        rm[h] = r < n ? __ldg(a.m + r) : 0.f;
        ry[h] = r < n ? (int)__ldg(a.y + r) : -1;
      }
    }
    for (int s = 0; s < nstg; ++s, ++q) {
      const int sl = q % nst;
      mbar_wait(full + sl, (q / nst) & 1);
      const float* slot = ring + sl * SLOT;
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(slot);
      unsigned ah[RT_RB / 8][4], al[RT_RB / 8][4];
#pragma unroll
      for (int kk = 0; kk < RT_RB / 8; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int off;
          if (GRAD) {
            off = foff[c] + kk * 8 * 128;
          } else {  // chunk 2 kk + c / 2 of row mr, swizzled by mr & 7 = g
            off = foff[c] + ((((2 * kk + (c >> 1)) ^ g)) << 4);
          }
          a.tf.split(*reinterpret_cast<const float*>(xb + off), ah[kk][c], al[kk][c]);
        }
      const float* bh = slot + BM * RT_RB + cbase * RT_RB;
      const float* bl = bh + NPT * RT_RB;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_reg(acc[e]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < RT_RB / 8; ++kk) {
        const uint64_t dh = desc_sw128(bh + kk * 8), dl = desc_sw128(bl + kk * 8);
        wgmma_tf32<BN>(acc, al[kk], dh, kk > 0);
        wgmma_tf32<BN>(acc, ah[kk], dl, 1);
        wgmma_tf32<BN>(acc, ah[kk], dh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_reg(acc[e]);
#pragma unroll
      for (int kk = 0; kk < RT_RB / 8; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fence_reg(ah[kk][c]);
          fence_reg(al[kk][c]);
        }
      bar_arrive(1 + sl, RT_CONSUMERS + np);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) run[e] += acc[e];  // fold the stage, rounded
      if constexpr (CT && !GRAD) {
        if ((s + 1) % dst == 0) {  // class tile s / dst done: merge it into the rows' (max, sum)
          const int c0 = s / dst * NPT;
          float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F}, tsum[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int cls = c0 + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
            if (cls < K) {
              const float z = run[e] + __ldg(a.b + cls);
              run[e] = z;
              tmax[h] = fmaxf(tmax[h], z);
              if (cls == ry[h]) lsum -= z * rm[h];
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], o));
            tmax[h] = fmaxf(rmax[h], tmax[h]);  // the new running max
          }
          float* zt = zb + (size_t)(s / dst) * (BN / 2) * RT_CONSUMERS;
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int cls = c0 + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
            if (cls < K) tsum[h] += expf(run[e] - tmax[h]);
            zt[e * RT_CONSUMERS] = run[e];
            run[e] = 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) tsum[h] += __shfl_xor_sync(0xffffffffu, tsum[h], o);
            rsum[h] = (a.knock & KNOCK_ROUTE_NO_RESCALE ? rsum[h] : rsum[h] * expf(rmax[h] - tmax[h])) + tsum[h];
            rmax[h] = tmax[h];
          }
        }
      }
    }

    // accumulator element e: row (A) or column slot (B) 16 w + 8 h + g,
    // h = (e >> 1) & 1; class cbase + 8 (e >> 2) + 2 t + (e & 1)
    if (GRAD) {
      const int ct = tile % a.col_tiles, c0 = tile / a.col_tiles % nct * NPT, rr = tile / (a.col_tiles * nct);
      float* P = a.part + (size_t)rr * K * (d + 1);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int col = ct * BM + wslab + col_of(w, (e >> 1) & 1, g);
        const int cls = c0 + cbase + 8 * (e >> 2) + 2 * t + (e & 1);
        if (col < d && cls < K) {
          float* p = P + (size_t)cls * (d + 1) + col;
          *p = CT ? *p + run[e] : run[e];  // CT: launch pairs add up in chunk order
        }
        run[e] = 0.f;
      }
      continue;
    }
    if constexpr (CT && !GRAD) {  // (A) after the last class tile: R^T's hi and lo, the intercept gradient
      const int r0 = tile * BM + wslab + 16 * w + g;  // rows r0 and r0 + 8
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        inv[h] = 1.f / rsum[h];
        if (t == 0) lsum += (logf(rsum[h]) + rmax[h]) * rm[h];
      }
      float* sd = a.side + (size_t)blockIdx.x * (K + 1);
      for (int ct = 0; ct < nct; ++ct, ++nx) {
        const int c0 = ct * NPT;
        // the class tile's logits first, all 64 loads in flight at once: the
        // R^T stores below may alias them, so a load after one would wait
        const float* zt = zb + (size_t)ct * (BN / 2) * RT_CONSUMERS;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) run[e] = zt[e * RT_CONSUMERS];
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int cls = c0 + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
          const int r = r0 + 8 * h;
          float rv = 0.f;
          if (cls < K && r < n) {
            rv = (expf(run[e] - rmax[h]) * inv[h] - (cls == ry[h] ? 1.f : 0.f)) * rm[h];
            unsigned hi, lo;
            a.tf.split(rv, hi, lo);
            a.rhi[(size_t)cls * a.nr + r] = __uint_as_float(hi);
            a.rlo[(size_t)cls * a.nr + r] = __uint_as_float(lo);
          }
          run[e] = rv;
        }
        float* gx = gbw + (nx & 1) * 8 * BN;  // this exchange's buffer: the one before last is free
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float v = run[4 * j + p] + run[4 * j + 2 + p];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) gx[(tid / 32) * BN + 8 * j + 2 * t + p] = v;
          }
        bar_sync(RT_BAR_XCHG, RT_CONSUMERS);
        if (tid < NPT && c0 + tid < K) {  // one thread a class: the block's side row in row-tile order
          float v = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) v += gx[w8 * BN + tid];
          sd[c0 + tid] = tl == 0 ? v : sd[c0 + tid] + v;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) run[e] = 0.f;
      continue;
    }
    const int r0 = tile * BM + wslab + 16 * w + g;  // rows r0 and r0 + 8
    float mr[2], zy[2] = {0.f, 0.f}, mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, se[2] = {0.f, 0.f};
    int yi[2];
    bool hit[2] = {false, false};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      mr[h] = r < n ? __ldg(a.m + r) : 0.f;
      yi[h] = r < n ? (int)__ldg(a.y + r) : -1;
    }
    // logits; the padded classes (past K) take no part in the max or the sum
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int cls = cbase + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
      if (cls < K) {
        const float z = run[e] + __ldg(a.b + cls);
        run[e] = z;
        mx[h] = fmaxf(mx[h], z);
        if (cls == yi[h]) {
          zy[h] = z;
          hit[h] = true;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int cls = cbase + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
      const float ex = cls < K ? expf(run[e] - mx[h]) : 0.f;
      run[e] = ex;
      se[h] += ex;
    }
    float scale[2], lse[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) se[h] += __shfl_xor_sync(0xffffffffu, se[h], o);
    }
    if (SPLIT) {  // the two warpgroups' (max, sum) of each row, combined alike by both
      float* xw = xchg + (tl & 1) * 256;
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 16 * w + g + 8 * h;
          xw[(wg * 64 + rl) * 2] = mx[h];
          xw[(wg * 64 + rl) * 2 + 1] = se[h];
        }
      }
      bar_sync(RT_BAR_XCHG, RT_CONSUMERS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * w + g + 8 * h;
        const float m0 = xw[rl * 2], s0 = xw[rl * 2 + 1];
        const float m1 = xw[(64 + rl) * 2], s1 = xw[(64 + rl) * 2 + 1];
        const float M = fmaxf(m0, m1);
        const float S = s0 * expf(m0 - M) + s1 * expf(m1 - M);
        scale[h] = expf(mx[h] - M) / S;
        lse[h] = logf(S) + M;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        scale[h] = 1.f / se[h];
        lse[h] = logf(se[h]) + mx[h];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t == 0 && (!SPLIT || wg == 0)) lsum += lse[h] * mr[h];
      if (hit[h]) lsum -= zy[h] * mr[h];
    }
    // the residuals: R^T's hi and lo, and the intercept gradient
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int cls = cbase + 8 * (e >> 2) + 2 * t + (e & 1), h = (e >> 1) & 1;
      const int r = r0 + 8 * h;
      float rv = 0.f;
      if (cls < K && r < n) {
        rv = (run[e] * scale[h] - (cls == yi[h] ? 1.f : 0.f)) * mr[h];
        unsigned hi, lo;
        a.tf.split(rv, hi, lo);
        a.rhi[(size_t)cls * a.nr + r] = __uint_as_float(hi);
        a.rlo[(size_t)cls * a.nr + r] = __uint_as_float(lo);
      }
      run[e] = rv;
    }
    float* gw = gbw + (tid / 32) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v = run[4 * j + p] + run[4 * j + 2 + p];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) gw[8 * j + 2 * t + p] += v;  // this warp's slot, tiles in order
      }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) run[e] = 0.f;
  }
  if (GRAD) return;

  // (A)'s block partial: the warps' intercept sums and losses in warp order
  bar_sync(RT_BAR_END, RT_CONSUMERS);
  lsum = warp_sum(lsum);
  if (lane == 0) wloss[tid / 32] = lsum;
  bar_sync(RT_BAR_END, RT_CONSUMERS);
  float* sd = a.side + (size_t)blockIdx.x * (K + 1);
  for (int c = tid; !CT && c < NPT && c < K; c += RT_CONSUMERS) {  // CT: the sweep wrote them
    float v = 0.f;
    if (SPLIT) {
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) v += gbw[(4 * (c / BN) + w4) * BN + c % BN];
    } else {
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) v += gbw[w8 * BN + c];
    }
    sd[c] = v;
  }
  if (tid == 0) {
    float v = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) v += wloss[w8];
    sd[K] = v;
  }
}

// A's TF32 hi and lo, (K, da) each (da = d rounded up to a multiple of 4)
__global__ void route_split_kernel(const float* __restrict__ A, float* __restrict__ hi, float* __restrict__ lo,
                                   int K, int d, int da, Tf32 tf) {
  const int64_t total = (int64_t)K * d, stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    unsigned h, l;
    tf.split(A[i], h, l);
    const int64_t o = i / d * da + i % d;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major (rows, cols) f32 matrix with `ld` floats a row, in
// boxes of 32 columns x box_rows rows, 128-byte swizzled, zero past the edges
cudaError_t route_map(CUtensorMap* map, const float* p, int64_t rows, int cols, int64_t ld, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)RT_RB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool SPLIT, bool CT = false>
cudaError_t route_pass(const RouteArgs& a, const float* ahi, const float* alo, int da, int grid_a, int grid_b,
                       int knock, cudaStream_t st) {
  constexpr int BM = route_bm(SPLIT), NPT = SPLIT ? 2 * BN : BN;
  const size_t smem = route_smem_bytes(BN, SPLIT, a.nst, CT);
  CUtensorMap tmx{}, tmh{}, tml{};
  cudaError_t err = cudaSuccess;
  if (a.tma_x) err = route_map(&tmx, a.X, a.n, a.d, a.d, BM);
  if (err == cudaSuccess) err = route_map(&tmh, ahi, a.K, a.d, da, NPT);
  if (err == cudaSuccess) err = route_map(&tml, alo, a.K, a.d, da, NPT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(logreg_route_kernel<BN, SPLIT, false, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  logreg_route_kernel<BN, SPLIT, false, CT><<<grid_a, RT_THREADS, smem, st>>>(tmx, tmh, tml, a);
  if (knock & KNOCK_ROUTE_NO_GRAD) return cudaGetLastError();
  if (a.tma_x) err = route_map(&tmx, a.X, a.n, a.d, a.d, 32);
  if (err == cudaSuccess) err = route_map(&tmh, a.rhi, a.K, a.n, a.nr, NPT);
  if (err == cudaSuccess) err = route_map(&tml, a.rlo, a.K, a.n, a.nr, NPT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(logreg_route_kernel<BN, SPLIT, true, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  logreg_route_kernel<BN, SPLIT, true, CT><<<grid_b, RT_THREADS, smem, st>>>(tmx, tmh, tml, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster kernel: binomial (K = 1) rows too wide for the tile kernel
// (16,380 < d <= 262,144). One row there is 64-1,024 KB, so no SM can stage
// whole rows beside their gradient, and the general kernel read X twice
// (logits, then the gradient from device memory again). Here each row's
// columns are split across the CTAs of a thread-block cluster, so X is
// read from device memory once:
//   - a cluster of C CTAs (2-16, one an SM) walks rows cluster, cluster +
//     clusters, ...; CTA rank r owns the column slice [4 W r, 4 W (r + 1))
//     (W <= 4,096 16-byte chunks, 16-64 KB) and stages each row's slice
//     into a ring of `nst` slots, completing on the slot's mbarrier: one
//     cp.async.bulk a row slice where `vec` (d % 4 == 0, X 16-byte
//     aligned); else a row slice starts `shift` floats past a 16-byte
//     boundary, so the bulk copy takes its aligned interior and thread 0
//     copies the at most 3 + 3 floats before and after it by 4-byte
//     cp.async, the slice staged `shift` floats into its row, and the
//     readers realign each chunk from two 16-byte reads (per row one of
//     four compile-time cases);
//   - (L) each thread owns CL_IPT chunks of the slice (chunk tid + 256 i),
//     with A's chunks in registers; a row's partial logit is its chunks'
//     products (four accumulators by i % 4, added pairwise), summed across
//     the warp, then across the 8 warps in order;
//   - the exchange: thread 0 stores that partial into its rank's place in
//     every rank's exchange slot (distributed shared memory: mapa,
//     st.async), each store completing its 4 bytes on that rank's slot
//     barrier, which its own CTA armed with the C ranks' bytes
//     (expect_tx). No cluster-wide barrier a row: a CTA runs up to CL_LAG
//     rows ahead of its slowest peer (row t's logit goes out, then row t -
//     CL_LAG's residual and gradient follow), so one CTA's late copy does
//     not stall the cluster each row (a barrier.cluster a row
//     holds the C CTAs in lockstep: 11-37% of the time on an H100; an
//     mbarrier arrival a peer with release semantics costs a fence each);
//   - every CTA adds a row's C partials in rank order and adds b: every
//     rank holds the same f32 logit, bit for bit, and turns it into the
//     residual (sigmoid(z) - y) m; rank 0 alone adds the loss and the
//     intercept gradient;
//   - (G) each thread adds r x into its CL_IPT float4 gradient registers from
//     the same staged rows, rows in order, and never reads X again;
//   - each CTA writes its slice of the cluster's (d + 1) partial once (rank
//     0 the intercept in the last column, and the loss), and the
//     fixed-order second pass (logreg_reduce_kernel) adds one partial a
//     cluster: deterministic, with no float atomics.
// What bounds it on an H100: the bytes of X, read once (at 72,309 x 20,958,
// 6.06 GB, 1.81 ms at 3.35 TB/s); 2 n d FMAs are far below the FP32 peak.
// Per row a CTA waits on its block barriers and its peers' partials; the
// ring's copies in flight (3-7 slots of one 32-64 KB row slice) cover them.

// float4 gradient items a thread (4,096 chunks a CTA at most, so 16 CTAs
// take 262,144 columns), and the ring's most slots
constexpr int CL_IPT = 16;
constexpr int CL_MAX_STAGES = 8;
// rows a CTA may run ahead of its slowest peer, and the exchange's slots
// (2 CL_LAG + 2: a rank publishes row t only once every peer has read
// row t - CL_XSLOTS, which it had to before it published row t - 1 - CL_LAG)
constexpr int CL_LAG = 2;
constexpr int CL_XSLOTS = 2 * CL_LAG + 2;
// the probe's knock-outs of the cluster kernel (the results are then
// wrong): the exchange (each rank takes its own partial as the logit),
// timing only; the last rank's partial left out of every logit, a
// negative control. KNOCK_G_NO_X: its gradient stage without its reads of
// the staged rows.
constexpr int KNOCK_CL_NO_EXCHANGE = 64;
constexpr int KNOCK_CL_DROP_RANK = 128;

// dynamic shared memory of logreg_cluster_kernel in bytes
// (ops/logreg_kernels.py::_cluster_smem computes the same): the ring of
// nst slots of a row slice of 4 (W + 1) floats (a chunk of room for a
// shifted slice), the exchange's slots of 16 ranks' partials, the warps'
// partials and the residual (two row parities each), and the slots'
// mbarriers
__host__ __device__ inline size_t cluster_smem_bytes(int W, int nst) {
  return (size_t)nst * (W + 1) * 16 + 4 * (16 * CL_XSLOTS + 2 * WARPS + 2) + 8 * (size_t)(nst + CL_XSLOTS);
}

// chunk j of a staged row slice (floats 4 j .. 4 j + 3) whose floats sit
// DL places into the row: from the 16-byte reads of chunks j and j + 1
template <int DL>
__device__ __forceinline__ float4 shifted_chunk(const float4* row, int j) {
  const float4 u = row[j];
  if constexpr (DL == 0) {
    return u;
  } else {
    const float4 v = row[j + 1];
    if constexpr (DL == 1) return make_float4(u.y, u.z, u.w, v.x);
    else if constexpr (DL == 2) return make_float4(u.z, u.w, v.x, v.y);
    else return make_float4(u.w, v.x, v.y, v.z);
  }
}
// f(std::integral_constant<int, dl>) for a runtime dl in 0..3
template <typename F>
__device__ __forceinline__ void with_shift(int dl, F&& f) {
  switch (dl) {
    case 0: f(std::integral_constant<int, 0>()); break;
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    default: f(std::integral_constant<int, 3>());
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `p`'s counterpart in CTA `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// an asynchronous store of v to the shared::cluster address `addr` (this
// CTA's or a peer's) that completes 4 bytes of the transaction count of
// the mbarrier at `bar` (in the same CTA as `addr`)
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v),
               "r"(bar)
               : "memory");
}
// mbar_wait whose completion makes the arrivals' earlier stores from
// other CTAs of the cluster visible
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n@!p bra "
      "WAIT_%=;\n}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global to this CTA's shared memory, both
// 16-byte aligned, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
logreg_cluster_kernel(const float* __restrict__ X, const float* __restrict__ y, const float* __restrict__ m,
                      const float* __restrict__ A, const float* __restrict__ b, float* __restrict__ part,
                      float* __restrict__ loss_part, int64_t n, int d, int W, int nst, int knock) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool exchange = !(knock & KNOCK_CL_NO_EXCHANGE);
  const unsigned rank = cluster_rank(), C = cluster_size();
  const unsigned peers = knock & KNOCK_CL_DROP_RANK ? C - 1 : C;
  const int64_t cid = cluster_id(), ncl = cluster_count();
  // floats of a rank's slice, and of a staged row (a chunk more, for a
  // slice shifted off alignment)
  const int RW = 4 * W, RS = RW + 4;
  float* ring = smem;                       // [nst][RS]: a row slice a slot
  float* xr = ring + (size_t)nst * RS;      // [CL_XSLOTS][16 ranks]: the ranks' partial logits
  float* wp = xr + CL_XSLOTS * 16;          // [2][WARPS]: the warps' partials, by tile parity
  float* sR = wp + 2 * WARPS;               // [2]: the residual, by tile parity
  uint64_t* full = reinterpret_cast<uint64_t*>(sR + 2);  // [nst]: the ring's slots
  uint64_t* xfull = full + nst;                          // [CL_XSLOTS]: the exchange's
  // this rank's columns [c0, c0 + ncols), nw chunks of them (the last
  // possibly partial)
  const int c0 = rank * RW, ncols = max(0, min(d - c0, RW)), nw = (ncols + 3) / 4;
  // rows a CTA may run ahead of its slowest peer: what the ring holds
  // beside one row's copy in flight
  const int lag = min(CL_LAG, nst - 2);

  float4 a[CL_IPT], g[CL_IPT];
#pragma unroll
  for (int i = 0; i < CL_IPT; ++i) {
    const int c = 4 * (tid + i * THREADS), e = c0 + ncols;  // zero past the slice
    a[i].x = c0 + c < e ? A[c0 + c] : 0.f;
    a[i].y = c0 + c + 1 < e ? A[c0 + c + 1] : 0.f;
    a[i].z = c0 + c + 2 < e ? A[c0 + c + 2] : 0.f;
    a[i].w = c0 + c + 3 < e ? A[c0 + c + 3] : 0.f;
    g[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float b0 = b[0];
  if (!VEC) {  // a shifted slice's last chunk reads past its floats: only ever finite ones
    float4* r4 = reinterpret_cast<float4*>(ring);
    for (int i = tid; i < nst * RS / 4; i += THREADS) r4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the copies overwrite them
  }
  if (tid == 0) {
    // VEC: the bulk copy's expect_tx; else that and every thread's
    // asynchronous arrival after thread 0's head and tail copies
    for (int s = 0; s < nst; ++s) mbar_init(full + s, VEC ? 1 : THREADS + 1);
    // this CTA's expect_tx of every rank's partial of a row
    for (int s = 0; s < CL_XSLOTS; ++s) mbar_init(xfull + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // no rank signals a peer before the peer's barriers exist
  cluster_arrive();
  cluster_wait();

  // this cluster's rows cid, cid + ncl, ...: its it-th is cid + it ncl
  const int iters = cid < n ? (int)((n - cid + ncl - 1) / ncl) : 0;
  auto row_of = [&](int it) -> int64_t { return cid + (int64_t)it * ncl; };
  // where row `row`'s slice starts past a 16-byte boundary, in floats; its
  // floats before the first boundary (head) and its whole 16-byte groups
  // after it
  const uint64_t xq = reinterpret_cast<uintptr_t>(X) / 4;
  auto shift = [&](int64_t row) -> int { return VEC ? 0 : (int)((xq + (uint64_t)(row * d + c0)) & 3); };
  auto cut = [&](int64_t row, int& dl, int& head, int& groups) {
    dl = shift(row);
    head = min((4 - dl) & 3, ncols);
    groups = (ncols - head) / 4;
  };
  auto issue = [&](int it) {  // row it's slice into slot it % nst
    if (it >= iters) return;
    const int64_t row = row_of(it);
    float* slot = ring + (size_t)(it % nst) * RS;
    uint64_t* bar = full + it % nst;
    int dl, head, groups;
    cut(row, dl, head, groups);
    const float* src = X + row * d + c0;
    if (tid == 0) {  // the aligned interior, float dl of the slice at float dl of its row
      mbar_expect(bar, 16u * groups);
      if (groups > 0) bulk_copy(slot + dl + head, src + head, 16u * groups, bar);
      if (!VEC) {  // and its head and tail floats
        for (int c = 0; c < head; ++c) cp_async4(slot + dl + c, src + c, 4);
        for (int c = head + 4 * groups; c < ncols; ++c) cp_async4(slot + dl + c, src + c, 4);
      }
    }
    if (!VEC) mbar_cp_async_arrive(bar);  // every thread arrives once a slot use
  };
  // f(row it's staged slice as float4s, std::integral_constant<int, its shift>)
  auto with_row = [&](int it, auto&& f) {
    const float4* row = reinterpret_cast<const float4*>(ring + (size_t)(it % nst) * RS);
    if constexpr (VEC) {
      f(row, std::integral_constant<int, 0>());
    } else {
      with_shift(shift(row_of(it)), [&](auto D) { f(row, D); });
    }
  };
  // (L): row t's partial logit over this rank's slice: the thread's chunks
  // (four accumulators by i % 4, added pairwise), the warp, then into the
  // warps' slots (two buffers by parity)
  auto logits = [&](int t) {
    mbar_wait(full + t % nst, (t / nst) & 1);
    with_row(t, [&](const float4* row, auto D) {
      constexpr int DL = decltype(D)::value;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < CL_IPT; ++i) {
        const int j = tid + i * THREADS;
        if (j < nw) {
          const float4 x = shifted_chunk<DL>(row, j);
          float u = s4[i & 3];
          u = fmaf(x.x, a[i].x, u);
          u = fmaf(x.y, a[i].y, u);
          u = fmaf(x.z, a[i].z, u);
          u = fmaf(x.w, a[i].w, u);
          s4[i & 3] = u;
        }
      }
      const float v = warp_sum((s4[0] + s4[1]) + (s4[2] + s4[3]));
      if (lane == 0) wp[(t & 1) * WARPS + warp] = v;
    });
  };
  // thread 0: the CTA's partial of row t (the warps in order) into this
  // rank's place of every rank's exchange slot, each store completing its
  // bytes on that rank's barrier, which expects the C ranks' partials
  auto publish = [&](int t) {
    if (tid != 0) return;
    const int sx = t % CL_XSLOTS;
    float* dst = xr + sx * 16 + rank;
    const float* w8 = wp + (t & 1) * WARPS;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += w8[w];
    if (!exchange) {
      *dst = v;
      return;
    }
    mbar_expect(xfull + sx, C * 4u);
    for (unsigned q = 0; q < C; ++q) st_async(map_rank(dst, q), v, map_rank(xfull + sx, q));
  };
  // (G): row t times its residual into g
  auto grad = [&](int t) {
    const float rv = sR[t & 1];
    with_row(t, [&](const float4* row, auto D) {
      constexpr int DL = decltype(D)::value;
#pragma unroll
      for (int i = 0; i < CL_IPT; ++i) {
        const int j = tid + i * THREADS;
        if (j < nw) {
          const float4 x = knock & KNOCK_G_NO_X ? a[i] : shifted_chunk<DL>(row, j);
          g[i].x = fmaf(rv, x.x, g[i].x);
          g[i].y = fmaf(rv, x.y, g[i].y);
          g[i].z = fmaf(rv, x.z, g[i].z);
          g[i].w = fmaf(rv, x.w, g[i].w);
        }
      }
    });
  };

  // Software pipeline over this cluster's rows: row t's logit is
  // published, then row t - lag's residual (its partials from every rank)
  // and gradient follow, its slot refilled
  for (int s = 0; s < nst; ++s) issue(s);
  float lsum = 0.f, gbs = 0.f;  // rank 0's thread 0: loss and intercept gradient
  for (int t = 0; t < iters + lag; ++t) {
    const int u = t - lag;
    const int64_t r0 = u >= 0 ? row_of(u) : 0;
    // row u's mask and label, loaded ahead of the logits
    const float mr = tid == 0 && u >= 0 ? __ldg(m + r0) : 0.f, yr = tid == 0 && u >= 0 ? __ldg(y + r0) : 0.f;
    if (t < iters) {
      logits(t);
      __syncthreads();  // row t's warp partials
      publish(t);
    }
    if (u < 0) continue;
    // every rank: the row's logit from the C partials in rank order, + b
    if (tid == 0) {
      const int sx = u % CL_XSLOTS;
      float z = 0.f;
      if (exchange) {
        mbar_wait_cluster(xfull + sx, (u / CL_XSLOTS) & 1);
        for (unsigned q = 0; q < peers; ++q) z += xr[sx * 16 + q];
      } else {
        z = xr[sx * 16 + rank];
      }
      z += b0;
      const float rv = (1.f / (1.f + expf(-z)) - yr) * mr;
      sR[u & 1] = rv;
      if (rank == 0) {
        lsum += (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yr * z) * mr;
        gbs += rv;
      }
    }
    __syncthreads();  // row u's residual
    grad(u);
    __syncthreads();  // every thread is done with slot u % nst
    issue(u + nst);   // into that slot
  }
  // no CTA leaves while a peer may still signal it
  cluster_arrive();
  cluster_wait();

  // this rank's slice of the cluster's partial, written once
  float* P = part + (size_t)cid * (d + 1);
#pragma unroll
  for (int i = 0; i < CL_IPT; ++i) {
    const int j = tid + i * THREADS;
    if (j < nw) {
      const float v[4] = {g[i].x, g[i].y, g[i].z, g[i].w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * j + w < ncols) P[c0 + 4 * j + w] = v[w];
    }
  }
  if (rank == 0 && tid == 0) {
    loss_part[cid] = lsum;
    P[d] = gbs;
  }
}

template <bool VEC>
cudaError_t cluster_config(int C, int clusters, size_t smem, cudaStream_t st, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const auto kern = logreg_cluster_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

}  // namespace

// The caller picks the kernel (ops/logreg_kernels.py::_k3_variant):
// 10 * NV + 1 for logreg_rows_kernel<NV, 1>, 100 * NV + KP for
// logreg_mrows_kernel<NV, KP>, 1000 + IPT (binomial) and 2000 + IPT
// (multinomial) for logreg_tile_kernel with its launch geometry (BM, vec
// and the shared memory the wrapper sized, which must equal
// tile_smem_floats), anything else for the general kernel.
extern "C" int logreg_loss_grad_launch(const float* X, const float* y, const float* m,
                                       const float* A, const float* b, float* gA,
                                       float* gb, float* loss, float* part,
                                       float* loss_part, int64_t n, int d, int K,
                                       int multinomial, int RT, int nblocks,
                                       int64_t rows_per_block, int variant, int BM,
                                       int vec, int smem_bytes, int knock,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)RT * K;
#define ROWS(NV, KR)                                                     \
  case 10 * NV + KR:                                                     \
    logreg_rows_kernel<NV, KR, false><<<nblocks, THREADS, 0, st>>>(     \
        X, y, m, A, b, part, loss_part, n, d, K, multinomial, 0, 0);     \
    break;
#define MROWS(NV, KP)                                                           \
  case 100 * NV + KP: {                                                         \
    const size_t bytes = sizeof(float) * mrows_smem_floats<NV, KP>();           \
    const cudaError_t err = cudaFuncSetAttribute(                               \
        logreg_mrows_kernel<NV, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        (int)bytes);                                                            \
    if (err != cudaSuccess) return (int)err;                                    \
    logreg_mrows_kernel<NV, KP><<<nblocks, THREADS, bytes, st>>>(              \
        X, y, m, A, b, part, loss_part, n, d, K);                               \
    break;                                                                      \
  }
#define TILE(KG, IPT)                                                             \
  case (KG == 1 ? 1000 : 2000) + IPT: {                                           \
    const size_t bytes = sizeof(float) * tile_smem_floats(d, K, KG, BM);          \
    if (bytes != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;           \
    const cudaError_t err = cudaFuncSetAttribute(                                 \
        logreg_tile_kernel<KG, IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        (int)bytes);                                                              \
    if (err != cudaSuccess) return (int)err;                                      \
    logreg_tile_kernel<KG, IPT><<<nblocks, THREADS, bytes, st>>>(                 \
        X, y, m, A, b, part, loss_part, n, d, K, BM, vec);                        \
    break;                                                                        \
  }
#define MROWS_NV(NV)                                                            \
  MROWS(NV, 2) MROWS(NV, 3) MROWS(NV, 4) MROWS(NV, 5) MROWS(NV, 6) MROWS(NV, 7)   \
  MROWS(NV, 8) MROWS(NV, 9) MROWS(NV, 10) MROWS(NV, 11) MROWS(NV, 12)             \
  MROWS(NV, 13) MROWS(NV, 14) MROWS(NV, 15) MROWS(NV, 16)
  if (!(knock & KNOCK_NO_PARTIAL)) switch (variant) {
    ROWS(1, 1)
    ROWS(2, 1)
    ROWS(4, 1)
    ROWS(8, 1)
    MROWS_NV(1)
    MROWS_NV(2)
    TILE(1, 1)
    TILE(1, 2)
    TILE(1, 4)
    TILE(1, 8)
    TILE(1, 16)
    TILE(4, 1)
    TILE(4, 2)
    TILE(4, 4)
    default:
      logreg_partial_kernel<false><<<nblocks, THREADS, smem, st>>>(
          X, y, m, A, b, part, loss_part, n, d, K, multinomial, RT, rows_per_block, knock, 0);
  }
#undef TILE
#undef MROWS_NV
#undef MROWS
#undef ROWS
  const int64_t total = (int64_t)K * (d + 1) + 1;
  if (!(knock & KNOCK_NO_REDUCE))
    logreg_reduce_kernel<<<(unsigned)((total + 31) / 32), THREADS, 0, st>>>(
        part, loss_part, nblocks, gA, gb, loss, d, K, nullptr, 0);
  return (int)cudaGetLastError();
}

// bf16 X (ops/logreg_kernels.py::_k3_variant_bf16): 10 * NV + 1 for
// logreg_rows_kernel<NV, 1, true> (binomial, d % 4 == 0, d <= 128 NV, X
// 8-byte aligned, A 16-byte aligned), 0 for the general kernel's bf16
// instance (any shape; RT, nblocks and rows_per_block as the f32 general
// kernel's). round_ops: the numerical contract (the note at the top);
// knock KNOCK_NO_R_ROUND a negative control, 1 and 2 as above.
extern "C" int logreg_loss_grad_bf16_launch(const void* X, const float* y, const float* m, const float* A,
                                            const float* b, float* gA, float* gb, float* loss, float* part,
                                            float* loss_part, int64_t n, int d, int K, int multinomial, int RT,
                                            int nblocks, int64_t rows_per_block, int variant, int round_ops,
                                            int knock, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant != 0 && (multinomial || K != 1 || d % 4 != 0 || reinterpret_cast<uintptr_t>(X) % 8 != 0 ||
                       reinterpret_cast<uintptr_t>(A) % 16 != 0 || d > 128 * (variant / 10)))
    return (int)cudaErrorInvalidValue;
#define ROWS_BF(NV)                                                                                  \
  case 10 * NV + 1:                                                                                 \
    logreg_rows_kernel<NV, 1, true><<<nblocks, THREADS, 0, st>>>(X, y, m, A, b, part, loss_part, n, d, \
                                                                 K, 0, round_ops, knock);            \
    break;
  if (!(knock & KNOCK_NO_PARTIAL)) switch (variant) {
    ROWS_BF(1)
    ROWS_BF(2)
    ROWS_BF(4)
    ROWS_BF(8)
    case 0:
      logreg_partial_kernel<true><<<nblocks, THREADS, sizeof(float) * (size_t)RT * K, st>>>(
          X, y, m, A, b, part, loss_part, n, d, K, multinomial, RT, rows_per_block, knock, round_ops);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ROWS_BF
  const int64_t total = (int64_t)K * (d + 1) + 1;
  if (!(knock & KNOCK_NO_REDUCE))
    logreg_reduce_kernel<<<(unsigned)((total + 31) / 32), THREADS, 0, st>>>(
        part, loss_part, nblocks, gA, gb, loss, d, K, nullptr, 0);
  return (int)cudaGetLastError();
}

// The route past the tile kernel's cap, one chunk of n rows (X, y, m
// offset to it by the caller): A's split (split_a: the first chunk),
// logits kernel (A) on grid_a blocks, gradient kernel (B) on grid_b
// blocks over col_tiles x ranges tiles of range_rows rows (a multiple of
// 32; CT: col_tiles x class tiles x ranges). `code` is 3000 + BN (3256:
// 129-256 classes, split over the two warpgroups; 3900: the class-tiled
// instance, 2 <= K <= 12,288 in tiles of 128); ahi and alo hold (K, da)
// floats, rhi and rlo (K, nr); part takes `ranges` partials of K (d + 1)
// (CT: zeroed by the caller, added to), side grid_a of K + 1; zs (CT)
// grid_a x class tiles x 16,384 floats. knock 16: the logits kernel
// alone; 32 (CT): the class tiles merged without rescaling the sum.
extern "C" int logreg_route_launch(const float* X, const float* y, const float* m, const float* A,
                                   const float* b, float* ahi, float* alo, float* rhi, float* rlo,
                                   float* part, float* side, float* zs, int n, int d, int K, int code,
                                   int stages, int grid_a, int col_tiles, int ranges, int range_rows,
                                   int grid_b, int da, int nr, int split_a, int tma_x, unsigned tf32_bias,
                                   unsigned tf32_mask, int knock, void* stream) {
  const bool ct = code == RT_CT_CODE, split = code == 3256;
  const int bn = ct || split ? 128 : code - 3000;
  const int npt = split ? 2 * bn : bn;
  if (n < 1 || d < 1 || K < 2 || K > (ct ? RT_CT_MAX_K : npt) || (ct && !zs) || stages < 2 ||
      stages > RT_MAX_STAGES || range_rows % RT_RB != 0 || (int64_t)ranges * range_rows < n ||
      col_tiles * route_bm(split) < d || grid_a < 1 || grid_b < 1 || da < d || da % 4 != 0 || nr < n ||
      nr % 4 != 0 || (tma_x && (d % 4 != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tf32 tf{tf32_bias, tf32_mask};
  if (split_a) {
    const int64_t kd = (int64_t)K * d;
    route_split_kernel<<<(unsigned)((kd + 255) / 256 < 1024 ? (kd + 255) / 256 : 1024), 256, 0, st>>>(
        A, ahi, alo, K, d, da, tf);
  }
  const RouteArgs a{X, y, m, b, rhi, rlo, part, side, zs, n, d, K, stages, tma_x, col_tiles, ranges, range_rows,
                    nr, ct ? (K + npt - 1) / npt : 1, knock, tf};
  cudaError_t err;
  switch (code) {
    case 3016: err = route_pass<16, false>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    case 3032: err = route_pass<32, false>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    case 3064: err = route_pass<64, false>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    case 3128: err = route_pass<128, false>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    case 3256: err = route_pass<128, true>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    case RT_CT_CODE: err = route_pass<128, false, true>(a, ahi, alo, da, grid_a, grid_b, knock, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The route's second pass: the fixed-order sum of nb gradient partials
// and nside (intercept, loss) partials.
extern "C" int logreg_route_reduce(const float* part, int nb, const float* side, int nside, float* gA,
                                   float* gb, float* loss, int d, int K, void* stream) {
  const int64_t total = (int64_t)K * (d + 1) + 1;
  logreg_reduce_kernel<<<(unsigned)((total + 31) / 32), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      part, nullptr, nb, gA, gb, loss, d, K, side, nside);
  return (int)cudaGetLastError();
}

// The cluster kernel (binomial 16,380 < d <= 262,144) on `clusters`
// clusters of C CTAs, then the second pass over their partials, at the
// geometry the caller computed (ops/logreg_kernels.py::_cluster_geometry):
// W chunks a rank's slice, nst ring slots, smem_bytes (which must equal
// cluster_smem_bytes); `vec` picks the instance (bulk copies alone, or
// off 16-byte alignment). knock: 1 and 2 as for the other kernels, 4
// (KNOCK_G_NO_X), 64 and 128 (see the kernel).
extern "C" int logreg_cluster_launch(const float* X, const float* y, const float* m, const float* A,
                                     const float* b, float* gA, float* gb, float* loss, float* part,
                                     float* loss_part, int64_t n, int d, int C, int W, int nst, int smem_bytes,
                                     int clusters, int vec, int knock, void* stream) {
  const int nch = (d + 3) / 4;
  if (n < 0 || d < 1 || C < 1 || C > 16 || (C & (C - 1)) || W != (nch + C - 1) / C || CL_IPT * THREADS < W ||
      nst < 2 || nst > CL_MAX_STAGES || clusters < 1 || (size_t)smem_bytes != cluster_smem_bytes(W, nst) ||
      (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(knock & KNOCK_NO_PARTIAL)) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err;
    if (vec) {
      err = cluster_config<true>(C, clusters, smem_bytes, st, cfg, attr);
      if (err == cudaSuccess)
        err = cudaLaunchKernelEx(&cfg, logreg_cluster_kernel<true>, X, y, m, A, b, part, loss_part, n, d, W, nst,
                                 knock);
    } else {
      err = cluster_config<false>(C, clusters, smem_bytes, st, cfg, attr);
      if (err == cudaSuccess)
        err = cudaLaunchKernelEx(&cfg, logreg_cluster_kernel<false>, X, y, m, A, b, part, loss_part, n, d, W, nst,
                                 knock);
    }
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t total = (int64_t)d + 2;
  if (!(knock & KNOCK_NO_REDUCE))
    logreg_reduce_kernel<<<(unsigned)((total + 31) / 32), THREADS, 0, st>>>(part, loss_part, clusters, gA, gb,
                                                                           loss, d, 1, nullptr, 0);
  return (int)cudaGetLastError();
}

// the most clusters of C CTAs of the cluster kernel's instance `vec`, at
// smem_bytes of dynamic shared memory each, that the card holds at once
// (0: none can launch)
extern "C" int logreg_cluster_occupancy(int vec, int C, int smem_bytes, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = vec ? cluster_config<true>(C, 1, smem_bytes, nullptr, cfg, attr)
                              : cluster_config<false>(C, 1, smem_bytes, nullptr, cfg, attr);
  const void* fn = vec ? (const void*)logreg_cluster_kernel<true> : (const void*)logreg_cluster_kernel<false>;
  *out = 0;
  return (int)(err == cudaSuccess ? cudaOccupancyMaxActiveClusters(out, fn, &cfg) : err);
}

// registers, local (spill) bytes a thread, resident blocks an SM at `smem`
// bytes of dynamic shared memory, and that smem: out[0..3], of the kernel
// a launcher code names (0: the general kernel, 1000 + IPT and 2000 + IPT:
// the tile kernel's instances, 3000 + BN, 3256 and 3900: the route's
// logits kernel, 4000 + BN, 4256 and 4900: its gradient kernel, 5016
// and 5116: the cluster kernel's instances on the bulk copies alone and
// off 16-byte alignment, 10000 and 10000 + 10 NV + 1: the general and
// rows kernels' bf16 instances) or of the second pass (-1)
extern "C" int logreg_attributes(int variant, int smem, int* out) {
  const void* fn = nullptr;
  switch (variant) {
    case -1: fn = (const void*)logreg_reduce_kernel; break;
    case 0: fn = (const void*)logreg_partial_kernel<false>; break;
    case 10000: fn = (const void*)logreg_partial_kernel<true>; break;
    case 10011: fn = (const void*)logreg_rows_kernel<1, 1, true>; break;
    case 10021: fn = (const void*)logreg_rows_kernel<2, 1, true>; break;
    case 10041: fn = (const void*)logreg_rows_kernel<4, 1, true>; break;
    case 10081: fn = (const void*)logreg_rows_kernel<8, 1, true>; break;
    case 1001: fn = (const void*)logreg_tile_kernel<1, 1>; break;
    case 1002: fn = (const void*)logreg_tile_kernel<1, 2>; break;
    case 1004: fn = (const void*)logreg_tile_kernel<1, 4>; break;
    case 1008: fn = (const void*)logreg_tile_kernel<1, 8>; break;
    case 1016: fn = (const void*)logreg_tile_kernel<1, 16>; break;
    case 2001: fn = (const void*)logreg_tile_kernel<4, 1>; break;
    case 2002: fn = (const void*)logreg_tile_kernel<4, 2>; break;
    case 2004: fn = (const void*)logreg_tile_kernel<4, 4>; break;
    case 3016: fn = (const void*)logreg_route_kernel<16, false, false>; break;
    case 3032: fn = (const void*)logreg_route_kernel<32, false, false>; break;
    case 3064: fn = (const void*)logreg_route_kernel<64, false, false>; break;
    case 3128: fn = (const void*)logreg_route_kernel<128, false, false>; break;
    case 3256: fn = (const void*)logreg_route_kernel<128, true, false>; break;
    case 4016: fn = (const void*)logreg_route_kernel<16, false, true>; break;
    case 4032: fn = (const void*)logreg_route_kernel<32, false, true>; break;
    case 4064: fn = (const void*)logreg_route_kernel<64, false, true>; break;
    case 4128: fn = (const void*)logreg_route_kernel<128, false, true>; break;
    case 4256: fn = (const void*)logreg_route_kernel<128, true, true>; break;
    case RT_CT_CODE: fn = (const void*)logreg_route_kernel<128, false, false, true>; break;
    case RT_CT_CODE + 1000: fn = (const void*)logreg_route_kernel<128, false, true, true>; break;
    case 5000 + CL_IPT: fn = (const void*)logreg_cluster_kernel<true>; break;
    case 5100 + CL_IPT: fn = (const void*)logreg_cluster_kernel<false>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int threads = variant >= 3000 && variant < 5000 ? RT_THREADS : THREADS;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = smem;
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
