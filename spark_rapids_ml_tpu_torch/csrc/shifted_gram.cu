// Shifted Gram pass: G = sum_r m_r^2 (x_r - mu)(x_r - mu)^T and
// s = sum_r m_r (x_r - mu), in f32, for any n and d. Each row is scaled
// by m_r before the product, so G weighs it by m_r^2: for a 0/1 mask that
// is m_r, and row weights w_r enter as m_r = sqrt(w_r).
//
// Replaces spark_rapids_ml_tpu/ops/linalg.py::_shifted_gram_pallas (the
// pl.pallas_call at linalg.py:141), which streams row tiles through VMEM
// into one d x d accumulator carried across a sequential grid.
//
// What bounds it on an H100: instruction issue. At 12M x 256 the pass
// forms 62.5% of the full product 2*n*d^2, 0.98 TFLOP of exact f32 FMA,
// against 12.3 GB of X: the symmetric half alone is 11.9 ms of FP32 at
// 67 TFLOP/s, the bytes 3.7 ms of HBM at 3.35 TB/s. Each FFMA takes a
// scheduler's issue slot, so every other instruction (shared loads, a
// stage's global loads, shift and store, address arithmetic) and every
// cycle a scheduler finds no warp ready is FP32 rate lost; under this load
// the card also sits at its power limit (1.89-1.98 GHz at ~695 W). The
// products stay in plain f32 fmaf (no TF32, no tensor cores) to keep the
// rounding class of the JAX package's CPU/interpret oracle.
//
// Design. Blocks run in parallel in no order, so the TPU's resident
// accumulator becomes a grid of (upper-triangle 128x128 output tile, row
// split): each block walks its row range in 16-row stages and accumulates
// an 8x8 register micro-tile per thread (the classic SGEMM layout) from the
// shifted and masked rows (x - mu) * m of its two column panels in shared
// memory. Against the issue limit:
// - Two blocks per SM (__launch_bounds__(256, 2): at most 128 registers),
//   16 warps, 4 a scheduler. A thread's loads walk from one row pointer per
//   block with its row count in 32 bits.
// - Loads overlap FMAs: two stage buffers. The next stage's global loads
//   (float4 when d % 4 == 0 and X is 16-byte aligned) go to registers
//   before the current stage's 16 k-steps and are shifted, masked and
//   stored to the other buffer after them, with mu staged once per block:
//   one __syncthreads() a stage. No branch guards the loads (a stage past
//   the last is all selects): behind one, the compiler sank them below the
//   FMAs. The scalar path (any d, any alignment) keeps one row in flight at
//   a time, its 4-column slots masked per column.
// - Less work on the diagonal: a diagonal tile stages one panel (A is B)
//   and skips the lower-left 64x64 quadrant of its micro-tiles (acc[i >= 4]
//   [j < 4], a template, so block-uniform); the reduction pass mirrors it.
//   At d = 256 that is 62.5% of the full product instead of 75%.
// - Enough blocks: the wrapper cuts the rows into splits for ~16 waves of
//   resident blocks, so the diagonal tiles' shorter blocks even out.
// Each block writes its partial tile (and a diagonal tile its column sums)
// to a scratch buffer, and a second pass sums the partials over splits in a
// fixed order: deterministic, with no float atomics. Rows past n are zeroed
// with a select (not a multiply), as the TPU kernel guards its overhanging
// last tile; columns past d feed only outputs the reduction drops.
//
// Measured (K1-only probes on an NVIDIA H100 80GB HBM3, 700.00 W): 22.9-23.4
// ms at 12,000,112 x 256 (16 waves), against 28.4-28.6 ms for one cuBLAS
// SGEMM of the shifted rows and 50.5 ms for this kernel's first version;
// the float4 instance uses 128 registers and no spills, the scalar one 128
// registers and 44 bytes of spills (loop constants reloaded once a stage).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // output tile edge
constexpr int HALF = TILE / 2;
constexpr int BK = 16;        // rows per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int MIN_BLOCKS = 2; // resident blocks per SM the register budget allows
constexpr int GROUPS = THREADS / (TILE / 4);  // 8 row groups of one float4-wide pass

// (row, column) tile of upper-triangle tile t of a T x T tile grid
struct TilePos {
  int i, j;
};
__device__ __forceinline__ TilePos upper_tile(int t, int T) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  return {i, i + t};
}

// micro-tile row/col i in [0, 8) of thread coordinate c in [0, 16)
__device__ __forceinline__ int micro(int c, int i) {
  return i < 4 ? c * 4 + i : HALF + c * 4 + (i - 4);
}

// One thread's share of a stage in flight: rows k0 and k0 + 8, columns
// c..c+3 of each of the NP panels, and the two rows' weights.
template <int NP>
struct Prefetch {
  float4 x[NP][BK / GROUPS];
  float m[BK / GROUPS];
};

// Bits 0..3 set for the columns of a 4-column slot that lie inside the row,
// given the columns left from the slot's first on.
__device__ __forceinline__ int slot_mask(int cols_left) {
  return cols_left >= 4 ? 15 : cols_left > 0 ? (1 << cols_left) - 1 : 0;
}

// Rows k0 + 8j (J0 <= j < J1) of the next stage into registers. xp points
// at this thread's first element of the stage (row rb + k0, panel A's
// column); panel B lies dB further; left = rows of the split from row
// rb + k0 on. A float4 slot past d reads the row's last float4 instead (it
// feeds only outputs the reduction drops); a scalar slot reads the columns
// its mask ok2 (panel A in bits 0-3, B in 4-7) marks inside the row.
template <bool VEC, int NP, int J0, int J1>
__device__ __forceinline__ void load_stage(Prefetch<NP>& p, const float* xp, const float* mp,
                                           int left, int d, int dB, int ok2) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    const bool rv = left > GROUPS * j;
    p.m[j] = rv ? __ldg(mp + GROUPS * j) : 0.f;
    const float* xr = xp + GROUPS * j * d;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const float* xq = q ? xr + dB : xr;
      if (VEC) {
        p.x[q][j] = rv ? __ldg(reinterpret_cast<const float4*>(xq)) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {  // bit e of the mask: column e of the slot lies inside the row
        const int ok = q ? ok2 >> 4 : ok2;
        p.x[q][j].x = (rv && (ok & 1)) ? __ldg(xq) : 0.f;
        p.x[q][j].y = (rv && (ok & 2)) ? __ldg(xq + 1) : 0.f;
        p.x[q][j].z = (rv && (ok & 4)) ? __ldg(xq + 2) : 0.f;
        p.x[q][j].w = (rv && (ok & 8)) ? __ldg(xq + 3) : 0.f;
      }
    }
  }
}

// (x - mu) * m into the panels P[q][k0 + 8j][c..c+3]; rows past the split
// (left <= 8j) are zeroed by a select. A diagonal tile adds its values into
// the column sums.
template <int NP, bool DIAG, int J0, int J1>
__device__ __forceinline__ void store_stage(const Prefetch<NP>& p, float (*P)[BK][TILE],
                                            const float (*mu_s)[TILE], int left, int k0, int c,
                                            float (&ssum)[4]) {
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const float4 mu = *reinterpret_cast<const float4*>(&mu_s[q][c]);
#pragma unroll
    for (int j = J0; j < J1; ++j) {
      const bool rv = left > GROUPS * j;
      const float mr = p.m[j];
      const float4 x = p.x[q][j];
      float4 v;
      v.x = rv ? (x.x - mu.x) * mr : 0.f;
      v.y = rv ? (x.y - mu.y) * mr : 0.f;
      v.z = rv ? (x.z - mu.z) * mr : 0.f;
      v.w = rv ? (x.w - mu.w) * mr : 0.f;
      *reinterpret_cast<float4*>(&P[q][k0 + GROUPS * j][c]) = v;
      if (DIAG) {
        ssum[0] += v.x;
        ssum[1] += v.y;
        ssum[2] += v.z;
        ssum[3] += v.w;
      }
    }
  }
}

// k-steps K0..K1-1 of the 8x8 micro-tile; a diagonal tile skips the
// lower-left quadrant (the reduction mirrors the upper-right one into it).
template <bool DIAG, int K0, int K1>
__device__ __forceinline__ void mma_stage(float (&acc)[8][8], const float* A, const float* B,
                                          int tx, int ty) {
#pragma unroll
  for (int k = K0; k < K1; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * TILE + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * TILE + HALF + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * TILE + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k * TILE + HALF + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(DIAG && i >= 4 && j < 4)) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The block's walk over rows [r0, r1): stage s + 1 loads while stage s
// multiplies, two buffers, one barrier a stage.
template <bool VEC, bool DIAG>
__device__ __forceinline__ void walk(float (&acc)[8][8], float (&ssum)[4],
                                     float (*S)[2][BK][TILE], const float (*mu_s)[TILE],
                                     const float* __restrict__ X, const float* __restrict__ m,
                                     int64_t r0, int64_t r1, int d, int ci0, int cj0, int tid) {
  constexpr int NP = DIAG ? 1 : 2;
  if (r0 >= r1) return;
  const int k0 = tid / (TILE / 4), c = (tid % (TILE / 4)) * 4;
  const int tx = tid % 16, ty = tid / 16;
  // a float4 slot past d reads the row's last float4 instead
  const int ca = VEC ? min(ci0 + c, d - 4) : ci0 + c;
  const int dB = (VEC ? min(cj0 + c, d - 4) : cj0 + c) - ca;
  const int ok2 = slot_mask(d - (ci0 + c)) | slot_mask(d - (cj0 + c)) << 4;
  const float* xp = X + (r0 + k0) * d + ca;
  const float* mp = m + r0 + k0;
  int left = (int)(r1 - r0) - k0;  // a split holds at most 2^30 rows (the wrapper)
  const int stages = (int)((r1 - r0 + BK - 1) / BK);
  constexpr int R = BK / GROUPS;
  Prefetch<NP> p;
  load_stage<VEC, NP, 0, R>(p, xp, mp, left, d, dB, ok2);
  store_stage<NP, DIAG, 0, R>(p, S[0], mu_s, left, k0, c, ssum);
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    // the next stage, also past the last one: its loads and its store are
    // then all selects, and no branch parts them from the FMAs
    left -= BK;
    xp += BK * d;
    mp += BK;
    const int buf = st & 1;
    const float* A = &S[buf][0][0][0];
    const float* B = &S[buf][NP - 1][0][0];
    if constexpr (VEC) {
      load_stage<VEC, NP, 0, R>(p, xp, mp, left, d, dB, ok2);
      mma_stage<DIAG, 0, BK>(acc, A, B, tx, ty);
      store_stage<NP, DIAG, 0, R>(p, S[buf ^ 1], mu_s, left, k0, c, ssum);
    } else {  // scalar loads: one row in flight at a time, half the registers
      load_stage<VEC, NP, 0, 1>(p, xp, mp, left, d, dB, ok2);
      mma_stage<DIAG, 0, BK / 2>(acc, A, B, tx, ty);
      store_stage<NP, DIAG, 0, 1>(p, S[buf ^ 1], mu_s, left, k0, c, ssum);
      load_stage<VEC, NP, 1, R>(p, xp, mp, left, d, dB, ok2);
      mma_stage<DIAG, BK / 2, BK>(acc, A, B, tx, ty);
      store_stage<NP, DIAG, 1, R>(p, S[buf ^ 1], mu_s, left, k0, c, ssum);
    }
    __syncthreads();
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_partial_kernel(const float* __restrict__ X, const float* __restrict__ m,
                    const float* __restrict__ mu, float* __restrict__ part_G,
                    float* __restrict__ part_s, int64_t n, int d, int T,
                    int64_t rows_per_split) {
  __shared__ __align__(16) float S[2][2][BK][TILE];  // [buffer][panel][row][col]
  __shared__ __align__(16) float mu_s[2][TILE];

  const TilePos tp = upper_tile(blockIdx.x, T);
  const int ti = tp.i, tj = tp.j;
  const bool diag = ti == tj;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ci0 = ti * TILE, cj0 = tj * TILE;
  {
    const int q = tid / TILE, cl = tid % TILE;
    const int cg = (q ? cj0 : ci0) + cl;
    mu_s[q][cl] = cg < d ? mu[cg] : 0.f;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ssum[4] = {0.f, 0.f, 0.f, 0.f};  // diagonal blocks: columns c..c+3 of rows k0 (mod 8)

  if (diag)
    walk<VEC, true>(acc, ssum, S, mu_s, X, m, r0, r1, d, ci0, cj0, tid);
  else
    walk<VEC, false>(acc, ssum, S, mu_s, X, m, r0, r1, d, ci0, cj0, tid);

  float* out = part_G + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE * TILE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = micro(ty, i);
    *reinterpret_cast<float4*>(&out[row * TILE + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&out[row * TILE + HALF + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (diag) {  // block-uniform: the 8 row groups' column sums, in group order
    float* red = &S[0][0][0][0];  // [GROUPS][TILE]; the walk ended on a barrier
    const int k0 = tid / (TILE / 4), c = (tid % (TILE / 4)) * 4;
    *reinterpret_cast<float4*>(&red[k0 * TILE + c]) = make_float4(ssum[0], ssum[1], ssum[2], ssum[3]);
    __syncthreads();
    if (tid < TILE) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) v += red[g * TILE + tid];
      part_s[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE + tid] = v;
    }
  }
}

// Sums the per-split partials in split order and mirrors the upper tiles,
// and inside a diagonal tile the upper-right quadrant into the lower-left.
__global__ void gram_reduce_kernel(const float* __restrict__ part_G,
                                   const float* __restrict__ part_s,
                                   float* __restrict__ G, float* __restrict__ s,
                                   int d, int T, int nsplit) {
  const int t = blockIdx.y;
  const int n_up = gridDim.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < TILE * TILE) {
    const TilePos tp = upper_tile(t, T);
    const int ti = tp.i, tj = tp.j;
    const int lr = e / TILE, lc = e % TILE;
    const int r = ti * TILE + lr, c = tj * TILE + lc;
    if (r < d && c < d) {
      const int src = (ti == tj && lr >= HALF && lc < HALF) ? lc * TILE + lr : e;
      float v = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < nsplit; ++sp)
        v += part_G[((int64_t)sp * n_up + t) * TILE * TILE + src];
      G[(int64_t)r * d + c] = v;
      if (ti != tj) G[(int64_t)c * d + r] = v;
    }
  }
  if (t == 0 && e < d) {  // column e's sums sit in diagonal tile (i, i), i = e / TILE
    const int i = e / TILE;
    const int td = i * T - i * (i - 1) / 2;
    float v = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) v += part_s[((int64_t)sp * n_up + td) * TILE + e % TILE];
    s[e] = v;
  }
}

}  // namespace

extern "C" int shifted_gram_launch(const float* X, const float* m, const float* mu,
                                   float* G, float* s, float* part_G, float* part_s,
                                   int64_t n, int d, int nsplit,
                                   int64_t rows_per_split, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (d + TILE - 1) / TILE;
  const int n_up = T * (T + 1) / 2;
  const dim3 grid(n_up, nsplit);
  if (vec)
    gram_partial_kernel<true><<<grid, THREADS, 0, st>>>(
        X, m, mu, part_G, part_s, n, d, T, rows_per_split);
  else
    gram_partial_kernel<false><<<grid, THREADS, 0, st>>>(
        X, m, mu, part_G, part_s, n, d, T, rows_per_split);
  const int span = d > TILE * TILE ? d : TILE * TILE;
  gram_reduce_kernel<<<dim3((span + 255) / 256, n_up), 256, 0, st>>>(
      part_G, part_s, G, s, d, T, nsplit);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the partial-sum kernel (the smaller of its two
// load variants), as the grid geometry needs it.
extern "C" int shifted_gram_blocks_per_sm(int* out) {
  int a = 0, b = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, gram_partial_kernel<true>, THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gram_partial_kernel<false>, THREADS, 0);
  *out = a < b ? a : b;
  return (int)e;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
