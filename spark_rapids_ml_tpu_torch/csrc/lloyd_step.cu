// Fused Lloyd step: for every row, the nearest centre by ||c||^2 - 2 x.c
// (ties to the lowest index, as jnp.argmin), then sums[a] += m*x,
// counts[a] += (m > 0) and cost += m * max(best + ||x||^2, 0), in one pass
// over X. The (n, k) score and one-hot intermediates never reach device
// memory.
//
// Replaces spark_rapids_ml_tpu/ops/kmeans_pallas.py::lloyd_step_pallas (the
// pl.pallas_call at kmeans_pallas.py:174), which keeps the distance tile,
// the one-hot and the (k, d) accumulators resident in VMEM.
//
// What bounds it on an H100: the score product, 2*n*k*d operations (1.57e15
// at 12M x 256 and k = 1024), against 12.3 GB of X (~3.7 ms at 3.35 TB/s).
// In f32 FMA on the CUDA cores that is >= 94 ms at 67 TFLOP/s, and a SIMT
// tile stops near half of it. So the products run on the tensor cores in
// 3xTF32, as in knn_topk.cu: each operand value x is split into hi =
// tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties away
// from zero (an integer add and mask of the bits with the constants the
// wrapper passes), and each k = 8 step issues three wgmma m64n128k8 TF32
// products, lo*hi' + hi*lo' + hi*hi', into a fresh f32 accumulator for each
// 32-feature stage, which is folded into the running f32 score with an
// ordinary, rounded add (the tensor cores' own accumulation truncates).
// x = hi + lo + e with |e| <= 2^-22 |x|, so the dropped lo*lo' and e terms
// are rounding noise of a few f32 units a product: the scores stay well
// inside the band that the on-card check grants an f32 score, and one-pass
// TF32 (hi*hi' alone) does not. Three times the TF32 work: >= 38 ms at 495
// TFLOP/s.
//
// Design. split_centres_kernel first writes the centres' TF32 hi and lo
// once (scratch the wrapper allocates: 2 MB at k = 1024, resident in L2)
// and ||c||^2 padded with +inf to whole tiles, so that a centre past k
// (zero-filled by the tensor copy) never wins. Then a persistent grid, one
// block an SM, walks row blocks of 128 rows. Each row block sweeps the
// centre tiles of 128, each tile over d in stages of 32 features. A
// producer warp keeps a ring of up to 4 stages in flight: three TMA copies a
// stage (the rows, the centres' hi and lo, 128-byte swizzled, zero past the
// edges) on one transaction barrier. Two consumer warpgroups, given the
// producer warpgroup's registers by setmaxnreg, wait on that barrier, each
// own 64 rows as one m64n128 accumulator, split their rows' A fragments in
// registers, issue the products with the centres' hi and lo read from
// shared memory, and fold. At the end of a tile each thread forms
// csq[col] - 2*run for its two rows' 32 columns, takes their minimum in
// increasing column order, and a 4-lane shuffle takes the quad's with the
// lowest index on ties; a later tile (higher indices) wins only when
// strictly smaller. No score reaches shared memory. At the end of a row
// block the consumers hand its 128 (best, arg) pairs to the other three
// warps of the producer warpgroup through a double buffer, and go on to the
// next row block while those warps walk this one: they re-read each row
// (still in L2), add m*x into sums[a] with 16-byte vector atomics
// (atomicAdd on float4, sm_90) and 1 into counts[a] with int32 atomics (exact),
// and sum the cost of their rows in a fixed order. So the accumulation
// overlaps the next row block's products. An m = 0 row adds nothing to sums
// or counts. The atomics' order varies from run to run, so sums agree with
// a fixed-order sum to f32 rounding, not bitwise. The per-warp costs are
// summed over row blocks in a fixed order by cost_reduce_kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // rows a row block: two m64 warpgroups
constexpr int BN = 128;            // centres a tile: one m64n128 product's N
constexpr int BK = 32;             // features a stage: one 128-byte row
constexpr int CONSUMERS = 256;     // two warpgroups multiply and take the argmin
constexpr int PRODUCERS = 128;     // warp 8 copies, warps 9-11 walk
constexpr int WALKERS = PRODUCERS - 32;
constexpr int WALK_WARPS = WALKERS / 32;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAX_STAGES = 4;
constexpr int SLOT = (BM + 2 * BN) * BK;  // floats of a stage: rows, centres' hi, centres' lo
constexpr unsigned FULL = 0xffffffffu;

// the dynamic shared memory of a block: 1,024 bytes of alignment slack, the
// stage ring, each slot's TMA barrier, and the two (best, arg) buffers
size_t smem_bytes(int stages) { return 1024 + (size_t)stages * (SLOT * 4 + 8) + 2 * BM * 8; }

struct Tf32 {
  unsigned bias, mask;  // x rounded to TF32: (bits(x) + bias) & mask
  __device__ __forceinline__ unsigned round(float x) const { return (__float_as_uint(x) + bias) & mask; }
  __device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) const {
    hi = round(x);
    lo = round(x - __uint_as_float(hi));  // exact difference
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// named barriers: empty[slot] between the consumers and the copying warp;
// ready[buf] and free[buf] between the consumers and the walking warps
__device__ __forceinline__ int bar_empty(int s) { return 1 + s; }
__device__ __forceinline__ int bar_ready(int b) { return 1 + MAX_STAGES + b; }
__device__ __forceinline__ int bar_free(int b) { return 3 + MAX_STAGES + b; }
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the transaction barrier a stage's three tensor copies complete
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(b)) : "memory");
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
// a (32 features x 128 rows) box of a row-major f32 matrix at (feature x,
// row y), 128-byte swizzled, zero past its edges
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
// byte offset of 16-byte chunk c of row r in such a tile
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// one m64n128k8 TF32 product of the warpgroup: d (+)= A (64 x 8, from
// registers: a[] as mma.m16n8k8's A fragment of the warp's 16 rows) x B
// (128 x 8)^T, K-major in shared memory under the 128-byte swizzle
// (descriptor db)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4], uint64_t db, int accumulate) {
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

// (s, i) replaces (bs, bi) in a lowest-index-on-ties minimum
__device__ __forceinline__ void take_min(float s, int i, float& bs, int& bi) {
  if (s < bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The centres' TF32 hi and lo, and csq padded with +inf to kpad entries.
__global__ void split_centres_kernel(const float* __restrict__ C, const float* __restrict__ csq,
                                     float* __restrict__ chi, float* __restrict__ clo,
                                     float* __restrict__ csq_pad, int64_t kd, int k, int kpad, Tf32 tf) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < kd; i += stride) {
    unsigned h, l;
    tf.split(C[i], h, l);
    chi[i] = __uint_as_float(h);
    clo[i] = __uint_as_float(l);
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < kpad; i += stride)
    csq_pad[i] = i < k ? csq[i] : CUDART_INF_F;
}

// The rows come in by TMA through tmx (boxes of 32 features x 128 rows),
// the centres' hi and lo through tmh and tml (32 x 128 centres). Block b
// takes row blocks b, b + gridDim.x, ...; d % 4 == 0 and X 16-byte aligned.
__global__ void __launch_bounds__(THREADS, 1)
lloyd_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmh,
             const __grid_constant__ CUtensorMap tml, const float* __restrict__ X, const float* __restrict__ m,
             const float* __restrict__ csq_pad, float* __restrict__ sums, int* __restrict__ counts,
             float* __restrict__ cost_part, int64_t n, int d, int k, int nst, Tf32 tf) {
  extern __shared__ unsigned char dyn_raw[];
  unsigned char* dyn = dyn_raw + ((1024 - (smem_addr(dyn_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(dyn);                         // [nst][SLOT], swizzled rows
  uint64_t* tma_bar = reinterpret_cast<uint64_t*>(ring + nst * SLOT);  // [nst]
  float* best_s = reinterpret_cast<float*>(tma_bar + nst);             // [2][BM]
  int* arg_s = reinterpret_cast<int*>(best_s + 2 * BM);                // [2][BM]

  const int64_t nrb = (n + BM - 1) / BM;
  const int nloc = blockIdx.x < nrb ? (int)((nrb - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const int ntiles = (k + BN - 1) / BN;
  const int nks = (d + BK - 1) / BK;
  const int per_rb = ntiles * nks;
  const int total = nloc * per_rb;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int sl = 0; sl < nst; ++sl) mbar_init(tma_bar + sl);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == CONSUMERS / 32) {
      // The copying warp: stage q's three copies as soon as its slot is free.
      for (int q = 0; q < total; ++q) {
        const int sl = q % nst;
        if (q >= nst) bar_sync(bar_empty(sl), CONSUMERS + 32);  // the consumers are done with q - nst
        if (lane == 0) {
          const int j = q / per_rb, rem = q - j * per_rb;
          const int lt = rem / nks, k0 = (rem - lt * nks) * BK;
          const int row0 = (int)((blockIdx.x + (int64_t)j * gridDim.x) * BM);
          float* slot = ring + sl * SLOT;
          mbar_expect(tma_bar + sl, SLOT * 4);
          tma_load(slot, &tmx, k0, row0, tma_bar + sl);
          tma_load(slot + BM * BK, &tmh, k0, lt * BN, tma_bar + sl);
          tma_load(slot + (BM + BN) * BK, &tml, k0, lt * BN, tma_bar + sl);
        }
      }
      // take the consumers' last releases, so that no barrier is left half way
      for (int q = total > nst ? total - nst : 0; q < total; ++q) bar_sync(bar_empty(q % nst), CONSUMERS + 32);
    } else {
      // The walking warps: for each row block, once the consumers have
      // handed over its (best, arg) pairs, rows ww, ww + 3, ...: sums and
      // counts by atomics, the cost of the warp's rows in order.
      const int ww = warp - CONSUMERS / 32 - 1;
      const int d4 = d / 4;
      for (int j = 0; j < nloc; ++j) {
        const int buf = j & 1;
        const int64_t rb = blockIdx.x + (int64_t)j * gridDim.x;
        bar_sync(bar_ready(buf), CONSUMERS + WALKERS);
        float wc = 0.f;
        for (int r = ww; r < BM; r += WALK_WARPS) {
          const int64_t gr = rb * BM + r;
          if (gr >= n) break;
          const float mr = m[gr];
          const int a = arg_s[buf * BM + r];
          const float bs = best_s[buf * BM + r];
          const float4* xr = reinterpret_cast<const float4*>(X + gr * d);
          float4* sa = reinterpret_cast<float4*>(sums + (int64_t)a * d);
          float xsq = 0.f;
          for (int c = lane; c < d4; c += 32) {
            const float4 v = xr[c];
            xsq = fmaf(v.x, v.x, xsq);
            xsq = fmaf(v.y, v.y, xsq);
            xsq = fmaf(v.z, v.z, xsq);
            xsq = fmaf(v.w, v.w, xsq);
            if (mr != 0.f) atomicAdd(sa + c, make_float4(mr * v.x, mr * v.y, mr * v.z, mr * v.w));
          }
          xsq = warp_sum(xsq);
          if (lane == 0) {
            if (mr > 0.f) atomicAdd(&counts[a], 1);
            wc += fmaxf(bs + xsq, 0.f) * mr;
          }
        }
        if (lane == 0) cost_part[rb * WALK_WARPS + ww] = wc;
        if (j + 2 < nloc) bar_arrive(bar_free(buf), CONSUMERS + WALKERS);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    // Consumers: warpgroup tid / 128 multiplies its 64 rows, split in
    // registers, by each stage's centres on the tensor cores, folds each
    // stage, and takes the argmin at the end of each centre tile.
    const int g = lane / 4, t = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's rows in the block: r0, r0 + 8
    // fragment e: row r0 + 8 ((e >> 1) & 1), centre column 8 (e >> 2) + 2t + (e & 1)
    float acc[64], run[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = run[e] = 0.f;
    float best0 = CUDART_INF_F, best1 = CUDART_INF_F;
    int arg0 = 0, arg1 = 0;
    int ks = 0, lt = 0, j = 0;
    for (int p = 0; p < total; ++p) {
      const int sl = p % nst;
      mbar_wait(tma_bar + sl, (p / nst) & 1);
      const float* slot = ring + sl * SLOT;
      // the warp's A fragments: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      unsigned ah[BK / 8][4], al[BK / 8][4];
      {
        const unsigned char* xb = reinterpret_cast<const unsigned char*>(slot);
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = r0 + 8 * (c & 1), kf = kk * 8 + t + 4 * (c >> 1);
            const float v = *reinterpret_cast<const float*>(xb + sw128(r, kf / 4) + 4 * (kf % 4));
            tf.split(v, ah[kk][c], al[kk][c]);
          }
      }
      // lo*hi' + hi*lo' + hi*hi' for each k = 8 step into a fresh
      // accumulator
      const float* ch = slot + BM * BK;
      const float* cl = ch + BN * BK;
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_reg(acc[e]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t dch = desc_sw128(ch + kk * 8), dcl = desc_sw128(cl + kk * 8);
        wgmma_tf32(acc, al[kk], dch, kk > 0);
        wgmma_tf32(acc, ah[kk], dcl, 1);
        wgmma_tf32(acc, ah[kk], dch, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_reg(acc[e]);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fence_reg(ah[kk][c]);
          fence_reg(al[kk][c]);
        }
      bar_arrive(bar_empty(sl), CONSUMERS + 32);
#pragma unroll
      for (int e = 0; e < 64; ++e) run[e] += acc[e];  // fold the stage, rounded
      if (++ks < nks) continue;
      ks = 0;

      // the tile's argmin: each row's 32 columns of this thread in
      // increasing order, then the quad's, lowest index on ties
      {
        const int c0 = lt * BN;
        const float* cq = csq_pad + c0;
        float b0 = CUDART_INF_F, b1 = CUDART_INF_F;
        int a0 = 0x7fffffff, a1 = 0x7fffffff;
#pragma unroll
        for (int e = 0; e < 64; e += 4) {
          const int col = 8 * (e >> 2) + 2 * t;
          const float2 cc = __ldg(reinterpret_cast<const float2*>(cq + col));
          const float s00 = cc.x - 2.f * run[e], s01 = cc.y - 2.f * run[e + 1];
          const float s10 = cc.x - 2.f * run[e + 2], s11 = cc.y - 2.f * run[e + 3];
          if (s00 < b0) { b0 = s00; a0 = c0 + col; }
          if (s01 < b0) { b0 = s01; a0 = c0 + col + 1; }
          if (s10 < b1) { b1 = s10; a1 = c0 + col; }
          if (s11 < b1) { b1 = s11; a1 = c0 + col + 1; }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          take_min(__shfl_xor_sync(FULL, b0, off), __shfl_xor_sync(FULL, a0, off), b0, a0);
          take_min(__shfl_xor_sync(FULL, b1, off), __shfl_xor_sync(FULL, a1, off), b1, a1);
        }
        if (b0 < best0) {  // later tiles hold higher indices: strict <
          best0 = b0;
          arg0 = a0;
        }
        if (b1 < best1) {
          best1 = b1;
          arg1 = a1;
        }
#pragma unroll
        for (int e = 0; e < 64; ++e) run[e] = 0.f;
      }
      if (++lt < ntiles) continue;
      lt = 0;

      // hand the row block's pairs to the walking warps
      const int buf = j & 1;
      if (j >= 2) bar_sync(bar_free(buf), CONSUMERS + WALKERS);  // they are done with row block j - 2
      if (t == 0) {
        best_s[buf * BM + r0] = best0;
        arg_s[buf * BM + r0] = arg0;
        best_s[buf * BM + r0 + 8] = best1;
        arg_s[buf * BM + r0 + 8] = arg1;
      }
      bar_arrive(bar_ready(buf), CONSUMERS + WALKERS);
      best0 = best1 = CUDART_INF_F;
      arg0 = arg1 = 0;
      ++j;
    }
  }
}

// Fixed-order sum of the per-warp costs.
__global__ void cost_reduce_kernel(const float* __restrict__ part, int64_t np, float* __restrict__ cost) {
  __shared__ float sh[256];
  float v = 0.f;
  for (int64_t i = threadIdx.x; i < np; i += 256) v += part[i];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[0] = sh[0];
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

// the map of a row-major (rows, d) f32 matrix in boxes of 32 features x 128
// rows, 128-byte swizzled, zero past the edges
cudaError_t row_map(CUtensorMap* map, const float* X, int64_t rows, int d) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(X), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// X (n, d), C (k, d): d % 4 == 0 and both 16-byte aligned (the tensor
// copies' and the vector atomics' rule). chi, clo (k, d) and csq_pad
// (ceil(k / 128) * 128) are scratch; cost_part holds 3 * ceil(n / 128)
// floats. stages 2..4; grid blocks, each walking every grid-th row block.
extern "C" int lloyd_step_launch(const float* X, const float* m, const float* C, const float* csq, float* chi,
                                 float* clo, float* csq_pad, float* sums, int* counts, float* cost, float* cost_part,
                                 int64_t n, int d, int k, int stages, int grid, unsigned tf32_bias,
                                 unsigned tf32_mask, void* stream) {
  if (k < 1 || d < 1 || d % 4 != 0 || stages < 2 || stages > MAX_STAGES || grid < 1 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 || reinterpret_cast<uintptr_t>(chi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(clo) % 16 != 0 || reinterpret_cast<uintptr_t>(sums) % 16 != 0 ||
      n >= ((int64_t)1 << 31))  // the copies' row coordinates are 32-bit
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tf32 tf{tf32_bias, tf32_mask};
  const int kpad = (k + BN - 1) / BN * BN;
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)k * d, st);
  cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)k, st);
  const int64_t kd = (int64_t)k * d;
  split_centres_kernel<<<(unsigned)((kd + 255) / 256 < 1024 ? (kd + 255) / 256 : 1024), 256, 0, st>>>(
      C, csq, chi, clo, csq_pad, kd, k, kpad, tf);
  const int64_t nrb = (n + BM - 1) / BM;
  if (nrb > 0) {
    CUtensorMap tmx, tmh, tml;
    cudaError_t err = row_map(&tmx, X, n, d);
    if (err == cudaSuccess) err = row_map(&tmh, chi, k, d);
    if (err == cudaSuccess) err = row_map(&tml, clo, k, d);
    const size_t smem = smem_bytes(stages);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(lloyd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    lloyd_kernel<<<(unsigned)(nrb < grid ? nrb : grid), THREADS, smem, st>>>(tmx, tmh, tml, X, m, csq_pad, sums,
                                                                            counts, cost_part, n, d, k, stages, tf);
  }
  cost_reduce_kernel<<<1, 256, 0, st>>>(cost_part, nrb * WALK_WARPS, cost);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes a thread, resident blocks an SM and
// dynamic shared memory of the kernel with `stages` slots: out[0..3]
extern "C" int lloyd_step_attributes(int stages, int* out) {
  if (stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(stages);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, lloyd_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lloyd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], lloyd_kernel, THREADS, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
