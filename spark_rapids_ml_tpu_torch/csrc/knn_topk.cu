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
// What bounds it on an H100: the products, 2*nq*ni*d operations (6.71e16 at
// the kNN shape, 131,072 queries x 1,000,000 items x 256), against 1.16 GB
// of inputs and state (0.35 ms at 3.35 TB/s). In f32 FMA on the CUDA cores
// that is >= 1.00 s at 67 TFLOP/s, and a SIMT tile stops near half of it.
// So the products run on the tensor cores in 3xTF32: each operand value x
// is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// with ties away from zero (cvt.rna.tf32.f32's rounding, done as an integer
// add and mask of the bits with the constants the wrapper passes), and each
// k = 8 step issues three wgmma m64n128k8 TF32 products, lo*hi' + hi*lo' +
// hi*hi', into an f32 accumulator: three times the TF32 work, >= 0.41 s at
// 495 TFLOP/s. (A form of this kernel on mma.sync m16n8k8 ran its
// products at about a quarter of that rate on an H100; wgmma is the tensor
// cores' full-rate path.)
//
// Why the accuracy holds. x = hi + lo + e with |x - hi| <= 2^-11 |x| and
// |e| <= 2^-22 |x|, so the dropped lo*lo' and the e terms are each <=
// 2^-22 of |x x'|, rounding noise of a few f32 units per product. The
// tensor cores' own f32 accumulation truncates; so a fresh accumulator
// takes only one 32-feature stage (twelve truncating adds) and is folded
// into the running f32 score on the CUDA cores with an ordinary, rounded
// add after every stage. The error per
// score stays well inside the band TAU_UNITS*u*sqrt(d)*T that the on-card
// check holds an f32 score to; one-pass TF32 (hi*hi' alone) does not.
//
// Design. A block owns BM query rows (128; 64 where k is large, so that the
// state's BM*k*8 bytes fit beside the stages) and sweeps the item tiles of
// 128 of its item range; each row's k best stay in shared memory. A
// producer warpgroup feeds a ring of 2-3 stages: one thread starts two TMA
// copies a stage (32 features of the query rows and of the item tile, both
// K-major as they lie in memory, 128-byte swizzled, zero past the edges,
// on a transaction barrier), and the warpgroup then splits the stage's
// items once (hi in place, lo beside) and hands the stage over on a named
// barrier. Each consumer warpgroup (two at 128 rows, given the producers'
// registers by setmaxnreg) owns 64 rows as one m64n128 accumulator, splits
// its rows' A fragments in registers, issues its products with the items'
// hi and lo read from shared memory, and folds the stage. (Reading the
// query rows' hi and lo from shared memory too made shared-memory traffic,
// not the tensor cores, the bound.) The two warpgroups run at their own
// pace on their own full and empty barriers, so that one's gate can overlap
// the other's products. The tau gate: each thread tests its fragment's
// scores against their rows' current k-th pair; a quarter of the tile's
// columns at a time, and only when some score of the warpgroup passes
// (bar.red.or), the scores go to the warpgroup's own query rows of the
// slot, and one warp per row inserts the candidates that still pass, one
// at a time, into the sorted list (position by a warp count, shift by one).
//
// Small query batches: ceil(nq / BM) blocks may fill less than the card. The
// wrapper then splits the items into S ranges (gridDim.y); each block folds
// its range into a fresh state in scratch, and knn_merge_kernel merges the
// incoming state and the S partial states into k pairs a row in (score, id)
// order (one warp a row, a k-round warp argmin over the lists' heads).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;           // items a tile: one m64n128 product's N
constexpr int BK = 32;            // features a stage: one 128-byte row
constexpr int QTR = BN / 4;       // score columns the insertion takes at a time
constexpr int PRODUCERS = 128;    // a warpgroup loads and splits the stages
constexpr int MAX_K = 128;
// two warpgroups' full and empty barriers for each of 3 slots, with their
// own, fit the 16 named barriers
constexpr int MAX_STAGES = 3;
constexpr int MAX_SPLITS = 255;
constexpr int MERGE_THREADS = 256;  // the merge kernel: a warp a row
constexpr int MERGE_LISTS = (MAX_SPLITS + 1) / 32;  // lists a lane holds
constexpr unsigned FULL = 0xffffffffu;

// the dynamic shared memory of a block of bm query rows: 1,024 bytes of
// alignment slack, the stage ring (each slot the query rows, then the
// items' TF32 hi and lo), each slot's csq and ids and its TMA barrier, and
// the state
size_t smem_bytes(int bm, int stages, int k) {
  return 1024 + (size_t)stages * ((bm + 2 * BN) * BK * 4 + 2 * BN * 4 + 8) + (size_t)bm * k * 8;
}

// (s, i) strictly before (t, j) in the (score, id) order
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

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

// named barriers: 1 + w warpgroup w's consumers alone; full[w][slot] and
// empty[w][slot] between the producers and warpgroup w
__device__ __forceinline__ int bar_wg(int w) { return 1 + w; }
__device__ __forceinline__ int bar_full(int w, int s) { return 3 + MAX_STAGES * w + s; }
__device__ __forceinline__ int bar_empty(int w, int s) { return 3 + 2 * MAX_STAGES + MAX_STAGES * w + s; }
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// the OR of `pred` over the n threads of barrier id, which they all wait for
__device__ __forceinline__ int bar_or(int id, int n, int pred) {
  int out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %3, 0;\nbar.red.or.pred q, %1, %2, p;\nselp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(id), "r"(n), "r"(pred)
      : "memory");
  return out;
}

// the transaction barrier a stage's two tensor copies complete
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
// a (32 features x rows) box of a row-major f32 matrix at (feature x, row
// y), 128-byte swizzled, zero past its edges
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

// WG consumer warpgroups, each 64 query rows (BM = 64 * WG rows a block),
// and a producer warpgroup: 128 * WG + PRODUCERS threads. The query rows and
// the items come in by TMA (tmq, tmx: 32-feature boxes of BM and BN rows).
template <int WG>
__global__ void __launch_bounds__(WG * 128 + PRODUCERS, 1)
knn_topk_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmx,
                const float* __restrict__ csq, const int* __restrict__ ids,
                const float* __restrict__ in_d, const int* __restrict__ in_i,
                float* __restrict__ out_d, int* __restrict__ out_i, int64_t nq, int64_t ni,
                int d, int k, int64_t tiles_per_split, int nst, Tf32 tf) {
  constexpr int CONSUMERS = WG * 128;
  constexpr int THREADS = CONSUMERS + PRODUCERS;
  constexpr int BM = WG * 64;
  constexpr int QF = BM * BK;           // floats of the query rows in a slot
  constexpr int XF = BN * BK;           // floats of the items' hi (and of their lo)
  constexpr int SLOT = QF + 2 * XF;
  extern __shared__ unsigned char dyn_raw[];
  unsigned char* dyn = dyn_raw + ((1024 - (smem_addr(dyn_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(dyn);            // [nst][SLOT], swizzled rows
  float* meta_c = ring + nst * SLOT;                      // [nst][BN] the tile's csq
  int* meta_i = reinterpret_cast<int*>(meta_c + nst * BN);  // [nst][BN] its ids
  uint64_t* tma_bar = reinterpret_cast<uint64_t*>(meta_i + nst * BN);  // [nst]
  float* S = reinterpret_cast<float*>(tma_bar + nst);     // [BM][k] scores, sorted
  int* I = reinterpret_cast<int*>(S + BM * k);            // [BM][k] ids

  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int split = blockIdx.y;
  const int64_t i_lo = split * tiles_per_split * BN;
  const int64_t i_hi = ni < i_lo + tiles_per_split * BN ? ni : i_lo + tiles_per_split * BN;
  const int ntiles = i_hi > i_lo ? (int)((i_hi - i_lo + BN - 1) / BN) : 0;
  const int nks = (d + BK - 1) / BK;
  const int total = ntiles * nks;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // the incoming state (a fresh one without in_d); rows past nq at -inf,
  // so that they never pass the gate
  for (int e = tid; e < BM * k; e += THREADS) {
    const int64_t gr = row0 + e / k;
    S[e] = gr < nq ? (in_d ? in_d[gr * k + e % k] : CUDART_INF_F) : -CUDART_INF_F;
    I[e] = gr < nq && in_i ? in_i[gr * k + e % k] : -1;
  }
  if (tid == 0) {
    for (int sl = 0; sl < nst; ++sl) mbar_init(tma_bar + sl);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if constexpr (WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Producers: thread 0 starts stage q's two copies as soon as its slot
    // is free; all split the items of stage q - 1 once it has landed (hi in
    // place, lo beside), with its tile's csq and ids on a tile's last
    // stage, and hand it to the consumers.
    const int pt = tid - CONSUMERS;
    for (int q = 0; q <= total; ++q) {
      if (q < total) {
        const int sl = q % nst;
        if (q >= nst)  // the consumers are done with stage q - nst
          for (int w = 0; w < WG; ++w) bar_sync(bar_empty(w, sl), 128 + PRODUCERS);
        if (pt == 0) {
          const int lt = q / nks, k0 = (q - lt * nks) * BK;
          float* slot = ring + sl * SLOT;
          mbar_expect(tma_bar + sl, (BM + BN) * BK * 4);
          tma_load(slot, &tmq, k0, (int)row0, tma_bar + sl);
          tma_load(slot + BM * BK, &tmx, k0, (int)(i_lo + (int64_t)lt * BN), tma_bar + sl);
        }
      }
      const int sq = q - 1;
      if (sq < 0) continue;
      const int sl = sq % nst, lt = sq / nks;
      float c = 0.f;
      int id = 0;
      const bool last = sq - lt * nks == nks - 1;
      const int64_t col = i_lo + (int64_t)lt * BN + pt;
      if (last && col < i_hi) {
        c = csq[col];
        id = ids[col];
      }
      mbar_wait(tma_bar + sl, (sq / nst) & 1);
      uint4* hi = reinterpret_cast<uint4*>(ring + sl * SLOT + QF);
      uint4* lo = reinterpret_cast<uint4*>(ring + sl * SLOT + QF + XF);
#pragma unroll 4
      for (int e = pt; e < XF / 4; e += PRODUCERS) {
        const uint4 v = hi[e];
        uint4 h, l;
        tf.split(__uint_as_float(v.x), h.x, l.x);
        tf.split(__uint_as_float(v.y), h.y, l.y);
        tf.split(__uint_as_float(v.z), h.z, l.z);
        tf.split(__uint_as_float(v.w), h.w, l.w);
        hi[e] = h;
        lo[e] = l;
      }
      if (last) {
        meta_c[sl * BN + pt] = c;
        meta_i[sl * BN + pt] = id;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int w = 0; w < WG; ++w) bar_arrive(bar_full(w, sl), 128 + PRODUCERS);
    }
    // take the consumers' last releases, so that no barrier is left half way
    for (int q = total > nst ? total : nst; q < total + nst; ++q)
      if (q - nst < total)
        for (int w = 0; w < WG; ++w) bar_sync(bar_empty(w, q % nst), 128 + PRODUCERS);
  } else {
    if constexpr (WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // Consumers: warpgroup wg multiplies its 64 rows, split in registers,
    // by each stage's items on the tensor cores, folds each stage, and gates
    // and inserts at the end of each item tile, at its own pace.
    const int g = lane / 4, t = lane % 4;
    const int wg = warp / 4, wl = warp % 4;
    const int r0 = warp * 16 + g;  // this thread's rows in the block: r0, r0 + 8
    // fragment e: row r0 + 8 ((e >> 1) & 1), item column 8 (e >> 2) + 2t + (e & 1)
    float acc[64], run[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = run[e] = 0.f;
    int tl = 0, ks = 0;
    for (int p = 0; p < total; ++p) {
      const int sl = p % nst;
      const bool last = ks == nks - 1;
      bar_sync(bar_full(wg, sl), 128 + PRODUCERS);
      float* slot = ring + sl * SLOT;
      // the warp's A fragments: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      unsigned ah[BK / 8][4], al[BK / 8][4];
      {
        const unsigned char* qb = reinterpret_cast<const unsigned char*>(slot);
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = r0 + 8 * (c & 1), kf = kk * 8 + t + 4 * (c >> 1);
            const float v = *reinterpret_cast<const float*>(qb + sw128(r, kf / 4) + 4 * (kf % 4));
            tf.split(v, ah[kk][c], al[kk][c]);
          }
      }
      // lo*hi' + hi*lo' + hi*hi' for each k = 8 step into a fresh
      // accumulator
      const float* xh = slot + QF;
      const float* xl = xh + XF;
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_reg(acc[e]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t dxh = desc_sw128(xh + kk * 8), dxl = desc_sw128(xl + kk * 8);
        wgmma_tf32(acc, al[kk], dxh, kk > 0);
        wgmma_tf32(acc, ah[kk], dxl, 1);
        wgmma_tf32(acc, ah[kk], dxh, 1);
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
      if (!last) bar_arrive(bar_empty(wg, sl), 128 + PRODUCERS);
#pragma unroll
      for (int e = 0; e < 64; ++e) run[e] += acc[e];  // fold the stage, rounded
      if (!last) {
        ++ks;
        continue;
      }

      // tau gate against the rows' current k-th pairs
      const float* cq = meta_c + sl * BN;
      const int* iq = meta_i + sl * BN;
      const int64_t c0 = i_lo + (int64_t)tl * BN;
      const int nvalid = i_hi - c0 < BN ? (int)(i_hi - c0) : BN;
      int pass[4] = {0, 0, 0, 0};
      {
        const float ws0 = S[r0 * k + k - 1], ws1 = S[(r0 + 8) * k + k - 1];
        const int wi0 = I[r0 * k + k - 1], wi1 = I[(r0 + 8) * k + k - 1];
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int col = 8 * (e >> 2) + 2 * t;
          const float2 cc = *reinterpret_cast<const float2*>(cq + col);
          const int2 ii = *reinterpret_cast<const int2*>(iq + col);
          const float ws = (e & 2) ? ws1 : ws0;
          const int wi = (e & 2) ? wi1 : wi0;
          run[e] = cc.x - 2.f * run[e];
          run[e + 1] = cc.y - 2.f * run[e + 1];
          pass[e >> 4] |= (col < nvalid && before(run[e], ii.x, ws, wi)) |
                          (col + 1 < nvalid && before(run[e + 1], ii.y, ws, wi));
        }
      }
      // a quarter of the tile's columns at a time, in the warpgroup's own
      // query rows of the slot (no product reads them any more): 64 x QTR
      // floats, columns swizzled by 8 * (row & 3)
      float* tile = slot + wg * 64 * BK;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (!bar_or(bar_wg(wg), 128, pass[h])) continue;
#pragma unroll
        for (int e = 16 * h; e < 16 * h + 16; e += 2) {
          const int rl = wl * 16 + g + 8 * ((e >> 1) & 1);
          const int cl = (8 * ((e >> 2) - 4 * h) + 2 * t) ^ (8 * (rl & 3));
          *reinterpret_cast<float2*>(tile + rl * QTR + cl) = make_float2(run[e], run[e + 1]);
        }
        bar_sync(bar_wg(wg), 128);
        // one warp per row: insert the passing candidates in lane order,
        // each re-tested against the row's current k-th pair
        for (int rl = wl; rl < 64 && row0 + wg * 64 + rl < nq; rl += 4) {
          const int r = wg * 64 + rl;
          float* Sr = S + r * k;
          int* Ir = I + r * k;
          float ws = Sr[k - 1];
          int wi = Ir[k - 1];
          const int col = QTR * h + lane;
          const float sc = tile[rl * QTR + (lane ^ (8 * (rl & 3)))];
          const int id = iq[col];
          unsigned mask = __ballot_sync(FULL, col < nvalid && before(sc, id, ws, wi));
          while (mask) {
            const int srcl = __ffs(mask) - 1;
            mask &= mask - 1;
            const float cs_ = __shfl_sync(FULL, sc, srcl);
            const int ci = __shfl_sync(FULL, id, srcl);
            if (!before(cs_, ci, ws, wi)) continue;  // uniform over the warp
            unsigned cnt = 0;
            for (int e = lane; e < k; e += 32) cnt += before(Sr[e], Ir[e], cs_, ci);
            const int pos = (int)__reduce_add_sync(FULL, cnt);  // pos <= k - 1
            float v[MAX_K / 32];
            int vi[MAX_K / 32];
#pragma unroll
            for (int u = 0; u < MAX_K / 32; ++u) {
              const int e = lane + 32 * u;
              if (e >= pos && e < k - 1) {
                v[u] = Sr[e];
                vi[u] = Ir[e];
              }
            }
            __syncwarp();
#pragma unroll
            for (int u = 0; u < MAX_K / 32; ++u) {
              const int e = lane + 32 * u;
              if (e >= pos && e < k - 1) {
                Sr[e + 1] = v[u];
                Ir[e + 1] = vi[u];
              }
            }
            if (lane == 0) {
              Sr[pos] = cs_;
              Ir[pos] = ci;
            }
            __syncwarp();
            ws = Sr[k - 1];
            wi = Ir[k - 1];
          }
        }
        bar_sync(bar_wg(wg), 128);
      }
      // the tile's generic writes before the slot's next tensor copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(bar_empty(wg, sl), 128 + PRODUCERS);
#pragma unroll
      for (int e = 0; e < 64; ++e) run[e] = 0.f;
      ks = 0;
      ++tl;
    }
  }
  __syncthreads();

  float* od = out_d + (int64_t)split * nq * k;
  int* oi = out_i + (int64_t)split * nq * k;
  for (int e = tid; e < BM * k; e += THREADS) {
    const int64_t gr = row0 + e / k;
    if (gr < nq) {
      od[gr * k + e % k] = S[e];
      oi[gr * k + e % k] = I[e];
    }
  }
}

// one warp per row: the k first pairs, in (score, id) order, of the
// incoming state and the `splits` partial states (each sorted). Lane l
// holds lists l, l + 32, ...; each round takes the warp's least head.
__global__ void __launch_bounds__(MERGE_THREADS)
knn_merge_kernel(const float* __restrict__ in_d, const int* __restrict__ in_i,
                 const float* __restrict__ part_d, const int* __restrict__ part_i,
                 float* __restrict__ out_d, int* __restrict__ out_i, int64_t nq, int k, int splits) {
  const int64_t row = (int64_t)blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nq) return;
  const int lists = splits + 1;
  auto head = [&](int list, int pos, float& s, int& id) {
    if (list >= lists || pos >= k) {
      s = CUDART_INF_F;
      id = 0x7fffffff;  // after every pair, the (+inf, -1) fillers too
    } else if (list == 0) {
      s = in_d[row * k + pos];
      id = in_i[row * k + pos];
    } else {
      const int64_t o = ((int64_t)(list - 1) * nq + row) * k + pos;
      s = part_d[o];
      id = part_i[o];
    }
  };
  int pos[MERGE_LISTS];
  float hs[MERGE_LISTS];
  int hid[MERGE_LISTS];
#pragma unroll
  for (int q = 0; q < MERGE_LISTS; ++q) {
    pos[q] = 0;
    head(lane + 32 * q, 0, hs[q], hid[q]);
  }
  for (int r = 0; r < k; ++r) {
    float bs = hs[0];
    int bi = hid[0], bq = 0;
#pragma unroll
    for (int q = 1; q < MERGE_LISTS; ++q)
      if (before(hs[q], hid[q], bs, bi)) {
        bs = hs[q];
        bi = hid[q];
        bq = q;
      }
    float ms = bs;
    int mi = bi, ml = lane;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float os = __shfl_xor_sync(FULL, ms, off);
      const int oi = __shfl_xor_sync(FULL, mi, off);
      const int ol = __shfl_xor_sync(FULL, ml, off);
      if (before(os, oi, ms, mi) || (os == ms && oi == mi && ol < ml)) {
        ms = os;
        mi = oi;
        ml = ol;
      }
    }
    if (lane == 0) {
      out_d[row * k + r] = ms;
      out_i[row * k + r] = mi;
    }
    if (lane == ml) {
#pragma unroll
      for (int q = 0; q < MERGE_LISTS; ++q)
        if (q == bq) head(lane + 32 * q, ++pos[q], hs[q], hid[q]);
    }
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

// the map of a row-major (rows, d) f32 matrix in boxes of 32 features x
// box_rows rows, 128-byte swizzled, zero past the edges
cudaError_t row_map(CUtensorMap* map, const float* X, int64_t rows, int d, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(X), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int WG>
cudaError_t launch_topk(const float* Xq, const float* Xi, const float* csq, const int* ids, const float* in_d,
                        const int* in_i, float* out_d, int* out_i, int64_t nq, int64_t ni, int d, int k, int stages,
                        int splits, int64_t tiles_per_split, Tf32 tf, cudaStream_t stream) {
  constexpr int BM = WG * 64;
  CUtensorMap tmq, tmx;
  cudaError_t err = row_map(&tmq, Xq, nq, d, BM);
  if (err == cudaSuccess) err = row_map(&tmx, Xi, ni, d, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(BM, stages, k);
  err = cudaFuncSetAttribute(knn_topk_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t nb = (nq + BM - 1) / BM;
  if (nb > 0)
    knn_topk_kernel<WG><<<dim3((unsigned)nb, (unsigned)splits), WG * 128 + PRODUCERS, smem, stream>>>(
        tmq, tmx, csq, ids, in_d, in_i, out_d, out_i, nq, ni, d, k, tiles_per_split, stages, tf);
  return cudaGetLastError();
}

template <int WG>
cudaError_t attributes(int k, int stages, int* out) {
  constexpr int BM = WG * 64;
  const size_t smem = smem_bytes(BM, stages, k);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, knn_topk_kernel<WG>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_topk_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], knn_topk_kernel<WG>, WG * 128 + PRODUCERS, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  return err;
}

}  // namespace

// in_d / in_i: the incoming state (nq, k); out_d / out_i: the result
// (nq, k). splits > 1 folds each item range into part_d / part_i (splits,
// nq, k) and merges them with the incoming state into out. Xq and Xi: d %
// 4 == 0 and 16-byte aligned (the tensor copies' rule). bm is 128 or 64;
// stages 2..3.
extern "C" int knn_topk_launch(const float* Xq, const float* Xi, const float* csq, const int* ids,
                               const float* in_d, const int* in_i, float* out_d, int* out_i,
                               float* part_d, int* part_i, int64_t nq, int64_t ni, int d, int k,
                               int bm, int stages, int splits, int64_t tiles_per_split,
                               unsigned tf32_bias, unsigned tf32_mask, void* stream) {
  if (k < 1 || k > MAX_K || (bm != 64 && bm != 128) || stages < 2 || stages > MAX_STAGES || splits < 1 ||
      splits > MAX_SPLITS || tiles_per_split < 1 || d < 1 || d % 4 != 0 ||
      reinterpret_cast<uintptr_t>(Xq) % 16 != 0 || reinterpret_cast<uintptr_t>(Xi) % 16 != 0 ||
      nq >= ((int64_t)1 << 31) || ni >= ((int64_t)1 << 31))  // the copies' row coordinates are 32-bit
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tf32 tf{tf32_bias, tf32_mask};
  const bool merge = splits > 1;
  const float* kin_d = merge ? nullptr : in_d;
  const int* kin_i = merge ? nullptr : in_i;
  float* kout_d = merge ? part_d : out_d;
  int* kout_i = merge ? part_i : out_i;
  // 128 rows: two consumer warpgroups; 64 rows (large k): one
  cudaError_t err = bm == 128 ? launch_topk<2>(Xq, Xi, csq, ids, kin_d, kin_i, kout_d, kout_i, nq, ni, d, k, stages,
                                               splits, tiles_per_split, tf, st)
                              : launch_topk<1>(Xq, Xi, csq, ids, kin_d, kin_i, kout_d, kout_i, nq, ni, d, k, stages,
                                               splits, tiles_per_split, tf, st);
  if (err != cudaSuccess || !merge || nq == 0) return (int)err;
  constexpr int rows = MERGE_THREADS / 32;
  knn_merge_kernel<<<(unsigned)((nq + rows - 1) / rows), MERGE_THREADS, 0, st>>>(in_d, in_i, part_d, part_i, out_d,
                                                                                out_i, nq, k, splits);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes a thread, resident blocks an SM and
// dynamic shared memory of the instance for (bm, k, stages): out[0..3]
extern "C" int knn_topk_attributes(int bm, int k, int stages, int* out) {
  if (k < 1 || k > MAX_K || stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  return (int)(bm == 64 ? attributes<1>(k, stages, out) : attributes<2>(k, stages, out));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
