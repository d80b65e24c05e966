// Histograms of the RandomForest builder: kernels K5 and K6, per node.
//
// Rows arrive sorted by tree node, each node's run padded to a multiple of
// r_sub rows, so every aligned sub-block of r_sub rows belongs to one node
// (padding rows carry sw == 0 and any bin).
//
// K5 (node_hist_launch). For tree t, node j and stat s, slot f:
//   out[t, j, s, f * nb + b] = sum over the padded rows r of node j with
//                              bins[src2[t, r], f] == b of swq[t, r, s]
// with bins the builder's uint8 table, shared (n, F) or per tree (T, n, F),
// read through the sort permutation src2; a bin >= nb adds nothing.
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::subblock_hist (the
// pl.pallas_call at rf_pallas.py:190) together with the per-node
// segment_sum its caller applies (tree_kernels.py:531-545).
//
// K6 (node_hist_sel_launch). The same sums with each node's own F feature
// ids feats[t, j, f] selecting the bytes of the full rows of the shared
// (n, d_row) table:
//   bin(r, f) = bins[src2[t, r], feats[t, j, f]], and bin 0 where the id
//               lies outside [0, d_row) (the sentinel n_features when
//               n_features == d_row).
// Replaces ::subblock_hist_sel (:312) together with everything its caller
// (tree_kernels.py:1163-1172) does around it: the gather of the node-sorted
// full rows (T * n_pad * d_row bytes written, 6.46 GB at 8 trees of
// 131,072 rows of 4,096 bytes) that the TPU kernel reads, its dense
// per-sub-block partials (as many bytes again) and their per-node sum.
//
// Summation order (both): a node's run is cut into spans of a sub-blocks
// (a = max(1, SPAN_ROWS / r_sub), from the node's start); a span sums its
// rows in row order from +0; a node is the in-order fold of its spans'
// sums from +0. A node of one span (every node of the deep levels; an empty
// node is one span of no rows) is written by its span's blocks; the spans
// of a longer node write partials that a second kernel folds in order.
// No float atomics: the result is bitwise repeatable, and equal to the
// plain version's on the CPU (a row-order scatter_add_, then an in-order
// index_add_ over spans).
//
// What bounds them on an H100: the bytes are the rows read through src2,
// the weights and the node histograms written. K5 reads F bytes a row
// (35.8 MB of rows and 67 MB of histograms at the GBT's level 7). K6 needs
// only the 32-byte sectors that a row's F selected bytes touch: 43 of the
// 94 that 3,000 features span at 55 ids (1.8 GB at 8 x 131,072 rows and
// their padding), beside 2.15 GB of node histograms at 4,096 nodes. Adds are S * F a row;
// each is a shared-memory read-modify-write of a few instructions, so issue
// is the other bound (the walk takes half of the GBT's level 7; PERF.md §6).
//
// Design. One block per (span, tile of P (slot, stat) pairs, tree), P a
// multiple of 32 and one thread a pair, pairs in (slot, stat) order so that
// a tile stages each row's bytes for its slots once. The span's rows are
// staged into shared memory by cp.async, a chunk ahead of the walk, in two
// stages, with their weights. K5 stages each row's window of the tile's
// slots in aligned 16-byte words where the table allows. A span of K6 lies
// in one node, so its ids are one set: the block reads them once, and
// stages for each row the 4-byte word that holds each selected byte, one
// 4-byte cp.async a slot, a warp on 32 slots of one row, so that the loads
// of a row coalesce by its sectors and a row costs the sectors its ids
// touch (staging the window of the row between the tile's least and
// largest id by 16-byte cp.async, the whole row at 55 random ids of 3,000,
// took 1.4-2.3x as long on an H100; PERF.md §6); a sentinel slot reads no
// byte and walks a zero byte. Each thread walks the staged rows in order
// for its pair, two rows a step (both bins read before either is written;
// one bin twice adds in row order). The histograms are bin-major, h[b * P + q], so
// a thread owns one bank and the walk has no bank conflicts whatever the
// bins; the write goes out through a per-warp transpose of 32 pairs x 16
// bins (float4 rows of stride 20 where nb % 16 == 0, else scalar rows of
// stride 17) as 64-byte runs of one pair's bins. The span table (spans past
// a node's first, partial slots, multi-span nodes, each an exclusive prefix
// over the nodes) is built on the card by a one-block-a-tree scan, so the
// grid is sized from bounds and needs no host sync: block x < n_nodes takes
// node x's first span (no search), the rest the spans past a node's first
// (a binary search of the table); blocks past a tree's spans exit.

#include <cuda_runtime.h>
#include <stdint.h>

// A launch's sizes, as _NodeHistPlan in ops/rf_kernels.py (its
// geometry). At namespace scope: the C entry points take it.
struct NodeHistPlan {
  int64_t n_pad;        // padded rows of a tree
  int64_t tree_stride;  // bins entries between trees (0: one shared table)
  int64_t part_slots;   // span partial slots of a tree
  int F;                // slots of a histogram row (K5: also the bytes of a row of bins)
  int S;                // stats
  int nb;               // bins
  int r_sub;            // rows a sub-block
  int a;                // sub-blocks a span
  int n_nodes;
  int T;
  int f_lo;             // this launch's slots: [f_lo, f_lo + fc)
  int fc;
  int P;                // threads a block, one (slot, stat) pair each
  int rows;             // rows staged at a time
  int pitch;            // bytes a staged row of bins (a multiple of 16)
  int ns;               // weights a staged row holds (S)
  int tiles;            // pair tiles of the launch's slots
  int spans;            // bound on a tree's spans (grid x)
  int multi;            // bound on a tree's multi-span nodes (fold grid x)
  int smem;             // dynamic shared memory a block
  int vec;              // K5: rows staged as aligned 16-byte words (else bytes)
  int skip;             // the probe's knock-outs, 0 on every path: 1 the walk,
                        // 2 the row loads (cp.async instances), 4 the write
  int d_row;            // bytes a row of bins (K6; K5: F)
};

namespace {

constexpr int NH_MAX_THREADS = 256;
constexpr int TAB_THREADS = 1024;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_PER_THREAD = 4;
constexpr int TB_STRIDE = 17;   // a transpose row: 16 bins and one pad float
constexpr int TB4_STRIDE = 20;  // the same, 16-byte aligned rows (nb % 16 == 0)

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }

__device__ __forceinline__ int64_t node_subblocks(const int64_t* ps, int j, int r_sub) {
  return ps[j + 1] / r_sub - ps[j] / r_sub;
}

__device__ __forceinline__ int node_span_count(int64_t c, int a) {
  return c <= a ? 1 : (int)((c + a - 1) / a);
}

// tabs (T, 3, n_nodes + 1) int32: exclusive prefix sums over the nodes of
// (spans past the node's first, spans of multi-span nodes, multi-span
// nodes); entry n_nodes holds the totals. One block a tree; each thread
// takes a run of nodes.
__global__ void __launch_bounds__(TAB_THREADS)
node_span_table_kernel(const int64_t* __restrict__ pstart, int32_t* __restrict__ tabs, const NodeHistPlan pl) {
  __shared__ int wsum[3][TAB_THREADS / 32];
  const int nn = pl.n_nodes;
  const int64_t* ps = pstart + (int64_t)blockIdx.x * (nn + 1);
  int32_t* tab = tabs + (int64_t)blockIdx.x * 3 * (nn + 1);
  const int per = (nn + TAB_THREADS - 1) / TAB_THREADS;
  const int j0 = min(nn, (int)threadIdx.x * per), j1 = min(nn, j0 + per);
  int v[3] = {0, 0, 0};
  for (int j = j0; j < j1; ++j) {
    const int sp = node_span_count(node_subblocks(ps, j, pl.r_sub), pl.a);
    v[0] += sp - 1;
    if (sp > 1) { v[1] += sp; v[2] += 1; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[3];
  for (int k = 0; k < 3; ++k) {
    int x = v[k];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    inc[k] = x;
    if (lane == 31) wsum[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < 3; ++k) {
      int x = wsum[k][lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      wsum[k][lane] = x;  // inclusive over warps
    }
  }
  __syncthreads();
  int run[3];
  for (int k = 0; k < 3; ++k) run[k] = inc[k] - v[k] + (warp ? wsum[k][warp - 1] : 0);
  for (int j = j0; j < j1; ++j) {
    const int sp = node_span_count(node_subblocks(ps, j, pl.r_sub), pl.a);
    tab[j] = run[0];
    tab[(nn + 1) + j] = run[1];
    tab[2 * (nn + 1) + j] = run[2];
    run[0] += sp - 1;
    if (sp > 1) { run[1] += sp; run[2] += 1; }
  }
  if (threadIdx.x == TAB_THREADS - 1)
    for (int k = 0; k < 3; ++k) tab[k * (nn + 1) + nn] = wsum[k][TAB_THREADS / 32 - 1];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A chunk of a span's rows in shared memory: the bytes of each row's
// window (pitch apart), then its weights (ns apart).
struct Stage {
  unsigned char* bytes;
  float* w;
};

// The block's span: node j's i-th, its padded rows [row_begin, row_end),
// and whether it is the node's only one (written straight to out).
struct Span {
  int j, i;
  int64_t row_begin, row_end;
  bool direct;
};

// Block x of tree t: span x < n_nodes is node x's first; span n_nodes + y
// is the y-th of the spans past a node's first, node j holding those from
// extra_cum[j]. False for a block past the tree's spans.
__device__ __forceinline__ bool find_span(const int64_t* pstart, const int32_t* extra_cum, const NodeHistPlan& pl,
                                          int t, int u, Span& sp) {
  const int nn = pl.n_nodes;
  int j = u, i = 0;
  if (u >= nn) {
    const int x = u - nn;
    if (x >= extra_cum[nn]) return false;
    int lo = 0, hi = nn - 1;  // the last j with extra_cum[j] <= x
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (extra_cum[mid] <= x) lo = mid; else hi = mid - 1;
    }
    j = lo;
    i = 1 + x - extra_cum[j];
  }
  const int64_t* ps = pstart + (int64_t)t * (nn + 1);
  const int64_t sb0 = ps[j] / pl.r_sub;
  const int64_t c = node_subblocks(ps, j, pl.r_sub);
  sp.j = j;
  sp.i = i;
  sp.direct = node_span_count(c, pl.a) == 1;
  sp.row_begin = (sb0 + (int64_t)i * pl.a) * pl.r_sub;
  sp.row_end = (sb0 + min64(c, (int64_t)(i + 1) * pl.a)) * pl.r_sub;
  return true;
}

// The block's tile of pairs p = fl * S + s over the launch's slots fl in
// [0, fc): [p0, pend); its slots fa..fb; the stats a staged row holds (all
// S, or sa..sa + ns - 1 where the tile lies in one slot).
struct Tile {
  int p0, pend, fa, fb, sa, ns;
};

__device__ __forceinline__ Tile tile_of(const NodeHistPlan& pl) {
  Tile tl;
  tl.p0 = blockIdx.y * pl.P;
  tl.pend = min(pl.fc * pl.S, tl.p0 + pl.P);
  tl.fa = tl.p0 / pl.S;
  tl.fb = (tl.pend - 1) / pl.S;
  tl.sa = tl.fa == tl.fb ? tl.p0 - tl.fa * pl.S : 0;
  tl.ns = tl.fa == tl.fb ? tl.pend - tl.p0 : pl.S;
  return tl;
}

// Walks a staged chunk of nr rows for the thread's pair: h[b * P] is its
// column; bp and wp its byte and weight in the chunk's first row, pitch
// and ns bytes and floats apart (pitch 0: one byte for every row). Two rows
// a step, the next step's bins and weights read before this step's adds
// (reading up to two rows past the chunk, inside the block's shared
// memory: values never used); both bins read before either is written, a
// bin met twice adding in row order.
__device__ __forceinline__ void walk_rows(float* h, int P, int nb, const unsigned char* bp, const float* wp,
                                          int pitch, int ns, int nr) {
  int b1 = bp[0], b2 = bp[pitch];
  float w1 = wp[0], w2 = wp[ns];
  int rr = 0;
  for (; rr + 1 < nr; rr += 2) {
    bp += 2 * pitch;
    wp += 2 * ns;
    const int c1 = bp[0], c2 = bp[pitch];
    const float v1 = wp[0], v2 = wp[ns];
    const bool ok1 = b1 < nb, ok2 = b2 < nb, same = b1 == b2;
    float* h1 = h + b1 * P;
    float* h2 = h + b2 * P;
    float x1 = 0.f, x2 = 0.f;
    if (ok1) x1 = *h1;
    if (ok2) x2 = *h2;
    x1 = __fadd_rn(x1, w1);
    x2 = __fadd_rn(x2, w2);
    if (same) x1 = __fadd_rn(x1, w2);
    if (ok1) *h1 = x1;
    if (ok2 && !same) *h2 = x2;
    b1 = c1;
    b2 = c2;
    w1 = v1;
    w2 = v2;
  }
  if (rr < nr && b1 < nb) h[b1 * P] = __fadd_rn(h[b1 * P], w1);
}

// The span's sums h (nb, P), pairs [p0, pend), out to the node's histogram
// (a direct span) or to its partial slot, 64 bytes of one pair's bins at a
// time through a per-warp transpose in tb (the stages, walked by now).
__device__ __forceinline__ void write_span(const float* h, float* tb0, float* out, float* parts,
                                           const int32_t* extra_cum, const NodeHistPlan& pl, int t, const Span& sp,
                                           const Tile& tl) {
  const int nn = pl.n_nodes;
  float* dst;
  int64_t ld_s;
  int f_base;
  if (sp.direct) {
    dst = out + ((int64_t)t * nn + sp.j) * ((int64_t)pl.S * pl.F * pl.nb);
    ld_s = (int64_t)pl.F * pl.nb;
    f_base = 0;
  } else {
    const int32_t* part_cum = extra_cum + (nn + 1);
    dst = parts + ((int64_t)t * pl.part_slots + part_cum[sp.j] + sp.i) * ((int64_t)pl.S * pl.fc * pl.nb);
    ld_s = (int64_t)pl.fc * pl.nb;
    f_base = pl.f_lo;
  }
  const int p = tl.p0 + threadIdx.x;
  const bool mine = p < tl.pend;
  const int fq = p / pl.S, sq = p - fq * pl.S;
  const long long my_off = mine ? sq * ld_s + (int64_t)(pl.f_lo + fq - f_base) * pl.nb : 0;
  const int lane = threadIdx.x & 31, qw = threadIdx.x & ~31;
  const int warp_pairs = min(32, tl.pend - tl.p0 - qw);  // the same for the whole warp
  if (warp_pairs <= 0) return;
  const float* hq = h + qw + lane;
  if (pl.nb % 16 == 0) {
    // 32 pairs x 16 bins a step through rows of TB4_STRIDE floats: lane l
    // writes its pair's bins as four float4 (conflict-free: a quarter warp's
    // rows start 20 banks apart); then a quarter warp reads rows r and r + 4
    // (conflict-free) and each four lanes store one pair's 64 bytes
    float* tb = tb0 + qw * TB4_STRIDE;
    const int c4 = lane & 3, r_in = (lane >> 3) + 4 * ((lane >> 2) & 1);
    for (int b0 = 0; b0 < pl.nb; b0 += 16) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* hk = hq + (b0 + 4 * k) * pl.P;
        *reinterpret_cast<float4*>(tb + lane * TB4_STRIDE + 4 * k) =
            make_float4(hk[0], hk[pl.P], hk[2 * pl.P], hk[3 * pl.P]);
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 32; m += 8) {
        const int row = m + r_in;
        const long long off = __shfl_sync(0xffffffffu, my_off, row);
        if (row < warp_pairs)
          *reinterpret_cast<float4*>(dst + off + b0 + 4 * c4) =
              *reinterpret_cast<const float4*>(tb + row * TB4_STRIDE + 4 * c4);
      }
      __syncwarp();
    }
    return;
  }
  float* tb = tb0 + qw * TB_STRIDE;
  for (int b0 = 0; b0 < pl.nb; b0 += 16) {
    // lane l: pair qw + l, bins b0 .. b0 + 15 into row l
#pragma unroll
    for (int k = 0; k < 16; ++k) tb[lane * TB_STRIDE + k] = b0 + k < pl.nb ? hq[(b0 + k) * pl.P] : 0.f;
    __syncwarp();
    // two pairs a step: lanes 0-15 row k, lanes 16-31 row k + 1
    const int b = b0 + (lane & 15);
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int row = k + (lane >> 4);
      const long long off = __shfl_sync(0xffffffffu, my_off, row);
      if (row < warp_pairs && b < pl.nb) dst[off + b] = tb[row * TB_STRIDE + (lane & 15)];
    }
    __syncwarp();
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NH_MAX_THREADS)
node_hist_kernel(const uint8_t* __restrict__ bins, const int64_t* __restrict__ src2,
                 const float* __restrict__ swq, const int64_t* __restrict__ pstart,
                 const int32_t* __restrict__ tabs, float* __restrict__ out, float* __restrict__ parts,
                 const NodeHistPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.z;
  const int32_t* extra_cum = tabs + (int64_t)t * 3 * (pl.n_nodes + 1);
  Span sp;
  if (!find_span(pstart, extra_cum, pl, t, blockIdx.x, sp)) return;
  const int64_t row_begin = sp.row_begin, row_end = sp.row_end;
  const Tile tl = tile_of(pl);
  const int sa = tl.sa, ns = tl.ns;
  // each staged row holds the row's bytes [w0, w0 + wn)
  int w0 = pl.f_lo + tl.fa, wn = tl.fb - tl.fa + 1;
  if (VEC) {
    const int w1 = min(pl.F, (w0 + wn + 15) & ~15);
    w0 &= ~15;
    wn = w1 - w0;
  }

  // h (nb, P): h[b * P + q]; two stages of rows; the src2 entries of two
  // chunks; the write's transpose rows reuse the stages
  float* h = reinterpret_cast<float*>(smem);
  unsigned char* stage0 = smem + (size_t)pl.nb * pl.P * sizeof(float);
  const int stage_bytes = (pl.rows * (pl.pitch + 4 * pl.ns) + 15) & ~15;
  const int stages_bytes = max(2 * stage_bytes, TB4_STRIDE * 4 * pl.P);
  int64_t* srcbuf = reinterpret_cast<int64_t*>(stage0 + stages_bytes);
  auto stage = [&](int k) {
    unsigned char* b = stage0 + k * stage_bytes;
    return Stage{b, reinterpret_cast<float*>(b + pl.rows * pl.pitch)};
  };

  const int q = threadIdx.x;
  const int p = tl.p0 + q;
  const bool mine = p < tl.pend;
  const int fq = p / pl.S;
  const int sq = p - fq * pl.S;
  const int boff = pl.f_lo + fq - w0;
  const int woff = sq - sa;
  for (int e = threadIdx.x; e < pl.nb * pl.P / 4; e += blockDim.x)
    reinterpret_cast<float4*>(h)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int64_t tr = (int64_t)t * pl.n_pad;
  const uint8_t* tbins = bins + (int64_t)t * pl.tree_stride;
  const int chunks = (int)((row_end - row_begin + pl.rows - 1) / pl.rows);
  auto chunk_rows = [&](int k) { return (int)min64(pl.rows, row_end - row_begin - (int64_t)k * pl.rows); };
  if (VEC) {
    // chunk k's src2 entries into srcbuf[k & 1], then (once they are in)
    // its rows and weights into stage k & 1: cp.async, one chunk ahead of
    // the walk
    const int words = wn >> 4;
    auto issue_src = [&](int k) {
      if (pl.skip & 2) return;
      const int64_t r0 = row_begin + (int64_t)k * pl.rows;
      for (int e = threadIdx.x; e < chunk_rows(k); e += blockDim.x)
        cp_async8(srcbuf + (k & 1) * pl.rows + e, src2 + tr + r0 + e);
    };
    auto issue_rows = [&](int k) {
      if (pl.skip & 2) return;
      const int64_t r0 = row_begin + (int64_t)k * pl.rows;
      const int nr = chunk_rows(k);
      const Stage st = stage(k & 1);
      const int64_t* sb = srcbuf + (k & 1) * pl.rows;
      for (int e = threadIdx.x; e < nr * words; e += blockDim.x) {
        const int rr = e / words, kk = e - rr * words;
        cp_async16(st.bytes + rr * pl.pitch + 16 * kk, tbins + sb[rr] * pl.F + w0 + 16 * kk);
      }
      for (int e = threadIdx.x; e < nr * ns; e += blockDim.x) {
        const int rr = e / ns, kk = e - rr * ns;
        cp_async4(st.w + rr * ns + kk, swq + (tr + r0 + rr) * pl.S + sa + kk);
      }
    };
    if (chunks > 0) {
      issue_src(0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      issue_rows(0);
      if (chunks > 1) issue_src(1);
      cp_async_commit();
    }
    for (int k = 0; k < chunks; ++k) {
      cp_async_wait_all();
      __syncthreads();  // chunk k and chunk k + 1's src2 are in; chunk k - 1 is walked
      if (k + 1 < chunks) {
        issue_rows(k + 1);
        if (k + 2 < chunks) issue_src(k + 2);
        cp_async_commit();
      }
      const Stage st = stage(k & 1);
      if (mine && !(pl.skip & 1))
        walk_rows(h + q, pl.P, pl.nb, st.bytes + boff, st.w + woff, pl.pitch, ns, chunk_rows(k));
    }
  } else {
    const Stage st = stage(0);
    for (int k = 0; k < chunks; ++k) {
      const int64_t r0 = row_begin + (int64_t)k * pl.rows;
      const int nr = chunk_rows(k);
      __syncthreads();  // the previous chunk is walked
      for (int e = threadIdx.x; e < nr * wn; e += blockDim.x) {
        const int rr = e / wn, kk = e - rr * wn;
        st.bytes[rr * pl.pitch + kk] = tbins[src2[tr + r0 + rr] * pl.F + w0 + kk];
      }
      for (int e = threadIdx.x; e < nr * ns; e += blockDim.x) {
        const int rr = e / ns, kk = e - rr * ns;
        st.w[rr * ns + kk] = swq[(tr + r0 + rr) * pl.S + sa + kk];
      }
      __syncthreads();
      if (mine) walk_rows(h + q, pl.P, pl.nb, st.bytes + boff, st.w + woff, pl.pitch, ns, nr);
    }
  }
  __syncthreads();  // the stages hold the transpose rows from here
  if (pl.skip & 4) return;
  write_span(h, reinterpret_cast<float*>(stage0), out, parts, extra_cum, pl, t, sp, tl);
}

// K6's span kernel: K5's, with each staged row built from the 4-byte word
// of each of the node's selected bytes. Shared memory past the stages and
// the src2 entries: the row offset each staged word is read from (nfm
// ints), 16 zero bytes (a sentinel slot's bin), and two rows of slack for
// the walk's reads past the last stage.
__global__ void __launch_bounds__(NH_MAX_THREADS)
node_hist_sel_kernel(const uint8_t* __restrict__ bins, const int64_t* __restrict__ src2,
                     const float* __restrict__ swq, const int64_t* __restrict__ pstart,
                     const int32_t* __restrict__ feats, const int32_t* __restrict__ tabs,
                     float* __restrict__ out, float* __restrict__ parts, const NodeHistPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nn = pl.n_nodes;
  const int t = blockIdx.z;
  const int32_t* extra_cum = tabs + (int64_t)t * 3 * (nn + 1);
  Span sp;
  if (!find_span(pstart, extra_cum, pl, t, blockIdx.x, sp)) return;
  const Tile tl = tile_of(pl);
  const int sa = tl.sa, ns = tl.ns;
  const int nf = tl.fb - tl.fa + 1;  // slots the tile stages
  const int nfm = min(pl.fc, (pl.P - 1) / pl.S + 2);

  float* h = reinterpret_cast<float*>(smem);
  unsigned char* stage0 = smem + (size_t)pl.nb * pl.P * sizeof(float);
  const int stage_bytes = (pl.rows * (pl.pitch + 4 * pl.ns) + 15) & ~15;
  const int stages_bytes = max(2 * stage_bytes, TB4_STRIDE * 4 * pl.P);
  int64_t* srcbuf = reinterpret_cast<int64_t*>(stage0 + stages_bytes);
  int* roff = reinterpret_cast<int*>(srcbuf + 2 * pl.rows);
  unsigned char* zero = reinterpret_cast<unsigned char*>(roff + ((nfm + 3) & ~3));
  auto stage = [&](int k) {
    unsigned char* b = stage0 + k * stage_bytes;
    return Stage{b, reinterpret_cast<float*>(b + pl.rows * pl.pitch)};
  };

  // the node's ids of the tile's slots, once: the word each staged word is
  // read from, -1 for a sentinel
  const int32_t* ids = feats + ((int64_t)t * nn + sp.j) * pl.F + pl.f_lo + tl.fa;
  if (threadIdx.x < 16) zero[threadIdx.x] = 0;
  for (int k = threadIdx.x; k < nf; k += blockDim.x) {
    const int id = ids[k];
    roff[k] = id >= 0 && id < pl.d_row ? (id & ~3) : -1;
  }
  const int q = threadIdx.x;
  const int p = tl.p0 + q;
  const bool mine = p < tl.pend;
  const int fq = p / pl.S;
  const int sq = p - fq * pl.S;
  const int my_id = mine ? ids[fq - tl.fa] : -1;
  const bool sentinel = my_id < 0 || my_id >= pl.d_row;
  const int woff = sq - sa;
  for (int e = threadIdx.x; e < pl.nb * pl.P / 4; e += blockDim.x)
    reinterpret_cast<float4*>(h)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int boff = 4 * (fq - tl.fa) + (my_id & 3);
  const int bpitch = sentinel ? 0 : pl.pitch;

  const int64_t tr = (int64_t)t * pl.n_pad;
  const int chunks = (int)((sp.row_end - sp.row_begin + pl.rows - 1) / pl.rows);
  auto chunk_rows = [&](int k) { return (int)min64(pl.rows, sp.row_end - sp.row_begin - (int64_t)k * pl.rows); };
  // chunk k's src2 entries into srcbuf[k & 1], then (once they are in) its
  // rows and weights into stage k & 1: cp.async, one chunk ahead of the walk
  auto issue_src = [&](int k) {
    if (pl.skip & 2) return;
    const int64_t r0 = sp.row_begin + (int64_t)k * pl.rows;
    for (int e = threadIdx.x; e < chunk_rows(k); e += blockDim.x)
      cp_async8(srcbuf + (k & 1) * pl.rows + e, src2 + tr + r0 + e);
  };
  auto issue_rows = [&](int k) {
    if (pl.skip & 2) return;
    const int64_t r0 = sp.row_begin + (int64_t)k * pl.rows;
    const int nr = chunk_rows(k);
    const Stage st = stage(k & 1);
    const int64_t* sb = srcbuf + (k & 1) * pl.rows;
    // a warp on consecutive slots of one row: its loads coalesce by sector
    for (int e = threadIdx.x; e < nr * nf; e += blockDim.x) {
      const int rr = e / nf, kk = e - rr * nf;
      const int o = roff[kk];
      if (o >= 0) cp_async4(st.bytes + rr * pl.pitch + 4 * kk, bins + sb[rr] * pl.d_row + o);
    }
    for (int e = threadIdx.x; e < nr * ns; e += blockDim.x) {
      const int rr = e / ns, kk = e - rr * ns;
      cp_async4(st.w + rr * ns + kk, swq + (tr + r0 + rr) * pl.S + sa + kk);
    }
  };
  if (chunks > 0) {
    issue_src(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    issue_rows(0);
    if (chunks > 1) issue_src(1);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait_all();
    __syncthreads();  // chunk k and chunk k + 1's src2 are in; chunk k - 1 is walked
    if (k + 1 < chunks) {
      issue_rows(k + 1);
      if (k + 2 < chunks) issue_src(k + 2);
      cp_async_commit();
    }
    const Stage st = stage(k & 1);
    if (mine && !(pl.skip & 1))
      walk_rows(h + q, pl.P, pl.nb, sentinel ? zero : st.bytes + boff, st.w + woff, bpitch, ns, chunk_rows(k));
  }
  __syncthreads();  // the stages hold the transpose rows from here
  if (pl.skip & 4) return;
  write_span(h, reinterpret_cast<float*>(stage0), out, parts, extra_cum, pl, t, sp, tl);
}

// out[t, j] of every multi-span node j: its spans' partials folded in
// order from +0. Block (x, y, t): the x-th multi-span node of tree t, a
// run of FOLD_THREADS * FOLD_PER_THREAD entries of its (S, fc * nb) sums.
__global__ void __launch_bounds__(FOLD_THREADS)
node_fold_kernel(const int64_t* __restrict__ pstart, const int32_t* __restrict__ tabs,
                 const float* __restrict__ parts, float* __restrict__ out, const NodeHistPlan pl) {
  const int nn = pl.n_nodes;
  const int t = blockIdx.z;
  const int x = blockIdx.x;
  const int32_t* part_cum = tabs + (int64_t)t * 3 * (nn + 1) + (nn + 1);
  const int32_t* multi_cum = part_cum + (nn + 1);
  if (x >= multi_cum[nn]) return;
  // the first j with multi_cum[j + 1] > x
  int lo = 0, hi = nn - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (multi_cum[mid + 1] > x) hi = mid; else lo = mid + 1;
  }
  const int j = lo;
  const int nsp = node_span_count(node_subblocks(pstart + (int64_t)t * (nn + 1), j, pl.r_sub), pl.a);
  const int64_t run = (int64_t)pl.fc * pl.nb;
  const int64_t width = (int64_t)pl.S * run;
  const float* src = parts + ((int64_t)t * pl.part_slots + part_cum[j]) * width;
  float* dst = out + ((int64_t)t * nn + j) * ((int64_t)pl.S * pl.F * pl.nb) + (int64_t)pl.f_lo * pl.nb;
  const int64_t e0 = (int64_t)blockIdx.y * FOLD_THREADS * FOLD_PER_THREAD;
  const int64_t e1 = min64(width, e0 + FOLD_THREADS * FOLD_PER_THREAD);
  for (int64_t e = e0 + threadIdx.x; e < e1; e += FOLD_THREADS) {
    float acc = 0.f;
    for (int k = 0; k < nsp; ++k) acc = __fadd_rn(acc, src[k * width + e]);
    const int64_t s = e / run;
    dst[s * pl.F * pl.nb + (e - s * run)] = acc;
  }
}

// The span kernel of an instance, with the largest dynamic shared memory
// granted to it so far (one static a template instance).
template <typename Kernel>
int set_smem(Kernel kernel, int smem, int& granted) {
  if (smem <= granted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) granted = smem;
  return (int)e;
}

template <bool VEC>
int node_hist_set_smem(int smem) {
  static int granted = 48 << 10;
  return set_smem(node_hist_kernel<VEC>, smem, granted);
}

int node_hist_sel_set_smem(int smem) {
  static int granted = 48 << 10;
  return set_smem(node_hist_sel_kernel, smem, granted);
}

bool plan_ok(const NodeHistPlan& pl) {
  return !(pl.T < 1 || pl.T > 65535 || pl.n_nodes < 1 || pl.S < 1 || pl.nb < 1 || pl.nb > 256 || pl.r_sub < 1 ||
           pl.a < 1 || pl.fc < 1 || pl.f_lo < 0 || pl.f_lo + pl.fc > pl.F || pl.P < 32 || pl.P % 32 ||
           pl.P > NH_MAX_THREADS || pl.rows < 1 || pl.pitch % 16 || pl.tiles < 1 || pl.tiles > 65535 ||
           pl.spans < 1 || pl.multi < 0 || pl.smem > 232448 || pl.d_row < 1);
}

// The span table (when table != 0) before a level's first span launch;
// the fold after a span launch where a node can have more than one span.
int launch_table(const int64_t* pstart, int32_t* tabs, const NodeHistPlan& pl, int table, cudaStream_t st) {
  if (!table) return 0;
  node_span_table_kernel<<<pl.T, TAB_THREADS, 0, st>>>(pstart, tabs, pl);
  return (int)cudaGetLastError();
}

int launch_fold(const int64_t* pstart, const int32_t* tabs, const float* parts, float* out, const NodeHistPlan& pl,
                cudaStream_t st) {
  if (pl.multi == 0) return 0;
  const int64_t width = (int64_t)pl.S * pl.fc * pl.nb;
  const int64_t chunks = (width + FOLD_THREADS * FOLD_PER_THREAD - 1) / (FOLD_THREADS * FOLD_PER_THREAD);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  node_fold_kernel<<<dim3((unsigned)pl.multi, (unsigned)chunks, (unsigned)pl.T), FOLD_THREADS, 0, st>>>(
      pstart, tabs, parts, out, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 per node. bins (n, F) or (T, n, F) uint8 (plan->tree_stride 0 or n *
// F), src2 (T, n_pad) int64, swq (T, n_pad, S) f32, pstart (T, n_nodes + 1)
// int64, out (T, n_nodes, S, F * nb) f32, tabs (T, 3, n_nodes + 1) int32,
// parts (T, part_slots, S, fc * nb) f32; all contiguous. Launches the span
// table (when table != 0), the span kernel, and the fold where a node can
// have more than one span.
extern "C" int node_hist_launch(const uint8_t* bins, const int64_t* src2, const float* swq,
                                const int64_t* pstart, float* out, int32_t* tabs, float* parts,
                                const NodeHistPlan* plan, int table, void* stream) {
  const NodeHistPlan pl = *plan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!plan_ok(pl) || pl.vec < 0 || pl.vec > 1 || (pl.vec && pl.F % 16)) return (int)cudaErrorInvalidValue;
  int e = launch_table(pstart, tabs, pl, table, st);
  if (e) return e;
  const dim3 grid((unsigned)pl.spans, (unsigned)pl.tiles, (unsigned)pl.T);
  e = pl.vec ? node_hist_set_smem<true>(pl.smem) : node_hist_set_smem<false>(pl.smem);
  if (e) return e;
  if (pl.vec)
    node_hist_kernel<true><<<grid, pl.P, pl.smem, st>>>(bins, src2, swq, pstart, tabs, out, parts, pl);
  else
    node_hist_kernel<false><<<grid, pl.P, pl.smem, st>>>(bins, src2, swq, pstart, tabs, out, parts, pl);
  e = (int)cudaGetLastError();
  return e ? e : launch_fold(pstart, tabs, parts, out, pl, st);
}

// K6 per node. bins (n, d_row) uint8 shared by the trees, 4-byte aligned
// with d_row % 4 == 0, feats (T, n_nodes, F) int32 the nodes' ids, the
// rest as node_hist_launch.
extern "C" int node_hist_sel_launch(const uint8_t* bins, const int64_t* src2, const float* swq,
                                    const int64_t* pstart, const int32_t* feats, float* out, int32_t* tabs,
                                    float* parts, const NodeHistPlan* plan, int table, void* stream) {
  const NodeHistPlan pl = *plan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(bins);
  if (!plan_ok(pl) || pl.tree_stride || pl.d_row % 4 || base % 4) return (int)cudaErrorInvalidValue;
  int e = launch_table(pstart, tabs, pl, table, st);
  if (e) return e;
  const dim3 grid((unsigned)pl.spans, (unsigned)pl.tiles, (unsigned)pl.T);
  e = node_hist_sel_set_smem(pl.smem);
  if (e) return e;
  node_hist_sel_kernel<<<grid, pl.P, pl.smem, st>>>(bins, src2, swq, pstart, feats, tabs, out, parts, pl);
  e = (int)cudaGetLastError();
  return e ? e : launch_fold(pstart, tabs, parts, out, pl, st);
}

// A span kernel's registers, local (spill) bytes a thread and resident
// blocks an SM at P threads and smem bytes: K5 (sel 0; vec: its 16-byte
// row instance) or K6 (sel 1).
extern "C" int node_hist_attributes(int sel, int vec, int P, int smem, int* regs, int* local_bytes, int* blocks) {
  cudaFuncAttributes fa;
  const void* k = sel ? (const void*)node_hist_sel_kernel
                      : (vec ? (const void*)node_hist_kernel<true> : (const void*)node_hist_kernel<false>);
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  const int se = sel ? node_hist_sel_set_smem(smem)
                     : (vec ? node_hist_set_smem<true>(smem) : node_hist_set_smem<false>(smem));
  if (se) return se;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, P, smem);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
