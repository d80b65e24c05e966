// Histograms of the RandomForest builder (kernel K5 in two forms, and K6).
//
// Rows arrive sorted by tree node, each node's run padded to a multiple of
// r_sub rows, so every aligned sub-block of r_sub rows belongs to one node
// (padding rows carry sw == 0 and any bin).
//
// K5, per node (node_hist_launch: what the builder runs). For tree t, node
// j and stat s, slot f:
//   out[t, j, s, f * nb + b] = sum over the padded rows r of node j with
//                              bins[src2[t, r], f] == b of swq[t, r, s]
// with bins the builder's uint8 table, shared (n, F) or per tree (T, n, F),
// read through the sort permutation src2; a bin >= nb adds nothing. Its
// summation order is fixed: a node's run is cut into spans of a sub-blocks
// (a = max(1, SPAN_ROWS / r_sub), from the node's start); a span sums its
// rows in row order from +0; a node is the in-order fold of its spans'
// sums from +0. A node of one span (every node of the deep levels; an empty
// node is one span of no rows) is written by its span's blocks; the spans
// of a longer node write partials that a second kernel folds in order.
// No float atomics: the result is bitwise repeatable, and equal to the
// plain version's on the CPU (a row-order scatter_add_, then an in-order
// index_add_ over spans).
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::subblock_hist (the
// pl.pallas_call at rf_pallas.py:190) together with the per-node
// segment_sum its caller applies (tree_kernels.py:531-545).
//
// What bounds it on an H100: the bytes are the rows read (F bytes each,
// through src2), the weights, and the node histograms written: 35.8 MB of
// rows and 67 MB of histograms at the GBT's level 7, where the dense
// per-sub-block partials (next) wrote 143 MB for every chunk of 32
// features. Adds are S * F a row, a few hundred million a level; each is a
// shared-memory read-modify-write of a few instructions, so issue is the
// other bound (the walk takes half of the GBT's level 7; PERF.md §6).
//
// Design. One block per (span, tile of P (slot, stat) pairs, tree), P a
// multiple of 32 and one thread a pair, pairs in (slot, stat) order so that
// a tile reads each row's bytes for its slots once. The span's rows are
// staged into shared memory by cp.async, a chunk ahead of the walk, in two
// stages (each row's window of the tile's slots in aligned 16-byte words
// where the table allows, and its weights); each thread walks the staged
// rows in order for its pair, two rows a step (both bins read before
// either is written; one bin twice adds in row order). The histograms are
// bin-major, h[b * P + q], so a thread owns one bank and the walk has no
// bank conflicts whatever the bins; the write goes out through a per-warp
// transpose of 32 pairs x 16 bins (float4 rows of stride 20 where nb % 16
// == 0, else scalar rows of stride 17) as 64-byte runs of one pair's
// bins. The span table (spans past a node's first, partial slots,
// multi-span nodes, each an exclusive prefix over the nodes) is built on
// the card by a one-block-a-tree scan, so the grid is sized from bounds and
// needs no host sync: block x < n_nodes takes node x's first span (no
// search), the rest the spans past a node's first (a binary search of the
// table); blocks past a tree's spans exit.
//
// K5, per sub-block (subblock_hist_launch; no caller in the builder, kept
// as K6's instance) and K6 write the whole (S, k * nb) tile of sub-block j:
//   out[j, s, f * nb + b] = sum over rows r of sub-block j with bin(r, f) == b
//                           of sw[r, s]
// for every b in [0, nb), zeros included.
//   K5 (subblock_hist):     bin(r, f) = binq[r, f], int32 bins gathered
//                           beforehand; a bin outside [0, nb) adds nothing.
//   K6 (subblock_hist_sel): bin(r, f) = bq[r, featsq[j, f]], the slot's
//                           feature id looked up per sub-block and the byte
//                           read from the full uint8 row; an id outside
//                           [0, d_pad) (the sentinel n_features when
//                           n_features == d_pad) gives bin 0.
// They replace ::subblock_hist and ::subblock_hist_sel (:312), which build
// each tile as one-hot matrix products on the MXU. Their output is dense
// although a sub-block of r_sub rows touches at most r_sub of each slot's
// nb bins, so the partials written are their whole cost. One block per
// (sub-block, tile of (stat, slot) pairs): the pair p = s * k + f owns the
// nb floats at out[j, p * nb ...], held in shared memory (at most 8,192
// floats), zero-filled, then written out whole. One thread per pair walks
// the sub-block's rows in order and adds sw[r, s] at its bin: no atomics,
// every bin the sequential row-order sum. The adds are plain f32 adds (no
// product to contract), exact to IEEE rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE_FLOATS = 8192;

template <bool SEL>
__global__ void __launch_bounds__(THREADS)
subblock_hist_kernel(const int32_t* __restrict__ binq, const uint8_t* __restrict__ bq,
                     const int32_t* __restrict__ featsq, const float* __restrict__ sw,
                     float* __restrict__ out, int r_sub, int k, int nb, int S, int d_pad,
                     int pairs_per_tile) {
  extern __shared__ float h[];
  const int64_t sb = blockIdx.x;
  const int p0 = blockIdx.y * pairs_per_tile;
  const int P = min(pairs_per_tile, S * k - p0);
  const int nfl = P * nb;
  for (int i = threadIdx.x; i < nfl; i += THREADS) h[i] = 0.f;
  __syncthreads();

  const int64_t r0 = sb * r_sub;
  for (int q = threadIdx.x; q < P; q += THREADS) {
    const int p = p0 + q;
    const int s = p / k;
    const int f = p - s * k;
    float* hq = h + q * nb;
    int fid = 0;
    bool in_row = true;
    if (SEL) {
      fid = featsq[sb * k + f];
      in_row = fid >= 0 && fid < d_pad;
    }
    for (int j = 0; j < r_sub; ++j) {
      const int64_t r = r0 + j;
      int b;
      if (SEL) {
        b = in_row ? (int)bq[r * d_pad + fid] : 0;
      } else {
        b = binq[r * k + f];
      }
      const float w = sw[r * S + s];
      if (b >= 0 && b < nb) hq[b] += w;
    }
  }
  __syncthreads();

  float* o = out + sb * ((int64_t)S * k * nb) + (int64_t)p0 * nb;
  for (int i = threadIdx.x; i < nfl; i += THREADS) o[i] = h[i];
}

template <bool SEL>
int launch(const int32_t* binq, const uint8_t* bq, const int32_t* featsq, const float* sw,
           float* out, int64_t n_sb, int r_sub, int k, int nb, int S, int d_pad,
           cudaStream_t st) {
  if (n_sb <= 0) return 0;
  if (r_sub < 1 || k < 1 || nb < 1 || nb > 256 || S < 1 || n_sb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int pairs = S * k;
  const int per_tile = min(pairs, TILE_FLOATS / nb);
  const int n_tiles = (pairs + per_tile - 1) / per_tile;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)per_tile * nb * sizeof(float);
  dim3 grid((unsigned)n_sb, (unsigned)n_tiles);
  subblock_hist_kernel<SEL><<<grid, THREADS, smem, st>>>(binq, bq, featsq, sw, out, r_sub, k,
                                                         nb, S, d_pad, per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. binq (n_sb * r_sub, k) int32, sw (n_sb * r_sub, S) f32, out
// (n_sb, S, k * nb) f32; all contiguous.
extern "C" int subblock_hist_launch(const int32_t* binq, const float* sw, float* out,
                                    int64_t n_sb, int r_sub, int k, int nb, int S,
                                    void* stream) {
  return launch<false>(binq, nullptr, nullptr, sw, out, n_sb, r_sub, k, nb, S, 0,
                       static_cast<cudaStream_t>(stream));
}

// K6. bq (n_sb * r_sub, d_pad) uint8, featsq (n_sb, k) int32, sw
// (n_sb * r_sub, S) f32, out (n_sb, S, k * nb) f32; all contiguous.
extern "C" int subblock_hist_sel_launch(const uint8_t* bq, const int32_t* featsq,
                                        const float* sw, float* out, int64_t n_sb, int r_sub,
                                        int k, int nb, int S, int d_pad, void* stream) {
  if (d_pad < 1) return (int)cudaErrorInvalidValue;
  return launch<true>(nullptr, bq, featsq, sw, out, n_sb, r_sub, k, nb, S, d_pad,
                      static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// K5, per node
// ---------------------------------------------------------------------------

// K5 per node: a launch's sizes, as _NodeHistPlan in ops/rf_kernels.py (its
// geometry). At namespace scope: the C entry point takes it.
struct NodeHistPlan {
  int64_t n_pad;        // padded rows of a tree
  int64_t tree_stride;  // bins entries between trees (0: one shared table)
  int64_t part_slots;   // span partial slots of a tree
  int F;                // slots of a row of bins
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
  int vec;              // rows read as aligned 16-byte words
  int skip;             // the probe's knock-outs, 0 on every path: 1 the walk,
                        // 2 the row loads (16-byte instance), 4 the write
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

// Walks a staged chunk of nr rows for the thread's pair: h[b * P] is its
// column; bp and wp its byte and weight in the chunk's first row, pitch
// and ns bytes and floats apart. Two rows a step, the next step's bins and
// weights read before this step's adds (reading up to two rows past the
// chunk, inside the stages: values never used); both bins read before
// either is written, a bin met twice adding in row order.
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

template <bool VEC>
__global__ void __launch_bounds__(NH_MAX_THREADS)
node_hist_kernel(const uint8_t* __restrict__ bins, const int64_t* __restrict__ src2,
                 const float* __restrict__ swq, const int64_t* __restrict__ pstart,
                 const int32_t* __restrict__ tabs, float* __restrict__ out, float* __restrict__ parts,
                 const NodeHistPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nn = pl.n_nodes;
  const int t = blockIdx.z;
  const int u = blockIdx.x;
  // span u < n_nodes is node u's first; span n_nodes + x is the x-th of the
  // spans past a node's first, node j holding those from extra_cum[j]
  const int32_t* extra_cum = tabs + (int64_t)t * 3 * (nn + 1);
  int j = u, i = 0;
  if (u >= nn) {
    const int x = u - nn;
    if (x >= extra_cum[nn]) return;
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
  const bool direct = node_span_count(c, pl.a) == 1;
  const int64_t row_begin = (sb0 + (int64_t)i * pl.a) * pl.r_sub;
  const int64_t row_end = (sb0 + min64(c, (int64_t)(i + 1) * pl.a)) * pl.r_sub;

  // the tile's pairs p = fl * S + s over the launch's slots fl in [0, fc)
  const int pairs = pl.fc * pl.S;
  const int p0 = blockIdx.y * pl.P;
  const int pend = min(pairs, p0 + pl.P);
  const int fa = p0 / pl.S, fb = (pend - 1) / pl.S;
  const int sa = fa == fb ? p0 - fa * pl.S : 0;
  const int ns = fa == fb ? pend - p0 : pl.S;
  // each staged row holds the row's bytes [w0, w0 + wn)
  int w0 = pl.f_lo + fa, wn = fb - fa + 1;
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
  const int p = p0 + q;
  const bool mine = p < pend;
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

  // the span's sums: straight into the node's histogram, or a partial
  float* dst;
  int64_t ld_s;
  int f_base;
  if (direct) {
    dst = out + ((int64_t)t * nn + j) * ((int64_t)pl.S * pl.F * pl.nb);
    ld_s = (int64_t)pl.F * pl.nb;
    f_base = 0;
  } else {
    const int32_t* part_cum = extra_cum + (nn + 1);
    dst = parts + ((int64_t)t * pl.part_slots + part_cum[j] + i) * ((int64_t)pl.S * pl.fc * pl.nb);
    ld_s = (int64_t)pl.fc * pl.nb;
    f_base = pl.f_lo;
  }
  const long long my_off = mine ? sq * ld_s + (int64_t)(pl.f_lo + fq - f_base) * pl.nb : 0;
  if (pl.skip & 4) return;
  const int lane = threadIdx.x & 31, qw = threadIdx.x & ~31;
  const int warp_pairs = min(32, pend - p0 - qw);  // the same for the whole warp
  if (warp_pairs <= 0) return;
  const float* hq = h + qw + lane;
  if (pl.nb % 16 == 0) {
    // 32 pairs x 16 bins a step through rows of TB4_STRIDE floats: lane l
    // writes its pair's bins as four float4 (conflict-free: a quarter warp's
    // rows start 20 banks apart); then a quarter warp reads rows r and r + 4
    // (conflict-free) and each four lanes store one pair's 64 bytes
    float* tb = reinterpret_cast<float*>(stage0) + qw * TB4_STRIDE;
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
  float* tb = reinterpret_cast<float*>(stage0) + qw * TB_STRIDE;
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

template <bool VEC>
int node_hist_set_smem(int smem) {
  // the largest dynamic shared memory asked of this instance so far
  static int granted = 48 << 10;
  if (smem <= granted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(node_hist_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) granted = smem;
  return (int)e;
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
  if (pl.T < 1 || pl.T > 65535 || pl.n_nodes < 1 || pl.S < 1 || pl.nb < 1 || pl.nb > 256 || pl.r_sub < 1 ||
      pl.a < 1 || pl.fc < 1 || pl.f_lo < 0 || pl.f_lo + pl.fc > pl.F || pl.P < 32 || pl.P % 32 ||
      pl.P > NH_MAX_THREADS || pl.rows < 1 || pl.pitch % 16 || pl.tiles < 1 || pl.tiles > 65535 ||
      pl.spans < 1 || pl.multi < 0 || pl.smem > 232448 ||
      (pl.vec && pl.F % 16))
    return (int)cudaErrorInvalidValue;
  if (table) {
    node_span_table_kernel<<<pl.T, TAB_THREADS, 0, st>>>(pstart, tabs, pl);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)pl.spans, (unsigned)pl.tiles, (unsigned)pl.T);
  int e = pl.vec ? node_hist_set_smem<true>(pl.smem) : node_hist_set_smem<false>(pl.smem);
  if (e) return e;
  if (pl.vec)
    node_hist_kernel<true><<<grid, pl.P, pl.smem, st>>>(bins, src2, swq, pstart, tabs, out, parts, pl);
  else
    node_hist_kernel<false><<<grid, pl.P, pl.smem, st>>>(bins, src2, swq, pstart, tabs, out, parts, pl);
  e = (int)cudaGetLastError();
  if (e || pl.multi == 0) return e;
  const int64_t width = (int64_t)pl.S * pl.fc * pl.nb;
  const int64_t chunks = (width + FOLD_THREADS * FOLD_PER_THREAD - 1) / (FOLD_THREADS * FOLD_PER_THREAD);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  node_fold_kernel<<<dim3((unsigned)pl.multi, (unsigned)chunks, (unsigned)pl.T), FOLD_THREADS, 0, st>>>(
      pstart, tabs, parts, out, pl);
  return (int)cudaGetLastError();
}

// The span kernel's registers, local (spill) bytes a thread and resident
// blocks an SM at P threads and smem bytes (vec: the 16-byte row instance).
extern "C" int node_hist_attributes(int vec, int P, int smem, int* regs, int* local_bytes, int* blocks) {
  cudaFuncAttributes fa;
  cudaError_t e = vec ? cudaFuncGetAttributes(&fa, node_hist_kernel<true>)
                      : cudaFuncGetAttributes(&fa, node_hist_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  const int se = vec ? node_hist_set_smem<true>(smem) : node_hist_set_smem<false>(smem);
  if (se) return se;
  e = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, node_hist_kernel<true>, P, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, node_hist_kernel<false>, P, smem);
  return (int)e;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
