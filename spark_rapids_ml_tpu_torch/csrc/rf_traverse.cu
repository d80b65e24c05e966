// The packed-forest descent of a transform batch (kernel K9), from the root
// or from a given hop-1 index, with its leaf ids or its leaf-payload sums.
//
// The forest is re-laid by pack_forest (ops/tree_kernels.py). Hop 1 walks
// each tree's top k1 levels through feat1/thr1 (T_pad, n1 = 2^k1 - 1), heap
// order:
//   i = 0; at most k1 steps: f = feat1[t, i]; stop if f < 0;
//   i = 2i + 1 + (byte f of the row's packed bins > thr1[t, i])
// A row that stopped above level k1 (i < n1) has its leaf. Otherwise l =
// i - n1 names one of the tree's 2^k1 subtrees, whose 2^k2 - 1 internal
// nodes sit in table row t * 2^k1 + l of feat2/thr2, heap-ordered along the
// lanes (feature -1 = leaf); from lane m = 0 the row takes at most k2 steps
// of the same test, and the local slot m becomes the global heap index
//   delta = depth of m, pd = 2^delta, id = (2^k1 pd - 1) + l pd + (m - (pd - 1)).
// With k2 = 0 the hop-1 index is the leaf. Every value of the walk is an
// integer: the ids are bit-identical to any other evaluation of it.
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::packed_traverse (the
// pl.pallas_call at rf_pallas.py:676: hop 2 as a masked lockstep over all
// trees of a row block, the table row picked by an MXU one-hot product, the
// bytes by a lane shuffle, at most 128 words a row) together with what its
// caller computes around it in XLA (spark_rapids_ml_tpu/ops/tree_kernels.py
// ::_packed_hop1, a bf16 one-hot product of every tree's hop-1 tests, and
// ::_packed_payload, the sum of the leaves' payloads).
//
// Starts and epilogues (one template):
//   ROOT  walks each (row, tree) from the root: hop 1 and hop 2;
//   I1    starts from a given hop-1 index i1 (n, T_pad): the TPU kernel's
//         contract (hop 2 only);
//   LEAF  writes the (n, T_pad) int32 global leaf ids;
//   SUM   writes the (n, V) f32 sums over the T real trees of each tree's
//         payload values[t, leaf, :] (T, M, V), in the JAX association:
//         partial sums of 8 trees in tree order, then across the groups in
//         order, f32 adds only (__fadd_rn: no contraction, no atomics). The
//         ids never reach global memory.
//
// What bounds it on an H100: the bytes, each input read once and the
// output written once: the packed rows (n * 4 * words), the node tables
// and, for SUM, the payload tensor and (n, V) out; at the bench forest's
// batch (131,072 rows of 256 bytes, 50 trees of depth 13, V = 2) 43 MB,
// 0.013 ms. A walk is a chain of up to 14 dependent steps (k1 <= 8, k2 <=
// 6), a node then a byte of the row each, so latency and the hop-2 node
// loads (a 32-byte L2 sector a step for 4 bytes: ~6 TB/s of L2 reads at
// the bench shape) set the time; the design keeps what it can on chip and
// two walks of a lane in flight.
//
// Design. A block takes R = 64 rows and all trees, 8 trees a pass (its 8
// warps; the payload's group of 8): warp = tree, lane = rows lane and
// lane + 32, walked in lockstep so that their loads overlap.
//   - A node is one int32 word, -1 at a leaf, else (feature << 9) |
//     (threshold + 1) (ops/rf_kernels.py::forest_nodes, made once per
//     model): one load a step, and the test is byte >= word & 511.
//   - The block's rows (contiguous in global memory) are staged once in
//     shared memory by 4-byte cp.async, a row at an odd word stride so that
//     rows' bytes at one feature fall in distinct banks; rows too wide to
//     stage (the caller's STAGE cap) are read from global memory.
//   - Each pass's 8 trees' hop-1 words are staged in shared memory by
//     cp.async one pass ahead (two buffers); hop-2 words come from L2.
//   - One barrier a pass: the ids of a pass go to shared memory (a row at
//     9 words), and the next pass's barrier hands them to the epilogue,
//     which runs while the next pass walks: LEAF writes them out 8 trees of
//     4 rows a warp; SUM's thread for item (row, v) reads the 8 payloads of
//     its row and adds them in tree order, then into its running sum (in a
//     register where 64 V <= 512, else in out: the generic instance, any
//     V).
//   - 32-bit indices inside a block, 64-bit block bases; no division.
// ptxas (CUDA 12.8, sm_90a, __launch_bounds__(256, 6)): 32-40 registers,
// no spills. Measured beside one chain a lane, a node as two words, a
// vectorised first hop-2 sector and knock-outs: PERF.md section 6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 8;     // trees a pass: a block's warps, the payload's group
constexpr int THREADS = 32 * GROUP;
constexpr int CHAINS = 2;    // rows a lane walks at once
constexpr int R = 32 * CHAINS;  // rows a block
constexpr int LEAF_STRIDE = GROUP + 1;  // words a row of the staged leaf ids
constexpr int LANES = 64;    // node words a hop-2 table row (2^k2 - 1 <= 63)
constexpr int MIN_BLOCKS = 6;  // resident blocks an SM: at most 40 registers

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A node word is -1 at a leaf, else (feature << 9) | (threshold + 1): the
// walk goes right where the row's byte >= word & 511. The byte read at a
// leaf (the unsigned feature field clamped to the row) is discarded.
__device__ __forceinline__ int step(const uint8_t* row, int w, int i, int dmax) {
  const int right = row[min((unsigned)w >> 9, (unsigned)dmax)] >= (w & 511) ? 1 : 0;
  return w < 0 ? i : 2 * i + 1 + right;
}

// CHAINS (row, tree) walks of one lane in lockstep, so that their loads are
// in flight together. rows[c]: row c's bytes (shared or global memory);
// live[c]: a row of the batch; h1: the tree's staged hop-1 node words
// (ROOT); i[c]: the hop-1 index (I1); h2: the hop-2 node words; trow: t *
// 2^k1. Leaves the global leaf ids in i.
template <bool ROOT>
__device__ __forceinline__ void walk(const uint8_t* const (&rows)[CHAINS], const bool (&live)[CHAINS],
                                     const int* h1, int (&i)[CHAINS], const int32_t* __restrict__ h2, int trow,
                                     int k1, int k2, int dmax) {
  const int n1 = (1 << k1) - 1;
  if (ROOT) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) i[c] = 0;
    for (int s = 0; s < k1; ++s) {
      int w[CHAINS];
      bool any = false;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        w[c] = h1[i[c]];
        any |= w[c] >= 0;
      }
      if (!any) break;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) i[c] = step(rows[c], w[c], i[c], dmax);
    }
  }
  if (k2 == 0) return;
  const int K1 = 1 << k1;
  int l[CHAINS], m[CHAINS];
  bool done[CHAINS];
  const int32_t* sub[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    done[c] = !live[c] || i[c] < n1;
    l[c] = min(max(i[c] - n1, 0), K1 - 1);
    sub[c] = h2 + (trow + l[c]) * LANES;
    m[c] = 0;
  }
  for (int s = 0; s < k2; ++s) {
    int w[CHAINS];
    bool any = false;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      w[c] = done[c] ? -1 : __ldg(sub[c] + m[c]);
      done[c] = w[c] < 0;
      any |= !done[c];
    }
    if (!any) break;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) m[c] = step(rows[c], w[c], m[c], dmax);
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    if (i[c] < n1) continue;
    const int pd = 1 << (31 - __clz(m[c] + 1));  // 2^(depth of slot m)
    i[c] = (K1 * pd - 1) + l[c] * pd + (m[c] - (pd - 1));
  }
}

// A pass's epilogue: its ids (s_leaf) out (LEAF), or the group's payload
// sum into the running sums (SUM): item (row, v) = v * R + row, thread tid
// the items tid + c * THREADS (in acc[c] where R V <= CHAINS * THREADS, else
// in sum_out).
template <bool SUM, bool ACC_REG>
__device__ __forceinline__ void epilogue(const int* s_leaf, int t0, int r0, int nrows, int tid,
                                         const float* __restrict__ values, int M, int V, int n_trees,
                                         int32_t* __restrict__ leaf_out, float* __restrict__ sum_out, int t_pad,
                                         float (&acc)[CHAINS]) {
  if (SUM) {
    const int cnt = min(GROUP, n_trees - t0);
    const float* vg = values + (int64_t)t0 * M * V;
#pragma unroll
    for (int c = 0; c < (ACC_REG ? CHAINS : 1); ++c) {
      for (int item = tid + c * THREADS; item < R * V; item += (ACC_REG ? R * V : THREADS)) {
        const int r = item % R, v = item / R;
        if (r >= nrows) continue;
        const int* ids = s_leaf + r * LEAF_STRIDE;
        float x[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) x[j] = j < cnt ? __ldg(vg + (j * M + ids[j]) * V + v) : 0.0f;
        float part = x[0];
#pragma unroll
        for (int j = 1; j < GROUP; ++j)
          if (j < cnt) part = __fadd_rn(part, x[j]);
        if (ACC_REG) {
          acc[c] = t0 == 0 ? part : __fadd_rn(acc[c], part);
        } else {
          float* o = sum_out + (int64_t)(r0 + r) * V + v;
          *o = t0 == 0 ? part : __fadd_rn(*o, part);
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const int e = tid + c * THREADS, wr = e >> 3, wt = e & 7;  // 4 rows x 8 trees a warp
      if (wr < nrows) leaf_out[(int64_t)(r0 + wr) * t_pad + t0 + wt] = s_leaf[wr * LEAF_STRIDE + wt];
    }
  }
}

template <bool ROOT, bool SUM, bool STAGE, bool ACC_REG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
packed_forest_kernel(const int32_t* __restrict__ packed, int n, int words, int ws,
                     const int32_t* __restrict__ nodes1, const int32_t* __restrict__ i1,
                     const int32_t* __restrict__ nodes2, const float* __restrict__ values, int M, int V,
                     int n_trees, int32_t* __restrict__ leaf_out, float* __restrict__ sum_out, int t_pad, int k1,
                     int k2) {
  extern __shared__ int4 smem[];
  const int n1 = (1 << k1) - 1;
  const int hn = ROOT ? GROUP * n1 : 0;  // a pass's hop-1 nodes
  int* s_h1 = reinterpret_cast<int*>(smem);  // [2][hn] node words, two buffers
  int* s_leaf = s_h1 + 2 * hn;               // [2][R * LEAF_STRIDE] ids
  int* s_rows = s_leaf + 2 * R * LEAF_STRIDE;  // STAGE: [R * ws] words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, n - r0);
  const int32_t* pblk = packed + (int64_t)r0 * words;
  if (STAGE) {
    for (int r = warp; r < nrows; r += GROUP)
      for (int c = lane; c < words; c += 32) cp_async4(s_rows + r * ws + c, pblk + r * words + c);
  }
  if (ROOT)
    for (int e = tid; e < hn; e += THREADS) cp_async4(s_h1 + e, nodes1 + e);
  cp_async_commit();
  // lane's rows: lane and lane + 32 (a row past the batch walks row 0)
  const uint8_t* rows[CHAINS];
  bool live[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int r = lane + 32 * c;
    live[c] = r < nrows;
    rows[c] = STAGE ? reinterpret_cast<const uint8_t*>(s_rows + (live[c] ? r : 0) * ws)
                    : reinterpret_cast<const uint8_t*>(pblk + (live[c] ? r : 0) * words);
  }
  const int dmax = 4 * words - 1;
  const int passes = ((SUM ? n_trees : t_pad) + GROUP - 1) / GROUP;
  float acc[CHAINS] = {};
  // One barrier a pass: pass p's nodes and ids use buffer p & 1. After the
  // barrier of pass p, every walk of pass p - 1 (buffer p - 1 & 1: its
  // nodes free, its ids final) and every epilogue of pass p - 2 (its ids
  // free) is done: pass p - 1's epilogue runs, pass p + 1's nodes are
  // copied into the free buffer, and pass p is walked.
  for (int p = 0; p < passes; ++p) {
    const int b = p & 1, t0 = p * GROUP;
    cp_async_wait_all();
    __syncthreads();
    if (p > 0)
      epilogue<SUM, ACC_REG>(s_leaf + (b ^ 1) * R * LEAF_STRIDE, t0 - GROUP, r0, nrows, tid, values, M, V, n_trees,
                             leaf_out, sum_out, t_pad, acc);
    if (ROOT && p + 1 < passes) {
      const int32_t* src = nodes1 + (t0 + GROUP) * n1;
      for (int e = tid; e < hn; e += THREADS) cp_async4(s_h1 + (b ^ 1) * hn + e, src + e);
      cp_async_commit();
    }
    const int t = t0 + warp;
    if (t < (SUM ? n_trees : t_pad) && live[0]) {
      int i[CHAINS];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        i[c] = ROOT || !live[c] ? 0 : __ldg(i1 + (int64_t)(r0 + lane + 32 * c) * t_pad + t);
      walk<ROOT>(rows, live, s_h1 + b * hn + warp * n1, i, nodes2, t << k1, k1, k2, dmax);
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        if (live[c]) s_leaf[b * R * LEAF_STRIDE + (lane + 32 * c) * LEAF_STRIDE + warp] = i[c];
    }
  }
  __syncthreads();
  epilogue<SUM, ACC_REG>(s_leaf + ((passes - 1) & 1) * R * LEAF_STRIDE, (passes - 1) * GROUP, r0, nrows, tid, values,
                         M, V, n_trees, leaf_out, sum_out, t_pad, acc);
  if (SUM && ACC_REG) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const int item = tid + c * THREADS, r = item % R, v = item / R;
      if (item < R * V && r < nrows) sum_out[(int64_t)(r0 + r) * V + v] = acc[c];
    }
  }
}

template <bool ROOT, bool SUM, bool STAGE, bool ACC_REG>
cudaError_t launch(const int32_t* packed, int n, int words, int ws, const int32_t* nodes1, const int32_t* i1,
                   const int32_t* nodes2, const float* values, int M, int V, int n_trees, int32_t* leaf_out,
                   float* sum_out, int t_pad, int k1, int k2, int smem, cudaStream_t stream) {
  auto kern = packed_forest_kernel<ROOT, SUM, STAGE, ACC_REG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + R - 1) / R);
  kern<<<blocks, THREADS, smem, stream>>>(packed, n, words, ws, nodes1, i1, nodes2, values, M, V, n_trees, leaf_out,
                                          sum_out, t_pad, k1, k2);
  return cudaGetLastError();
}

}  // namespace

// packed (n, words) int32 rows; root: nodes1 (t_pad, 2^k1 - 1) hop-1 node
// words, else i1 (n, t_pad) int32; nodes2 (t_pad * 2^k1, 64) hop-2 node
// words (ops/rf_kernels.py::forest_nodes); values (n_trees, M, V) f32 or
// null: SUM into sum_out (n, V), else LEAF into leaf_out (n, t_pad). stage,
// ws (words a staged row, odd) and smem (bytes) are the caller's geometry
// (ops/rf_kernels.py::_forest_geometry). All contiguous; t_pad a multiple
// of 8 >= n_trees; 1 <= k1 <= 8, 0 <= k2 <= 6 (k2 >= 1 without root); rows
// of at most 2^22 bytes; 32-bit offsets hold.
extern "C" int packed_forest_launch(const int32_t* packed, int n, int words, int ws, int stage, int root,
                                    const int32_t* nodes1, const int32_t* i1, const int32_t* nodes2,
                                    const float* values, int M, int V, int n_trees, int32_t* leaf_out,
                                    float* sum_out, int t_pad, int k1, int k2, int smem, void* stream) {
  if (n <= 0) return 0;
  if (words < 1 || words > (1 << 20) || k1 < 1 || k1 > 8 || k2 < 0 || k2 > 6 || (!root && k2 < 1) ||
      t_pad < GROUP || t_pad % GROUP || (stage && ws < words))
    return (int)cudaErrorInvalidValue;
  if (values && (n_trees < 1 || n_trees > t_pad || V < 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K9_ARGS packed, n, words, ws, nodes1, i1, nodes2, values, M, V, n_trees, leaf_out, sum_out, t_pad, k1, k2, \
                smem, s
  cudaError_t err;
  if (!root) {
    err = stage ? launch<false, false, true, false>(K9_ARGS) : launch<false, false, false, false>(K9_ARGS);
  } else if (!values) {
    err = stage ? launch<true, false, true, false>(K9_ARGS) : launch<true, false, false, false>(K9_ARGS);
  } else if (R * V <= CHAINS * THREADS) {
    err = stage ? launch<true, true, true, true>(K9_ARGS) : launch<true, true, false, true>(K9_ARGS);
  } else {
    err = stage ? launch<true, true, true, false>(K9_ARGS) : launch<true, true, false, false>(K9_ARGS);
  }
#undef K9_ARGS
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
