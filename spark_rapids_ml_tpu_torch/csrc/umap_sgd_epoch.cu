// One UMAP SGD epoch over CSR-padded rows. For every row r (head i) the sum
// over its K slots of the clipped attractive pull towards the slot's tail
// row and the clipped repulsive pushes away from `neg` negative rows, every
// term masked by the slot's Bernoulli draw u < p:
//   attractive  -2ab (d2)^(b-1) / (a (d2)^b + 1) * diff, clipped to +-4,
//               times attract_scale
//   repulsive   2 gamma b / ((0.001 + d2) (a (d2)^b + 1)) * diff, clipped
// each zero where d2 = 0. The negative of slot (r, k), sample s, is
//   src[perm[(((r - offs[s]) mod R) * K + k) mod n_tab]]
// (a permutation of the table laid cyclically over the slots and rolled by
// offs[s] rows), computed here from perm and offs: the (R, neg*K) id array
// is never written. Two epilogues of one kernel:
//   ROWS  (row_off null): the per-row sums (R, C), the TPU kernel's output;
//   STEP  (row_off = each head's first row, rows sorted by head): the
//         epoch's tail too, next[i] = emb[i] + alpha * (sum of head i's
//         rows), every head written (a head without rows is copied), the
//         rows' heads read from emb itself. No float atomics (below).
// The slot uniforms are streamed (u, the caller's draws), or drawn here:
//   u(r, k) = (bits >> 8) * 2^-24,  bits = mix32(mix32(ctr ^ key) + key),
//   ctr = (r * K + k) mod 2^32,     key = mix32(seed + 0x9e3779b9),
// mix32 being the xor-shift-multiply finaliser below (32-bit multiplies,
// low word): the plain version computes the same bits with int64 ops.
//
// Replaces spark_rapids_ml_tpu/ops/umap_pallas.py::sgd_epoch_rows (the
// pl.pallas_call at umap_pallas.py:277), which keeps the whole embedding
// table resident in VMEM and streams the CSR rows through it, and, in its
// STEP epilogue, the caller's sorted segment_sum and emb + alpha * upd
// (umap_pallas.py:397-400); its draws in the kernel take the place of the
// TPU kernel's rng="onchip" mode (a counter-based hash for the TPU's PRNG).
//
// What bounds it on an H100: the bytes it must stream, 8 bytes a slot
// (tail id, p; 4 more with streamed u) plus the head rows in and the sums
// or next rows out; at the UMAP fit shape (~0.1M rows x K = 24) ~20-30 MB,
// 6-9 us at 3.35 TB/s. The table (65,536 x 2 f32, 512 KB) and perm stay in
// the 50 MB L2, so the K (1 + neg) row gathers a row makes are L2 reads.
// Only a fifth to a half of the slots are active, and each active slot
// makes 1 + neg dependent gathers (perm, then the table row) and a powf.
//
// Design. A warp takes a run of consecutive rows (about four waves of the
// card's resident warps over the rows, so a head of many rows, a hub of the
// kNN graph, is shared by several warps). For each 32 slots of a row it
// loads tails and p (and u) one slot a lane, the next row's while this one
// computes, draws, finds the active slots with __ballot_sync and compacts
// them in shared memory; then it spreads the active (slot, sample) terms
// over all 32 lanes (about 29 a row at the fit shape instead of 6 in series
// on one lane in five): each lane loads its index (tail, or perm), then its
// table row, then computes. One powf a term: (d2)^(b-1) is (d2)^b / d2
// where (d2)^b is a normal float, the exact powf elsewhere. Each lane adds
// a head's terms over its rows in registers; a xor-shuffle tree gives the
// head's sums, the same in every lane. A head whose rows are all the
// warp's is written at once; a head shared with other warps leaves the
// warp's sums in its slot of a workspace, and the last of its warps to
// arrive (an integer atomicAdd) adds the slots in warp order. So two
// launches on the same inputs agree bit for bit. C <= 8 has its own
// instances (the components in registers); any other C runs the generic
// instance, which walks its rows once per block of 8 components.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int GENERIC_BLOCK = 8;  // components a pass of the generic instance
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0xd35a2d97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float clip4(float x) { return fminf(fmaxf(x, -4.f), 4.f); }

struct Args {
  const float* src;        // (n_tab, C): the table the tails and negatives index
  const float* h;          // ROWS: (R, C) head rows; STEP: (n_head, C) embedding
  const int64_t* row_off;  // STEP: (n_head + 1) first row of each head; ROWS: null
  const int* row_heads;    // STEP: (R,) the head of each row, ascending; ROWS: null
  const int* tails;        // (R, K)
  const float* p;          // (R, K)
  const int* perm;         // (n_tab,)
  const int* offs;         // (neg,)
  const float* u;          // (R, K) streamed uniforms, or null: drawn with key
  uint32_t* bits_out;      // null, or (R, K): the bits drawn for every slot visited
  float* out;              // ROWS: (R, C) sums; STEP: (n_head, C) next embedding
  float* part;             // STEP: (warps, 2, C) a warp's sums of the heads it shares
  int* arrive;             // STEP: (warps) arrivals at each shared head; 0 between launches
  int64_t R, n_head, n_tab;
  int K, C, neg, rows_per_warp;
  int wide;                // wide: R * K or n_tab past 32 bits
  uint32_t key;
  uint32_t tab_m;          // x mod n_tab = x - q n_tab, q = (t + ((x - t) >> s1)) >> s2,
  int tab_s1, tab_s2;      // t = umulhi(x, tab_m) (division by an invariant integer)
  float a, b, bm1, c_att, c_rep, scale, alpha;
  int knock;  // measurement only, 0 on every path: 1 no terms, 2 no powf, 4 no perm reads,
              // 8 the launch alone
};

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ q, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(q) + i);
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(q) + i);
      v[2 * i] = t.x, v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(q + i);
  }
}

// Copies the embedding rows of heads [h0, h1) (heads without rows).
__device__ __forceinline__ void copy_heads(const Args& A, int64_t h0, int64_t h1, int lane) {
  for (int64_t i = h0 * A.C + lane; i < h1 * A.C; i += 32) A.out[i] = __ldg(A.h + i);
}

// A warp's slot data of chunk kc of row r: tail, p and (streamed) u.
__device__ __forceinline__ void load_slot(const Args& A, int r, int k, int& tl, float& pv, float& uv) {
  if (k < A.K) {
    const int64_t e = (int64_t)r * A.K + k;
    tl = __ldg(A.tails + e);
    pv = __ldg(A.p + e);
    if (A.u) uv = __ldg(A.u + e);
  }
}

__device__ __forceinline__ int head_of(const Args& A, int r) {
  return A.row_off ? __ldg(A.row_heads + r) : r;
}

// The CB components from cb of head row hd (the rest 0).
template <int CB, bool FIXED>
__device__ __forceinline__ void load_head(const Args& A, int hd, int cb, int nc, float* v) {
  const float* q = A.h + (int64_t)hd * (FIXED ? CB : A.C) + cb;
  if constexpr (FIXED) {
    load_row<CB>(q, v);
  } else {
#pragma unroll
    for (int i = 0; i < CB; ++i) v[i] = i < nc ? __ldg(q + i) : 0.f;
  }
}

// FIXED: C == CB, one pass, the components in registers. Otherwise C is
// A.C and each warp walks its rows once per block of CB components.
template <int CB, bool FIXED>
__global__ void __launch_bounds__(THREADS, 4) sgd_epoch_kernel(const Args A) {
  __shared__ int cmp_tail[WARPS][32];
  __shared__ int cmp_k[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = FIXED ? CB : A.C;
  const int K = A.K, np1 = A.neg + 1;
  if (A.knock & 8) return;  // the launch alone
  // a warp's rows [rb, re) of the live ones (STEP: the rows up to the last
  // one with a slot of p > 0); the loads that need no other issued first
  const bool step = A.row_off != nullptr;
  // (rows and heads below 2^31: 32-bit indices)
  const int w = blockIdx.x * WARPS + warp;
  if ((int64_t)w * A.rows_per_warp >= A.R) {
    if (step && w == 0) copy_heads(A, 0, A.n_head, lane);  // no row: every head copied
    return;
  }
  const int rb = w * A.rows_per_warp;
  const int first = head_of(A, rb);
  const int prev = step && rb > 0 ? head_of(A, rb - 1) : -1;
  // a row ahead: the next row's first 32 slots and head row, the head of
  // the row after it
  int pf_tl = 0;
  float pf_p = 0.f, pf_u = 1.f;
  load_slot(A, rb, lane, pf_tl, pf_p, pf_u);
  const int hd1_first = rb + 1 < A.R ? head_of(A, rb + 1) : -1;
  const int live = (int)(step ? A.row_off[A.n_head] : A.R);
  const int re = min(rb + A.rows_per_warp, live);
  if (rb >= live) {
    if (step && w == 0) copy_heads(A, 0, A.n_head, lane);  // no live row: every head copied
    return;
  }
  const float inv_np1 = 1.f / (float)np1;
  // the heads after the warp's rows: only its first and last heads can be
  // shared with other warps
  const int next = step && re < live ? head_of(A, re) : -1;
  const int last = head_of(A, re - 1);

  for (int cb = 0; cb < C; cb += CB) {
    const int nc = FIXED ? CB : min(CB, C - cb);
    float hv[CB], g[CB], hv_next[CB];
    // the head's sums: written (ROWS; STEP when the head's rows are all
    // this warp's), or a partial of a head shared with other warps, the
    // last of which to arrive adds the partials in warp order
    auto flush = [&](int hd) {
      float mine = 0.f, own = 0.f;
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        float v = g[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (lane == i) mine = v, own = hv[i];
      }
      const int c = cb + lane;
      if (!step) {
        if (lane < nc) A.out[(int64_t)hd * C + c] = mine;
        return;
      }
      if (!(hd == first && prev == hd) && !(hd == last && next == hd)) {
        if (lane < nc) A.out[(int64_t)hd * C + c] = own + A.alpha * mine;
        return;
      }
      const int h0 = (int)A.row_off[hd], h1 = (int)A.row_off[hd + 1];
      if (lane < nc) A.part[((int64_t)w * 2 + (h0 <= rb ? 0 : 1)) * C + c] = mine;
      if (cb + CB < C) return;  // the last pass arrives
      __threadfence();
      __syncwarp();
      const int wf = h0 / A.rows_per_warp, wl = (h1 - 1) / A.rows_per_warp;
      int is_last = 0;
      if (lane == 0) {
        is_last = atomicAdd(A.arrive + wf, 1) == (int)(wl - wf);
        if (is_last) A.arrive[wf] = 0;
      }
      if (__shfl_sync(FULL, is_last, 0)) {
        __threadfence();
        for (int cc = lane; cc < C; cc += 32) {
          float sum = 0.f;
          for (int v = wf; v <= wl; ++v)
            sum += __ldcg(A.part + ((int64_t)v * 2 + (h0 <= v * A.rows_per_warp ? 0 : 1)) * C + cc);
          A.out[(int64_t)hd * C + cc] = __ldg(A.h + (int64_t)hd * C + cc) + A.alpha * sum;
        }
      }
    };
    int cur = first;
    // heads without rows are written by the warp of the row after them
    if (step && cb == 0 && cur > prev + 1) copy_heads(A, prev + 1, cur, lane);
    load_head<CB, FIXED>(A, cur, cb, nc, hv);
#pragma unroll
    for (int i = 0; i < CB; ++i) g[i] = 0.f;
    if (cb > 0) load_slot(A, rb, lane, pf_tl, pf_p, pf_u);  // a later pass starts again
    int hd1 = rb + 1 < re ? hd1_first : -1;
    for (int r = rb; r < re; ++r) {
      const int tl0 = pf_tl;
      const float p0 = pf_p, u0 = pf_u;
      const int hr_next = hd1;
      if (r + 1 < re) {
        load_slot(A, r + 1, lane, pf_tl, pf_p, pf_u);
        load_head<CB, FIXED>(A, hr_next, cb, nc, hv_next);
        hd1 = r + 2 < re ? head_of(A, r + 2) : -1;
      }
      for (int kc = 0; kc < K; kc += 32) {
        const int k = kc + lane;
        int tl = tl0;
        float pv = p0, uv = u0;
        if (kc > 0) {
          tl = 0, pv = 0.f, uv = 1.f;
          load_slot(A, r, k, tl, pv, uv);
        }
        bool act = false;
        if (k < K) {
          if (!A.u) {
            const int64_t e = (int64_t)r * K + k;
            const uint32_t bits = mix32(mix32((uint32_t)e ^ A.key) + A.key);
            if (A.bits_out && cb == 0) A.bits_out[e] = bits;
            uv = (float)(bits >> 8) * 5.9604644775390625e-8f;  // 2^-24
          }
          act = uv < pv;
        }
        const unsigned m = __ballot_sync(FULL, act);
        if (m == 0 || (A.knock & 1)) continue;
        if (act) {
          const int rank = __popc(m & ((1u << lane) - 1u));
          cmp_tail[warp][rank] = tl;
          cmp_k[warp][rank] = k;
        }
        __syncwarp();
        const int nt = __popc(m) * np1;
        for (int t0 = 0; t0 < nt; t0 += 32) {
          const int t = t0 + lane;
          if (t < nt) {
            // term t: active slot j, sample si (0: the attractive term)
            int j = (int)(((float)t + 0.5f) * inv_np1);
            int si = t - j * np1;
            if (si < 0) {
              --j;
              si += np1;
            } else if (si >= np1) {
              ++j;
              si -= np1;
            }
            int id = cmp_tail[warp][j];
            if (si > 0 && !(A.knock & 4)) {
              int rr = r - __ldg(A.offs + si - 1);
              if (rr < 0) rr += (int)A.R;
              const int kk = cmp_k[warp][j];
              int64_t f;
              if (A.wide) {
                f = ((int64_t)rr * K + kk) % A.n_tab;
              } else {
                const uint32_t x = (uint32_t)rr * (uint32_t)K + (uint32_t)kk;
                const uint32_t th = __umulhi(x, A.tab_m);
                f = x - ((th + ((x - th) >> A.tab_s1)) >> A.tab_s2) * (uint32_t)A.n_tab;
              }
              id = __ldg(A.perm + f);
            }
            const float* q = A.src + (int64_t)id * C;
            float diff[CB];
            float d2 = 0.f;
            if constexpr (FIXED) {
              load_row<CB>(q, diff);
#pragma unroll
              for (int i = 0; i < CB; ++i) {
                diff[i] = hv[i] - diff[i];
                d2 += diff[i] * diff[i];
              }
            } else {
              const float* hrow = A.h + (int64_t)cur * C;
              for (int c = 0; c < C; ++c) {
                const float dc = __ldg(hrow + c) - __ldg(q + c);
                d2 += dc * dc;
              }
#pragma unroll
              for (int i = 0; i < CB; ++i) diff[i] = i < nc ? hv[i] - __ldg(q + cb + i) : 0.f;
            }
            if (d2 > 0.f) {
              // one division, no branch: attractive c_att (d2)^b / (d2 (a (d2)^b + 1)),
              // repulsive c_rep / ((0.001 + d2) (a (d2)^b + 1)); (d2)^(b-1) by its
              // own powf where (d2)^b is not a normal float
              const float pb = (A.knock & 2) ? d2 : powf(d2, A.b);
              const float den = A.a * pb + 1.f;
              const bool att = si == 0;
              float coef = (att ? A.c_att * pb : A.c_rep) / ((att ? d2 : 0.001f + d2) * den);
              if (att && !(pb >= FLT_MIN && pb <= FLT_MAX)) coef = A.c_att * powf(d2, A.bm1) / den;
              const float wt = att ? A.scale : 1.f;
#pragma unroll
              for (int i = 0; i < CB; ++i) g[i] += clip4(coef * diff[i]) * wt;
            }
          }
        }
        __syncwarp();  // the next chunk overwrites the compaction
      }
      if (r + 1 < re && hr_next != cur) {
        flush(cur);
        if (step && cb == 0 && hr_next > cur + 1) copy_heads(A, cur + 1, hr_next, lane);
        cur = hr_next;
#pragma unroll
        for (int i = 0; i < CB; ++i) hv[i] = hv_next[i], g[i] = 0.f;
      }
    }
    flush(cur);
    // heads without rows after the last live row's head
    if (step && cb == 0 && re == live && cur + 1 < A.n_head) copy_heads(A, cur + 1, A.n_head, lane);
  }
}

template <int CB, bool FIXED>
int launch(const Args& A, int64_t warps, cudaStream_t st) {
  const int64_t blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  sgd_epoch_kernel<CB, FIXED><<<(unsigned)blocks, THREADS, 0, st>>>(A);
  return (int)cudaGetLastError();
}

template <int CB, bool FIXED>
int resident(int* warps) {
  int dev = 0, sms = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sgd_epoch_kernel<CB, FIXED>, THREADS, 0);
  *warps = sms * blocks * WARPS;
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, gamma arrive as the f32 constants the reference multiplies by:
// bm1 = b - 1, c_att = -2ab and c_rep = 2 gamma b, each formed in double.
// u null: the slot draws are made here from seed. row_off null: the ROWS
// epilogue (h the (R, C) head rows); else STEP (h the (n_head, C)
// embedding, row_heads the rows' heads, part and arrive the workspace of
// `warps` warps, arrive zero). A warp takes rows_per_warp rows; `warps`
// warps cover the R rows. knock 0 but to measure.
extern "C" int umap_sgd_epoch_launch(const float* src, const float* h, const int64_t* row_off,
                                     const int* row_heads, const int* tails, const float* p,
                                     const int* perm, const int* offs, const float* u,
                                     uint32_t seed, uint32_t* bits_out, float* out, float* part,
                                     int* arrive, int64_t R, int64_t n_head, int K, int C, int neg,
                                     int64_t n_tab, float a, float b, float bm1, float c_att,
                                     float c_rep, float attract_scale, float alpha,
                                     int rows_per_warp, int64_t warps, int knock, void* stream) {
  if (R <= 0 && row_off == nullptr) return 0;
  if (R < 0 || R > INT32_MAX || n_head > INT32_MAX || K < 1 || C < 1 || neg < 0 || n_tab < 1 ||
      rows_per_warp < 1 || warps < 1 || warps > INT32_MAX / WARPS || warps * rows_per_warp < R)
    return (int)cudaErrorInvalidValue;
  // division by n_tab (Granlund and Montgomery): l = ceil(log2 n_tab),
  // m = floor(2^32 (2^l - n_tab) / n_tab) + 1
  int l = 0;
  while (l < 32 && (int64_t(1) << l) < n_tab) ++l;
  const uint32_t m =
      (uint32_t)((((unsigned __int128)1 << 32) * (((uint64_t)1 << l) - (uint64_t)n_tab)) / (uint64_t)n_tab + 1);
  const Args A{src, h, row_off, row_heads, tails, p, perm, offs, u, bits_out, out, part, arrive,
               R, n_head, n_tab, K, C, neg, rows_per_warp,
               (R + 1) * K > (int64_t)UINT32_MAX || n_tab > (int64_t)UINT32_MAX,
               mix32(seed + 0x9e3779b9u), m, l < 1 ? l : 1, l > 1 ? l - 1 : 0, a, b, bm1, c_att,
               c_rep, attract_scale, alpha, knock};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1, true>(A, warps, st);
    case 2: return launch<2, true>(A, warps, st);
    case 3: return launch<3, true>(A, warps, st);
    case 4: return launch<4, true>(A, warps, st);
    case 5: return launch<5, true>(A, warps, st);
    case 6: return launch<6, true>(A, warps, st);
    case 7: return launch<7, true>(A, warps, st);
    case 8: return launch<8, true>(A, warps, st);
    default: return launch<GENERIC_BLOCK, false>(A, warps, st);
  }
}

// Warps of the instance for C resident on the whole card at once.
extern "C" int umap_sgd_epoch_resident_warps(int C, int* warps) {
  switch (C) {
    case 1: return resident<1, true>(warps);
    case 2: return resident<2, true>(warps);
    case 3: return resident<3, true>(warps);
    case 4: return resident<4, true>(warps);
    case 5: return resident<5, true>(warps);
    case 6: return resident<6, true>(warps);
    case 7: return resident<7, true>(warps);
    case 8: return resident<8, true>(warps);
    default: return resident<GENERIC_BLOCK, false>(warps);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
