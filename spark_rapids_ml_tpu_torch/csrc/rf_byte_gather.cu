// Byte gather from word-packed bins (kernels K7 and K8).
//
// Each row r carries its uint8 bins packed four to an int32 word (byte j of
// word w is bin 4w + j, the little-endian bytes of the bin row). For G index
// sets idx[g] (n, k) the kernel computes
//   out[g, r, j] = (packed[r, idx >> 2] >> (8 * (idx & 3))) & 0xFF,  idx = idx[g, r, j]
// and 0 where idx lies outside [0, 4 * words): the sentinel rule of the JAX
// package's compare-select contraction (_contract_gather), which matches no
// word there. Every value is an integer, so the result equals any other
// evaluation of the same gather bit for bit.
//
// Replaces spark_rapids_ml_tpu/ops/rf_pallas.py::packed_byte_gather_many (the
// pl.pallas_call at rf_pallas.py:727, kernel K8) and, with G = 1,
// packed_byte_gather (rf_pallas.py:507, kernel K7). The TPU kernels select the
// word with one in-register lane shuffle of a (2048, W) block and fetch every
// packed row G times (grid G-major); nothing of that is carried over.
//
// What bounds it on an H100: the bytes. idx is read once and out written once
// (4 bytes each per entry), the packed rows once: at the RF bench forest's
// two-hop shape (G = 8 trees, 131,072 rows, k = 63, 64 words a row) 264 MB
// in, 264 MB out and 34 MB of rows, 0.168 ms at 3.35 TB/s. Two index/output
// streams and a dependent lookup per entry need many bytes in flight: by
// Little's law ~20 KB an SM at ~0.7 us of DRAM latency. One thread an entry
// with four entries a thread (the first port) reached 1.7-2.5 TB/s.
//
// Design. A block owns a chunk of R consecutive rows (R a multiple of 4) and
// all G index sets for them: G spans of R * k consecutive entries. A thread
// loads AHEAD 16-byte vectors of idx (four entries each, neighbouring
// threads on neighbouring addresses, streaming loads) before its first
// lookup, and stores its four bytes a vector with a streaming store: 64 B a
// thread, 64 KB an SM in flight at 4 blocks of 256 threads. A vector's set
// and row come from multiply-shift divisions (FastDiv) and a running column,
// not a division an entry. The head and tail of a set's span that are not
// 16-byte aligned (a set's base is aligned only when n * k % 4 == 0) go
// through scalar accesses. Instances:
//   direct: lookups read the packed word with __ldg; G inside the block, so
//     a chunk's rows reach one SM's L1 once for all G sets;
//   staged: the chunk's rows (contiguous, R * words * 4 bytes) arrive in
//     shared memory by 16-byte cp.async, two stages, the next chunk's while
//     this one's lookups are served; for dense gathers (many lookups for
//     each 32-byte sector of a row), where it matched or beat direct;
//   each in a vector form (idx and out 16-byte aligned) and a scalar form
//   (a base off 16-byte alignment).
// A grid of one wave of resident blocks walks the chunks; with many waves
// of chunks each block takes one (the block scheduler then balances them).
// The routing and every size (R, grid, shared memory) come from the caller
// (ops/rf_kernels.py::_gather_geometry, set from sweeps on the card); this
// file does not choose again.
//
// ptxas (-Xptxas -v, _build/rf_byte_gather.log, CUDA 12.8, sm_90a, at most
// 64 registers by __launch_bounds__(256, 4)): staged vector 62 registers,
// staged scalar 44, direct vector 62, direct scalar 32; no spills; staged
// shared memory is dynamic, two stages of R rows. With AHEAD = 8 the vector
// forms spilled 88-168 B, their index loads among them, so the loads did
// not overlap (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM: at most 64 registers
constexpr int AHEAD = 4;       // idx loads a thread issues before its first lookup
constexpr uint32_t NONE = 0xffffffffu;

// x / d for x < 2^31 by a multiply and a shift (Granlund and Montgomery):
// s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1, x / d = (umulhi(x, m) + x) >> s.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_div(uint32_t d) {
  if (d == 0) return {0u, 1u, 0u};  // divides nothing: its loop is empty
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, (uint32_t)m, s};
}

__device__ __forceinline__ uint32_t fdiv(const FastDiv& f, uint32_t x) {
  return (__umulhi(x, f.m) + x) >> f.s;
}

struct Args {
  const int32_t* packed;
  const int32_t* idx;
  int32_t* out;
  int64_t n, nk, chunks;
  int words, k, G, R;
  uint32_t limit;  // 4 * words: an index at or past it (or below 0) reads 0
  FastDiv kdiv;    // by k: an entry's row within its chunk
  // by a set's item count in a full chunk and in the last one: vectors
  // (span / 4) in the vector instances, entries (span) in the scalar ones
  FastDiv full, last;
};

// byte j of local row `row` (of a stage, or of the chunk's first row in
// packed; R * words < 2^31, so the word's index takes 32 bits)
template <bool STAGED>
__device__ __forceinline__ int byte_at(const Args& a, const int32_t* __restrict__ rows, uint32_t row, int j) {
  if ((uint32_t)j >= a.limit) return 0;
  const int32_t* p = rows + (row * (uint32_t)a.words + ((uint32_t)j >> 2));
  const uint32_t w = STAGED ? (uint32_t)*p : (uint32_t)__ldg(p);
  return (int)((w >> ((j & 3) * 8)) & 0xFFu);
}

// entries of set g's span in chunk (offset `base` in a set) before its
// first 16-byte boundary: the low bits of g * nk + base, in 32 bits
__device__ __forceinline__ uint32_t head(const Args& a, uint32_t g, int64_t base, uint32_t span) {
  return min((0u - (g * (uint32_t)a.nk + (uint32_t)base)) & 3u, span);
}

// every entry of chunk c's G spans
template <bool STAGED, bool VEC>
__device__ __forceinline__ void serve(const Args& a, const int32_t* __restrict__ rows, int64_t c) {
  const int64_t r0 = c * a.R;
  const uint32_t span = (uint32_t)(min((int64_t)a.R, a.n - r0) * a.k);  // entries a set
  const FastDiv cd = c == a.chunks - 1 ? a.last : a.full;
  const int64_t base = r0 * a.k;  // offset of the chunk's first entry in a set
  const uint32_t nq = (uint32_t)a.G * cd.d;
  for (uint32_t q0 = threadIdx.x; q0 < nq; q0 += AHEAD * THREADS) {
    // the loads, all before the first lookup; an item keeps its set and
    // its offset in the set's span (NONE: past the end)
    uint32_t g[AHEAD], L[AHEAD];
    int4 v[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const uint32_t q = q0 + u * THREADS;
      g[u] = fdiv(cd, q);
      const uint32_t it = q - g[u] * cd.d;
      if (VEC) {
        const uint32_t h = head(a, g[u], base, span);
        L[u] = q < nq && it < (span - h) >> 2 ? h + 4 * it : NONE;
      } else {
        L[u] = q < nq ? it : NONE;
      }
      if (L[u] != NONE) {
        const int32_t* src = a.idx + ((int64_t)g[u] * a.nk + base + L[u]);
        if (VEC)
          v[u] = __ldcs(reinterpret_cast<const int4*>(src));
        else
          v[u].x = __ldcs(src);
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (L[u] == NONE) continue;
      int32_t* dst = a.out + ((int64_t)g[u] * a.nk + base + L[u]);
      uint32_t row = fdiv(a.kdiv, L[u]);
      if (VEC) {
        uint32_t col = L[u] - row * a.k;
        int r[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r[i] = byte_at<STAGED>(a, rows, row, r[i]);
          if (++col == (uint32_t)a.k) {
            col = 0;
            ++row;
          }
        }
        __stcs(reinterpret_cast<int4*>(dst), make_int4(r[0], r[1], r[2], r[3]));
      } else {
        __stcs(dst, byte_at<STAGED>(a, rows, row, v[u].x));
      }
    }
  }
  if (VEC) {  // each set's unaligned head (slots 0-3) and tail (slots 4-7)
    for (uint32_t q = threadIdx.x; q < (uint32_t)a.G * 8u; q += THREADS) {
      const uint32_t slot = q & 7u, g = q >> 3;
      const uint32_t h = head(a, g, base, span);
      const uint32_t L = slot < 4 ? slot : h + ((span - h) & ~3u) + (slot - 4);
      if (slot < 4 ? L >= h : L >= span) continue;
      const int64_t e = (int64_t)g * a.nk + base + L;
      __stcs(a.out + e, byte_at<STAGED>(a, rows, fdiv(a.kdiv, L), __ldcs(a.idx + e)));
    }
  }
}

__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// chunk c's rows into a stage: 16-byte copies (the chunk starts at row
// c * R, R a multiple of 4, so at a 16-byte boundary of an aligned base),
// then the last chunk's words past the last whole vector
__device__ __forceinline__ void load_stage(const Args& a, int32_t* stage, int64_t c) {
  const int64_t r0 = c * a.R;
  const int32_t* src = a.packed + r0 * a.words;
  const uint32_t count = (uint32_t)(min((int64_t)a.R, a.n - r0) * a.words);
  const uint32_t nvec = count >> 2;
  for (uint32_t i = threadIdx.x; i < nvec; i += THREADS) cp_async16(stage + 4 * i, src + 4 * i);
  for (uint32_t i = 4 * nvec + threadIdx.x; i < count; i += THREADS) cp_async4(stage + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) gather_staged(const Args a) {
  extern __shared__ int4 smem4[];
  int32_t* stage = reinterpret_cast<int32_t*>(smem4);
  const int64_t stage_ints = (int64_t)a.R * a.words;
  int64_t c = blockIdx.x;
  if (c < a.chunks) load_stage(a, stage, c);
  for (int s = 0; c < a.chunks; c += gridDim.x, s ^= 1) {
    const int64_t next = c + gridDim.x;
    if (next < a.chunks) {
      load_stage(a, stage + (s ^ 1) * stage_ints, next);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // every thread's copies of this stage have landed
    serve<true, VEC>(a, stage + s * stage_ints, c);
    __syncthreads();  // nobody reads the stage the next copy goes into
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) gather_direct(const Args a) {
  for (int64_t c = blockIdx.x; c < a.chunks; c += gridDim.x)
    serve<false, VEC>(a, a.packed + c * a.R * a.words, c);
}

// the staged forms may take the device's opt-in shared memory, and prefer
// shared memory over L1 (their streams do not allocate in L1); set once
bool staged_ready[2] = {false, false};

template <bool VEC>
cudaError_t ready_staged() {
  if (staged_ready[VEC]) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_staged<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_staged<VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  staged_ready[VEC] = e == cudaSuccess;
  return e;
}

template <bool VEC>
cudaError_t launch_staged(const Args& a, int grid, int smem, cudaStream_t s) {
  const cudaError_t e = ready_staged<VEC>();
  if (e != cudaSuccess) return e;
  gather_staged<VEC><<<grid, THREADS, smem, s>>>(a);
  return cudaSuccess;
}

}  // namespace

// A launch's sizes (ops/rf_kernels.py::_Plan). instance: bit 1 staged (else
// direct), bit 0 the vector form (idx and out 16-byte aligned; staged also
// needs packed aligned). R rows a chunk (a multiple of 4, G * R * k < 2^31,
// R * words < 2^31), `grid` blocks, `smem` bytes of two stages (staged).
struct Plan {
  int64_t n;
  int words, k, G, instance, R, grid, smem;
};

// packed (n, words) int32, idx (G, n, k) int32, out (G, n, k) int32; all
// contiguous.
extern "C" int packed_byte_gather_launch(const int32_t* packed, const int32_t* idx, int32_t* out,
                                         const Plan* p, void* stream) {
  const int64_t n = p->n;
  const int words = p->words, k = p->k, G = p->G, R = p->R;
  if (n <= 0 || k <= 0 || G <= 0) return 0;
  if (words < 1 || words > (1 << 29) || R < 4 || R % 4 || p->grid < 1 || p->instance < 0 || p->instance > 3 ||
      (int64_t)G * R * k >= (1ll << 31) || (int64_t)R * words >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const bool staged = p->instance & 2, vec = p->instance & 1;
  if (staged && (int64_t)p->smem < 2 * (int64_t)R * words * 4) return (int)cudaErrorInvalidValue;
  Args a;
  a.packed = packed;
  a.idx = idx;
  a.out = out;
  a.n = n;
  a.nk = n * k;
  a.chunks = (n + R - 1) / R;
  a.words = words;
  a.k = k;
  a.G = G;
  a.R = R;
  a.limit = 4u * (uint32_t)words;
  a.kdiv = make_div((uint32_t)k);
  const uint32_t span_full = (uint32_t)R * k;
  const uint32_t span_last = (uint32_t)((n - (a.chunks - 1) * R) * k);
  a.full = make_div(vec ? span_full >> 2 : span_full);
  a.last = make_div(vec ? span_last >> 2 : span_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (staged)
    e = vec ? launch_staged<true>(a, p->grid, p->smem, s) : launch_staged<false>(a, p->grid, p->smem, s);
  else if (vec)
    gather_direct<true><<<p->grid, THREADS, 0, s>>>(a);
  else
    gather_direct<false><<<p->grid, THREADS, 0, s>>>(a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// for the geometry: the SM count, the shared memory a block may opt into,
// and the blocks an SM holds by registers and threads (the fewest of the
// four forms, with no shared memory)
extern "C" int packed_byte_gather_device(int device, int* sms, int* smem_optin, int* resident) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int b[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b[0], gather_direct<false>, THREADS, 0);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b[1], gather_direct<true>, THREADS, 0);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b[2], gather_staged<false>, THREADS, 0);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b[3], gather_staged<true>, THREADS, 0);
  *resident = min(min(b[0], b[1]), min(b[2], b[3]));
  return (int)e;
}

// resident blocks an SM of one form at `smem` bytes of shared memory (the
// geometry's assumption, checked on the card)
extern "C" int packed_byte_gather_occupancy(int instance, int smem, int* blocks) {
  cudaError_t e = cudaSuccess;
  if (instance & 2) e = (instance & 1) ? ready_staged<true>() : ready_staged<false>();
  if (e != cudaSuccess) return (int)e;
  switch (instance) {
    case 0: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_direct<false>, THREADS, smem);
    case 1: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_direct<true>, THREADS, smem);
    case 2: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_staged<false>, THREADS, smem);
    default: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_staged<true>, THREADS, smem);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
