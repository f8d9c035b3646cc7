// Kernel K17: the device-metrics fold, cpr_tpu/device_metrics.py's cell
// algebra (MetricsSpec.count / observe / observe_hist, fold_episode_stats,
// update_rollout, the serve and PPO cells) over tensors that other kernels
// already wrote, added into one flat accumulator buffer.
//
// Replaces: cpr_tpu/device_metrics.py:56-218 (`MetricsSpec`), folded in
// cpr_tpu/envs/base.py:303-328, :403-451, :506-592,
// cpr_tpu/serve/engine.py:311-320 and cpr_tpu/train/ppo.py:217-248.
// Plain twin: cpr_tpu_torch/device_metrics.py `fold_plain`.
//
// The accumulator is the spec's flat buffer of 32-bit words: counters and
// histogram bins are int32 sums that wrap at 2^32 as XLA's do; a stats
// cell is four float32 words (min, max, sum, count) laid out as four
// blocks of the spec's stats cells (`n_stats` words apart). One launch
// folds a table of up to kMaxCells cells:
//
//   kCount      word += scale * sum(x)            (x int32 or bool;
//                                                  x null: n * scale)
//   kNonfinite  word += scale * #rows with a nonfinite element among
//               their row_len elements (row_len 1: each element)
//   kStats      min/max (NaN-propagating, as jnp.minimum/maximum), sum,
//               count over the masked elements; the unmasked elements'
//               nonfinite count into counter word dst2 when dst2 >= 0
//               (fold_episode_stats' nonfinite_stats, read in the same
//               pass); x null: one observation of `value`
//   kHist       bin i counts the masked elements in [e[i-1], e[i]), NaN
//               and +inf in the overflow bin: jnp.searchsorted(edges, x,
//               side="right")
//
// Masks select `where` as the reference does: a masked-out NaN stays out
// of min/max (where(w, x, inf)); an empty cell keeps min +inf, max -inf
// and count 0. A mask is bool, or int32 read as `m != 0`, jnp.where's
// truth (the episode drivers pass n_episodes itself for has_ep =
// n_episodes > 0, without a glue launch).
//
// Bound: bytes. Every input is read once (kStats reads its values once
// for both its cell and its nonfinite count); the accumulator is a few
// dozen words. Design: each cell gets a fixed number of blocks from the
// wrapper, each block a contiguous range of rows; a block reduces its
// range in a fixed order (per thread in row order, then warp shuffles,
// then warps in order) and writes 32 partial words to scratch. The last
// block to arrive (an integer ticket, zeroed before the launch) reduces
// every cell's partials in block order, a warp a word, and one thread
// merges the cells into the accumulator in table order, so two cells may
// add into one word. No float atomics: a fold gives the same bits on
// every run. Its float sums follow this order, not XLA's; counters,
// bins, min, max and count are exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 24;
constexpr int kEdgePool = 64;
constexpr int kWords = 32;  // partial words a block; bins of a hist

enum Kind : int32_t { kCount = 0, kNonfinite = 1, kStats = 2, kHist = 3 };
enum XType : int32_t { kF32 = 0, kI32 = 1, kBool = 2 };
enum MType : int32_t { kNoMask = 0, kMaskBool = 1, kMaskInt = 2 };

struct Cell {
  const void* x;     // null: an immediate cell
  const void* mask;  // null: no mask
  int64_t n;         // rows
  int64_t stride;    // elements of x between rows
  int64_t mstride;   // elements of mask between rows
  int32_t row_len;   // elements of a row (kNonfinite only; else 1)
  int32_t kind, xtype, mtype;
  int32_t scale;     // counter increment a unit
  float value;       // an immediate kStats cell's observation
  int32_t dst;       // counter or first bin word; stats: its min word
  int32_t dst2;      // kStats: counter word of its nonfinite count, or -1
  int32_t n_stats;   // kStats: words between min, max, sum and count
  int32_t n_edges, edge_off;
  int32_t first_block, n_blocks;
};

struct Table {
  int32_t n_cells, n_blocks;
  float edges[kEdgePool];
  Cell cells[kMaxCells];
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// jnp.minimum / jnp.maximum: NaN in either argument gives NaN (fminf and
// fmaxf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

__device__ __forceinline__ float load_f(const Cell& c, int64_t i) {
  if (c.xtype == kF32) return __ldg(static_cast<const float*>(c.x) + i);
  if (c.xtype == kI32)
    return (float)__ldg(static_cast<const int32_t*>(c.x) + i);
  return static_cast<const uint8_t*>(c.x)[i] ? 1.f : 0.f;
}

__device__ __forceinline__ uint32_t load_u(const Cell& c, int64_t i) {
  if (c.xtype == kI32)
    return (uint32_t)__ldg(static_cast<const int32_t*>(c.x) + i);
  return static_cast<const uint8_t*>(c.x)[i] ? 1u : 0u;
}

__device__ __forceinline__ bool load_m(const Cell& c, int64_t r) {
  if (c.mtype == kNoMask) return true;
  const int64_t i = r * c.mstride;
  if (c.mtype == kMaskBool) return static_cast<const uint8_t*>(c.mask)[i] != 0;
  return __ldg(static_cast<const int32_t*>(c.mask) + i) != 0;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// op 0 min, 1 max, 2 sum
__device__ __forceinline__ float warp_fold(float v, int op) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_down_sync(0xffffffffu, v, o);
    v = op == 0 ? nan_min(v, w) : op == 1 ? nan_max(v, w) : v + w;
  }
  return v;
}

// words of a cell's partial
__device__ __forceinline__ int cell_words(const Cell& c) {
  return c.kind == kHist ? c.n_edges + 1 : c.kind == kStats ? 5 : 1;
}

// One block's range of one cell -> its 32 partial words.
__device__ void block_partial(const Table& tab, const Cell& c, int b,
                              uint32_t* __restrict__ out) {
  __shared__ uint32_t s_hist[kWords];
  __shared__ float s_f[3][kWarps];
  __shared__ uint32_t s_u[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t per = (c.n + c.n_blocks - 1) / c.n_blocks;
  const int64_t lo = (int64_t)(b - c.first_block) * per;
  const int64_t hi = lo + per < c.n ? lo + per : c.n;
  if (c.kind == kHist) {
    for (int i = tid; i < kWords; i += kThreads) s_hist[i] = 0u;
    __syncthreads();
    for (int64_t r = lo + tid; r < hi; r += kThreads) {
      if (!load_m(c, r)) continue;
      const float v = load_f(c, r * c.stride);
      int bin = c.n_edges;  // NaN: searchsorted's len(edges)
      if (v == v) {
        bin = 0;
        for (int e = 0; e < c.n_edges; ++e)
          bin += tab.edges[c.edge_off + e] <= v ? 1 : 0;
      }
      atomicAdd(&s_hist[bin], 1u);
    }
    __syncthreads();
    for (int i = tid; i < kWords; i += kThreads) out[i] = s_hist[i];
    return;
  }
  float mn = __int_as_float(0x7f800000), mx = -mn, sm = 0.f;
  uint32_t ct = 0u, nf = 0u;
  for (int64_t r = lo + tid; r < hi; r += kThreads) {
    if (c.kind == kCount) {
      ct += load_u(c, r * c.stride);
    } else if (c.kind == kNonfinite) {
      bool bad = false;
      for (int k = 0; k < c.row_len; ++k)
        bad |= !isfinite(load_f(c, r * c.stride + k));
      ct += bad ? 1u : 0u;
    } else {
      const float v = load_f(c, r * c.stride);
      nf += isfinite(v) ? 0u : 1u;
      if (load_m(c, r)) {
        mn = nan_min(mn, v);
        mx = nan_max(mx, v);
        sm = sm + v;
        ct += 1u;
      }
    }
  }
  mn = warp_fold(mn, 0);
  mx = warp_fold(mx, 1);
  sm = warp_fold(sm, 2);
  ct = warp_sum(ct);
  nf = warp_sum(nf);
  if (lane == 0) {
    s_f[0][warp] = mn;
    s_f[1][warp] = mx;
    s_f[2][warp] = sm;
    s_u[0][warp] = ct;
    s_u[1][warp] = nf;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mn = nan_min(mn, s_f[0][w]);
      mx = nan_max(mx, s_f[1][w]);
      sm = sm + s_f[2][w];
      ct += s_u[0][w];
      nf += s_u[1][w];
    }
    if (c.kind == kStats) {
      out[0] = __float_as_uint(mn);
      out[1] = __float_as_uint(mx);
      out[2] = __float_as_uint(sm);
      out[3] = ct;
      out[4] = nf;
    } else {
      out[0] = ct;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
metrics_fold_kernel(const __grid_constant__ Table tab,
                    uint32_t* __restrict__ acc,
                    uint32_t* __restrict__ partial,
                    unsigned int* __restrict__ ticket) {
  __shared__ uint32_t s_res[kMaxCells][kWords];
  __shared__ bool s_last;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (b < tab.n_blocks) {
    int ci = 0;
    for (int j = 0; j < tab.n_cells; ++j) {
      const Cell& cj = tab.cells[j];
      if (cj.n_blocks > 0 && b >= cj.first_block &&
          b < cj.first_block + cj.n_blocks)
        ci = j;
    }
    block_partial(tab, tab.cells[ci], b, partial + (size_t)b * kWords);
  }
  // the last block to arrive folds every cell
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each (cell, word) reduced over the cell's blocks by one warp: lane l
  // takes blocks l, l + 32, ... in order, then a fixed shuffle tree
  for (int p = warp; p < tab.n_cells * kWords; p += kWarps) {
    const int ci = p / kWords, w = p % kWords;
    const Cell& c = tab.cells[ci];
    if (c.n_blocks == 0 || w >= cell_words(c)) continue;
    const uint32_t* src = partial + (size_t)c.first_block * kWords + w;
    if (c.kind == kStats && w < 3) {
      float r = w == 0 ? __int_as_float(0x7f800000)
              : w == 1 ? __int_as_float(0xff800000) : 0.f;
      for (int j = lane; j < c.n_blocks; j += 32) {
        const float v = __uint_as_float(__ldcg(src + (size_t)j * kWords));
        r = w == 0 ? nan_min(r, v) : w == 1 ? nan_max(r, v) : r + v;
      }
      r = warp_fold(r, w);
      if (lane == 0) s_res[ci][w] = __float_as_uint(r);
    } else {
      uint32_t r = 0u;
      for (int j = lane; j < c.n_blocks; j += 32)
        r += __ldcg(src + (size_t)j * kWords);
      r = warp_sum(r);
      if (lane == 0) s_res[ci][w] = r;
    }
  }
  __syncthreads();
  if (tid != 0) return;
  float* f = reinterpret_cast<float*>(acc);
  for (int ci = 0; ci < tab.n_cells; ++ci) {
    const Cell& c = tab.cells[ci];
    const bool imm = c.x == nullptr;
    if (c.kind == kCount || c.kind == kNonfinite) {
      const uint32_t t = imm ? (uint32_t)(uint64_t)(c.n * (int64_t)c.scale)
                             : s_res[ci][0] * (uint32_t)c.scale;
      acc[c.dst] += t;
    } else if (c.kind == kHist) {
      if (!imm)
        for (int w = 0; w <= c.n_edges; ++w) acc[c.dst + w] += s_res[ci][w];
    } else {
      float mn, mx, sm;
      uint32_t ct, nf;
      if (imm) {
        mn = mx = sm = c.value;
        ct = 1u;
        nf = isfinite(c.value) ? 0u : 1u;
      } else {
        mn = __uint_as_float(s_res[ci][0]);
        mx = __uint_as_float(s_res[ci][1]);
        sm = __uint_as_float(s_res[ci][2]);
        ct = s_res[ci][3];
        nf = s_res[ci][4];
      }
      const int S = c.n_stats;
      f[c.dst] = nan_min(f[c.dst], mn);
      f[c.dst + S] = nan_max(f[c.dst + S], mx);
      f[c.dst + 2 * S] = f[c.dst + 2 * S] + sm;
      f[c.dst + 3 * S] = f[c.dst + 3 * S] + (float)ct;
      if (c.dst2 >= 0) acc[c.dst2] += nf;
    }
  }
}

}  // namespace

extern "C" {

// K17 launch: fold the Table's cells into `acc` (the spec's flat
// buffer). `scratch` holds kWords * (n_blocks + 1) words: the ticket,
// then each block's partial words.
cudaError_t cpr_k17_fold(const void* table, void* acc, void* scratch,
                         void* stream) {
  const Table* tab = static_cast<const Table*>(table);
  if (tab->n_cells <= 0) return cudaSuccess;
  if (tab->n_cells > kMaxCells) return cudaErrorInvalidValue;
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(s, 0, sizeof(uint32_t), st);
  if (e != cudaSuccess) return e;
  const int grid = tab->n_blocks > 0 ? tab->n_blocks : 1;
  metrics_fold_kernel<<<grid, kThreads, 0, st>>>(
      *tab, static_cast<uint32_t*>(acc), s + kWords, s);
  return cudaGetLastError();
}

// sizeof(Table): the wrapper holds its ctypes layout to it
int cpr_k17_table_bytes() { return (int)sizeof(Table); }

const char* cpr_k17_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
