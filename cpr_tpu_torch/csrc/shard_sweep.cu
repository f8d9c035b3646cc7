// Kernels K16-state, K16-psum and K16-grid: the Bellman sweeps of the
// sharded value-iteration solvers, one launch a shard.
//
// Replaces:
//   K16-state: cpr_tpu/parallel/state_shard.py:195-216 `make_chunk_fn` (a
//       shard's `make_vi_sweep` over its block of states with local src
//       ids, the two all_gathers of the block's value and progress a
//       sweep, the all_gather of the policy a chunk), as driven by
//       `sharded_state_value_iteration` (:128-266);
//   K16-psum: cpr_tpu/parallel/__init__.py:196-235 (`vi_while_loop` and
//       `make_vi_chunk` with `reduce=psum`: each shard's partial Q planes
//       over its transition chunk, summed over the shards, then the
//       greedy backup), as driven by `sharded_value_iteration`;
//   K16-grid: cpr_tpu/parallel/state_shard.py:319-357 (`body`: a
//       [G_blk, t_blk] segment sum, the vmapped `_greedy_backup`, the
//       all_gather on the state axis, the freeze), as driven by
//       `make_grid_state_chunk_step` (:269-373).
// Plain twins: cpr_tpu_torch/parallel/state_shard.py
// `_state_block_sweep_plain`, `_grid_state_chunk_plain`;
// cpr_tpu_torch/parallel/__init__.py `_PsumPlain.sweep`.
//
// Layout: each state shard's block is a sorted table of its own
// (mdp_table.cuh; `parallel.state_shard.Block`) over its s_blk states
// with local src ids, whose dst index the replicated vectors of length
// n_vec (S or S_pad). A shard reads the whole replicated value and
// progress vectors and writes its slice [off, off + s_blk) of the next
// ones (a Jacobi sweep, as K4's); on one card every shard shares the
// replicated buffers, so the all_gather is the write itself. K16-psum
// reads the whole sorted table, split into n contiguous row ranges.
//
// Bound: memory, as K4: every row once, the segment index, the [S]
// vectors; K16-psum moreover writes and reads the shards' partial planes
// of the segments their row ranges touch.
//
// Design: one thread a state, K4's per-state backup (`backup_state`), so
// K16-state at any shard count computes K4's floats, and K16-grid K7's.
// A shard's max |V' - V| of sweep j goes to its own slot dbits[j] by an
// atomicMax on the bits (values >= 0; a max is order-free), and the
// sweep's delta is the max over the shards' slots: the reference's max
// over the gathered vector, pad states included (they stay 0). K16-psum
// runs two launches a sweep: (a) one thread a segment of the shard's row
// range, writing the segment's partial sums of its rows, in row order,
// into the shard's planes (indexed by segment: the [S, A] plane's
// non-empty entries; the planes of segments a range does not touch are
// never written and stay 0); (b) one thread a state, which sums the
// partials of the shards that touch each segment in shard order, then
// K4's greedy backup under the table's segment validity (a segment is
// valid when any shard's rows carry mass), the delta and K4's loop
// control (`finish_sweep`).

#include <cuda_runtime.h>

#include <cstdint>

#include "mdp_table.cuh"

namespace cpr {

// One state shard on the card: its block table, its first state in the
// replicated vectors and its delta slots [steps].
struct StateShard {
  SweepTable tb;
  int64_t off;
  unsigned long long* dbits;
};

// One grid x state shard: its state block (probe column unused), its
// points' probability columns [G_blk, n_rows] in the block's row order
// and segment validity [G_blk, n_seg], the live points among them (local
// ids), its first point g0 and first state off in the [G, n_vec] planes,
// and its delta slots [G_blk, steps].
struct GridShard {
  SweepTable tb;
  const void* probs;
  const uint8_t* valid;
  const int32_t* live;
  int32_t n_live;
  int32_t pad;
  int64_t n_rows;
  int64_t n_seg;
  int64_t g0;
  int64_t off;
  unsigned long long* dbits;
};

}  // namespace cpr

namespace {

using cpr::add_rn;
using cpr::backup_state;
using cpr::bits_of;
using cpr::mul_rn;

constexpr int kThreads = cpr::kSweepThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    state_block_kernel(cpr::StateShard sh, T discount, const T* __restrict__ V,
                       const T* __restrict__ P, T* __restrict__ V2,
                       T* __restrict__ P2, int32_t* __restrict__ pol, int j) {
  const int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  T d = 0;
  if (s < sh.tb.n_states) {
    T bv, bp;
    const int best =
        backup_state<T>(sh.tb, static_cast<const T*>(sh.tb.prob),
                        sh.tb.seg_valid, s, discount, V, P, bv, bp);
    const int64_t g = sh.off + s;
    V2[g] = bv;
    P2[g] = bp;
    pol[g] = best;
    d = fabs(bv - V[g]);
  }
  const unsigned long long b = cpr::block_max_bits(bits_of(d));
  if (threadIdx.x == 0) atomicMax(&sh.dbits[j], b);
}

// K16-psum (a): segment k0 + thread of the rows [r0, r1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    psum_partial_kernel(cpr::SweepTable tb, const int64_t* __restrict__ stop,
                        int64_t r0, int64_t r1, int64_t k0, int64_t k1,
                        T discount, const T* __restrict__ V,
                        const T* __restrict__ P, T* __restrict__ qv,
                        T* __restrict__ qp) {
  if (stop != nullptr && stop[2]) return;  // the while loop has stopped
  const int64_t k = k0 + blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (k >= k1) return;
  const T* __restrict__ prob = static_cast<const T*>(tb.prob);
  const T* __restrict__ reward = static_cast<const T*>(tb.reward);
  const T* __restrict__ progress = static_cast<const T*>(tb.progress);
  const int64_t lo = max((int64_t)tb.seg_ptr[k], r0);
  const int64_t hi = min((int64_t)tb.seg_ptr[k + 1], r1);
  T sv = 0, sp = 0;
  for (int64_t r = lo; r < hi; ++r) {
    const int j = tb.dst[r];
    const T pr = prob[r];
    sv = add_rn(sv, mul_rn(pr, add_rn(reward[r], mul_rn(discount, V[j]))));
    sp = add_rn(sp, mul_rn(pr, add_rn(progress[r], mul_rn(discount, P[j]))));
  }
  qv[k] = sv;
  qp[k] = sp;
}

// The shards' partial planes: plane b of n at qv[b], qp[b].
template <typename T>
struct Planes {
  const T* qv[8];
  const T* qp[8];
};

// K16-psum (b): the shards' partials summed, the greedy backup, the
// delta and the loop control. Shard b holds rows [b * chunk, (b + 1) *
// chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    psum_backup_kernel(cpr::SweepTable tb, cpr::LoopCtl c, Planes<T> pl,
                       int64_t chunk, const T* __restrict__ V,
                       T* __restrict__ V2, T* __restrict__ P2,
                       int32_t* __restrict__ pol) {
  if (c.ctl[2]) return;
  const int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  T d = 0;
  if (s < tb.n_states) {
    int best = -1;
    T bv = 0, bp = 0;
    for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
      if (!tb.seg_valid[k]) continue;
      const int b0 = (int)(tb.seg_ptr[k] / chunk);
      const int b1 = (int)((tb.seg_ptr[k + 1] - 1) / chunk);
      T qv = pl.qv[b0][k], qp = pl.qp[b0][k];
      for (int b = b0 + 1; b <= b1; ++b) {
        qv = add_rn(qv, pl.qv[b][k]);
        qp = add_rn(qp, pl.qp[b][k]);
      }
      if (best < 0 || qv > bv) {
        best = tb.seg_act[k];
        bv = qv;
        bp = qp;
      }
    }
    V2[s] = bv;
    P2[s] = bp;
    pol[s] = best;
    d = fabs(bv - V[s]);
  }
  cpr::finish_sweep<T>(d, c);
}

// K16-grid: a block is (live point, 256 states of the shard's block), the
// point varying fastest, as K7's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grid_block_kernel(cpr::GridShard sh, int64_t n_vec, T discount,
                      const T* __restrict__ V, const T* __restrict__ P,
                      T* __restrict__ V2, T* __restrict__ P2,
                      int32_t* __restrict__ pol, int steps, int j) {
  const int gl = sh.live[blockIdx.x % sh.n_live];
  const int64_t s =
      (blockIdx.x / sh.n_live) * (int64_t)kThreads + threadIdx.x;
  const T* __restrict__ prob = static_cast<const T*>(sh.probs) + gl * sh.n_rows;
  const uint8_t* __restrict__ vld = sh.valid + gl * sh.n_seg;
  const int64_t row = (sh.g0 + gl) * n_vec;
  T d = 0;
  if (s < sh.tb.n_states) {
    T bv, bp;
    const int best = backup_state<T>(sh.tb, prob, vld, s, discount, V + row,
                                     P + row, bv, bp);
    const int64_t g = row + sh.off + s;
    V2[g] = bv;
    P2[g] = bp;
    pol[g] = best;
    d = fabs(bv - V[g]);
  }
  const unsigned long long b = cpr::block_max_bits(bits_of(d));
  if (threadIdx.x == 0) atomicMax(&sh.dbits[(int64_t)gl * steps + j], b);
}

unsigned blocks_of(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t state_sweeps(const cpr::StateShard* sh, int n, double discount,
                         void* const* v, void* const* p, void* pol,
                         int64_t first, int count, cudaStream_t st) {
  for (int i = 0; i < count; ++i) {
    const int a = (int)((first + i) & 1), b = a ^ 1;
    for (int k = 0; k < n; ++k) {
      if (sh[k].tb.n_states <= 0) continue;
      state_block_kernel<T><<<blocks_of(sh[k].tb.n_states), kThreads, 0, st>>>(
          sh[k], (T)discount, (const T*)v[a], (const T*)p[a], (T*)v[b],
          (T*)p[b], (int32_t*)pol, (int)(first + i));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t psum_sweeps(const cpr::SweepTable* tb, const cpr::LoopCtl* c,
                        const int64_t* ranges, int n_ranges, int lead, int n,
                        int64_t chunk, double discount, void* const* qv,
                        void* const* qp, void* const* v, void* const* p,
                        void* pol, int64_t first, int count,
                        cudaStream_t st) {
  Planes<T> pl;
  for (int b = 0; b < n; ++b) {
    pl.qv[b] = (const T*)qv[b];
    pl.qp[b] = (const T*)qp[b];
  }
  for (int i = 0; i < count; ++i) {
    const int a = (int)((first + i) & 1), b = a ^ 1;
    for (int k = 0; k < n_ranges; ++k) {
      const int64_t* r = ranges + 5 * k;  // shard, r0, r1, k0, k1
      if (r[4] <= r[3]) continue;
      psum_partial_kernel<T><<<blocks_of(r[4] - r[3]), kThreads, 0, st>>>(
          *tb, lead ? c->ctl : nullptr, r[1], r[2], r[3], r[4], (T)discount,
          (const T*)v[a], (const T*)p[a], (T*)qv[r[0]], (T*)qp[r[0]]);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (!lead) continue;
    psum_backup_kernel<T><<<blocks_of(tb->n_states), kThreads, 0, st>>>(
        *tb, *c, pl, chunk, (const T*)v[a], (T*)v[b], (T*)p[b],
        (int32_t*)pol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t grid_sweeps(const cpr::GridShard* sh, int n, int64_t n_vec,
                        double discount, void* const* v, void* const* p,
                        void* pol, int64_t first, int count, int steps,
                        cudaStream_t st) {
  for (int i = 0; i < count; ++i) {
    const int j = (int)(first + i), a = j & 1, b = a ^ 1;
    for (int k = 0; k < n; ++k) {
      if (sh[k].tb.n_states <= 0 || sh[k].n_live <= 0) continue;
      const unsigned blocks = blocks_of(sh[k].tb.n_states) * sh[k].n_live;
      grid_block_kernel<T><<<blocks, kThreads, 0, st>>>(
          sh[k], n_vec, (T)discount, (const T*)v[a], (const T*)p[a], (T*)v[b],
          (T*)p[b], (int32_t*)pol, steps, j);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K16-state: `count` sweeps of the `n` state shards on this card, the i-th
// being global sweep g = first + i: every shard reads (v[g % 2], p[g % 2])
// (the replicated [n_vec] vectors) and writes its slice of v[(g + 1) % 2],
// p[(g + 1) % 2] and `pol`, its max delta into its dbits[g] (g counted
// from the chunk's first sweep). One launch a shard a sweep, in shard
// order, on `stream`.
cudaError_t cpr_k16_state_sweeps(const cpr::StateShard* sh, int n, int f64,
                                 double discount, void* v0, void* v1,
                                 void* p0, void* p1, void* pol, int64_t first,
                                 int count, void* stream) {
  void* v[2] = {v0, v1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  return f64 ? state_sweeps<double>(sh, n, discount, v, p, pol, first, count,
                                    st)
             : state_sweeps<float>(sh, n, discount, v, p, pol, first, count,
                                   st);
}

// K16-psum: `count` sweeps over the sorted table `tb`, the i-th being
// global sweep g = first + i. Each sweep launches (a) for each of the
// `n_ranges` shards on this card, ranges[5k .. 5k+4] = (b, r0, r1, k0,
// k1): shard b's rows [r0, r1) and the segments [k0, k1) they touch, its
// partial planes qv[b], qp[b] [n_seg]; then, with `lead` set, (b) the
// backup, which sums the planes of all `n` shards (shard b holding rows
// [b * chunk, (b + 1) * chunk)) and reads (v[g % 2], p[g % 2]), writes
// the other buffers and `pol`, with K4's loop control `c`. Without
// `lead`, `c` is not read and the planes of other cards may be null.
// n <= 8.
cudaError_t cpr_k16_psum_sweeps(const cpr::SweepTable* tb,
                                const cpr::LoopCtl* c, const int64_t* ranges,
                                int n_ranges, int lead, int n, int64_t chunk,
                                double discount, void* const* qv,
                                void* const* qp, void* v0, void* v1, void* p0,
                                void* p1, void* pol, int64_t first, int count,
                                void* stream) {
  if (n < 1 || n > 8) return cudaErrorInvalidValue;
  void* v[2] = {v0, v1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  return tb->f64 ? psum_sweeps<double>(tb, c, ranges, n_ranges, lead, n,
                                       chunk, discount, qv, qp, v, p, pol,
                                       first, count, st)
                 : psum_sweeps<float>(tb, c, ranges, n_ranges, lead, n, chunk,
                                      discount, qv, qp, v, p, pol, first,
                                      count, st);
}

// K16-grid: `count` sweeps of the `n` grid x state shards on this card,
// the i-th being sweep j = first + i of a chunk of `steps`: it reads
// (v[j % 2], p[j % 2]) [G, n_vec] and writes the shards' live points'
// blocks of the other buffers and of `pol`, each shard's point maxima
// into its dbits[gl * steps + j].
cudaError_t cpr_k16_grid_sweeps(const cpr::GridShard* sh, int n, int f64,
                                int64_t n_vec, double discount, void* v0,
                                void* v1, void* p0, void* p1, void* pol,
                                int64_t first, int count, int steps,
                                void* stream) {
  void* v[2] = {v0, v1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  return f64 ? grid_sweeps<double>(sh, n, n_vec, discount, v, p, pol, first,
                                   count, steps, st)
             : grid_sweeps<float>(sh, n, n_vec, discount, v, p, pol, first,
                                  count, steps, st);
}

const char* cpr_k16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
