// Kernels K4 (one Bellman sweep of value iteration), K5 (one sweep of
// policy evaluation) and K7 (K4 over a grid of probability columns) over
// an explicit MDP's transition rows.
//
// Replaces:
//   K4: cpr_tpu/mdp/explicit.py:340-380 `make_vi_sweep` (two
//       segment_sums over S*A segments), `_greedy_backup` and the max
//       value delta, as driven by `vi_while_loop` (:391-428) and the
//       chunk scan of `make_vi_chunk` (:483-511);
//   K5: cpr_tpu/mdp/explicit.py:862-880 `_pe_loop` (segment sums over
//       src of the on-policy rows);
//   K7: cpr_tpu/mdp/explicit.py:715-753 `make_grid_vi_chunk` (the K4
//       sweep vmapped over a [G] grid of probability columns, frozen
//       points passed through), as cpr_tpu/parallel/grid.py:32
//       `make_grid_chunk_step` runs it.
// Plain twins: cpr_tpu_torch/mdp/explicit.py `make_vi_sweep`,
// `_pe_sweep`, `_grid_chunk_plain`.
//
// Layout: the sorted table of mdp_table.cuh.
//
// Bound: memory. A sweep reads every row once (dst, prob, reward,
// progress: 16 bytes in float32), the segment index and the [S] value
// and progress vectors, gathers V[dst] and P[dst], and writes V', P' and
// the policy; it does 8 floating-point operations a row. Design: one
// thread per state, which walks its segments in action order and each
// segment's rows in their compiled order. The sums are plain sequential
// adds, no atomics, so a sweep is deterministic and sums each segment in
// the order the CPU twin does. The per-row arithmetic is written with
// explicit round-to-nearest intrinsics so nvcc cannot contract it into
// FMAs that the twin, computed op by op, does not form. The new value,
// progress and policy go to buffers separate from the ones read (a
// Jacobi sweep, as segment_sum computes it). K7 is K4 per grid point:
// its bound counts the shared columns once and each point's probability
// column, validity and planes; the kernel reads the shared columns once
// per point and counts on L2 to serve the other points (see the kernel).
//
// Loop control on the device: `ctl` int64 [4] holds the bits of the
// running max |V'-V| (a max does not depend on order, and the values are
// >= 0, so an atomicMax on the bits is deterministic), the number of
// sweeps done, a stop flag and a count of finished blocks. The last
// block of a sweep finishes it: it stores the delta (and into the
// residual ring), counts the sweep, and sets the stop flag when delta <=
// stop_delta or the sweep count reaches max_iter, exactly the reference's
// while-loop rule. A launch that finds the flag set returns at once, so
// the host can enqueue sweeps in blocks and read the flag once a block.

#include <cuda_runtime.h>

#include <cstdint>

#include "mdp_table.cuh"

namespace cpr {

struct LoopCtl {
  int64_t* ctl;    // [4]: max-delta bits, sweeps done, stop flag, blocks done
  void* delta;     // [1] the last sweep's delta
  void* resid;     // [resid_len] ring of per-sweep deltas, or null
  int32_t resid_len;
  int32_t can_stop;
  double stop_delta;
  int64_t max_iter;
};

}  // namespace cpr

namespace {

using cpr::add_rn;
using cpr::bits_of;
using cpr::from_bits;
using cpr::mul_rn;

constexpr int kThreads = 256;

// Reduce this thread's delta into the sweep's max; the last block to
// finish closes the sweep. Every thread of the block must call it.
template <typename T>
__device__ void finish_sweep(T d, const cpr::LoopCtl& c) {
  __shared__ unsigned long long warp_max[kThreads / 32];
  unsigned long long b = bits_of(d);
  for (int o = 16; o > 0; o >>= 1)
    b = max(b, __shfl_down_sync(0xffffffffu, b, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = b;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) b = max(b, warp_max[w]);
  auto* ctl = reinterpret_cast<unsigned long long*>(c.ctl);
  atomicMax(&ctl[0], b);
  __threadfence();
  if (atomicAdd(&ctl[3], 1ull) != gridDim.x - 1) return;
  // the last block: every other block's max is in ctl[0]
  const T delta = from_bits<T>(atomicExch(&ctl[0], 0ull));
  const long long it = (long long)ctl[1] + 1;
  ctl[1] = (unsigned long long)it;
  static_cast<T*>(c.delta)[0] = delta;
  if (c.resid_len > 0) static_cast<T*>(c.resid)[(it - 1) % c.resid_len] = delta;
  if (c.can_stop && (!(delta > (T)c.stop_delta) || it >= c.max_iter))
    ctl[2] = 1;
  ctl[3] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vi_sweep_kernel(cpr::SweepTable tb, cpr::LoopCtl c, T discount,
                    const T* __restrict__ V, const T* __restrict__ P,
                    T* __restrict__ V2, T* __restrict__ P2,
                    int32_t* __restrict__ pol) {
  if (c.ctl[2]) return;  // the loop has stopped: the whole grid returns
  const int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  T d = 0;
  if (s < tb.n_states) {
    const T* __restrict__ prob = static_cast<const T*>(tb.prob);
    const T* __restrict__ reward = static_cast<const T*>(tb.reward);
    const T* __restrict__ progress = static_cast<const T*>(tb.progress);
    int best = -1;
    T bv = 0, bp = 0;
    for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
      if (!tb.seg_valid[k]) continue;
      T qv = 0, qp = 0;
      for (int r = tb.seg_ptr[k], re = tb.seg_ptr[k + 1]; r < re; ++r) {
        const int j = tb.dst[r];
        const T pr = prob[r];
        qv = add_rn(qv, mul_rn(pr, add_rn(reward[r], mul_rn(discount, V[j]))));
        qp = add_rn(qp,
                    mul_rn(pr, add_rn(progress[r], mul_rn(discount, P[j]))));
      }
      // segments come in action order: a strict > keeps the lowest
      // action among equal values
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
  finish_sweep<T>(d, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pe_sweep_kernel(cpr::SweepTable tb, cpr::LoopCtl c,
                    const int32_t* __restrict__ policy, T discount,
                    const T* __restrict__ R, const T* __restrict__ P,
                    T* __restrict__ R2, T* __restrict__ P2) {
  if (c.ctl[2]) return;
  const int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  T d = 0;
  if (s < tb.n_states) {
    const T* __restrict__ prob = static_cast<const T*>(tb.prob);
    const T* __restrict__ reward = static_cast<const T*>(tb.reward);
    const T* __restrict__ progress = static_cast<const T*>(tb.progress);
    const int a = policy[s];
    T r2 = 0, p2 = 0;
    for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; a >= 0 && k < ke;
         ++k) {
      if (tb.seg_act[k] != a) continue;
      for (int r = tb.seg_ptr[k], re = tb.seg_ptr[k + 1]; r < re; ++r) {
        const int j = tb.dst[r];
        const T pr = prob[r];
        r2 = add_rn(r2, mul_rn(pr, add_rn(reward[r], mul_rn(discount, R[j]))));
        p2 = add_rn(p2,
                    mul_rn(pr, add_rn(progress[r], mul_rn(discount, P[j]))));
      }
      break;
    }
    R2[s] = r2;
    P2[s] = p2;
    d = fabs(r2 - R[s]);
  }
  finish_sweep<T>(d, c);
}

// K7: one sweep of every live grid point. Point g has its own probability
// column probs[g] and segment validity valid[g] (at gamma in {0, 1} rows
// carry probability 0, so validity differs between points); the rows'
// dst, reward and progress are shared. The per-state walk is K4's, so a
// point's sweep is bit for bit K4's sweep of its revalued table. Layout:
// a block is (point, 256 states), the point index varying fastest, so
// the blocks in flight at one time read the same stretch of the shared
// columns, which L2 then serves to every point. Frozen points are not in
// `live` and their buffers are never touched. The point's max |V'-V| of
// sweep j goes to dbits[g * steps + j] by an atomicMax on its bits
// (order-free, so deterministic).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grid_sweep_kernel(cpr::SweepTable tb, const T* __restrict__ probs,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ live, int n_live,
                      int64_t n_rows, int64_t n_seg, T discount,
                      const T* __restrict__ V, const T* __restrict__ P,
                      T* __restrict__ V2, T* __restrict__ P2,
                      int32_t* __restrict__ pol,
                      unsigned long long* __restrict__ dbits, int steps,
                      int j) {
  const int64_t S = tb.n_states;
  const int g = live[blockIdx.x % n_live];
  const int64_t s = (blockIdx.x / n_live) * (int64_t)kThreads + threadIdx.x;
  const T* __restrict__ prob = probs + g * n_rows;
  const uint8_t* __restrict__ vld = valid + g * n_seg;
  const int64_t off = g * S;
  T d = 0;
  if (s < S) {
    const T* __restrict__ reward = static_cast<const T*>(tb.reward);
    const T* __restrict__ progress = static_cast<const T*>(tb.progress);
    const T* __restrict__ Vg = V + off;
    const T* __restrict__ Pg = P + off;
    int best = -1;
    T bv = 0, bp = 0;
    for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
      if (!vld[k]) continue;
      T qv = 0, qp = 0;
      for (int r = tb.seg_ptr[k], re = tb.seg_ptr[k + 1]; r < re; ++r) {
        const int t = tb.dst[r];
        const T pr = prob[r];
        qv = add_rn(qv, mul_rn(pr, add_rn(reward[r], mul_rn(discount, Vg[t]))));
        qp = add_rn(qp,
                    mul_rn(pr, add_rn(progress[r], mul_rn(discount, Pg[t]))));
      }
      if (best < 0 || qv > bv) {
        best = tb.seg_act[k];
        bv = qv;
        bp = qp;
      }
    }
    V2[off + s] = bv;
    P2[off + s] = bp;
    pol[off + s] = best;
    d = fabs(bv - Vg[s]);
  }
  __shared__ unsigned long long warp_max[kThreads / 32];
  unsigned long long b = bits_of(d);
  for (int o = 16; o > 0; o >>= 1)
    b = max(b, __shfl_down_sync(0xffffffffu, b, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = b;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) b = max(b, warp_max[w]);
  atomicMax(&dbits[(int64_t)g * steps + j], b);
}

unsigned n_blocks(const cpr::SweepTable* tb) {
  return (unsigned)((tb->n_states + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// K4: `count` sweeps, the i-th being global sweep g = first + i, which
// reads (v[g % 2], p[g % 2]) and writes (v[(g + 1) % 2], p[(g + 1) % 2])
// and `pol`. Launches on `stream`; returns the first launch error.
cudaError_t cpr_k4_vi_sweeps(const cpr::SweepTable* tb, const cpr::LoopCtl* c,
                             double discount, void* v0, void* v1, void* p0,
                             void* p1, void* pol, int64_t first, int count,
                             void* stream) {
  if (tb->n_states <= 0) return cudaSuccess;
  void* v[2] = {v0, v1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  for (int i = 0; i < count; ++i) {
    const int a = (int)((first + i) & 1), b = a ^ 1;
    if (tb->f64)
      vi_sweep_kernel<double><<<n_blocks(tb), kThreads, 0, st>>>(
          *tb, *c, discount, (const double*)v[a], (const double*)p[a],
          (double*)v[b], (double*)p[b], (int32_t*)pol);
    else
      vi_sweep_kernel<float><<<n_blocks(tb), kThreads, 0, st>>>(
          *tb, *c, (float)discount, (const float*)v[a], (const float*)p[a],
          (float*)v[b], (float*)p[b], (int32_t*)pol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K5: as K4, over (r, p) with the fixed `policy` [S].
cudaError_t cpr_k5_pe_sweeps(const cpr::SweepTable* tb, const cpr::LoopCtl* c,
                             const void* policy, double discount, void* r0,
                             void* r1, void* p0, void* p1, int64_t first,
                             int count, void* stream) {
  if (tb->n_states <= 0) return cudaSuccess;
  void* r[2] = {r0, r1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  for (int i = 0; i < count; ++i) {
    const int a = (int)((first + i) & 1), b = a ^ 1;
    if (tb->f64)
      pe_sweep_kernel<double><<<n_blocks(tb), kThreads, 0, st>>>(
          *tb, *c, (const int32_t*)policy, discount, (const double*)r[a],
          (const double*)p[a], (double*)r[b], (double*)p[b]);
    else
      pe_sweep_kernel<float><<<n_blocks(tb), kThreads, 0, st>>>(
          *tb, *c, (const int32_t*)policy, (float)discount,
          (const float*)r[a], (const float*)p[a], (float*)r[b],
          (float*)p[b]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K7: `steps` sweeps of the live grid points `live` [n_live]; sweep i
// reads (v[i % 2], p[i % 2]) and writes the other buffer of each [G, S]
// pair, the policy plane `pol` [G, S] and dbits[g * steps + i].
cudaError_t cpr_k7_grid_sweeps(const cpr::SweepTable* tb, const void* probs,
                               const void* valid, const void* live,
                               int n_live, int64_t n_rows, int64_t n_seg,
                               double discount, void* v0, void* v1, void* p0,
                               void* p1, void* pol, void* dbits, int steps,
                               void* stream) {
  if (tb->n_states <= 0 || n_live <= 0) return cudaSuccess;
  void* v[2] = {v0, v1};
  void* p[2] = {p0, p1};
  const auto st = (cudaStream_t)stream;
  const unsigned blocks = n_blocks(tb) * (unsigned)n_live;
  for (int i = 0; i < steps; ++i) {
    const int a = i & 1, b = a ^ 1;
    if (tb->f64)
      grid_sweep_kernel<double><<<blocks, kThreads, 0, st>>>(
          *tb, (const double*)probs, (const uint8_t*)valid,
          (const int32_t*)live, n_live, n_rows, n_seg, discount,
          (const double*)v[a], (const double*)p[a], (double*)v[b],
          (double*)p[b], (int32_t*)pol, (unsigned long long*)dbits, steps,
          i);
    else
      grid_sweep_kernel<float><<<blocks, kThreads, 0, st>>>(
          *tb, (const float*)probs, (const uint8_t*)valid,
          (const int32_t*)live, n_live, n_rows, n_seg, (float)discount,
          (const float*)v[a], (const float*)p[a], (float*)v[b],
          (float*)p[b], (int32_t*)pol, (unsigned long long*)dbits, steps,
          i);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* cpr_k45_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
