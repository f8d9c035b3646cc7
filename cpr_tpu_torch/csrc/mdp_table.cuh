// The sorted MDP table as the MDP kernels read it (K4, K5, K6, K7, K16),
// the arithmetic helpers they share, K4's per-state greedy backup, the
// block's max delta and the device-side loop control of a sweep loop.
//
// Layout (cpr_tpu_torch/mdp/explicit.py `TensorMDP.from_columns`, built
// once per table): rows sorted stably by segment src*A+act; state s owns
// the non-empty segments state_seg[s]..state_seg[s+1], segment k the rows
// seg_ptr[k]..seg_ptr[k+1], with its action seg_act[k] and whether it has
// probability mass (seg_valid[k]).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cpr {

// Laid out like `_SweepTable` in cpr_tpu_torch/kernels/__init__.py.
struct SweepTable {
  const int32_t* state_seg;  // [S + 1]
  const int32_t* seg_ptr;    // [n_seg + 1]
  const int32_t* seg_act;    // [n_seg]
  const uint8_t* seg_valid;  // [n_seg]
  const int32_t* dst;        // [T]
  const void* prob;          // [T] float or double
  const void* reward;
  const void* progress;
  int64_t n_states;
  int32_t n_actions;
  int32_t f64;
};

// Explicit round-to-nearest arithmetic, so nvcc forms no FMA that the
// reference's computation does not.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Order-preserving bits of a value >= 0.
__device__ __forceinline__ unsigned long long bits_of(float x) {
  return (unsigned long long)__float_as_uint(x);
}
__device__ __forceinline__ unsigned long long bits_of(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float((unsigned)b);
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

constexpr int kSweepThreads = 256;  // threads a block of the sweep kernels

// The device-side control block of a sweep loop (`_Ctl` in
// cpr_tpu_torch/mdp/explicit.py).
struct LoopCtl {
  int64_t* ctl;    // [4]: max-delta bits, sweeps done, stop flag, blocks done
  void* delta;     // [1] the last sweep's delta
  void* resid;     // [resid_len] ring of per-sweep deltas, or null
  int32_t resid_len;
  int32_t can_stop;
  double stop_delta;
  int64_t max_iter;
};

// K4's per-state work: the greedy backup of state `s` of `tb`'s sorted
// rows under the probability column `prob` and segment validity `valid`,
// reading the values V and progress P at the rows' dst. Walks the state's
// segments in action order and each segment's rows in their compiled
// order with round-to-nearest adds and products; a strict > keeps the
// lowest action among equal values. Returns the action (-1: no valid
// segment, value and progress 0) and its value and progress in bv, bp.
// K4, K7, K16-state and K16-grid all call it, so they compute the same
// floats.
template <typename T>
__device__ __forceinline__ int backup_state(const SweepTable& tb,
                                            const T* __restrict__ prob,
                                            const uint8_t* __restrict__ valid,
                                            int64_t s, T discount,
                                            const T* __restrict__ V,
                                            const T* __restrict__ P, T& bv,
                                            T& bp) {
  const T* __restrict__ reward = static_cast<const T*>(tb.reward);
  const T* __restrict__ progress = static_cast<const T*>(tb.progress);
  int best = -1;
  bv = 0;
  bp = 0;
  for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
    if (!valid[k]) continue;
    T qv = 0, qp = 0;
    for (int r = tb.seg_ptr[k], re = tb.seg_ptr[k + 1]; r < re; ++r) {
      const int j = tb.dst[r];
      const T pr = prob[r];
      qv = add_rn(qv, mul_rn(pr, add_rn(reward[r], mul_rn(discount, V[j]))));
      qp = add_rn(qp, mul_rn(pr, add_rn(progress[r], mul_rn(discount, P[j]))));
    }
    if (best < 0 || qv > bv) {
      best = tb.seg_act[k];
      bv = qv;
      bp = qp;
    }
  }
  return best;
}

// The largest of the block's bits `b` (values >= 0), valid in thread 0.
// Every thread of the block must call it.
__device__ __forceinline__ unsigned long long block_max_bits(
    unsigned long long b) {
  __shared__ unsigned long long warp_max[kSweepThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    b = max(b, __shfl_down_sync(0xffffffffu, b, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = b;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kSweepThreads / 32; ++w) b = max(b, warp_max[w]);
  return b;
}

// Reduce this thread's delta into the sweep's max; the last block to
// finish closes the sweep: it stores the delta (and into the residual
// ring), counts the sweep, and sets the stop flag when delta <= stop_delta
// or the sweep count reaches max_iter. Every thread of the block must call
// it.
template <typename T>
__device__ void finish_sweep(T d, const LoopCtl& c) {
  const unsigned long long b = block_max_bits(bits_of(d));
  if (threadIdx.x != 0) return;
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

}  // namespace cpr
