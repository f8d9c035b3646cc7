// The sorted MDP table as the MDP kernels read it (K4, K5, K6, K7), and
// the arithmetic helpers they share.
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

}  // namespace cpr
