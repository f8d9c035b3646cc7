// The check kernel of K15 (csrc/exp_ring.cuh): the experience rings'
// device functions outside any burst, so that they can be held against
// the plain version (cpr_tpu_torch/learn/buffer.py `record_plain`,
// `step_keys_plain`) and timed alone. Also what `buffer.record` and
// `buffer.step_keys` launch on CUDA tensors.
//
// Replaces: as csrc/exp_ring.cuh (cpr_tpu/learn/buffer.py:75-110).
//
// `record`: one step of every live lane, a thread a lane: the lane's
// row at cursor % C gets obs [L, F], action, reward, done, era, erd and
// policy [L]; cursor and t advance by one. `step_keys`: fold_in(key[i],
// t[i]) a lane.
//
// Bound: bytes (the inputs read once, a live lane's 37 + 8 bytes
// written at F = 4).

#include <cuda_runtime.h>

#include <cstdint>

#include "exp_ring.cuh"

// One step's inputs, [L] each (obs [L, F]); ctypes `_ExpStepIn`. Outside
// the anonymous namespace so the entry points keep external linkage.
namespace cpr {

struct ExpStepIn {
  const bool* live;
  const float* obs;
  const int32_t* action;
  const float* reward;
  const bool* done;
  const float* era;
  const float* erd;
  const int32_t* policy;
};

}  // namespace cpr

using cpr::ExpPtrs;
using cpr::ExpStepIn;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
record_kernel(ExpPtrs e, ExpStepIn in, int64_t n_lanes) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_lanes || !in.live[i]) return;
  const int32_t c = e.cursor[i];
  cpr::exp_record(e, i, c, in.obs + i * e.obs_dim, in.action[i],
                  in.reward[i], in.done[i], in.era[i], in.erd[i],
                  in.policy[i]);
  e.cursor[i] = c + 1;
  e.t[i] += 1;
}

__global__ void __launch_bounds__(kThreads)
step_keys_kernel(const uint2* __restrict__ key, const int32_t* __restrict__ t,
                 uint2* __restrict__ out, int64_t n_lanes) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_lanes) out[i] = cpr::exp_step_key(key[i], t[i]);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

cudaError_t cpr_k15_record(const ExpPtrs* e, const ExpStepIn* in,
                           int64_t n_lanes, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  record_kernel<<<blocks_for(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      *e, *in, n_lanes);
  return cudaGetLastError();
}

cudaError_t cpr_k15_step_keys(const void* key, const void* t, void* out,
                              int64_t n_lanes, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  step_keys_kernel<<<blocks_for(n_lanes), kThreads, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const uint2*>(key), static_cast<const int32_t*>(t),
      static_cast<uint2*>(out), n_lanes);
  return cudaGetLastError();
}

const char* cpr_k15_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
