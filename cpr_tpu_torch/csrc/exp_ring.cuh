// Kernel K15: the per-lane experience rings of the always-on learning
// loop, as device functions. K14 (csrc/nakamoto_stream.cu `burst_kernel`,
// a thread a lane: `exp_record`) and K14-dag (csrc/dag_env.cuh
// `dag_burst_kernel`, a warp a lane: `exp_record_warp`) record every live
// lane's step with them inside their launches; the check kernel
// (csrc/exp_check.cu) runs them alone, one step a launch.
//
// Replaces: cpr_tpu/learn/buffer.py:52-110 (`init_buffer`'s layout,
// `step_keys`, `record`). Plain twins: cpr_tpu_torch/learn/buffer.py
// `record_plain`, `step_keys_plain`.
//
// Layout: the reference's, lane-major: obs [L, C, F] float32, action and
// policy [L, C] int32, reward, era, erd [L, C] float32, done [L, C]
// bool, cursor and t [L] int32, key [L, 2] (the lane's sampler stream).
// A live lane writes its step at slot cursor % C and advances cursor and
// the monotone counter t; a lane that is not live writes nothing (the
// reference's out-of-range drop slot). drain_experience and consolidate
// read the rings as they are, so they hold the reference's arrays.
//
// Bound: bytes. A recorded step writes F * 4 + 21 bytes (37 at F = 4,
// Nakamoto; 49 to 61 at F = 7 to 10, the DAG envs) into one lane's rows.
// In thread mode consecutive lanes lie C * F * 4 bytes apart, so a warp's
// stores touch 32 sectors each, which the L2 merges with the lane's next
// steps before they go to HBM (the check kernel, one step a launch, sees
// the uncoalesced cost whole); in warp mode the lane's warp writes its
// observation row as F consecutive words and one thread the scalars.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace cpr {

// ctypes `_ExpPtrs`; `obs` null means the plane is off.
struct ExpPtrs {
  float* obs;
  int32_t* action;
  float* reward;
  bool* done;
  float* era;
  float* erd;
  int32_t* policy;
  int32_t* cursor;
  int32_t* t;
  const uint2* key;
  int32_t cap;
  int32_t obs_dim;
};

// buffer.py:75-79: the lane's action key for a step, fold_in(key, t).
__device__ __forceinline__ uint2 exp_step_key(uint2 key, int32_t t) {
  return split_key(key, (uint32_t)t);
}

// buffer.py:82-110 for one live lane: the step at slot cursor % C.
// `obs` holds obs_dim floats (the pre-step observation).
__device__ __forceinline__ void exp_record(const ExpPtrs& e, int64_t lane,
                                           int32_t cursor, const float* obs,
                                           int action, float reward,
                                           bool done, float era, float erd,
                                           int32_t policy) {
  const int64_t r = lane * e.cap + cursor % e.cap;
  float* row = e.obs + r * e.obs_dim;
  if (e.obs_dim == 4) {
    *reinterpret_cast<float4*>(row) = make_float4(obs[0], obs[1], obs[2],
                                                  obs[3]);
  } else {
    for (int f = 0; f < e.obs_dim; ++f) row[f] = obs[f];
  }
  e.action[r] = action;
  e.reward[r] = reward;
  e.done[r] = done;
  e.era[r] = era;
  e.erd[r] = erd;
  e.policy[r] = policy;
}

// The same for the lane of the calling warp, every argument warp-uniform
// and `obs` a register array of at most MAXF: thread f < obs_dim writes
// element f of the row, thread 0 the scalars.
template <int MAXF>
__device__ __forceinline__ void exp_record_warp(
    const ExpPtrs& e, int64_t lane, int32_t cursor, const float* obs,
    int action, float reward, bool done, float era, float erd,
    int32_t policy) {
  const int t = threadIdx.x & 31;
  const int64_t r = lane * e.cap + cursor % e.cap;
  float* row = e.obs + r * e.obs_dim;
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < e.obs_dim && f == t) row[f] = obs[f];
  if (t == 0) {
    e.action[r] = action;
    e.reward[r] = reward;
    e.done[r] = done;
    e.era[r] = era;
    e.erd[r] = erd;
    e.policy[r] = policy;
  }
  __syncwarp();
}

}  // namespace cpr
