// Per-lane environment parameters of the stream and step_lanes kernels
// (K2, K3 and every K10): six arrays of L values (ctypes `_ParamPtrs`),
// scalar params broadcast to [L] by the wrapper. Each lane loads its own
// copy once, at kernel start, into the env's parameter struct, whose
// fields carry these names and this order (cpr_tpu/params.py without
// `defenders`, which no kernel reads).

#pragma once

#include <cstdint>

namespace cpr {

struct ParamPtrs {
  const float* alpha;
  const float* gamma;
  const float* activation_delay;
  const float* max_progress;
  const float* max_time;
  const int32_t* max_steps;
};

template <class P>
__device__ __forceinline__ P load_params(const ParamPtrs& pp, int64_t lane) {
  P p;
  p.alpha = pp.alpha[lane];
  p.gamma = pp.gamma[lane];
  p.activation_delay = pp.activation_delay[lane];
  p.max_progress = pp.max_progress[lane];
  p.max_time = pp.max_time[lane];
  p.max_steps = pp.max_steps[lane];
  return p;
}

}  // namespace cpr
