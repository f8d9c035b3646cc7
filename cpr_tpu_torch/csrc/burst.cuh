// The argument block of the serve engine's policy burst, shared by K14
// (csrc/nakamoto_stream.cu `burst_kernel`, a thread per lane) and K14-dag
// (csrc/dag_env.cuh `dag_burst_kernel`, a warp per lane, built into every
// K10 library). Laid out like the ctypes `_BurstArgs` in
// cpr_tpu_torch/kernels/__init__.py.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cpr {

// A lane's policy table entry is scripted (arg: the env's scripted policy
// id), a greedy net or a sampled net (arg: a net slot).
constexpr int kBurstSlots = 4;   // net slots a launch
constexpr int kBurstTable = 16;  // policy table entries
constexpr int kBurstScripted = 0, kBurstGreedy = 1, kBurstSample = 2;

struct BurstArgs {
  const int32_t* policy;  // [L] table id of each lane
  const bool* live;       // [L] lanes the burst advances
  bool* got;              // [L] out: the lane ended an episode
  int32_t* done_step;     // [L] out: the step of its first done
  float* caps;            // [4, L] out: CAPTURE_FIELDS at that step
  const float* w[kBurstSlots];  // a slot's policy MLP weights, or null
  int32_t w_off[kBurstSlots];   // their offset in shared memory (floats)
  int32_t in[kBurstSlots];
  int32_t hidden[kBurstSlots];
  int32_t n_actions[kBurstSlots];
  int32_t kind[kBurstTable];
  int32_t arg[kBurstTable];
  int32_t smem_floats;  // the slots' weights, 0 without nets
  int32_t burst;
  // admissions before the burst (null: none): a lane where admit[i]
  // first takes the fresh state of `init_lanes` from admit_keys[i], as
  // the engine's splice (the stream prologue, then the admitting tick)
  // gives it
  const bool* admit;
  const uint2* admit_keys;
};

// A resident engine's burst with its host traffic in one call: `in_bytes`
// from the pinned host buffer `h_in` to `d_in` (the launch's policy ids,
// live mask and admissions), `launch()` (the kernel's launch on `s`,
// returning its error), `out_bytes` from `d_out` (its registers) to the
// pinned `h_out`, and the wait for the stream.
template <class Launch>
cudaError_t burst_staged(const void* h_in, void* d_in, int64_t in_bytes,
                         const void* d_out, void* h_out, int64_t out_bytes,
                         cudaStream_t s, Launch launch) {
  cudaError_t err = cudaMemcpyAsync(d_in, h_in, (size_t)in_bytes,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  err = launch();
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(h_out, d_out, (size_t)out_bytes,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

}  // namespace cpr
