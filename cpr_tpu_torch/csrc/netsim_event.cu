// Kernel K12-event: the netsim's general discrete-event engine for
// Nakamoto (simple and flooding dissemination), one lane a (seed,
// activation delay) simulation of `activations` blocks.
//
// Replaces: cpr_tpu/netsim/engine.py:92-715 `_lane_fn`, Nakamoto (its Bk,
// Ethereum and Spar branches are K12-event-bk/-eth/-spar,
// netsim_event_{bk,eth,spar}.cu). Plain twin:
// cpr_tpu_torch/netsim/engine.py `event_plain`. The engine itself is
// netsim_event.cuh, shared with those and K13.
//
// Bound: the threefry work (a 5-way key split, a Gumbel block a node at
// each activation, an exponential draw, two blocks for each random
// delay sent) and the ledger bytes; a launch is latency-bound, a few
// dependent warp steps per block mined.
//
// Parity: equal to the plain twin step for step; to the JAX package
// wherever no two times are within the ULP differences of log1p and log.

#include "netsim_event.cuh"

using cpr::netsim::Ledger;
using cpr::netsim::LaneIn;
using cpr::netsim::Out;
using cpr::netsim::Planes;

extern "C" {

// K12-event launch: one warp a lane. keys [lanes, 2] uint32 (64-bit mode
// keys), delays [lanes] f64; the ledger planes [lanes, B] (uninitialised:
// the kernel writes genesis and every block before it reads one).
cudaError_t cpr_k12_event(const LaneIn* in, const Ledger* led,
                          const Planes* pl, int flooding, const Out* out,
                          void* stream) {
  return cpr::netsim::launch_event<false>(*in, *led, *pl, flooding, *out,
                                          (cudaStream_t)stream);
}

const char* cpr_k12_event_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
