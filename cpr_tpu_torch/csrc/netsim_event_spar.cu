// Kernel K12-event-spar: the netsim's event engine running Spar (a block
// once k - 1 confirming votes are visible, else a vote; `constant` and
// `block` rewards), one lane a (seed, activation delay) simulation of
// `activations` mints on up to 256 nodes.
//
// Replaces: cpr_tpu/netsim/engine.py:170-178, :270-282, :368-407,
// :472-530 and :622-663 (`_lane_fn`, its Spar branch). Plain twin:
// cpr_tpu_torch/netsim/engine.py `event_plain` with a Spar `Proto`. The
// engine is netsim_event.cuh (K12-event's), instantiated for Spar.
//
// Bound: the threefry work (a 5-way key split a step, a Gumbel block a
// node at each activation, an exponential draw, two blocks for each
// random delay sent) and the ledger bytes; a launch is latency-bound, a
// few dependent warp steps per block, plus a W-slot quorum scan at each
// mint.
//
// Parity: equal to the plain twin step for step; to the JAX package
// wherever no two times are within the ULP differences of log1p and log;
// rewards are sums of dyadic amounts, exact in float32 in any order.

#include "netsim_event.cuh"

using cpr::netsim::LaneIn;
using cpr::netsim::Ledger;
using cpr::netsim::Out;
using cpr::netsim::Planes;
using cpr::netsim::Proto;

extern "C" {

// K12-event-spar launch: one warp a lane. keys [lanes, 2] uint32
// (64-bit mode keys), delays [lanes] f64; the ledger planes [lanes, B]
// and the protocol's planes (uninitialised: the kernel writes every
// block's rows when it appends it); progress and on_chain [lanes] f64
// out.
cudaError_t cpr_k12_event_spar(const LaneIn* in, const Ledger* led,
                               const Planes* pl, int flooding,
                               const Proto* pr, const Out* out,
                               void* stream) {
  return cpr::netsim::launch_event<false, cpr::netsim::kSpar>(
      *in, *led, *pl, flooding, *pr, *out, (cudaStream_t)stream);
}

// The static shared memory of the kernel's instantiation for `ns`
// node slots a thread and the most a block of the current card may
// have, for the wrapper's node limit.
cudaError_t cpr_k12_event_spar_smem(int ns, int* static_bytes,
                                    int* block_bytes) {
  return cpr::netsim::event_smem_limits<false, cpr::netsim::kSpar>(
      ns, static_bytes, block_bytes);
}

const char* cpr_k12_event_spar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
