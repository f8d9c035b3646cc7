// Kernel K12-event-bk: the netsim's event engine running Bk (k votes a
// proposal; `constant` and `block` rewards), one lane a (seed, activation
// delay) simulation of `activations` votes on up to 32 nodes.
//
// Replaces: cpr_tpu/netsim/engine.py:153-188, :245-263, :409-509 and
// :578-650 (`_lane_fn`, its Bk branch). Plain twin:
// cpr_tpu_torch/netsim/engine.py `event_plain` with a Bk `Proto`. The
// engine is netsim_event.cuh (K12-event's), instantiated for Bk.
//
// Bound: the threefry work (a 5-way key split a step, a Gumbel block a
// node and a hash block at each activation, an exponential draw, two
// blocks for each random delay sent) and the ledger bytes; a launch is
// latency-bound, a few dependent warp steps per block, plus a W-slot
// window scan at each proposal.
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

// K12-event-bk launch: one warp a lane. keys [lanes, 2] uint32
// (64-bit mode keys), delays [lanes] f64; the ledger planes [lanes, B]
// and the protocol's planes (uninitialised: the kernel writes every
// block's rows when it appends it); progress and on_chain [lanes] f64
// out.
cudaError_t cpr_k12_event_bk(const LaneIn* in, const Ledger* led,
                             const Planes* pl, int flooding,
                             const Proto* pr, const Out* out,
                             void* stream) {
  return cpr::netsim::launch_event<false, cpr::netsim::kBk>(
      *in, *led, *pl, flooding, *pr, *out, (cudaStream_t)stream);
}

const char* cpr_k12_event_bk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
