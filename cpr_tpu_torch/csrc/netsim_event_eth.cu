// Kernel K12-event-eth: the netsim's event engine running Ethereum
// (whitepaper: preference by work, up to U uncles; Byzantium: by height,
// at most 2 uncles), one lane a (seed, activation delay) simulation of
// `activations` blocks on up to 256 nodes.
//
// Replaces: cpr_tpu/netsim/engine.py:164-169, :264-269, :311-366,
// :510-515 and :611-683 (`_lane_fn`, its Ethereum branch). Plain twin:
// cpr_tpu_torch/netsim/engine.py `event_plain` with an Ethereum `Proto`.
// The engine is netsim_event.cuh (K12-event's), instantiated for
// Ethereum.
//
// Bound: the threefry work (a 5-way key split a step, a Gumbel block a
// node at each activation, an exponential draw, two blocks for each
// random delay sent) and the ledger bytes; a launch is latency-bound, a
// few dependent warp steps per block, plus a W-slot uncle scan at each
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

// K12-event-eth launch: one warp a lane. keys [lanes, 2] uint32
// (64-bit mode keys), delays [lanes] f64; the ledger planes [lanes, B]
// and the protocol's planes (uninitialised: the kernel writes every
// block's rows when it appends it); progress and on_chain [lanes] f64
// out.
cudaError_t cpr_k12_event_eth(const LaneIn* in, const Ledger* led,
                              const Planes* pl, int flooding,
                              const Proto* pr, const Out* out,
                              void* stream) {
  return cpr::netsim::launch_event<false, cpr::netsim::kEth>(
      *in, *led, *pl, flooding, *pr, *out, (cudaStream_t)stream);
}

// The static shared memory of the kernel's instantiation for `ns`
// node slots a thread and the most a block of the current card may
// have, for the wrapper's node limit.
cudaError_t cpr_k12_event_eth_smem(int ns, int* static_bytes,
                                   int* block_bytes) {
  return cpr::netsim::event_smem_limits<false, cpr::netsim::kEth>(
      ns, static_bytes, block_bytes);
}

const char* cpr_k12_event_eth_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
