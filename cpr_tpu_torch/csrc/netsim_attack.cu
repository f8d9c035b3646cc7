// Kernel K13: the attacker in the network, node 0 of a topology running a
// scripted withholding policy inside the netsim's event engine, one lane
// a (seed, activation delay, alpha, policy) simulation.
//
// Replaces: cpr_tpu/netsim/attack.py:81-408 `_attack_lane_fn`. Plain
// twin: cpr_tpu_torch/netsim/attack.py `attack_plain`. The engine is
// netsim_event.cuh (K12-event's); on top: the private tip, the withheld
// FIFO, a release one block a step at the decision time ahead of any
// activation or delivery, the bounded two-pointer common-ancestor walk,
// and the policy on (a, h) by K2's device function
// (nakamoto_policy.cuh). Per-lane alpha enters through the lane's miner
// logits [lanes, N].
//
// Bound: as K12-event (a 4-way split a step); latency-bound.
//
// Parity: equal to the plain twin step for step, the policies computed
// from the integer (a, h) (exact against the decoded unit observation
// below 1696).

#include "netsim_event.cuh"

using cpr::netsim::Ledger;
using cpr::netsim::LaneIn;
using cpr::netsim::Out;
using cpr::netsim::Planes;

extern "C" {

// K13 launch: as cpr_k12_event, plus the lanes' policy ids (K2's ids),
// the withheld FIFO plane [lanes, B] in the ledger and per-lane logits.
cudaError_t cpr_k13_attack(const LaneIn* in, const Ledger* led,
                           const Planes* pl, int flooding, const Out* out,
                           void* stream) {
  return cpr::netsim::launch_event<true>(*in, *led, *pl, flooding, *out,
                                         (cudaStream_t)stream);
}

// The static shared memory of the kernel's instantiation for `ns`
// node slots a thread and the most a block of the current card may
// have, for the wrapper's node limit.
cudaError_t cpr_k13_smem(int ns, int* static_bytes,
                         int* block_bytes) {
  return cpr::netsim::event_smem_limits<true, cpr::netsim::kNak>(
      ns, static_bytes, block_bytes);
}

const char* cpr_k13_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
