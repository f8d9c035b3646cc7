// The four scripted Nakamoto SSZ policies as a device function, on the
// integer fork state (a, h): shared by K2/K3 (nakamoto_stream.cu) and the
// attacker in the network, K13 (netsim_attack.cu).
//
// Replaces: cpr_tpu/envs/nakamoto.py:247-289 (`honest`, `simple`,
// `es_2014`, `sm1`). The reference decodes (a, h) from the unit
// observation, which round-trips exactly while both stay below 1696
// (tests/test_torch_params_obs.py).

#pragma once

#include <cstdint>

namespace cpr {

constexpr int kAdopt = 0, kOverride = 1, kMatch = 2, kWait = 3;
constexpr int kEvPow = 0, kEvNetwork = 1;

// Policy ids: cpr_tpu_torch.envs.nakamoto.POLICY_NAMES order.
__device__ __forceinline__ int policy(int id, int32_t a, int32_t h) {
  switch (id) {
    case 0:  // honest
      return a > h ? kOverride : (a < h ? kAdopt : kWait);
    case 1:  // simple
      return h > 0 ? (a < h ? kAdopt : kOverride) : kWait;
    case 2:  // eyal-sirer-2014
      if (a < h) return kAdopt;
      if (h == 0 && a == 1) return kWait;
      if (h == 1 && a == 1) return kMatch;
      if (h == 1 && a == 2) return kOverride;
      if (h > 0) return a - h == 1 ? kOverride : kMatch;
      return kWait;
    default:  // sapirshtein-2016-sm1
      if (h > a) return kAdopt;
      if (h == 1 && a == 1) return kMatch;
      if (h == a - 1 && h >= 1) return kOverride;
      return kWait;
  }
}

}  // namespace cpr
