// The check kernel of K11-act (csrc/actor.cuh): the actor's device
// functions on given observations, outside any env stream, so that they
// can be held against the plain version (cpr_tpu_torch/train/ppo.py
// `ActorCritic.forward` and the categorical draw) and timed alone.
//
// Replaces: as csrc/actor.cuh (cpr_tpu/train/ppo.py:86-102, :341-344).
//
// Per lane: the observation obs[lane] [F], under extend_obs followed by
// (alpha[lane], gamma[lane]), goes through both MLPs in thread mode (a
// thread per lane, as K2 runs it) or warp mode (a warp per lane, as K10
// runs it); the action is chosen from the logits with `k_act` (the key
// of one rollout step) as the stream kernels choose it. Outputs logits
// [L, A], value [L], action [L], logp [L].
//
// Bound: operations, as K11-act in the streams (2 (F H + H H) + H (A + 1)
// FMAs a lane).

#include <cuda_runtime.h>

#include <cstdint>

#include "actor.cuh"

namespace {

using namespace cpr;

constexpr int kThreads = 128;

struct CheckOut {
  float* logits;
  float* value;
  int32_t* action;
  float* logp;
};

__device__ __forceinline__ void lane_input(const float* obs, int F,
                                           const float* alpha,
                                           const float* gamma, int64_t lane,
                                           float* x) {
  const bool ext = alpha != nullptr;
#pragma unroll
  for (int i = 0; i < kNetMaxIn; ++i)
    x[i] = i < F                ? obs[lane * F + i]
           : ext && i == F      ? alpha[lane]
           : ext && i == F + 1  ? gamma[lane]
                                : 0.f;
}

template <bool WARP>
__global__ void __launch_bounds__(kThreads)
actor_check_kernel(NetArgs n, const float* __restrict__ obs, int F,
                   const float* __restrict__ alpha,
                   const float* __restrict__ gamma, int64_t n_lanes,
                   CheckOut out) {
  const float* w = net_to_shared(n);
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t lane = WARP ? tid >> 5 : tid;
  if (lane >= n_lanes) return;  // whole warps in warp mode
  float x[kNetMaxIn];
  lane_input(obs, F, alpha, gamma, lane, x);
  const int A = n.n_actions;
  float logits[kNetMaxActions], value[1];
  if (WARP) {
    mlp_warp<kNetMaxActions>(w, n.in, n.hidden, A, x, logits);
    mlp_warp<1>(w + net_mlp_floats(n.in, n.hidden, A), n.in, n.hidden, 1, x,
                value);
  } else {
    mlp_thread<kNetMaxActions>(w, n.in, n.hidden, A, x, logits);
    mlp_thread<1>(w + net_mlp_floats(n.in, n.hidden, A), n.in, n.hidden, 1,
                  x, value);
  }
  float logp;
  const uint2 k_act = n.mode == kNetSample ? *n.key_in : make_uint2(0u, 0u);
  const int a = net_choose<kNetMaxActions>(n, logits, k_act, lane, logp);
  if (WARP && (threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int j = 0; j < kNetMaxActions; ++j)
    if (j < A) out.logits[lane * A + j] = logits[j];
  out.value[lane] = value[0];
  out.action[lane] = a;
  out.logp[lane] = logp;
}

template <bool WARP>
cudaError_t launch(const NetArgs* n, const float* obs, int F,
                   const float* alpha, const float* gamma, int64_t n_lanes,
                   const CheckOut* out, cudaStream_t s) {
  auto kernel = actor_check_kernel<WARP>;
  const size_t smem = net_smem_bytes(n);
  if (smem > 0) {  // static + dynamic may pass 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t threads = WARP ? 32 * n_lanes : n_lanes;
  kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, smem,
           s>>>(*n, obs, F, alpha, gamma, n_lanes, *out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11-act check launch: `n` the net (greedy or sample mode; key_in holds
// the step's k_act), `obs` [L, F], `alpha`/`gamma` [L] or null (no
// extend_obs), `out` the four outputs; warp mode if `warp`.
cudaError_t cpr_k11_actor_check(const NetArgs* n, const void* obs, int F,
                                const void* alpha, const void* gamma,
                                int64_t n_lanes, int warp, const void* out,
                                void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  if (n->n_actions > kNetMaxActions || n->hidden > kNetMaxHidden ||
      n->in > kNetMaxIn)
    return cudaErrorInvalidValue;
  const CheckOut* o = static_cast<const CheckOut*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* ob = static_cast<const float*>(obs);
  const float* al = static_cast<const float*>(alpha);
  const float* ga = static_cast<const float*>(gamma);
  return warp ? launch<true>(n, ob, F, al, ga, n_lanes, o, s)
              : launch<false>(n, ob, F, al, ga, n_lanes, o, s);
}

const char* cpr_k11_act_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
