// Kernel K11-act: the PPO actor-critic in the loop of the stream kernels
// (K2, csrc/nakamoto_stream.cu, a thread per lane; every K10 through
// csrc/dag_env.cuh, a warp per lane), and its check kernel
// (csrc/actor_check.cu).
//
// Replaces: cpr_tpu/train/ppo.py:86-102 `ActorCritic.__call__` (two tanh
// MLPs, a policy and a value head) and :339-344, the rollout's per-step
// key split, `jax.random.categorical` and the gathered log_softmax; in
// greedy mode the argmax of cpr_tpu/train/driver.py:137-139 and :327-329.
// Plain twins: cpr_tpu_torch/train/ppo.py `ActorCritic.forward`,
// `rollout_plain`, `NetPolicy.act`.
//
// Bound: operations. A lane step is 2 * (F*H + H*H) + H*(A+1) FMAs
// (about 10,000 at F = 12, H = 64, A = 8) and A gumbel draws, against a
// few dozen bytes of observation. The weights (41 KB at H = 64, 86 KB
// at H = 96) are read by every lane every step, so each block copies
// them once into shared memory (dynamic, so above 48 KB too) and reads
// them from there: in a warp the 32 threads read neighbouring hidden
// units (no bank conflicts); in thread mode all threads read the same
// word (a broadcast).
//
// Parity: the inputs of layer 2 travel between the warp's threads by
// shuffles; head sums are xor-butterflies, whose result has the same bits
// in every thread (each step adds the same two numbers, commutatively), so
// the action is warp-uniform. Sums run in another order than XLA's and
// with FMAs, and tanhf/expf/logf are CUDA's: logits, value and logp hold
// to the plain version within 1e-5, and an action differs only where two
// perturbed logits are closer than that (chip_smoke.py counts those
// lanes). The Gumbel bits are jax's: element lane * A + a of
// `uniform(k_act, (L, A))` in the partitionable threefry.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace cpr {

constexpr int kNetMaxIn = 16;
constexpr int kNetMaxHidden = 96;
constexpr int kNetSlots = kNetMaxHidden / 32;  // hidden units a warp thread
constexpr int kNetMaxActions = 24;
constexpr int kNetOff = 0, kNetGreedy = 1, kNetSample = 2;

// ctypes `_NetArgs`. The flat parameter vector holds, for pi then vf,
// each Dense's kernel [in, out] row-major and then its bias: layers
// 0 and 1 of width `hidden`, then the head (A outputs, or 1).
struct NetArgs {
  const float* w;  // the flat parameters
  float* logp;     // [T, L]: the drawn action's log-probability, or null
  float* value;    // [T, L]: the value head, or null
  const uint2* key_in;  // sample mode: the carry key before the launch
  uint2* key_out;       // sample mode: the carry key after it (not key_in)
  int32_t in;           // the net's input width
  int32_t hidden;
  int32_t n_actions;
  int32_t mode;  // kNetOff, kNetGreedy, kNetSample
};

__host__ __device__ inline int net_mlp_floats(int in, int h, int out) {
  return in * h + h + h * h + h + h * out + out;
}

__host__ __device__ inline int net_floats(int in, int h, int a) {
  return net_mlp_floats(in, h, a) + net_mlp_floats(in, h, 1);
}

// The block copies the weights into dynamic shared memory; every thread
// of the block must call this, before any of them returns.
__device__ __forceinline__ const float* net_to_shared(const NetArgs& n) {
  extern __shared__ float net_smem[];
  if (n.mode == kNetOff) return nullptr;
  const int total = net_floats(n.in, n.hidden, n.n_actions);
  for (int i = threadIdx.x; i < total; i += blockDim.x) net_smem[i] = n.w[i];
  __syncthreads();
  return net_smem;
}

// One MLP (two tanh layers and a linear head of `nout` <= NOUT outputs)
// run by one thread on x[in].
template <int NOUT>
__device__ __forceinline__ void mlp_thread(const float* w, int in, int h,
                                           int nout, const float* x,
                                           float* out) {
  const float* b0 = w + in * h;
  const float* w1 = b0 + h;
  const float* b1 = w1 + h * h;
  const float* wh = b1 + h;
  const float* bh = wh + h * nout;
  float h0[kNetMaxHidden];
#pragma unroll
  for (int j = 0; j < kNetMaxHidden; ++j) {
    float acc = 0.f;
    if (j < h) {
#pragma unroll
      for (int i = 0; i < kNetMaxIn; ++i)
        if (i < in) acc = fmaf(x[i], w[i * h + j], acc);
      acc = tanhf(acc + b0[j]);
    }
    h0[j] = acc;
  }
#pragma unroll
  for (int a = 0; a < NOUT; ++a) out[a] = 0.f;
  for (int j = 0; j < h; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kNetMaxHidden; ++i)
      if (i < h) acc = fmaf(h0[i], w1[i * h + j], acc);
    const float h1 = tanhf(acc + b1[j]);
#pragma unroll
    for (int a = 0; a < NOUT; ++a)
      if (a < nout) out[a] = fmaf(h1, wh[j * nout + a], out[a]);
  }
#pragma unroll
  for (int a = 0; a < NOUT; ++a)
    if (a < nout) out[a] += bh[a];
}

// The same MLP run by a whole warp on the warp-uniform x[in]: thread t
// holds hidden units t, t + 32, t + 64; every thread ends with all outputs.
template <int NOUT>
__device__ __forceinline__ void mlp_warp(const float* w, int in, int h,
                                         int nout, const float* x,
                                         float* out) {
  const int t = threadIdx.x & 31;
  const float* b0 = w + in * h;
  const float* w1 = b0 + h;
  const float* b1 = w1 + h * h;
  const float* wh = b1 + h;
  const float* bh = wh + h * nout;
  float h0[kNetSlots], h1[kNetSlots];
#pragma unroll
  for (int s = 0; s < kNetSlots; ++s) {
    const int j = t + 32 * s;
    float acc = 0.f;
    if (j < h) {
#pragma unroll
      for (int i = 0; i < kNetMaxIn; ++i)
        if (i < in) acc = fmaf(x[i], w[i * h + j], acc);
      acc = tanhf(acc + b0[j]);
    }
    h0[s] = acc;
  }
#pragma unroll
  for (int s = 0; s < kNetSlots; ++s) {
    const int j = t + 32 * s;
    float acc = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kNetSlots; ++s2) {
      if (32 * s2 >= h) break;  // warp-uniform
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        const float hv = __shfl_sync(0xffffffffu, h0[s2], src);
        const int i = 32 * s2 + src;
        if (j < h && i < h) acc = fmaf(hv, w1[i * h + j], acc);
      }
    }
    h1[s] = j < h ? tanhf(acc + b1[j]) : 0.f;
  }
#pragma unroll
  for (int a = 0; a < NOUT; ++a) {
    if (a >= nout) break;  // warp-uniform
    float p = 0.f;
#pragma unroll
    for (int s = 0; s < kNetSlots; ++s) {
      const int j = t + 32 * s;
      if (j < h) p = fmaf(h1[s], wh[j * nout + a], p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    out[a] = p + bh[a];
  }
}

// The action of `logits` [A]: the argmax (first index among equals) of
// the logits (greedy) or of logits + gumbel(k_act) at flat index
// lane * A + a (sample); `logp` its log_softmax entry.
template <int MAXA>
__device__ __forceinline__ int net_choose(const NetArgs& n,
                                          const float* logits, uint2 k_act,
                                          int64_t lane, float& logp) {
  const int A = n.n_actions;
  const bool sample = n.mode == kNetSample;
  float m = logits[0];
  int best = 0;
  float bv = -__int_as_float(0x7f800000);
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    if (a >= A) break;
    m = fmaxf(m, logits[a]);
    float v = logits[a];
    if (sample)
      v = gumbel_of_bits(random_bits(k_act, (uint32_t)(lane * A + a))) + v;
    if (v > bv) {
      bv = v;
      best = a;
    }
  }
  float s = 0.f, chosen = logits[0];
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    if (a >= A) break;
    s += expf(logits[a] - m);
    if (a == best) chosen = logits[a];
  }
  logp = (chosen - m) - logf(s);
  return best;
}

// The actor in a stream step, thread mode (K2): x[in] -> action; stores
// logp and value at `ti` where asked.
template <int MAXA>
__device__ __forceinline__ int net_act_thread(const NetArgs& n,
                                              const float* w, const float* x,
                                              uint2 k_act, int64_t lane,
                                              int64_t ti) {
  float logits[MAXA], value[1];
  mlp_thread<MAXA>(w, n.in, n.hidden, n.n_actions, x, logits);
  mlp_thread<1>(w + net_mlp_floats(n.in, n.hidden, n.n_actions), n.in,
                n.hidden, 1, x, value);
  float logp;
  const int a = net_choose<MAXA>(n, logits, k_act, lane, logp);
  if (n.logp != nullptr) n.logp[ti] = logp;
  if (n.value != nullptr) n.value[ti] = value[0];
  return a;
}

// The same in warp mode (K10); thread 0 stores.
template <int MAXA>
__device__ __forceinline__ int net_act_warp(const NetArgs& n, const float* w,
                                            const float* x, uint2 k_act,
                                            int64_t lane, int64_t ti) {
  float logits[MAXA], value[1];
  mlp_warp<MAXA>(w, n.in, n.hidden, n.n_actions, x, logits);
  mlp_warp<1>(w + net_mlp_floats(n.in, n.hidden, n.n_actions), n.in,
              n.hidden, 1, x, value);
  float logp;
  const int a = net_choose<MAXA>(n, logits, k_act, lane, logp);
  if ((threadIdx.x & 31) == 0) {
    if (n.logp != nullptr) n.logp[ti] = logp;
    if (n.value != nullptr) n.value[ti] = value[0];
  }
  return a;
}

// The rollout's carry-key chain (ppo.py:341): each step splits the key
// in two, keeps the first half and draws with the second.
struct NetKeys {
  uint2 carry;
  __device__ __forceinline__ explicit NetKeys(const NetArgs& n)
      : carry(n.mode == kNetSample ? *n.key_in : make_uint2(0u, 0u)) {}
  __device__ __forceinline__ uint2 next() {
    const uint2 k_act = split_key(carry, 1u);
    carry = split_key(carry, 0u);
    return k_act;
  }
};

// Dynamic shared memory of a launch with the net (0 without it).
inline size_t net_smem_bytes(const NetArgs* n) {
  if (n == nullptr || n->mode == kNetOff) return 0;
  return sizeof(float) * (size_t)net_floats(n->in, n->hidden, n->n_actions);
}

}  // namespace cpr
