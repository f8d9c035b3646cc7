// The episode-stream and step_lanes drivers of the DAG envs' kernels
// (K10-bk, K10-eth, K10-ts, K10-stree, K10-spar, K10-sdag), one warp per
// lane, templated on the env.
//
// Replaces: cpr_tpu/envs/base.py:342-506 `make_episode_stats_fn` (its
// scan over `_autoreset_body`, 206-231) with `rollout` (303-328) as the
// STORE_TRAJ variant and `init_lanes`/`reset_lanes` (245-257) as its
// zero-length launches, and base.py:259-301 `step_lanes`; the auto-reset
// is the logical reset of base.py:87-124 (rows [0, 2) of every DAG plane
// and every scalar switch to the fresh state, computed in place). Plain
// twins: cpr_tpu_torch/envs/base.py `stream_plain`, `step_lanes_plain`.
// The design follows K2/K3 (csrc/nakamoto_stream.cu) with a warp where
// those have a thread: the lane's scalars are warp-uniform registers,
// its DAG is K8's `LaneDag` (csrc/dag.cuh).
//
// An env supplies, as static device functions of a struct:
//   kObs                       observation length
//   reset(g, s, key, p, c, x)  dag cleared to rows [0, 2), fresh scalars,
//                              genesis and the first interaction
//   step(g, s, action, p, c, x, out)   one step and finish_step
// where x is the env's per-slot plane [L][W] (`EnvPtrs::stale`; LaneDag's
// plane reads index it by lane), nullptr for an env without one;
//   obs_ints(g, s, c, v)       the observation's natural-scale fields
//   encode(v, c, f)            obs.encode of those fields
//   policy(id, v, c)           a scripted policy on the integer fields
//
// Each lane loads its own EnvParams at kernel start (csrc/lane_params.cuh).
// With `net` the stream runs the actor-critic of K11-act (csrc/actor.cuh)
// on the encoded observation, the warp sharing the hidden units, instead
// of a scripted policy; `extend_obs` appends the lane's (alpha, gamma) to
// every observation written and to the net's input
// (cpr_tpu/envs/assumption.py).
//
// K14-dag (`dag_burst_kernel`) is the serve engine's policy burst over
// the same env step, built into every K10 library: it replaces
// cpr_tpu/serve/engine.py:215-344 `_build_burst` (the K-step burst over
// the resident lanes, K15's `record` inline) over the DAG envs' `step`
// (cpr_tpu/envs/{bk,ethereum,tailstorm,stree,spar,sdag}.py,
// tailstorm_june.py); plain twin cpr_tpu_torch/serve/engine.py
// `ResidentEngine._burst_plain`. It is K14 (csrc/nakamoto_stream.cu) with
// a warp where that has a thread: `burst` steps of every live lane under
// its policy table entry (the env's scripted policy on the integer
// fields, or K11-act's policy MLP on the encoded observation, greedy or
// sampled under fold_in(exp key, t)), the logical auto-reset as in the
// stream, the first-done registers, and with the rings every live step
// recorded. An admitted lane first takes what the engine's splice gives
// it, the DAG of a fresh `init_lanes` carry (every row of every plane
// empty) reset from split(key, 1), so no stale row of its last session
// survives; a lane that is neither live nor admitted keeps its carry and
// rings bit for bit. Bound: the env step's warp-collective latency, as
// the K10 stream; with nets the policy MLP's FMAs a step (shared by the
// warp: at (64, 64) and F = 10, 4.8k FMAs, 150 a thread); with the rings
// 49 to 61 bytes a step. The nets' weights go to dynamic shared memory
// once a block (`BurstArgs::smem_floats`); the static shared memory of
// K9's scratch (csrc/quorum.cuh) is beside them, and the launcher refuses
// a table whose nets do not fit (`kernels.check_dag_burst_nets`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "actor.cuh"
#include "burst.cuh"
#include "dag.cuh"
#include "exp_ring.cuh"
#include "lane_params.cuh"
#include "threefry.cuh"

namespace cpr {

// Per-lane scalars of a DAG env state (ctypes `_EnvPtrs`): i = public,
// private, event, pending_append | race_tip, steps, n_activations and
// tailstorm's match_tgt; f = time and the five last_* fields; b =
// ethereum's mining_own, mining_foreign | tailstorm's def_dirty | stree's,
// spar's and sdag's mining_excl; `stale` the [L][W] bool plane of
// tailstorm, stree and sdag. An env without a field passes nullptr.
struct EnvPtrs {
  int32_t* i[7];
  float* f[6];
  bool* b[2];
  uint2* key;
  bool* stale;
};

struct EnvParams {
  float alpha;
  float gamma;
  float activation_delay;
  float max_progress;
  float max_time;
  int32_t max_steps;
};

// Static env options (ctypes `_EnvConfig`).
struct EnvConfig {
  int32_t k;           // bk: votes per block; the parallel-PoW envs: k
  int32_t constant;    // incentive scheme: bk, spar constant | block, eth constant | discount
  int32_t ctk;         // bk: release selection width (capacity_topk)
  int32_t max_uncles;  // eth
  int32_t pref_work;   // eth: preference by work (else height)
  int32_t prog_work;   // eth: progress by work (else height)
  int32_t whitepaper;  // eth: the whitepaper preset's policy fields
  int32_t strict;      // eth: strict_match
  int32_t scheme;      // tailstorm, stree, sdag: constant | discount | punish | hybrid
                       // (| block: 4, TailstormJune on K10-stree)
  int32_t selection;   // tailstorm, stree, sdag: altruistic | heuristic | optimal
  int32_t cmax;        // tailstorm, stree, sdag: quorum candidate frame C
  int32_t rscan;       // tailstorm, stree, sdag: release scan R
  int32_t opt_window;  // tailstorm, stree: optimal selection's window
  int32_t unit;        // unit observations
};

// Trajectory, time-major: obs [T, L, kObs], action/reward/done [T, L],
// info [12, T, L].
struct DagTrajPtrs {
  float* obs;
  int32_t* action;
  float* reward;
  bool* done;
  float* info;
};

constexpr int kInfo = 12;    // INFO_KEYS, in order
constexpr int kEpisode = 7;  // info[5..11]: the episode_* keys
constexpr int kMaxObs = 10;  // encoded fields
constexpr int kMaxRow = kMaxObs + 2;  // + (alpha, gamma) under extend_obs
constexpr int kWarpsPerBlock = 4;

struct Scal {
  int32_t pub, priv, event, x, steps, nact, y;
  float time, last[5];  // last_reward_attacker .. last_sim_time
  bool own, foreign;
  uint2 key;
};

struct StepOut {
  float reward;
  bool done;
  float info[kInfo];
};

__device__ __forceinline__ Scal load_scal(const EnvPtrs& e, int64_t i) {
  Scal s;
  s.pub = e.i[0][i];
  s.priv = e.i[1][i];
  s.event = e.i[2][i];
  s.x = e.i[3][i];
  s.steps = e.i[4][i];
  s.nact = e.i[5][i];
  s.y = e.i[6] != nullptr ? e.i[6][i] : kNone;
  s.time = e.f[0][i];
#pragma unroll
  for (int j = 0; j < 5; ++j) s.last[j] = e.f[1 + j][i];
  s.own = e.b[0] != nullptr ? e.b[0][i] : false;
  s.foreign = e.b[1] != nullptr ? e.b[1][i] : false;
  s.key = e.key[i];
  return s;
}

__device__ __forceinline__ void store_scal(const EnvPtrs& e, int64_t i,
                                           const Scal& s) {
  if ((threadIdx.x & 31) != 0) return;
  e.i[0][i] = s.pub;
  e.i[1][i] = s.priv;
  e.i[2][i] = s.event;
  e.i[3][i] = s.x;
  e.i[4][i] = s.steps;
  e.i[5][i] = s.nact;
  if (e.i[6] != nullptr) e.i[6][i] = s.y;
  e.f[0][i] = s.time;
#pragma unroll
  for (int j = 0; j < 5; ++j) e.f[1 + j][i] = s.last[j];
  if (e.b[0] != nullptr) e.b[0][i] = s.own;
  if (e.b[1] != nullptr) e.b[1][i] = s.foreign;
  e.key[i] = s.key;
}

// Fresh scalars on `key` (the reset's zero state before its first draw).
__device__ __forceinline__ void zero_scal(Scal& s, uint2 key, int32_t event) {
  s.pub = s.priv = 0;
  s.event = event;
  s.x = s.y = kNone;
  s.steps = s.nact = 0;
  s.time = 0.f;
#pragma unroll
  for (int j = 0; j < 5; ++j) s.last[j] = 0.f;
  s.own = s.foreign = true;
  s.key = key;
}

// The four keys of one activation: split(key, 4) and one 32-bit draw from
// each of the last three (jax.random.split + exponential/uniform).
struct Draws {
  uint2 key;
  float e, u1, u2;
};

__device__ __forceinline__ Draws draw4(uint2 key) {
  Draws r;
  r.key = split_key(key, 0u);
  r.e = exponential_of_bits(random_bits(split_key(key, 1u), 0u));
  r.u1 = uniform_of_bits(random_bits(split_key(key, 2u), 0u));
  r.u2 = uniform_of_bits(random_bits(split_key(key, 3u), 0u));
  return r;
}

// The five keys of one mining draw: split(key, 5) and one 32-bit draw from
// each of the last four (tailstorm.py:496-514, stree.py:307-319).
struct Draws5 {
  uint2 key;
  float e, u_mine, u_hash, u_gamma;
};

__device__ __forceinline__ Draws5 draw5(uint2 key) {
  Draws5 r;
  r.key = split_key(key, 0u);
  r.e = exponential_of_bits(random_bits(split_key(key, 1u), 0u));
  r.u_mine = uniform_of_bits(random_bits(split_key(key, 2u), 0u));
  r.u_hash = uniform_of_bits(random_bits(split_key(key, 3u), 0u));
  r.u_gamma = uniform_of_bits(random_bits(split_key(key, 4u), 0u));
  return r;
}

// The lane's row of a per-slot plane outside the DAG (`EnvPtrs::stale`).
__device__ __forceinline__ bool* lane_plane(bool* plane, const LaneDag& g) {
  return plane + g.lane * (int64_t)g.W;
}

// base.py:137-171 `finish_step`.
__device__ __forceinline__ void finish_step(Scal& s, const EnvParams& p,
                                            float ra, float rd,
                                            float progress, float ct,
                                            bool extra_done, StepOut& o) {
  o.done = !(s.steps < p.max_steps && progress < p.max_progress &&
             s.time < p.max_time) ||
           extra_done;
  o.reward = ra - s.last[0];
  o.info[0] = o.reward;
  o.info[1] = rd - s.last[1];
  o.info[2] = progress - s.last[2];
  o.info[3] = ct - s.last[3];
  o.info[4] = s.time - s.last[4];
  o.info[5] = ra;
  o.info[6] = rd;
  o.info[7] = progress;
  o.info[8] = ct;
  o.info[9] = s.time;
  o.info[10] = (float)s.steps;
  o.info[11] = (float)s.nact;
  s.last[0] = ra;
  s.last[1] = rd;
  s.last[2] = progress;
  s.last[3] = ct;
  s.last[4] = s.time;
}

// obs.py field encodings, float32 in the JAX package's order.
__device__ __forceinline__ float enc_uint(int32_t x, float scale, bool unit) {
  if (!unit) return (float)x;
  const float two_over_pi = (float)(2.0 / 3.14159265358979323846);
  return two_over_pi * atanf((float)x / scale);
}
__device__ __forceinline__ float enc_int(int32_t x, float scale, bool unit) {
  if (!unit) return (float)x;
  const float pi = (float)3.14159265358979323846;
  return 0.5f + atanf((float)x / scale) / pi;
}
__device__ __forceinline__ float enc_discrete(int32_t x, int n, bool unit) {
  if (!unit) return (float)x;
  return (float)x / (float)(n - 1);
}

// Thread f < n of the warp writes element f of `v` to `out`.
__device__ __forceinline__ void put_row(float* out, const float* v, int n) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int f = 0; f < kMaxRow; ++f)
    if (f < n && f == t) out[f] = v[f];
}

// The lane's params, loaded once by the warp into shared memory: the
// env step reads them there rather than holding six more registers in a
// kernel already at its register limit.
__device__ __forceinline__ const EnvParams& warp_params(const ParamPtrs& pp,
                                                       int64_t lane) {
  __shared__ EnvParams lane_params[kWarpsPerBlock];
  EnvParams& p = lane_params[(threadIdx.x >> 5) % kWarpsPerBlock];
  if ((threadIdx.x & 31) == 0) p = load_params<EnvParams>(pp, lane);
  __syncwarp();
  return p;
}

// The encoded observation of width F: f[kObs] then, under extend_obs,
// the lane's (alpha, gamma).
template <class Env>
__device__ __forceinline__ void encode_ext(const int32_t* v,
                                           const EnvConfig& c,
                                           const EnvParams& p, bool ext,
                                           float* f) {
  Env::encode(v, c, f);
  if (ext) {
    f[Env::kObs] = p.alpha;
    f[Env::kObs + 1] = p.gamma;
  }
}

template <class Env, bool STORE_TRAJ, bool NET>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dag_stream_kernel(const __grid_constant__ DagPtrs dp,
                  const __grid_constant__ EnvPtrs ep, float* __restrict__ obs,
                  const uint2* __restrict__ keys, int init_mode,
                  int64_t n_lanes, int length, ParamPtrs pp, EnvConfig c,
                  int policy_id, bool ext, float* __restrict__ sums,
                  int32_t* __restrict__ n_done, DagTrajPtrs traj,
                  NetArgs net) {
  const float* w = NET ? net_to_shared(net) : nullptr;
  const int64_t lane = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (lane >= n_lanes) return;  // whole warps
  // the net's launches all take the STORE_TRAJ instantiation, with or
  // without a trajectory (one fewer copy of the env step to compile)
  const bool keep_traj = STORE_TRAJ && traj.action != nullptr;
  const EnvParams& p = warp_params(pp, lane);
  const int F = Env::kObs + (ext ? 2 : 0);
  NetKeys nk(net);
  LaneDag g;
  g.bind(dp, lane);
  bool* x = ep.stale;
  Scal s;
  if (init_mode == 0) {
    g.load_scalars();
    s = load_scal(ep, lane);
  } else {
    const uint2 k = keys[lane];
    Env::reset(g, s, init_mode == 1 ? split_key(k, 1u) : k, p, c, x);
  }
  int32_t v[kMaxObs];
  float f[NET ? kNetMaxIn : kMaxRow];
  Env::obs_ints(g, s, c, v);
  float acc[kEpisode];
#pragma unroll
  for (int k = 0; k < kEpisode; ++k) acc[k] = 0.f;
  int32_t nd = 0;
  const int t = threadIdx.x & 31;
  for (int step = 0; step < length; ++step) {
    const int64_t ti = step * n_lanes + lane;
    int action;
    if (NET || keep_traj) encode_ext<Env>(v, c, p, ext, f);
    if (NET) {
      const uint2 k_act =
          net.mode == kNetSample ? nk.next() : make_uint2(0u, 0u);
      action = net_act_warp<kNetMaxActions>(net, w, f, k_act, lane, ti);
    } else {
      action = Env::policy(policy_id, v, c);
    }
    if (keep_traj) {
      put_row(traj.obs + ti * F, f, F);
      if (t == 0) traj.action[ti] = action;
    }
    StepOut o;
    Env::step(g, s, action, p, c, x, o);
    if (keep_traj && t == 0) {
      traj.reward[ti] = o.reward;
      traj.done[ti] = o.done;
#pragma unroll
      for (int k = 0; k < kInfo; ++k)
        traj.info[(int64_t)k * length * n_lanes + ti] = o.info[k];
    }
    if (o.done) {
#pragma unroll
      for (int k = 0; k < kEpisode; ++k) acc[k] += o.info[5 + k];
      nd += 1;
      Env::reset(g, s, s.key, p, c, x);
    }
    Env::obs_ints(g, s, c, v);
  }
  store_scal(ep, lane, s);
  g.store_scalars();
  encode_ext<Env>(v, c, p, ext, f);
  put_row(obs + lane * F, f, F);
  if (NET && lane == 0 && t == 0 && net.key_out != nullptr)
    *net.key_out = nk.carry;
  if (sums != nullptr && t == 0) {
#pragma unroll
    for (int k = 0; k < kEpisode; ++k) sums[k * n_lanes + lane] = acc[k];
    n_done[lane] = nd;
  }
}

// Admit (copy the fresh lane whole), step the lanes in step_mask, leave
// the rest bit for bit; outputs zero/false outside step_mask, out_obs the
// raw post-step observation for stepped lanes and the held one elsewhere.
template <class Env>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dag_step_lanes_kernel(const __grid_constant__ DagPtrs dp,
                      const __grid_constant__ EnvPtrs ep,
                      float* __restrict__ obs,
                      const int32_t* __restrict__ actions,
                      const bool* __restrict__ admit,
                      const __grid_constant__ DagPtrs fdp,
                      const __grid_constant__ EnvPtrs fep,
                      const float* __restrict__ fresh_obs,
                      const bool* __restrict__ step_mask, int64_t n_lanes,
                      ParamPtrs pp, EnvConfig c, bool ext,
                      float* __restrict__ out_obs,
                      float* __restrict__ reward, bool* __restrict__ done,
                      float* __restrict__ info) {
  const int64_t lane = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (lane >= n_lanes) return;
  const EnvParams& p = warp_params(pp, lane);
  const int t = threadIdx.x & 31;
  const int F = Env::kObs + (ext ? 2 : 0);
  LaneDag g;
  g.bind(dp, lane);
  bool* x = ep.stale;
  const bool admitted = admit[lane];
  Scal s;
  if (admitted) {
    g.copy_from(fdp);
    s = load_scal(fep, lane);
    if (x != nullptr) {
      bool* dst = lane_plane(x, g);
      const bool* src = lane_plane(fep.stale, g);
      for (int j = t; j < g.W; j += 32) dst[j] = src[j];
      __syncwarp();
    }
  } else {
    g.load_scalars();
    s = load_scal(ep, lane);
  }
  int32_t v[kMaxObs];
  float f[kMaxRow];
  if (step_mask[lane]) {
    StepOut o;
    Env::step(g, s, actions[lane], p, c, x, o);
    Env::obs_ints(g, s, c, v);
    encode_ext<Env>(v, c, p, ext, f);
    put_row(out_obs + lane * F, f, F);
    if (o.done) Env::reset(g, s, s.key, p, c, x);
    store_scal(ep, lane, s);
    g.store_scalars();
    Env::obs_ints(g, s, c, v);
    encode_ext<Env>(v, c, p, ext, f);
    put_row(obs + lane * F, f, F);
    if (t == 0) {
      reward[lane] = o.reward;
      done[lane] = o.done;
#pragma unroll
      for (int k = 0; k < kInfo; ++k) info[k * n_lanes + lane] = o.info[k];
    }
    return;
  }
  if (admitted) {
    store_scal(ep, lane, s);
    g.store_scalars();
    if (t < F) obs[lane * F + t] = fresh_obs[lane * F + t];
  }
  __syncwarp();
  if (t < F) out_obs[lane * F + t] = obs[lane * F + t];
  if (t == 0) {
    reward[lane] = 0.f;
    done[lane] = false;
#pragma unroll
    for (int k = 0; k < kInfo; ++k) info[k * n_lanes + lane] = 0.f;
  }
}

// K14-dag: `b.burst` steps of every live lane under its table entry, the
// carry (`dp`/`ep`, `obs` [L, kObs]) updated in place, the first-done
// registers written for every lane (false/0 where not live), and with
// `e.obs` set every live step recorded into the rings (K15, `e.obs_dim`
// = kObs). With `b.admit` the admitted lanes first take their fresh state
// (the splice in the same launch). One instantiation an env, the nets
// read where `b.smem_floats` > 0 (a block-uniform argument).
template <class Env>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dag_burst_kernel(const __grid_constant__ DagPtrs dp,
                 const __grid_constant__ EnvPtrs ep, float* __restrict__ obs,
                 int64_t n_lanes, ParamPtrs pp, EnvConfig c,
                 const __grid_constant__ BurstArgs b,
                 const __grid_constant__ ExpPtrs e) {
  extern __shared__ float net_smem[];
  const bool nets = b.smem_floats > 0;
  if (nets) {
    for (int k = 0; k < kBurstSlots; ++k) {
      if (b.w[k] == nullptr) continue;
      const int nf = net_mlp_floats(b.in[k], b.hidden[k], b.n_actions[k]);
      for (int j = threadIdx.x; j < nf; j += blockDim.x)
        net_smem[b.w_off[k] + j] = b.w[k][j];
    }
    __syncthreads();
  }
  const int64_t lane = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (lane >= n_lanes) return;  // whole warps
  const int t = threadIdx.x & 31;
  const bool admitted = b.admit != nullptr && b.admit[lane];
  const bool live = b.live[lane];
  if (!admitted && !live) {  // held: registers zero, carry and rings kept
    if (t == 0) {
      b.got[lane] = false;
      b.done_step[lane] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) b.caps[k * n_lanes + lane] = 0.f;
    }
    return;
  }
  const EnvParams& p = warp_params(pp, lane);
  constexpr int F = Env::kObs;
  LaneDag g;
  g.bind(dp, lane);
  bool* x = ep.stale;
  Scal s;
  if (admitted) {  // init_lanes' fresh lane: the empty DAG, then reset
    g.clear_all();
    Env::reset(g, s, split_key(b.admit_keys[lane], 1u), p, c, x);
  } else {
    g.load_scalars();
    s = load_scal(ep, lane);
  }
  int32_t v[kMaxObs];
  float f[kNetMaxIn];
  Env::obs_ints(g, s, c, v);
  bool got = false;
  int32_t done_step = 0;
  float cap[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const int32_t pid = b.policy[lane];
    const int kind = b.kind[pid], arg = b.arg[pid];
    const bool by_net = nets && kind != kBurstScripted;
    NetArgs na{};
    const float* w = nullptr;
    if (by_net) {
      na.in = b.in[arg];
      na.hidden = b.hidden[arg];
      na.n_actions = b.n_actions[arg];
      na.mode = kind == kBurstSample ? kNetSampleLane : kNetGreedy;
      w = net_smem + b.w_off[arg];
    }
    const bool rec = e.obs != nullptr;
    int32_t cursor = 0, tt = 0;
    uint2 ekey = make_uint2(0u, 0u);
    if (rec) {
      cursor = e.cursor[lane];
      tt = e.t[lane];
      ekey = e.key[lane];
    }
    for (int k = 0; k < b.burst; ++k) {
      Env::encode(v, c, f);  // the pre-step observation
      int action;
      if (by_net) {
        float logits[kNetMaxActions], logp;
        mlp_warp<kNetMaxActions>(w, na.in, na.hidden, na.n_actions, f,
                                 logits);
        const uint2 k_act = kind == kBurstSample ? exp_step_key(ekey, tt)
                                                 : make_uint2(0u, 0u);
        action = net_choose<kNetMaxActions>(na, logits, k_act, lane, logp);
      } else {
        action = Env::policy(arg, v, c);
      }
      StepOut o;
      Env::step(g, s, action, p, c, x, o);
      if (rec) {
        exp_record_warp<kNetMaxIn>(e, lane, cursor, f, action, o.reward,
                                   o.done, o.info[5], o.info[6], pid);
        ++cursor;
        ++tt;
      }
      if (o.done) Env::reset(g, s, s.key, p, c, x);
      Env::obs_ints(g, s, c, v);
      if (o.done && !got) {  // CAPTURE_FIELDS: info 5, 6, 7, 10
        got = true;
        done_step = k;
        cap[0] = o.info[5];
        cap[1] = o.info[6];
        cap[2] = o.info[7];
        cap[3] = o.info[10];
      }
    }
    if (rec && t == 0) {
      e.cursor[lane] = cursor;
      e.t[lane] = tt;
    }
  }
  store_scal(ep, lane, s);
  g.store_scalars();
  Env::encode(v, c, f);
  put_row(obs + lane * F, f, F);
  if (t == 0) {
    b.got[lane] = got;
    b.done_step[lane] = done_step;
#pragma unroll
    for (int k = 0; k < 4; ++k) b.caps[k * n_lanes + lane] = cap[k];
  }
}

inline unsigned dag_blocks_for(int64_t n_lanes) {
  return (unsigned)((n_lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <class Env, bool STORE_TRAJ, bool NET>
cudaError_t launch_dag_stream_as(const DagPtrs* dp, const EnvPtrs* ep,
                                 void* obs, const void* keys, int init_mode,
                                 int64_t n_lanes, int length,
                                 const ParamPtrs* p, const EnvConfig* c,
                                 int policy_id, int extend_obs, void* sums,
                                 void* n_done, const DagTrajPtrs* traj,
                                 const NetArgs* net, cudaStream_t st) {
  auto kernel = dag_stream_kernel<Env, STORE_TRAJ, NET>;
  const size_t smem = net_smem_bytes(NET ? net : nullptr);
  if (smem > 0) {  // static + dynamic may pass 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dag_blocks_for(n_lanes), 32 * kWarpsPerBlock, smem, st>>>(
      *dp, *ep, static_cast<float*>(obs), static_cast<const uint2*>(keys),
      init_mode, n_lanes, length, *p, *c, policy_id, extend_obs != 0,
      static_cast<float*>(sums), static_cast<int32_t*>(n_done),
      traj != nullptr ? *traj : DagTrajPtrs{},
      NET ? *net : NetArgs{});
  return cudaGetLastError();
}

// The host side of every K10 env's two entry points: launch on `stream`,
// return the launch's error. `net` is null (the scripted `policy_id`) or
// the actor-critic's arguments.
template <class Env>
cudaError_t launch_dag_stream(const DagPtrs* dp, const EnvPtrs* ep, void* obs,
                              const void* keys, int init_mode,
                              int64_t n_lanes, int length, const ParamPtrs* p,
                              const EnvConfig* c, int policy_id,
                              int extend_obs, void* sums, void* n_done,
                              const DagTrajPtrs* traj, const NetArgs* net,
                              void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool with_net = net != nullptr && net->mode != kNetOff;
  if (traj != nullptr)
    return with_net ? launch_dag_stream_as<Env, true, true>(
                          dp, ep, obs, keys, init_mode, n_lanes, length, p, c,
                          policy_id, extend_obs, sums, n_done, traj, net, st)
                    : launch_dag_stream_as<Env, true, false>(
                          dp, ep, obs, keys, init_mode, n_lanes, length, p, c,
                          policy_id, extend_obs, sums, n_done, traj, net, st);
  return with_net ? launch_dag_stream_as<Env, true, true>(
                        dp, ep, obs, keys, init_mode, n_lanes, length, p, c,
                        policy_id, extend_obs, sums, n_done, traj, net, st)
                  : launch_dag_stream_as<Env, false, false>(
                        dp, ep, obs, keys, init_mode, n_lanes, length, p, c,
                        policy_id, extend_obs, sums, n_done, traj, net, st);
}

template <class Env>
cudaError_t launch_dag_step_lanes(
    const DagPtrs* dp, const EnvPtrs* ep, void* obs, const void* actions,
    const void* admit, const DagPtrs* fdp, const EnvPtrs* fep,
    const void* fresh_obs, const void* step_mask, int64_t n_lanes,
    const ParamPtrs* p, const EnvConfig* c, int extend_obs, void* out_obs,
    void* reward, void* done, void* info, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  dag_step_lanes_kernel<Env>
      <<<dag_blocks_for(n_lanes), 32 * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>(
          *dp, *ep, static_cast<float*>(obs),
          static_cast<const int32_t*>(actions),
          static_cast<const bool*>(admit), *fdp, *fep,
          static_cast<const float*>(fresh_obs),
          static_cast<const bool*>(step_mask), n_lanes, *p, *c,
          extend_obs != 0, static_cast<float*>(out_obs),
          static_cast<float*>(reward),
          static_cast<bool*>(done), static_cast<float*>(info));
  return cudaGetLastError();
}

// K14-dag with a resident engine's host traffic in the same call
// (csrc/burst.cuh `burst_staged`). `e` null: the experience plane is off.
template <class Env>
cudaError_t launch_dag_burst(const DagPtrs* dp, const EnvPtrs* ep, void* obs,
                             int64_t n_lanes, const ParamPtrs* p,
                             const EnvConfig* c, const BurstArgs* b,
                             const ExpPtrs* e, const void* h_in, void* d_in,
                             int64_t in_bytes, const void* d_out, void* h_out,
                             int64_t out_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&]() -> cudaError_t {
    if (n_lanes <= 0) return cudaSuccess;
    auto kernel = dag_burst_kernel<Env>;
    const size_t smem = sizeof(float) * (size_t)b->smem_floats;
    if (smem > 0) {  // static + dynamic may pass 48 KB
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<dag_blocks_for(n_lanes), 32 * kWarpsPerBlock, smem, st>>>(
        *dp, *ep, static_cast<float*>(obs), n_lanes, *p, *c, *b,
        e != nullptr ? *e : ExpPtrs{});
    return cudaGetLastError();
  };
  return burst_staged(h_in, d_in, in_bytes, d_out, h_out, out_bytes, st,
                      launch);
}

// K14-dag's static shared memory in this library (the lanes' params and,
// where the env runs K9, its scratch), as the compiled kernel has it, and
// the most shared memory a block of the current device may have; the
// policy MLPs of a launch take the rest.
template <class Env>
cudaError_t dag_burst_smem(int* static_bytes, int* block_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, dag_burst_kernel<Env>);
  if (err != cudaSuccess) return err;
  *static_bytes = (int)a.sharedSizeBytes;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(block_bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace cpr
