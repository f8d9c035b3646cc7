// Kernels K2 (fused episode stream), K3 (one-tick step_lanes) and K14
// (the serve engine's policy burst) for the Nakamoto SSZ selfish-mining
// environment.
//
// Replaces:
//   K2: cpr_tpu/envs/base.py:342-506 `make_episode_stats_fn` (its
//       `run_chunk` scan over `_autoreset_body`, :206-231), with `rollout`
//       (:303-328) as the STORE_TRAJ variant and `init_lanes` /
//       `reset_lanes` (:245-257) as its zero-length launches;
//   K3: cpr_tpu/envs/base.py:259-301 `step_lanes`;
//   K14: cpr_tpu/serve/engine.py:215-344 `_build_burst` (the K-step burst
//        over the resident lanes, with K15's `record` inline);
// all over cpr_tpu/envs/nakamoto.py `_mine` (120-157), `reset`
// (159-174), `_apply` (176-214), `step` (216-237) and the four scripted
// policies (247-289). Plain twins: cpr_tpu_torch/envs/base.py
// (`stream_plain`, `step_lanes_plain`) and cpr_tpu_torch/serve/engine.py
// (`ResidentEngine._burst_plain`).
//
// Bound: integer ALU. A lane step is 7 threefry2x32 blocks (about 560
// integer operations) plus a few dozen for the dynamics, against 76
// bytes of state that stay in registers for the whole K2 launch. The
// design is one thread per lane, the state loaded once and stored once,
// the loop over steps inside the thread, and the auto-reset taken only
// where an episode ended (the reference computes the reset every step and
// selects it; branching gives the same bits with half the threefry work).
//
// Per-lane params: each lane loads its own EnvParams at kernel start
// (csrc/lane_params.cuh); scalar params arrive broadcast to [L]. The
// policy is a scripted one or, with `net`, the actor-critic of K11-act
// (csrc/actor.cuh) run by the lane's thread, which in sample mode also
// stores logp and value beside the trajectory and returns the carry key.
// `extend_obs` appends the lane's (alpha, gamma) to every observation
// written and to the net's input (cpr_tpu/envs/assumption.py).
//
// K14 runs `burst` steps of every live lane, a thread a lane as K2, and
// holds the other lanes bit for bit. A lane's action comes from its
// entry of the engine's policy table: a scripted policy, a greedy net
// (argmax of the logits, first index among equals) or a sampled net (the
// per-lane categorical of csrc/actor.cuh under fold_in(exp key, t)); the
// nets are K11-act's policy MLP, each net slot's weights copied into
// shared memory once a block (a launch whose lanes use no net takes the
// instantiation without them). Per step, as engine.py:241-302: the
// action from the pre-step observation, the auto-resetting step, the
// record (K15, csrc/exp_ring.cuh) of the pre-step observation, action,
// reward, done and episode rewards, the continuation observation, and
// the lane's first done (step index and the four CAPTURE_FIELDS) kept in
// registers. Bound: the threefry work of a step, as K2; with nets the
// policy MLP's FMAs (4 * 64 + 64 * 64 + 64 * 4 at (64, 64)); with the
// rings their 37 bytes a step.
//
// Parity with the JAX package: integer state, keys, actions, done and
// the integer-valued float32 rewards are bit-identical. The time update
// is written with __fmul_rn/__fadd_rn so nvcc cannot contract it into an
// FMA that XLA does not form; log1pf and atanf may differ from XLA's by
// a few ULP. Policies are computed from the integer (a, h): the
// reference decodes them from the unit observation, which round-trips
// exactly while a and h stay below 1763 (tests/test_torch_params_obs.py).
// chip_smoke.py holds the main path's largest fork length below that and
// compares K2 with a plain run that decodes the observation.

#include <cuda_runtime.h>

#include <cstdint>

#include "actor.cuh"
#include "burst.cuh"
#include "exp_ring.cuh"
#include "lane_params.cuh"
#include "nakamoto_policy.cuh"
#include "threefry.cuh"

// The argument structs of the extern "C" entry points (laid out like the
// ctypes Structures in cpr_tpu_torch/kernels/__init__.py); outside the
// anonymous namespace so the entry points keep external linkage.
namespace cpr {

// Field order of cpr_tpu_torch.envs.nakamoto.STATE_FIELDS.
struct StatePtrs {
  int32_t* a;
  int32_t* h;
  int32_t* event;
  int32_t* match_h;
  float* ca_atk;
  float* ca_def;
  float* ca_progress;
  float* time;
  float* t_priv;
  float* t_pub;
  int32_t* steps;
  int32_t* n_activations;
  float* last_reward_attacker;
  float* last_reward_defender;
  float* last_progress;
  float* last_chain_time;
  float* last_sim_time;
  uint2* key;
};

struct Params {
  float alpha;
  float gamma;
  float activation_delay;
  float max_progress;
  float max_time;
  int32_t max_steps;
};

// Per-step trajectory, time-major: obs [T, L, F] (F = 4, or 6 under
// extend_obs), action/reward/done [T, L], info [12, T, L].
struct TrajPtrs {
  float* obs;
  int32_t* action;
  float* reward;
  bool* done;
  float* info;
};

}  // namespace cpr

using cpr::BurstArgs;
using cpr::ExpPtrs;
using cpr::NetArgs;
using cpr::ParamPtrs;
using cpr::Params;
using cpr::StatePtrs;
using cpr::TrajPtrs;

namespace {

using cpr::kAdopt;
using cpr::kEvNetwork;
using cpr::kEvPow;
using cpr::kMatch;
using cpr::kOverride;
using cpr::policy;
constexpr int kInfo = 12;     // INFO_KEYS, in order
constexpr int kEpisode = 7;   // info[5..11]: the episode_* keys
constexpr int kThreads = 128;

struct Lane {
  int32_t a, h, event, match_h;
  float ca_atk, ca_def, ca_progress;
  float time, t_priv, t_pub;
  int32_t steps, n_activations;
  float last_ra, last_rd, last_progress, last_ct, last_st;
  uint2 key;
};

struct StepOut {
  float reward;
  bool done;
  float info[kInfo];
};

__device__ __forceinline__ Lane load(const StatePtrs& s, int64_t i) {
  Lane x;
  x.a = s.a[i];
  x.h = s.h[i];
  x.event = s.event[i];
  x.match_h = s.match_h[i];
  x.ca_atk = s.ca_atk[i];
  x.ca_def = s.ca_def[i];
  x.ca_progress = s.ca_progress[i];
  x.time = s.time[i];
  x.t_priv = s.t_priv[i];
  x.t_pub = s.t_pub[i];
  x.steps = s.steps[i];
  x.n_activations = s.n_activations[i];
  x.last_ra = s.last_reward_attacker[i];
  x.last_rd = s.last_reward_defender[i];
  x.last_progress = s.last_progress[i];
  x.last_ct = s.last_chain_time[i];
  x.last_st = s.last_sim_time[i];
  x.key = s.key[i];
  return x;
}

__device__ __forceinline__ void store(const StatePtrs& s, int64_t i,
                                      const Lane& x) {
  s.a[i] = x.a;
  s.h[i] = x.h;
  s.event[i] = x.event;
  s.match_h[i] = x.match_h;
  s.ca_atk[i] = x.ca_atk;
  s.ca_def[i] = x.ca_def;
  s.ca_progress[i] = x.ca_progress;
  s.time[i] = x.time;
  s.t_priv[i] = x.t_priv;
  s.t_pub[i] = x.t_pub;
  s.steps[i] = x.steps;
  s.n_activations[i] = x.n_activations;
  s.last_reward_attacker[i] = x.last_ra;
  s.last_reward_defender[i] = x.last_rd;
  s.last_progress[i] = x.last_progress;
  s.last_chain_time[i] = x.last_ct;
  s.last_sim_time[i] = x.last_st;
  s.key[i] = x.key;
}

// nakamoto.py:120-157: one activation — split the key in four, one
// exponential time step, Bernoulli(alpha) miner, Bernoulli(gamma) race.
__device__ __forceinline__ void mine(Lane& s, const Params& p) {
  const uint2 knew = cpr::split_key(s.key, 0u);
  const uint2 k_dt = cpr::split_key(s.key, 1u);
  const uint2 k_mine = cpr::split_key(s.key, 2u);
  const uint2 k_gamma = cpr::split_key(s.key, 3u);
  const float e = cpr::exponential_of_bits(cpr::random_bits(k_dt, 0u));
  const float time = __fadd_rn(s.time, __fmul_rn(e, p.activation_delay));
  const bool attacker_mines =
      cpr::uniform_of_bits(cpr::random_bits(k_mine, 0u)) < p.alpha;
  const bool gamma_hit =
      cpr::uniform_of_bits(cpr::random_bits(k_gamma, 0u)) < p.gamma;
  if (attacker_mines) {
    s.a += 1;
    s.event = kEvPow;
    s.t_priv = time;
  } else {
    const bool def_on_attacker =
        s.match_h >= 0 && s.match_h == s.h && gamma_hit;
    if (def_on_attacker) {
      s.ca_atk += (float)s.h;
      s.ca_progress += (float)s.h;
      s.a -= s.h;
      s.h = 1;
    } else {
      s.h += 1;
    }
    s.match_h = -1;
    s.event = kEvNetwork;
    s.t_pub = time;
  }
  s.time = time;
  s.n_activations += 1;
  s.key = knew;
}

// nakamoto.py:159-174: fresh state on `key`, fast-forwarded one activation.
__device__ __forceinline__ void reset(Lane& s, uint2 key, const Params& p) {
  s.a = 0;
  s.h = 0;
  s.event = kEvPow;
  s.match_h = -1;
  s.ca_atk = s.ca_def = s.ca_progress = 0.f;
  s.time = s.t_priv = s.t_pub = 0.f;
  s.steps = 0;
  s.n_activations = 0;
  s.last_ra = s.last_rd = s.last_progress = s.last_ct = s.last_st = 0.f;
  s.key = key;
  mine(s, p);
}

// nakamoto.py:176-214.
__device__ __forceinline__ void apply(Lane& s, int action, bool strict) {
  const int32_t a = s.a, h = s.h;
  const bool adopt = action == kAdopt;
  const bool override_eff = action == kOverride && a > h;
  bool match_eff = action == kMatch && a >= h && h > 0;
  if (strict) match_eff = match_eff && s.event == kEvNetwork;
  if (override_eff) {
    s.ca_atk += (float)(h + 1);
    s.ca_progress += (float)(h + 1);
  }
  if (adopt) {
    s.ca_def += (float)h;
    s.ca_progress += (float)h;
  }
  s.a = adopt ? 0 : (override_eff ? a - (h + 1) : a);
  s.h = (adopt || override_eff) ? 0 : h;
  s.match_h = match_eff ? h : ((adopt || override_eff) ? -1 : s.match_h);
  const float t_priv = s.t_priv, t_pub = s.t_pub;
  s.t_priv = adopt ? t_pub : t_priv;
  s.t_pub = override_eff ? t_priv : t_pub;
}

// nakamoto.py:216-237 followed by base.py:137-171 `finish_step`.
__device__ __forceinline__ void step(Lane& s, int action, const Params& p,
                                     bool strict, StepOut& o) {
  apply(s, action, strict);
  mine(s, p);
  s.steps += 1;
  const bool head_private = s.a >= s.h;
  const float ra = s.ca_atk + (head_private ? (float)s.a : 0.f);
  const float rd = s.ca_def + (head_private ? 0.f : (float)s.h);
  const float progress = s.ca_progress + (float)max(s.a, s.h);
  const float ct = head_private ? s.t_priv : s.t_pub;
  o.done = !(s.steps < p.max_steps && progress < p.max_progress &&
             s.time < p.max_time);
  o.reward = ra - s.last_ra;
  o.info[0] = o.reward;
  o.info[1] = rd - s.last_rd;
  o.info[2] = progress - s.last_progress;
  o.info[3] = ct - s.last_ct;
  o.info[4] = s.time - s.last_st;
  o.info[5] = ra;
  o.info[6] = rd;
  o.info[7] = progress;
  o.info[8] = ct;
  o.info[9] = s.time;
  o.info[10] = (float)s.steps;
  o.info[11] = (float)s.n_activations;
  s.last_ra = ra;
  s.last_rd = rd;
  s.last_progress = progress;
  s.last_ct = ct;
  s.last_st = s.time;
}

// nakamoto.py:109-115 over obs.py `encode`: (public, private, diff, event).
__device__ __forceinline__ float4 observe(const Lane& s, bool unit) {
  const float h = (float)s.h, a = (float)s.a, d = (float)(s.a - s.h);
  const float e = (float)s.event;
  if (!unit) return make_float4(h, a, d, e);
  // the JAX package rounds 2/pi and pi to float32 before using them
  const float two_over_pi = (float)(2.0 / 3.14159265358979323846);
  const float pi = (float)3.14159265358979323846;
  return make_float4(two_over_pi * atanf(h), two_over_pi * atanf(a),
                     0.5f + atanf(d) / pi, e);
}

// One observation row of width 4 (+2 under extend_obs).
__device__ __forceinline__ void put_obs(float* row, float4 o, bool ext,
                                        const Params& p) {
  if (!ext) {
    *reinterpret_cast<float4*>(row) = o;
    return;
  }
  row[0] = o.x;
  row[1] = o.y;
  row[2] = o.z;
  row[3] = o.w;
  row[4] = p.alpha;
  row[5] = p.gamma;
}

// K2: `length` auto-resetting steps per lane under a scripted policy
// or (NET) the actor-critic, accumulating the episode_* info and the
// done count where done is set. init_mode 0 continues the carry in `st`;
// 1 starts each lane from keys[i] with the stream prologue (split, then
// reset: `init_lanes`); 2 resets from keys[i] directly (`reset_lanes`).
template <bool STORE_TRAJ, bool NET>
__global__ void __launch_bounds__(kThreads)
stream_kernel(StatePtrs st, float* __restrict__ obs,
              const uint2* __restrict__ keys, int init_mode, int64_t n_lanes,
              int length, ParamPtrs pp, int policy_id, bool strict, bool unit,
              bool ext, float* __restrict__ sums,
              int32_t* __restrict__ n_done, TrajPtrs traj, NetArgs net) {
  const float* w = NET ? cpr::net_to_shared(net) : nullptr;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  // the net's launches all take the STORE_TRAJ instantiation, with or
  // without a trajectory
  const bool keep_traj = STORE_TRAJ && traj.action != nullptr;
  const int F = ext ? 6 : 4;
  const Params p = cpr::load_params<Params>(pp, i);
  cpr::NetKeys nk(net);
  Lane s;
  if (init_mode == 0) {
    s = load(st, i);
  } else {
    const uint2 k = keys[i];
    reset(s, init_mode == 1 ? cpr::split_key(k, 1u) : k, p);
  }
  float acc[kEpisode];
#pragma unroll
  for (int k = 0; k < kEpisode; ++k) acc[k] = 0.f;
  int32_t nd = 0;
  for (int t = 0; t < length; ++t) {
    const int64_t ti = t * n_lanes + i;
    int action;
    if (NET) {
      const float4 o = observe(s, unit);
      const float x[cpr::kNetMaxIn] = {o.x, o.y, o.z, o.w, p.alpha,
                                       p.gamma};
      const uint2 k_act =
          net.mode == cpr::kNetSample ? nk.next() : make_uint2(0u, 0u);
      action = cpr::net_act_thread<4>(net, w, x, k_act, i, ti);
    } else {
      action = policy(policy_id, s.a, s.h);
    }
    if (keep_traj) {
      put_obs(traj.obs + ti * F, observe(s, unit), ext, p);
      traj.action[ti] = action;
    }
    StepOut o;
    step(s, action, p, strict, o);
    if (keep_traj) {
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
      reset(s, s.key, p);
    }
  }
  store(st, i, s);
  put_obs(obs + i * F, observe(s, unit), ext, p);
  if (NET && i == 0 && net.key_out != nullptr) *net.key_out = nk.carry;
  if (sums != nullptr) {
#pragma unroll
    for (int k = 0; k < kEpisode; ++k) sums[k * n_lanes + i] = acc[k];
    n_done[i] = nd;
  }
}

// K3: admit (splice fresh state), step the lanes in step_mask, freeze
// the rest bit for bit. Outputs are zero/false outside step_mask; out_obs
// is the raw post-step observation for stepped lanes and the held
// observation elsewhere.
__global__ void __launch_bounds__(kThreads)
step_lanes_kernel(StatePtrs st, float* __restrict__ obs,
                  const int32_t* __restrict__ actions,
                  const bool* __restrict__ admit, StatePtrs fresh,
                  const float* __restrict__ fresh_obs,
                  const bool* __restrict__ step_mask, int64_t n_lanes,
                  ParamPtrs pp, bool strict, bool unit, bool ext,
                  float* __restrict__ out_obs, float* __restrict__ reward,
                  bool* __restrict__ done, float* __restrict__ info) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int F = ext ? 6 : 4;
  const Params p = cpr::load_params<Params>(pp, i);
  const bool admitted = admit[i];
  if (step_mask[i]) {
    Lane s = admitted ? load(fresh, i) : load(st, i);
    StepOut o;
    step(s, actions[i], p, strict, o);
    put_obs(out_obs + i * F, observe(s, unit), ext, p);
    if (o.done) reset(s, s.key, p);
    store(st, i, s);
    put_obs(obs + i * F, observe(s, unit), ext, p);
    reward[i] = o.reward;
    done[i] = o.done;
#pragma unroll
    for (int k = 0; k < kInfo; ++k) info[k * n_lanes + i] = o.info[k];
    return;
  }
  if (admitted) {
    store(st, i, load(fresh, i));
    for (int f = 0; f < F; ++f) obs[i * F + f] = fresh_obs[i * F + f];
  }
  for (int f = 0; f < F; ++f) out_obs[i * F + f] = obs[i * F + f];
  reward[i] = 0.f;
  done[i] = false;
#pragma unroll
  for (int k = 0; k < kInfo; ++k) info[k * n_lanes + i] = 0.f;
}

// K14: `b.burst` steps of every live lane under its table entry, the
// carry (`st`, `obs` [L, 4]) updated in place, the first-done registers
// written for every lane (false/0 where not live), and with `e.obs` set
// every live step recorded into the rings (K15). With `b.admit` the
// admitted lanes first take their fresh state (the engine's admission of
// policy sessions: the splice in the same launch).
template <bool NET>
__global__ void __launch_bounds__(kThreads)
burst_kernel(StatePtrs st, float* __restrict__ obs, int64_t n_lanes,
             ParamPtrs pp, bool strict, bool unit, BurstArgs b, ExpPtrs e) {
  extern __shared__ float net_smem[];
  if (NET) {
    for (int k = 0; k < cpr::kBurstSlots; ++k) {
      if (b.w[k] == nullptr) continue;
      const int nf = cpr::net_mlp_floats(b.in[k], b.hidden[k],
                                         b.n_actions[k]);
      for (int j = threadIdx.x; j < nf; j += blockDim.x)
        net_smem[b.w_off[k] + j] = b.w[k][j];
    }
    __syncthreads();
  }
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const bool admitted = b.admit != nullptr && b.admit[i];
  if (admitted && !b.live[i]) {  // admitted but held: the splice alone
    const Params p = cpr::load_params<Params>(pp, i);
    Lane s;
    reset(s, cpr::split_key(b.admit_keys[i], 1u), p);
    store(st, i, s);
    *reinterpret_cast<float4*>(obs + i * 4) = observe(s, unit);
  }
  if (!b.live[i]) {  // held: registers zero, carry and rings untouched
    b.got[i] = false;
    b.done_step[i] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) b.caps[k * n_lanes + i] = 0.f;
    return;
  }
  const int32_t pid = b.policy[i];
  const int kind = b.kind[pid], arg = b.arg[pid];
  NetArgs na{};
  const float* w = nullptr;
  if (NET && kind != cpr::kBurstScripted) {
    na.in = b.in[arg];
    na.hidden = b.hidden[arg];
    na.n_actions = b.n_actions[arg];
    na.mode = kind == cpr::kBurstSample ? cpr::kNetSampleLane
                                        : cpr::kNetGreedy;
    w = net_smem + b.w_off[arg];
  }
  const Params p = cpr::load_params<Params>(pp, i);
  const bool rec = e.obs != nullptr;
  Lane s;
  float4 o;
  if (admitted) {
    reset(s, cpr::split_key(b.admit_keys[i], 1u), p);
    o = observe(s, unit);
  } else {
    s = load(st, i);
    o = *reinterpret_cast<const float4*>(obs + i * 4);
  }
  int32_t cursor = 0, t = 0;
  uint2 ekey = make_uint2(0u, 0u);
  if (rec) {
    cursor = e.cursor[i];
    t = e.t[i];
    ekey = e.key[i];
  }
  bool got = false;
  int32_t done_step = 0;
  float cap[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < b.burst; ++k) {
    int action;
    if (NET && kind != cpr::kBurstScripted) {
      const float x[cpr::kNetMaxIn] = {o.x, o.y, o.z, o.w};
      float logits[4], logp;
      cpr::mlp_thread<4>(w, na.in, na.hidden, na.n_actions, x, logits);
      const uint2 k_act = kind == cpr::kBurstSample
                              ? cpr::exp_step_key(ekey, t)
                              : make_uint2(0u, 0u);
      action = cpr::net_choose<4>(na, logits, k_act, i, logp);
    } else {
      action = policy(arg, s.a, s.h);
    }
    StepOut so;
    step(s, action, p, strict, so);
    if (rec) {
      const float ov[4] = {o.x, o.y, o.z, o.w};
      cpr::exp_record(e, i, cursor, ov, action, so.reward, so.done,
                      so.info[5], so.info[6], pid);
      ++cursor;
      ++t;
    }
    if (so.done) reset(s, s.key, p);
    o = observe(s, unit);
    if (so.done && !got) {  // CAPTURE_FIELDS: info 5, 6, 7, 10
      got = true;
      done_step = k;
      cap[0] = so.info[5];
      cap[1] = so.info[6];
      cap[2] = so.info[7];
      cap[3] = so.info[10];
    }
  }
  store(st, i, s);
  *reinterpret_cast<float4*>(obs + i * 4) = o;
  b.got[i] = got;
  b.done_step[i] = done_step;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.caps[k * n_lanes + i] = cap[k];
  if (rec) {
    e.cursor[i] = cursor;
    e.t[i] = t;
  }
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <bool STORE_TRAJ, bool NET>
cudaError_t launch_stream(const StatePtrs* st, void* obs, const void* keys,
                          int init_mode, int64_t n_lanes, int length,
                          const ParamPtrs* p, int policy_id, int strict_match,
                          int unit_obs, int extend_obs, void* sums,
                          void* n_done, const TrajPtrs* traj,
                          const NetArgs* net, cudaStream_t s) {
  auto kernel = stream_kernel<STORE_TRAJ, NET>;
  const size_t smem = cpr::net_smem_bytes(net);
  if (smem > 0) {  // static + dynamic may pass 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks_for(n_lanes), kThreads, smem, s>>>(
      *st, static_cast<float*>(obs), static_cast<const uint2*>(keys),
      init_mode, n_lanes, length, *p, policy_id, strict_match != 0,
      unit_obs != 0, extend_obs != 0, static_cast<float*>(sums),
      static_cast<int32_t*>(n_done), traj != nullptr ? *traj : TrajPtrs{},
      net != nullptr ? *net : NetArgs{});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 launch. `st` holds the carry (read when init_mode == 0, written
// always); `obs` [L, F] receives the continuation observation; `keys`
// [L, 2] is read when init_mode != 0; `p` the per-lane params; `sums`
// [7, L] and `n_done` [L] receive this launch's done-masked episode sums
// (both may be null for a zero-length launch); `traj` is null or the
// trajectory buffers; `net` is null (the scripted `policy_id`) or the
// actor-critic's arguments.
cudaError_t cpr_k2_stream(const StatePtrs* st, void* obs, const void* keys,
                          int init_mode, int64_t n_lanes, int length,
                          const ParamPtrs* p, int policy_id, int strict_match,
                          int unit_obs, int extend_obs, void* sums,
                          void* n_done, const TrajPtrs* traj,
                          const NetArgs* net, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool with_net = net != nullptr && net->mode != cpr::kNetOff;
  if (traj != nullptr)
    return with_net ? launch_stream<true, true>(
                          st, obs, keys, init_mode, n_lanes, length, p,
                          policy_id, strict_match, unit_obs, extend_obs, sums,
                          n_done, traj, net, s)
                    : launch_stream<true, false>(
                          st, obs, keys, init_mode, n_lanes, length, p,
                          policy_id, strict_match, unit_obs, extend_obs, sums,
                          n_done, traj, nullptr, s);
  return with_net ? launch_stream<true, true>(
                        st, obs, keys, init_mode, n_lanes, length, p,
                        policy_id, strict_match, unit_obs, extend_obs, sums,
                        n_done, nullptr, net, s)
                  : launch_stream<false, false>(
                        st, obs, keys, init_mode, n_lanes, length, p,
                        policy_id, strict_match, unit_obs, extend_obs, sums,
                        n_done, nullptr, nullptr, s);
}

// K3 launch; the carry (`st`, `obs`) is updated in place.
cudaError_t cpr_k3_step_lanes(const StatePtrs* st, void* obs,
                              const void* actions, const void* admit,
                              const StatePtrs* fresh, const void* fresh_obs,
                              const void* step_mask, int64_t n_lanes,
                              const ParamPtrs* p, int strict_match,
                              int unit_obs, int extend_obs, void* out_obs,
                              void* reward, void* done, void* info,
                              void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  step_lanes_kernel<<<blocks_for(n_lanes), kThreads, 0,
                      (cudaStream_t)stream>>>(
      *st, static_cast<float*>(obs), static_cast<const int32_t*>(actions),
      static_cast<const bool*>(admit), *fresh,
      static_cast<const float*>(fresh_obs),
      static_cast<const bool*>(step_mask), n_lanes, *p, strict_match != 0,
      unit_obs != 0, extend_obs != 0, static_cast<float*>(out_obs),
      static_cast<float*>(reward), static_cast<bool*>(done),
      static_cast<float*>(info));
  return cudaGetLastError();
}

// K14 launch; the carry (`st`, `obs`) and, with `e`, the rings are
// updated in place. `e` null: the experience plane is off.
cudaError_t cpr_k14_burst(const StatePtrs* st, void* obs, int64_t n_lanes,
                          const ParamPtrs* p, int strict_match, int unit_obs,
                          const BurstArgs* b, const ExpPtrs* e,
                          void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const ExpPtrs ex = e != nullptr ? *e : ExpPtrs{};
  const size_t smem = sizeof(float) * (size_t)b->smem_floats;
  if (smem > 0) {
    auto kernel = burst_kernel<true>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks_for(n_lanes), kThreads, smem, s>>>(
        *st, static_cast<float*>(obs), n_lanes, *p, strict_match != 0,
        unit_obs != 0, *b, ex);
  } else {
    burst_kernel<false><<<blocks_for(n_lanes), kThreads, 0, s>>>(
        *st, static_cast<float*>(obs), n_lanes, *p, strict_match != 0,
        unit_obs != 0, *b, ex);
  }
  return cudaGetLastError();
}

// K14 with a resident engine's host traffic in the same call
// (csrc/burst.cuh `burst_staged`).
cudaError_t cpr_k14_burst_staged(const StatePtrs* st, void* obs,
                                 int64_t n_lanes, const ParamPtrs* p,
                                 int strict_match, int unit_obs,
                                 const BurstArgs* b, const ExpPtrs* e,
                                 const void* h_in, void* d_in,
                                 int64_t in_bytes, const void* d_out,
                                 void* h_out, int64_t out_bytes,
                                 void* stream) {
  auto launch = [&]() -> cudaError_t {
    return cpr_k14_burst(st, obs, n_lanes, p, strict_match, unit_obs, b, e,
                         stream);
  };
  return cpr::burst_staged(h_in, d_in, in_bytes, d_out, h_out, out_bytes,
                           (cudaStream_t)stream, launch);
}

const char* cpr_k23_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
