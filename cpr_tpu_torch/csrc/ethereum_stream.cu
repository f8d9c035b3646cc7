// Kernel K10-eth: the Ethereum uncle-withholding env's fused episode
// stream and its one-tick step_lanes, one warp per lane over K8's DAG
// (csrc/dag.cuh).
//
// Replaces: cpr_tpu/envs/ethereum.py:327-522 — `_mine` (327-367),
// `_release_upto` (369-388), `_apply` (390-451), `observe` (453-482),
// `step` with the uncle-window retirement (484-519), over `chain_window`
// (181-214), `uncle_candidates` (216-237), `select_uncles` (239-246),
// `make_block` (248-284), `reset` (300-325) and the five policies
// (532-576) — under the drivers of cpr_tpu/envs/base.py (csrc/dag_env.cuh).
// Plain twin: cpr_tpu_torch/envs/ethereum.py.
//
// Bound: latency of warp-collective steps and L1/L2 traffic, as K10-bk.
// A step walks the six-generation uncle window three times (the mined
// block's and the observation's two heads: six scalar steps each, a
// parent row marked per step), selects at most `max_uncles` uncles by a
// top-k, and appends one block (a chain and a closure row).
//
// Parity with the JAX package: integer state, keys, rewards (dyadic:
// 15/16, (8 - d)/8, 1 + n/32, exact in float32) and done are
// bit-identical; the time update is __fmul_rn/__fadd_rn as in K2.

#include <cuda_runtime.h>

#include <cstdint>

#include "dag_env.cuh"

namespace {

using cpr::Block;
using cpr::EnvConfig;
using cpr::EnvParams;
using cpr::LaneDag;
using cpr::Mask;
using cpr::Row;
using cpr::Scal;
using cpr::StepOut;
using cpr::kMaxTopK;
using cpr::kNone;
using cpr::mask_count;

constexpr int kEvPow = 0, kEvNetwork = 1;
constexpr int kAdoptDiscard = 0, kAdoptRelease = 1, kOverride = 2, kMatch = 3,
              kRelease1 = 4, kWait = 5;
constexpr int kRules = 4, kAll = 3, kOwnOnly = 2;
constexpr int kAtt = 0, kDef = 1;
constexpr int kUncleWindow = 6;

__device__ __forceinline__ const int32_t* pref_plane(const LaneDag& g,
                                                     const EnvConfig& c) {
  return c.pref_work ? g.d->aux : g.d->height;
}
__device__ __forceinline__ int32_t pref(const LaneDag& g, const EnvConfig& c,
                                        int32_t b) {
  return g.at(pref_plane(g, c), b);
}

struct Window {
  int32_t anc[kUncleWindow];
  Mask in_chain;
};

// ethereum.py:181-214
__device__ void chain_window(const LaneDag& g, int32_t head, Window& w) {
  w.in_chain = 0;
  if (head >= 0 && (head & 31) == g.t) w.in_chain |= 1u << (head >> 5);
  int32_t b = head;
  for (int i = 0; i < kUncleWindow; ++i) {
    const int32_t bi = b < 0 ? 0 : b;
    const int32_t p0 = g.at(g.d->parents[0], bi);
    const bool has = b >= 0 && p0 >= 0;
    w.anc[i] = has ? p0 : -1;
    if (has) {
      const int32_t gb = g.at(g.d->gid, bi);
      for (int q = 0; q < g.P; ++q) {
        const int32_t v = g.at(g.d->parents[q], bi);
        if (v >= 0 && (v & 31) == g.t && g.at(g.d->gid, v) <= gb)
          w.in_chain |= 1u << (v >> 5);
      }
    }
    b = w.anc[i];
  }
}

// ethereum.py:216-237
__device__ Mask uncle_candidates(const LaneDag& g, const Window& w, Mask view,
                                 Mask filter) {
  int32_t ga[kUncleWindow];
  for (int i = 0; i < kUncleWindow; ++i)
    ga[i] = g.at(g.d->gid, w.anc[i] < 0 ? 0 : w.anc[i]);
  Mask m = 0;
#pragma unroll
  for (int j = 0; j < cpr::kNS; ++j) {
    if (!g.in(j)) continue;
    const int s = g.slot(j);
    const int32_t p0 = g.d->parents[0][g.o(s)];
    const int32_t gs = g.d->gid[g.o(s)];
    bool on = false;
    for (int i = 0; i < kUncleWindow; ++i)
      on = on || (p0 == w.anc[i] && w.anc[i] >= 0 && gs > ga[i]);
    if (p0 >= 0 && on) m |= 1u << j;
  }
  return g.exists() & view & filter & m & ~w.in_chain;
}

// ethereum.py:248-284 (with select_uncles, 239-246)
__device__ int32_t make_block(LaneDag& g, const EnvConfig& c, int32_t head,
                              Mask view, Mask filter, int32_t miner,
                              float time, bool vis_d) {
  Window w;
  chain_window(g, head, w);
  const Mask cand = uncle_candidates(g, w, view, filter);
  const int mu = c.max_uncles;
  int32_t uidx[kMaxTopK];
  bool uvalid[kMaxTopK];
  float score[cpr::kNS];
  const int32_t* pp = pref_plane(g, c);
#pragma unroll
  for (int j = 0; j < cpr::kNS; ++j) {
    if (!g.in(j)) {
      score[j] = 0.f;
      continue;
    }
    const int64_t q = g.o(g.slot(j));
    score[j] = (g.d->miner[q] == miner ? 0.f : 1e7f) + (float)pp[q];
  }
  g.top_k(score, cand, mu, uidx, uvalid);
  int n_uncles = 0;
  for (int i = 0; i < mu; ++i) n_uncles += uvalid[i];
  Block b;
  b.height = g.at(g.d->height, head) + 1;
  b.aux = g.at(g.d->aux, head) + 1 + n_uncles;
  const float miner_reward = 1.f + (float)n_uncles * 0.03125f;
  float atk = 0.f, dfn = 0.f;
  for (int i = 0; i < mu; ++i) {
    const int32_t u = uidx[i] < 0 ? 0 : uidx[i];
    float r = 0.f;
    if (uvalid[i])
      r = c.constant ? 0.9375f
                     : (8.f - (float)(b.height - g.at(g.d->height, u))) / 8.f;
    const int32_t um = g.at(g.d->miner, u);
    atk += um == kAtt ? r : 0.f;
    dfn += um == kDef ? r : 0.f;
  }
  atk += miner == kAtt ? miner_reward : 0.f;
  dfn += miner == kDef ? miner_reward : 0.f;
  Row row;
  row.p[0] = head;
  for (int i = 0; i < mu; ++i) row.p[1 + i] = uvalid[i] ? uidx[i] : kNone;
  b.kind = 0;
  b.miner = miner;
  b.vis_d = vis_d;
  b.time = time;
  b.reward_atk = atk;
  b.reward_def = dfn;
  b.progress = (float)(c.prog_work ? b.aux : b.height);
  return g.append_if(true, row, b);
}

__device__ __forceinline__ int32_t update_head(const LaneDag& g,
                                               const EnvConfig& c, int32_t old,
                                               int32_t cand) {
  return pref(g, c, cand) > pref(g, c, old) ? cand : old;
}

// ethereum.py:327-367
__device__ void mine(LaneDag& g, Scal& s, const EnvParams& p,
                     const EnvConfig& c) {
  const cpr::Draws r = cpr::draw4(s.key);
  const float time = __fadd_rn(s.time, __fmul_rn(r.e, p.activation_delay));
  const bool attacker = r.u1 < p.alpha;
  const bool gamma_hit = r.u2 < p.gamma;
  const int32_t rt = s.x < 0 ? 0 : s.x;
  const bool race_live = s.x >= 0 && pref(g, c, rt) == pref(g, c, s.pub);
  const int32_t def_parent = race_live && gamma_hit ? rt : s.pub;
  Mask view, filter;
  if (attacker) {
    view = g.bools(g.d->vis_a);
    const bool own = s.own, foreign = s.foreign;
    filter = g.where(g.d->miner, [own, foreign](int32_t m) {
      return (own && m == kAtt) || (foreign && m == kDef);
    });
  } else {
    view = g.bools(g.d->vis_d);
    filter = g.exists();
  }
  const int32_t head = attacker ? s.priv : def_parent;
  const int32_t blk = make_block(g, c, head, view, filter,
                                 attacker ? kAtt : kDef, time, !attacker);
  if (attacker) {
    s.priv = blk;
  } else {
    s.pub = update_head(g, c, s.pub, blk);
    s.x = -1;
  }
  s.event = attacker ? kEvPow : kEvNetwork;
  s.time = time;
  s.nact += 1;
  s.key = r.key;
}

// ethereum.py:390-451
__device__ void apply(LaneDag& g, Scal& s, int action, const EnvConfig& c) {
  const int act = action / kRules, rule = action % kRules;
  s.own = rule >= 2;
  s.foreign = rule % 2 == 1;
  const bool is_adopt = act == kAdoptDiscard || act == kAdoptRelease;
  const bool do_release = act == kAdoptRelease || act == kOverride ||
                          act == kMatch || act == kRelease1;
  if (do_release) {
    int32_t tip = s.priv;
    if (act != kAdoptRelease) {
      const int32_t pub_pref = pref(g, c, s.pub);
      int32_t target = pub_pref;
      if (act == kOverride) target = pub_pref + 1;
      if (act == kRelease1) {
        int32_t ca = g.common_ancestor(s.pub, s.priv);
        target = pref(g, c, ca < 0 ? 0 : ca) + 1;
      }
      tip = g.chain_first_at_most(s.priv, pref_plane(g, c), target);
    }
    g.release_masked(tip, s.time);
    const int32_t rt = tip < 0 ? 0 : tip;
    s.pub = update_head(g, c, s.pub, rt);
    bool tie = tip >= 0 && pref(g, c, rt) == pref(g, c, s.pub) && rt != s.pub;
    if (c.strict) tie = tie && s.event == kEvNetwork;
    if (tie) s.x = tip;
  }
  if (is_adopt) s.priv = s.pub;
}

struct EthEnv {
  static constexpr int kObs = 10;

  // ethereum.py:300-325 on the logically reset DAG
  __device__ static void reset(LaneDag& g, Scal& s, uint2 key,
                               const EnvParams& p, const EnvConfig& c,
                               bool*) {
    g.clear_rows(2);
    cpr::zero_scal(s, key, kEvPow);
    Row root;
    for (int q = 0; q < g.P; ++q) root.p[q] = kNone;
    Block b;
    b.miner = kNone;
    b.progress = 0.f;
    s.pub = s.priv = g.append_if(true, root, b);
    mine(g, s, p, c);
  }

  // ethereum.py:484-519
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c, bool*,
                              StepOut& o) {
    apply(g, s, action, c);
    mine(g, s, p, c);
    s.steps += 1;
    int32_t ca = g.common_ancestor(s.pub, s.priv);
    ca = ca < 0 ? 0 : ca;
    const int32_t anchor = g.chain_first_at_most(
        ca, g.d->height, g.at(g.d->height, ca) - kUncleWindow - 1);
    g.retire_below(anchor >= 0 ? g.at(g.d->gid, anchor) : 0);
    s.x = g.drop_if_retired(s.x);
    const bool pub_better = pref(g, c, s.pub) > pref(g, c, s.priv);
    const int32_t head = pub_better ? s.pub : s.priv;
    const int32_t* prog = c.prog_work ? g.d->aux : g.d->height;
    cpr::finish_step(s, p, g.at(g.d->cum_atk, head), g.at(g.d->cum_def, head),
                     (float)g.at(prog, head), g.at(g.d->born_at, head),
                     g.overflow, o);
  }

  // ethereum.py:453-482
  __device__ static void obs_ints(const LaneDag& g, const Scal& s,
                                  const EnvConfig& c, int32_t* v) {
    int32_t ca = g.common_ancestor(s.pub, s.priv);
    ca = ca < 0 ? 0 : ca;
    const int32_t hc = g.at(g.d->height, ca), wc = g.at(g.d->aux, ca);
    const int32_t ph = g.at(g.d->height, s.pub) - hc;
    const int32_t pw = g.at(g.d->aux, s.pub) - wc;
    const int32_t ah = g.at(g.d->height, s.priv) - hc;
    const int32_t aw = g.at(g.d->aux, s.priv) - wc;
    const Mask vis_a = g.bools(g.d->vis_a);
    Window w;
    chain_window(g, s.pub, w);
    const int mu = c.max_uncles;
    v[6] = min(mask_count(uncle_candidates(g, w, vis_a, g.bools(g.d->vis_d))),
               mu);
    chain_window(g, s.priv, w);
    v[7] = min(mask_count(uncle_candidates(
                   g, w, vis_a,
                   g.where(g.d->miner, [](int32_t m) { return m >= 0; }))),
               mu);
    v[8] = min(mask_count(uncle_candidates(
                   g, w, vis_a,
                   g.where(g.d->miner, [](int32_t m) { return m == kAtt; }))),
               mu);
    v[0] = ph;
    v[1] = pw;
    v[2] = ah;
    v[3] = aw;
    v[4] = ah - ph;
    v[5] = aw - pw;
    v[9] = s.event;
  }

  __device__ static void encode(const int32_t* v, const EnvConfig& c,
                                float* f) {
    const bool u = c.unit != 0;
    for (int i = 0; i < 4; ++i) f[i] = cpr::enc_uint(v[i], 1.f, u);
    f[4] = cpr::enc_int(v[4], 1.f, u);
    f[5] = cpr::enc_int(v[5], 1.f, u);
    for (int i = 6; i < 9; ++i) f[i] = cpr::enc_uint(v[i], 1.f, u);
    f[9] = cpr::enc_discrete(v[9], 2, u);
  }

  // ethereum.py:545-576 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig& c) {
    const int32_t ph = v[0], pw = v[1], ah = v[2], aw = v[3], ev = v[9];
    switch (id) {
      case 0:  // honest
        return pw > 0 ? kAdoptRelease * kRules + kAll : kOverride * kRules + kAll;
      case 1:    // selfish_release
      case 2: {  // selfish_discard
        const int adopt = id == 1 ? kAdoptRelease : kAdoptDiscard;
        const int32_t priv = c.whitepaper ? ah : aw, pub = c.whitepaper ? ph : pw;
        if (priv < pub) return adopt * kRules + kOwnOnly;
        return (pub == 0 ? kWait : kOverride) * kRules + kOwnOnly;
      }
      default: {  // fn19 / fn19pkel
        const int adopt = id == 3 ? kAdoptDiscard : kAdoptRelease;
        const int rule = id == 3 ? kAll : kOwnOnly;
        int a;
        if (ev == kEvPow)
          a = (ah == 2 && ph == 1) ? kOverride : kWait;
        else
          a = ah < ph ? adopt
                      : (ah == ph ? kMatch
                                  : (ah == ph + 1 ? kOverride : kRelease1));
        return a * kRules + rule;
      }
    }
  }
};

}  // namespace

extern "C" {

// K10-eth stream launch (as cpr_k10_bk_stream); `obs` [L, 10] (+2).
cudaError_t cpr_k10_eth_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<EthEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                     length, p, c, policy_id, extend_obs,
                                     sums, n_done, traj, net, stream);
}

cudaError_t cpr_k10_eth_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<EthEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

const char* cpr_k10_eth_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
