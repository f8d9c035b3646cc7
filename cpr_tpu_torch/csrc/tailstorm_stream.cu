// Kernel K10-ts: the Tailstorm withholding env's fused episode stream and
// its one-tick step_lanes, one warp per lane over K8's DAG
// (csrc/dag.cuh) and K9's quorums (csrc/quorum.cuh).
//
// Replaces: cpr_tpu/envs/tailstorm.py:417-675 — `reset` (417), `_advance`
// (443-536: the pending self-append, the defender's summary with its
// duplicate adoption, one mining draw), `observe` (538), `_release_sets`
// and `_apply` (564-633), `step` with the ring retirement (635-673), and
// beneath them `confirming`, `cmp_summaries`/`update_head`, `quorum` over
// the three selections, `summary_reward` over the four schemes,
// `append_summary` with its dedup and `mine_vote` (179-413), and the seven
// policies (677-750) — under the drivers of cpr_tpu/envs/base.py:175-231,
// :259-301 and :342-506 (csrc/dag_env.cuh). Plain twin:
// cpr_tpu_torch/envs/tailstorm.py over cpr_tpu_torch/envs/base.py.
//
// Bound: latency of warp-collective steps. A step is up to two quorum
// frames (a closure-row scan per candidate), a 128-position release scan
// when the attacker releases, a handful of masked scans of the lane's
// planes, one or two appends and, when the lane mines, 9 threefry blocks.
// The design skips what the reference computes and then discards: the
// release scan of a step that releases nothing, the defender's quorum of a
// lane that has nothing new, the heuristic beside an optimal selection
// inside its window.
//
// Parity with the JAX package: integer state, keys, rewards and done are
// bit-identical; the time update is __fmul_rn/__fadd_rn as in K2; the
// discount rate is a correctly rounded division; the policies read the
// integer observation fields.

#include <cuda_runtime.h>

#include <cstdint>

#include "vote_env.cuh"

namespace {

using namespace cpr;

constexpr int kSummary = 0, kVote = 1;
constexpr int kEvAppend = 0, kEvPow = 1, kEvNetwork = 2;
constexpr int kWaitProceed = 7, kAdoptProceed = 4, kOverrideProceed = 5,
              kMatchProceed = 6;

__device__ __forceinline__ float leaf_score(const LaneDag& g, int32_t s) {
  return __fsub_rn((float)g.at(g.d->aux, s), g.at(g.d->pow_hash, s));
}

__device__ __forceinline__ int32_t update_head(const LaneDag& g, int32_t old,
                                               int32_t cand, Mask filter,
                                               int32_t my) {
  return cmp_summaries(g, cand, old, filter, my) ? cand : old;
}

// tailstorm.py:356-394: the summary on b where a quorum exists and no
// identical summary does; returns the new slot, the duplicate, or NONE.
__device__ int32_t append_summary(LaneDag& g, QScratch& q, int32_t b,
                                  int32_t voter, Mask filter, Mask view,
                                  float time, const EnvConfig& c,
                                  bool& fresh) {
  const int k = c.k;
  auto score = [&g](int32_t s) { return leaf_score(g, s); };
  QFrame f;
  Row row;
  uint64_t leaves = 0;
  const bool found = select_quorum(g, q, f, confirming(g, b) & filter & view,
                                   voter, k, k, c, 0, 0, score, row, 0,
                                   leaves);
  fresh = false;
  if (!found) return kNone;
  // summary_reward (tailstorm.py:327-354) on the frame
  uint64_t sel = 0;
  if (scheme_punish(c)) {
    float best = -f_inf();
    int j = 0;
    for (int i = 0; i < f.C; ++i) {
      if (!bit(leaves, i)) continue;
      const float v = bit(f.cvalid, i) && i < f.nC
                          ? finite_or0(leaf_score(g, q.cidx[i]))
                          : -f_inf();
      if (v > best) {
        best = v;
        j = i;
      }
    }
    sel = leaves != 0ull ? q.abits[j] : 0ull;
  } else {
    for (int i = 0; i < f.C; ++i)
      if (bit(leaves, i)) sel |= q.abits[i];
  }
  const uint64_t own_att = cminer(g, q, f, kAtt);
  const uint64_t own_def = cminer(g, q, f, kDef);
  const int32_t depth0 = g.at(g.d->aux, row.p[0] < 0 ? 0 : row.p[0]);
  const float r = scheme_discount(c)
                      ? __fdiv_rn((float)depth0, (float)k)
                      : 1.f;
  const float atk = __fmul_rn(r, (float)__popcll(sel & own_att));
  const float dfn = __fmul_rn(r, (float)__popcll(sel & own_def));
  const int32_t height = g.at(g.d->height, b) + 1;
  // the dedup (tailstorm.py:370-381): same height and parent row, younger
  // than b; the lowest such slot
  Mask dup = g.exists() & g.kind_is(kSummary) &
             g.where(g.d->height, [height](int32_t h) { return h == height; }) &
             g.newer_than(b);
  for (int p = 0; p < g.P; ++p) {
    const int32_t v = row.p[p];
    dup &= g.where(g.d->parents[p], [v](int32_t x) { return x == v; });
  }
  const int32_t d = first_slot(g, dup);
  if (d >= 0) return d;
  Block blk;
  blk.kind = kSummary;
  blk.height = height;
  blk.aux = 0;
  blk.signer = kNone;
  blk.miner = voter;
  blk.vis_a = true;
  blk.vis_d = voter == kDef;
  blk.time = time;
  blk.reward_atk = atk;
  blk.reward_def = dfn;
  blk.progress = (float)(height * k);
  blk.auxf = atk;
  blk.auxg = dfn;
  blk.aux2 = b;
  fresh = true;
  return g.append_if(true, row, blk, b);
}

// tailstorm.py:396-413: a vote on the deepest visible branch confirming
// `pref`
__device__ int32_t mine_vote(LaneDag& g, int32_t pref, int32_t voter,
                             Mask view, float time, float powh,
                             const EnvConfig& c) {
  const Mask cand = confirming(g, pref) & view;
  const int32_t best =
      argmax_where(g, cand, [&g](int32_t s) { return leaf_score(g, s); });
  const int32_t parent = best >= 0 ? best : pref;
  const int32_t depth = best >= 0 ? g.at(g.d->aux, parent) + 1 : 1;
  Row row;
  row.p[0] = parent;
  for (int p = 1; p < g.P; ++p) row.p[p] = kNone;
  Block b;
  b.kind = kVote;
  b.height = g.at(g.d->height, pref);
  b.aux = depth;
  b.pow_hash = powh;
  b.signer = pref;
  b.miner = voter;
  b.vis_a = true;
  b.vis_d = voter == kDef;
  b.time = time;
  b.progress = (float)(b.height * c.k + depth);
  return g.append_if(true, row, b);
}

// tailstorm.py:443-536; `s.own` is def_dirty, `s.x` pending_append, `s.y`
// match_tgt.
__device__ void advance(LaneDag& g, QScratch& q, Scal& s, Mask& stale,
                        const EnvParams& p, const EnvConfig& c) {
  if (s.x >= 0) {
    s.priv = update_head(g, s.priv, s.x, g.bools(g.d->vis_a), kAtt);
    s.event = kEvAppend;
    s.x = kNone;
    return;
  }
  if (s.own) {
    const Mask vis_d = g.bools(g.d->vis_d);
    bool fresh;
    const int32_t si = append_summary(g, q, s.pub, kDef, vis_d, vis_d,
                                      s.time, c, fresh);
    if (fresh) {
      s.pub = update_head(g, s.pub, si, g.bools(g.d->vis_d), kDef);
      s.event = kEvNetwork;
      s.own = false;
      stale &= ~slot_bit(g, si);
      return;
    }
    if (si >= 0) {  // the defender adopts the existing duplicate
      if (g.t == 0) g.d->vis_d[g.o(si)] = true;
      __syncwarp();
      s.pub = update_head(g, s.pub, si, g.bools(g.d->vis_d), kDef);
    }
    s.own = false;
  }
  const Draws5 r = draw5(s.key);
  const float time = __fadd_rn(s.time, __fmul_rn(r.e, p.activation_delay));
  const bool attacker = r.u_mine < p.alpha;
  if (!attacker) {
    const int32_t tgt = s.y < 0 ? 0 : s.y;
    if (s.y >= 0 && r.u_gamma < p.gamma) {
      const Mask vis_d = g.bools(g.d->vis_d);
      if (!cmp_summaries(g, s.pub, tgt, vis_d, kDef) &&
          !cmp_summaries(g, tgt, s.pub, vis_d, kDef))
        s.pub = tgt;
    }
    s.y = kNone;
  }
  const int32_t pref = attacker ? s.priv : s.pub;
  const Mask view = g.bools(attacker ? g.d->vis_a : g.d->vis_d);
  const int32_t vi = mine_vote(g, pref, attacker ? kAtt : kDef, view, time,
                               r.u_hash, c);
  stale &= ~slot_bit(g, vi);
  s.event = attacker ? kEvPow : kEvNetwork;
  s.own = s.own || !attacker;
  s.time = time;
  s.nact += 1;
  s.key = r.key;
}

// tailstorm_ssz.ml:292-350 (tailstorm.py:580-633)
__device__ void apply(LaneDag& g, QScratch& q, Scal& s, Mask& stale,
                      int action, const EnvConfig& c) {
  const bool is_adopt = action == 0 || action == 4;
  const bool is_override = action == 1 || action == 5;
  const bool is_match = action == 2 || action == 6;
  const bool proceed = action >= 4;
  const int32_t old_priv = s.priv;
  if (is_override || is_match) {
    const Mask cands = g.exists() & ~g.bools(g.d->vis_d) & ~stale;
    const int32_t pub = s.pub, priv = s.priv;
    const Release rel = prefix_release_sets(
        g, q, pub, priv, cands, c.rscan, kSummary, g.d->auxg, [&]() {
          return cmp_summaries(g, priv, pub, g.bools(g.d->vis_d) | cands,
                               kDef);
        });
    const Mask mask = is_override ? rel.ovr : rel.mat;
    g.release(mask, s.time);
    if (is_override && rel.found) s.pub = rel.head;
    if (mask_any(mask)) s.own = true;
    if (is_match) {
      const int32_t tip = g.last_by_age(rel.mat);
      if (rel.found && tip >= 0) s.y = last_of_kind(g, tip, kSummary);
    } else {
      s.y = kNone;
    }
  }
  if (is_adopt) {
    s.priv = s.pub;
    stale = stale_after_adopt(g, s.pub, stale);
    s.y = kNone;
  }
  const Mask filter =
      proceed ? g.exists()
              : g.where(g.d->miner, [](int32_t m) { return m == kAtt; });
  const bool has_conf = mask_any(confirming(g, old_priv));
  const int32_t prev = g.at(g.d->aux2, old_priv);
  const int32_t extend = has_conf || prev < 0 ? old_priv : prev;
  bool fresh;
  const int32_t pending = append_summary(g, q, extend, kAtt, filter,
                                         g.bools(g.d->vis_a), s.time, c,
                                         fresh);
  if (fresh) stale &= ~slot_bit(g, pending);
  s.x = fresh ? pending : kNone;
}

struct TailstormEnv {
  static constexpr int kObs = 10;

  // tailstorm.py:417-441 on the logically reset DAG
  __device__ static void reset(LaneDag& g, Scal& s, uint2 key,
                               const EnvParams& p, const EnvConfig& c,
                               bool* stale_plane) {
    g.clear_rows(2);
    zero_scal(s, key, kEvPow);
    s.own = false;
    Mask stale = 0;
    Row root;
    for (int q = 0; q < g.P; ++q) root.p[q] = kNone;
    Block b;
    b.kind = kSummary;
    b.miner = kNone;
    b.progress = 0.f;
    s.pub = s.priv = g.append_if(true, root, b);
    advance(g, q_scratch(), s, stale, p, c);
    store_mask(g, stale_plane, stale);
  }

  // tailstorm.py:635-673
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c,
                              bool* stale_plane, StepOut& o) {
    QScratch& q = q_scratch();
    Mask stale = g.bools(stale_plane);
    apply(g, q, s, stale, action, c);
    advance(g, q, s, stale, p, c);
    s.steps += 1;
    int32_t lca = g.common_ancestor(s.pub, s.priv);
    lca = lca < 0 ? 0 : lca;
    const int32_t prev = g.at(g.d->aux2, lca);
    const int32_t anchor = prev >= 0 ? prev : lca;
    g.retire_below(g.at(g.d->gid, anchor));
    s.y = g.drop_if_retired(s.y);
    store_mask(g, stale_plane, stale);
    const int n_pub = mask_count(confirming(g, s.pub));
    const int n_priv = mask_count(confirming(g, s.priv));
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const bool pub_better = hp > hv || (hp == hv && n_pub > n_priv);
    const int32_t head = pub_better ? s.pub : s.priv;
    finish_step(s, p, g.at(g.d->cum_atk, head), g.at(g.d->cum_def, head),
                (float)(g.at(g.d->height, head) * c.k),
                g.at(g.d->born_at, head), g.overflow, o);
  }

  // tailstorm.py:538-562
  __device__ static void obs_ints(const LaneDag& g, const Scal& s,
                                  const EnvConfig& c, int32_t* v) {
    int32_t ca = g.common_ancestor(s.pub, s.priv);
    ca = ca < 0 ? 0 : ca;
    const Mask pub = confirming(g, s.pub) & g.bools(g.d->vis_d);
    const Mask inc = confirming(g, s.priv);
    const Mask exc =
        inc & g.where(g.d->miner, [](int32_t m) { return m == kAtt; });
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const int32_t hc = g.at(g.d->height, ca);
    v[0] = hp - hc;
    v[1] = hv - hc;
    v[2] = hv - hp;
    v[3] = mask_count(pub);
    v[4] = mask_count(inc);
    v[5] = mask_count(exc);
    v[6] = max_where(g, g.d->aux, pub);
    v[7] = max_where(g, g.d->aux, inc);
    v[8] = max_where(g, g.d->aux, exc);
    v[9] = s.event;
  }

  __device__ static void encode(const int32_t* v, const EnvConfig& c,
                                float* f) {
    const bool u = c.unit != 0;
    const float k = (float)c.k;
    f[0] = enc_uint(v[0], 1.f, u);
    f[1] = enc_uint(v[1], 1.f, u);
    f[2] = enc_int(v[2], 1.f, u);
    for (int i = 3; i < 9; ++i) f[i] = enc_uint(v[i], k, u);
    f[9] = enc_discrete(v[9], 3, u);
  }

  // tailstorm.py:686-750 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig& c) {
    const int32_t pub_b = v[0], priv_b = v[1], pub_v = v[3], priv_vi = v[4];
    const int32_t k = c.k;
    switch (id) {
      case 0:  // honest
        return pub_b > priv_b ? kAdoptProceed : kOverrideProceed;
      case 1:  // get-ahead
        return pub_b > priv_b ? kAdoptProceed
                              : (pub_b < priv_b ? kOverrideProceed
                                                : kWaitProceed);
      case 2:  // minor-delay
        return pub_b > priv_b ? kAdoptProceed
                              : (pub_b == 0 ? kWaitProceed : kOverrideProceed);
      case 3:    // avoid-loss
      case 5: {  // avoid-loss-b
        const int32_t hp = pub_b * k + pub_v, ap = priv_b * k + priv_vi;
        if (pub_b == 0) return kWaitProceed;
        if (pub_b == 1 && hp == ap)
          return id == 3 ? kMatchProceed : kOverrideProceed;
        if (hp > ap) return kAdoptProceed;
        if (hp == ap - 1) return kOverrideProceed;
        return pub_b < priv_b - 10 ? kOverrideProceed : kWaitProceed;
      }
      case 4:  // avoid-loss-a
        if (priv_b < pub_b) return kAdoptProceed;
        if (pub_b == 0) return kWaitProceed;
        if (priv_vi == 0 && priv_b == pub_b + 1) return kOverrideProceed;
        if (pub_b == priv_b && priv_vi == pub_v + 1) return kOverrideProceed;
        return priv_b - pub_b > 10 ? kOverrideProceed : kWaitProceed;
      default:  // long-delay
        if (pub_b > priv_b) return kAdoptProceed;
        if (pub_b == 0) return kWaitProceed;
        if (pub_b + 10 < priv_b) return kOverrideProceed;
        return pub_b * k + pub_v + 1 < priv_b * k + priv_vi ? kWaitProceed
                                                           : kOverrideProceed;
    }
  }
};

}  // namespace

extern "C" {

// K10-ts stream launch: as cpr_k10_bk_stream (csrc/bk_stream.cu); `obs`
// [L, 10] (+2 under extend_obs).
cudaError_t cpr_k10_ts_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<TailstormEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                     length, p, c, policy_id, extend_obs,
                                     sums, n_done, traj, net, stream);
}

// K10-ts step_lanes launch; the carry is updated in place.
cudaError_t cpr_k10_ts_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<TailstormEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

const char* cpr_k10_ts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
