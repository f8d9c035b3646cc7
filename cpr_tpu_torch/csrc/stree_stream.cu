// Kernel K10-stree: the Stree withholding env's fused episode stream and
// its one-tick step_lanes, one warp per lane over K8's DAG
// (csrc/dag.cuh) and K9's quorums (csrc/quorum.cuh), in the DAG mode of
// its compilation: the ring (K10-stree) or full capacity (K10-stree-full:
// the height walk of stree.py:167-169, K9-full, no retirement; also
// TailstormJune, cpr_tpu/envs/tailstorm_june.py, with its `block` scheme).
//
// Replaces: cpr_tpu/envs/stree.py:283-452 — `reset` (283), `_mine` (305:
// one mining draw, a block where a k-1 quorum exists, else a vote),
// `observe` (348), `_release_sets` and `_apply` (375-418), `step` with the
// ring retirement (420-452), and beneath them `confirming`, `vote_score`,
// `cmp_blocks`/`update_head`, `quorum` over the three selections and
// `block_reward` over the four schemes (147-279), and the six policies
// (456-523) — under the drivers of cpr_tpu/envs/base.py:175-231, :259-301
// and :342-506 (csrc/dag_env.cuh). Plain twin:
// cpr_tpu_torch/envs/stree.py over cpr_tpu_torch/envs/base.py.
//
// Bound: latency of warp-collective steps: one quorum frame a step (a
// closure-row scan per candidate), the release scan when the attacker
// releases, masked scans of the lane's planes, one append and 9 threefry
// blocks.
//
// Parity with the JAX package: integer state, keys, rewards and done are
// bit-identical; the time update is __fmul_rn/__fadd_rn as in K2; the vote
// order's age fraction and the discount rate are correctly rounded
// divisions; the policies read the integer observation fields.
//
// The library also holds K14-dag over this env, the serve engine's policy
// burst (csrc/dag_env.cuh `dag_burst_kernel`, entry
// `cpr_k14_stree_burst_staged`), built in each of its DAG modes.

#include <cuda_runtime.h>

#include <cstdint>

#include "vote_env.cuh"

namespace {

using namespace cpr;

constexpr int kBlock = 0, kVote = 1;
constexpr int kEvPow = 0, kEvNetwork = 1;
constexpr int kSchemeBlock = 4;  // EnvConfig.scheme of TailstormJune's block
constexpr int kWaitProceed = 7, kAdoptProceed = 4, kOverrideProceed = 5,
              kMatchProceed = 6;

// stree.py:171-180: depth desc, then insertion order
__device__ __forceinline__ float vote_score(const LaneDag& g, int32_t s) {
  const float age = (float)(g.age(s) - g.live_floor);
  return __fsub_rn((float)g.at(g.d->aux, s), __fdiv_rn(age, (float)g.W));
}

// stree.py:226-246: the block and its confirmed vote closure each earn r;
// TailstormJune's `block` scheme (tailstorm_june.py:42-51, stream option
// kSchemeBlock) pays the whole k to the block's miner
__device__ void block_reward(const LaneDag& g, const Row& row, int32_t miner,
                             const EnvConfig& c, float& atk, float& dfn) {
  if (c.scheme == kSchemeBlock) {
    atk = miner == kAtt ? (float)c.k : 0.f;
    dfn = miner == kDef ? (float)c.k : 0.f;
    return;
  }
  const int qn = c.k - 1;
  const int n_leaves = scheme_punish(c) ? 1 : qn;
  Mask closure = 0;
  for (int i = 0; i < n_leaves; ++i) {
    int32_t cur = row.p[1 + i];
    for (int it = 0; it < c.cmax && cur >= 0; ++it) {
      if (g.at(g.d->kind, cur) != kVote) break;
      closure |= slot_bit(g, cur);
      cur = g.at(g.d->parents[0], cur);
    }
  }
  const int32_t l0 = row.p[1];
  const int32_t depth0 = g.at(g.d->aux, l0 < 0 ? 0 : l0);
  const float r = scheme_discount(c)
                      ? __fdiv_rn((float)(depth0 + 1), (float)c.k)
                      : 1.f;
  const int na = mask_count(
      closure & g.where(g.d->miner, [](int32_t m) { return m == kAtt; }));
  const int nd = mask_count(
      closure & g.where(g.d->miner, [](int32_t m) { return m == kDef; }));
  atk = __fmul_rn(r, (float)(na + (miner == kAtt)));
  dfn = __fmul_rn(r, (float)(nd + (miner == kDef)));
}

// stree.py:248-279: a block where a k-1 quorum exists, else a vote on the
// deepest filtered visible branch; returns the slot, `is_blk` its kind
__device__ int32_t mine_one(LaneDag& g, QScratch& q, int32_t head, Mask view,
                            Mask filter, int32_t miner, float time, float powh,
                            const EnvConfig& c, bool& is_blk) {
  auto score = [&g](int32_t s) { return vote_score(g, s); };
  const Mask conf = confirming(g, head);
  QFrame f;
  Row row;
  row.p[0] = head;
  uint64_t leaves = 0;
  const bool found =
      select_quorum(g, q, f, conf & filter & view, miner, c.k - 1, c.k - 1, c,
                    1, 1, score, row, 1, leaves);
  Block b;
  if (found) {
    block_reward(g, row, miner, c, b.reward_atk, b.reward_def);
    b.kind = kBlock;
    b.height = g.at(g.d->height, head) + 1;
    b.aux = 0;
    b.signer = kNone;
  } else {
    const int32_t best = argmax_where(g, conf & view & filter, score);
    row.p[0] = best >= 0 ? best : head;
    for (int p = 1; p < g.P; ++p) row.p[p] = kNone;
    b.kind = kVote;
    b.height = g.at(g.d->height, head);
    b.aux = best >= 0 ? g.at(g.d->aux, best) + 1 : 1;
    b.signer = head;
  }
  b.pow_hash = powh;
  b.miner = miner;
  b.vis_a = true;
  b.vis_d = miner == kDef;
  b.time = time;
  b.progress = (float)(b.height * c.k + b.aux);
  is_blk = found;
  return g.append_if(true, row, b);
}

// stree.py:305-346; `s.x` is race_tip, `s.own` mining_excl.
__device__ void mine(LaneDag& g, QScratch& q, Scal& s, Mask& stale,
                     const EnvParams& p, const EnvConfig& c) {
  const Draws5 r = draw5(s.key);
  const float time = __fadd_rn(s.time, __fmul_rn(r.e, p.activation_delay));
  const bool attacker = r.u_mine < p.alpha;
  int32_t def_head = s.pub;
  if (!attacker) {
    if (s.x >= 0 && r.u_gamma < p.gamma) {
      const Mask vis_d = g.bools(g.d->vis_d);
      if (!cmp_blocks(g, s.pub, s.x, vis_d) && !cmp_blocks(g, s.x, s.pub, vis_d))
        def_head = s.x;
    }
    s.x = kNone;
  }
  const Mask ex = g.exists();
  const Mask filter =
      attacker && s.own
          ? g.where(g.d->miner, [](int32_t m) { return m == kAtt; })
          : ex;
  const int32_t head = attacker ? s.priv : def_head;
  const Mask view = g.bools(attacker ? g.d->vis_a : g.d->vis_d);
  const int32_t miner = attacker ? kAtt : kDef;
  bool is_blk;
  const int32_t idx = mine_one(g, q, head, view, filter, miner, time,
                               r.u_hash, c, is_blk);
  stale &= ~slot_bit(g, idx);
  if (attacker) {
    if (is_blk) s.priv = idx;
  } else {
    s.pub = is_blk && cmp_blocks(g, idx, def_head, g.bools(g.d->vis_d))
                ? idx
                : def_head;
  }
  s.event = attacker ? kEvPow : kEvNetwork;
  s.time = time;
  s.nact += 1;
  s.key = r.key;
}

// stree_ssz.ml:272-314 (stree.py:383-418)
__device__ void apply(LaneDag& g, QScratch& q, Scal& s, Mask& stale,
                      int action, const EnvConfig& c) {
  const bool is_adopt = action == 0 || action == 4;
  const bool is_override = action == 1 || action == 5;
  const bool is_match = action == 2 || action == 6;
  if (is_override || is_match) {
    const Mask cands = g.exists() & ~g.bools(g.d->vis_d) & ~stale;
    const int32_t pub = s.pub, priv = s.priv;
    const Release rel = prefix_release_sets(
        g, q, pub, priv, cands, c.rscan, kBlock, nullptr, [&]() {
          return cmp_blocks(g, priv, pub, g.bools(g.d->vis_d) | cands);
        });
    g.release(is_override ? rel.ovr : rel.mat, s.time);
    if (is_override && rel.found) s.pub = rel.head;
    if (is_match) {
      const int32_t tip = g.last_by_age(rel.mat);
      if (rel.found && tip >= 0) s.x = last_of_kind(g, tip, kBlock);
    } else {
      s.x = kNone;
    }
  }
  if (is_adopt) {
    s.priv = s.pub;
    stale = stale_after_adopt(g, q, s.pub, stale, c.rscan, cpr::kStaleWalk,
                              kBlock, g.d->parents[0]);
    s.x = kNone;
  }
  s.own = action < 4;
}

struct StreeEnv {
  static constexpr int kObs = 10;

  // stree.py:283-303 on the logically reset DAG
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
    b.kind = kBlock;
    b.miner = kNone;
    b.progress = 0.f;
    s.pub = s.priv = g.append_if(true, root, b);
    mine(g, q_scratch(), s, stale, p, c);
    store_mask(g, stale_plane, stale);
  }

  // stree.py:420-452
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c,
                              bool* stale_plane, StepOut& o) {
    QScratch& q = q_scratch();
    Mask stale = g.bools(stale_plane);
    apply(g, q, s, stale, action, c);
    mine(g, q, s, stale, p, c);
    s.steps += 1;
    if (cpr::kRing) {  // stree.py:426: the ring's retirement
      const int32_t ca = g.common_ancestor(s.pub, s.priv);
      g.retire_below(g.at(g.d->gid, ca < 0 ? 0 : ca));
      s.x = g.drop_if_retired(s.x);
    }
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

  // stree.py:348-373
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
    const float k = (float)c.k, q = (float)(c.k - 1 > 1 ? c.k - 1 : 1);
    f[0] = enc_uint(v[0], 1.f, u);
    f[1] = enc_uint(v[1], 1.f, u);
    f[2] = enc_int(v[2], 1.f, u);
    f[3] = enc_uint(v[3], k, u);
    f[4] = enc_uint(v[4], q, u);
    f[5] = enc_uint(v[5], q, u);
    f[6] = enc_uint(v[6], k, u);
    f[7] = enc_uint(v[7], q, u);
    f[8] = enc_uint(v[8], q, u);
    f[9] = enc_discrete(v[9], 2, u);
  }

  // stree.py:466-523 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig& c) {
    const int32_t pub_b = v[0], priv_b = v[1], pub_v = v[3], priv_vi = v[4],
                  inc_d = v[7];
    switch (id) {
      case 0:  // honest
        return pub_b > 0 ? kAdoptProceed : kOverrideProceed;
      case 1:  // release-block
        return priv_b < pub_b ? kAdoptProceed
                              : (priv_b > pub_b ? kOverrideProceed
                                                : kWaitProceed);
      case 2:  // override-block
        return priv_b < pub_b ? kAdoptProceed
                              : (pub_b == 0 ? kWaitProceed : kOverrideProceed);
      case 3:  // override-catchup
        if (priv_b < pub_b) return kAdoptProceed;
        if (pub_b == 0) return kWaitProceed;
        if (inc_d == 0 && priv_b == pub_b + 1) return kOverrideProceed;
        if (pub_b == priv_b && priv_vi == pub_v + 1) return kOverrideProceed;
        return priv_b - pub_b > 10 ? kOverrideProceed : kWaitProceed;
      case 4:  // minor-delay
        return pub_b > priv_b ? kAdoptProceed
                              : (pub_b == 0 ? kWaitProceed : kOverrideProceed);
      default: {  // avoid-loss
        const int32_t hp = pub_b * c.k + pub_v, ap = priv_b * c.k + priv_vi;
        if (pub_b == 0) return kWaitProceed;
        if (pub_b == 1 && hp == ap) return kMatchProceed;
        if (hp > ap) return kAdoptProceed;
        if (hp == ap - 1) return kOverrideProceed;
        return pub_b < priv_b - 10 ? kOverrideProceed : kWaitProceed;
      }
    }
  }
};

}  // namespace

extern "C" {

// K10-stree stream launch: as cpr_k10_bk_stream (csrc/bk_stream.cu);
// `obs` [L, 10] (+2 under extend_obs).
cudaError_t cpr_k10_stree_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<StreeEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                     length, p, c, policy_id, extend_obs,
                                     sums, n_done, traj, net, stream);
}

// K10-stree step_lanes launch; the carry is updated in place.
cudaError_t cpr_k10_stree_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<StreeEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

// K14-dag launch with its host traffic (csrc/dag_env.cuh
// `launch_dag_burst`): the carry and, with `e`, the rings are updated in
// place.
cudaError_t cpr_k14_stree_burst_staged(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    const cpr::BurstArgs* b, const cpr::ExpPtrs* e, const void* h_in,
    void* d_in, int64_t in_bytes, const void* d_out, void* h_out,
    int64_t out_bytes, void* stream) {
  return cpr::launch_dag_burst<StreeEnv>(dp, ep, obs, n_lanes, p, c, b, e, h_in,
                                    d_in, in_bytes, d_out, h_out, out_bytes,
                                    stream);
}

// K14-dag's static shared memory here and a block's limit
// (csrc/dag_env.cuh `dag_burst_smem`).
cudaError_t cpr_k14_stree_burst_smem(int* static_bytes, int* block_bytes) {
  return cpr::dag_burst_smem<StreeEnv>(static_bytes, block_bytes);
}

const char* cpr_k10_stree_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
