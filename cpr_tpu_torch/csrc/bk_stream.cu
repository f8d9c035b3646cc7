// Kernel K10-bk: the Bₖ withholding env's fused episode stream and its
// one-tick step_lanes, one warp per lane over K8's DAG (csrc/dag.cuh), in
// the DAG mode of its compilation: the ring (K10-bk) or full capacity
// (K10-bk-full: the height walks and the chain release of bk.py:336-338,
// 470-474, 505-508, no retirement).
//
// Replaces: cpr_tpu/envs/bk.py:340-572 — `_advance` (340-419), `observe`
// (421-447), `_apply` (449-528), `step` with the ring retirement
// (538-570), `quorum` (224-266), `reward_of_block` (268-282),
// `append_proposal` (284-299), `reset` (303-326) and the four policies
// (574-617) — under the drivers of cpr_tpu/envs/base.py:175-231,
// :259-301 and :342-506 (csrc/dag_env.cuh). Plain twin:
// cpr_tpu_torch/envs/bk.py over cpr_tpu_torch/envs/base.py.
//
// Bound: latency of warp-collective steps and L1/L2 traffic. A step is
// two quorum searches (each up to three top-k extractions of k passes of
// a 5-shuffle reduction), a handful of masked scans of the lane's 128-slot
// planes, one or two appends (a chain and a closure row each) and 7
// threefry blocks; the lane's 45 KB of planes stay in device memory. The
// design skips what the reference computes and then discards: a quorum
// whose vote count cannot reach k, the release selection of a step that
// releases nothing, the defender's quorum while a self-append is pending.
//
// Parity with the JAX package: integer state, keys, votes, rewards and
// done are bit-identical; the time update is __fmul_rn/__fadd_rn as in K2;
// the policies read the integer observation fields (exact below 1763).
//
// The library also holds K14-dag over this env, the serve engine's policy
// burst (csrc/dag_env.cuh `dag_burst_kernel`, entry
// `cpr_k14_bk_burst_staged`), built in each of its DAG modes.

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
using cpr::mask_any;

constexpr int kBlock = 0, kVote = 1;
constexpr int kEvAppend = 0, kEvPow = 1, kEvNetwork = 2;
constexpr int kAtt = 0, kDef = 1;
constexpr int kWaitProceed = 7, kAdoptProceed = 4, kOverrideProceed = 5,
              kMatchProceed = 6;

__device__ __forceinline__ Mask votes_on(const LaneDag& g, int32_t b) {
  return g.children0(b) & g.kind_is(kVote);
}

// bk.py:224-266; `row` is written only where found.
__device__ bool quorum(const LaneDag& g, int32_t b, int32_t voter, Mask filter,
                       Mask view, int k, Row& row) {
  const Mask votes = votes_on(g, b) & filter & view;
  const int nvotes = mask_count(votes);
  if (nvotes < k) return false;
  const Mask mine =
      votes & g.where(g.d->aux, [voter](int32_t a) { return a == voter; });
  const Mask theirs = votes & ~mine;
  const float my_hash = g.min_where(g.d->pow_hash, mine);
  const Mask child_blocks = g.children0(b) & g.kind_is(kBlock) & view;
  const float replace_hash = g.min_where(g.d->auxf, child_blocks);
  if (!(replace_hash > my_hash)) return false;
  const int nmine = mask_count(mine);
  const bool case1 = nmine >= k;
  const Mask theirs_ok = theirs & g.where(g.d->pow_hash, [my_hash](float h) {
                           return h > my_hash;
                         });
  const int n_needed = k - nmine;
  if (!(case1 || mask_count(theirs_ok) >= n_needed)) return false;
  int32_t idx[kMaxTopK];
  bool valid[kMaxTopK];
  g.top_k_plane(g.d->pow_hash, mine, k, idx, valid);
  Mask qm = g.mask_of(idx, valid, k);
  if (!case1) {
    g.top_k_plane(voter == kAtt ? g.d->born_at : g.d->vis_d_since, theirs_ok,
                  k, idx, valid);
    for (int i = 0; i < k; ++i) valid[i] = valid[i] && i < n_needed;
    qm |= g.mask_of(idx, valid, k);
  }
  g.top_k_plane(g.d->pow_hash, qm, k, idx, valid);
  row.p[0] = b;
  for (int i = 0; i < k; ++i) row.p[1 + i] = valid[i] ? idx[i] : kNone;
  return true;
}

// bk.py:268-282
__device__ void reward_of_block(const LaneDag& g, const Row& row,
                                int32_t signer, const EnvConfig& c,
                                float& atk, float& dfn) {
  if (c.constant) {
    int na = 0, nd = 0;
    for (int i = 1; i <= c.k; ++i) {
      const int32_t v = row.p[i];
      const int32_t id = g.at(g.d->aux, v < 0 ? 0 : v);
      na += v >= 0 && id == kAtt;
      nd += v >= 0 && id == kDef;
    }
    atk = (float)na;
    dfn = (float)nd;
  } else {
    atk = signer == kAtt ? (float)c.k : 0.f;
    dfn = signer == kDef ? (float)c.k : 0.f;
  }
}

__device__ __forceinline__ float row_leader_hash(const LaneDag& g,
                                                 const Row& row) {
  const int32_t v0 = row.p[1];
  return v0 >= 0 ? g.at(g.d->pow_hash, v0) : cpr::f_inf();
}

// bk.py:200-222: candidate strictly preferred over old?
__device__ int32_t update_head(const LaneDag& g, int32_t old, int32_t cand,
                               Mask filter) {
  if (cand == old) return old;
  const int32_t hc = g.at(g.d->height, cand), ho = g.at(g.d->height, old);
  if (hc != ho) return hc > ho ? cand : old;
  const int nc = mask_count(votes_on(g, cand) & filter);
  const int no = mask_count(votes_on(g, old) & filter);
  if (nc != no) return nc > no ? cand : old;
  const float lc = g.at(g.d->auxf, cand), lo = g.at(g.d->auxf, old);
  if (lc != lo) return lc < lo ? cand : old;
  return g.at(g.d->vis_d_since, cand) < g.at(g.d->vis_d_since, old) ? cand
                                                                     : old;
}

// bk.py:284-299
__device__ int32_t append_proposal(LaneDag& g, int32_t b, int32_t voter,
                                   Mask filter, Mask view, float time,
                                   const EnvConfig& c) {
  Row row;
  const bool found = quorum(g, b, voter, filter, view, c.k, row);
  if (!found) return kNone;
  Block blk;
  reward_of_block(g, row, voter, c, blk.reward_atk, blk.reward_def);
  blk.kind = kBlock;
  blk.height = g.at(g.d->height, b) + 1;
  blk.aux = 0;
  blk.signer = voter;
  blk.miner = voter;
  blk.vis_a = true;
  blk.vis_d = voter == kDef;
  blk.time = time;
  blk.progress = (float)(blk.height * c.k);
  blk.auxf = row_leader_hash(g, row);
  return g.append_if(true, row, blk);
}

// bk.py:340-419
__device__ void advance(LaneDag& g, Scal& s, const EnvParams& p,
                        const EnvConfig& c) {
  const bool has_pending = s.x >= 0;
  Row prow;
  bool found = false;
  if (!has_pending) {
    const Mask vis_d = g.bools(g.d->vis_d);
    found = quorum(g, s.pub, kDef, vis_d, vis_d, c.k, prow);
  }
  const bool do_prop = !has_pending && found;
  const bool do_mine = !has_pending && !found;
  const cpr::Draws r = cpr::draw4(s.key);
  const float time =
      do_mine ? __fadd_rn(s.time, __fmul_rn(r.e, p.activation_delay)) : s.time;
  const bool attacker = r.u1 < p.alpha;
  const int32_t target = attacker ? s.priv : s.pub;
  const int32_t miner_v = attacker ? kAtt : kDef;
  int32_t idx = kNone;
  if (do_prop) {
    Block b;
    reward_of_block(g, prow, kDef, c, b.reward_atk, b.reward_def);
    b.kind = kBlock;
    b.height = g.at(g.d->height, s.pub) + 1;
    b.aux = 0;
    b.signer = kDef;
    b.miner = kDef;
    b.vis_d = true;
    b.time = time;
    b.progress = (float)(b.height * c.k);
    b.auxf = row_leader_hash(g, prow);
    idx = g.append_if(true, prow, b);
  } else if (do_mine) {
    Row vrow;
    vrow.p[0] = target;
    for (int q = 1; q < g.P; ++q) vrow.p[q] = kNone;
    Block b;
    b.kind = kVote;
    b.height = g.at(g.d->height, target);
    b.aux = miner_v;
    b.pow_hash = r.u2;
    b.signer = kNone;
    b.miner = miner_v;
    b.vis_d = !attacker;
    b.time = time;
    b.progress = (float)(b.height * c.k + 1);
    b.auxf = cpr::f_inf();
    idx = g.append_if(true, vrow, b);
  }
  if (do_prop) s.pub = update_head(g, s.pub, idx, g.bools(g.d->vis_d));
  s.event = has_pending ? kEvAppend
                        : (do_prop ? kEvNetwork
                                   : (attacker ? kEvPow : kEvNetwork));
  if (has_pending) s.priv = s.x;
  s.x = kNone;
  s.time = time;
  s.nact += do_mine ? 1 : 0;
  s.key = r.key;
}

// bk.py:449-528
__device__ void apply(LaneDag& g, Scal& s, int action, const EnvConfig& c) {
  const int k = c.k;
  const bool is_adopt = action == 0 || action == 4;
  const bool is_override = action == 1 || action == 5;
  const bool is_match = action == 2 || action == 6;
  const bool is_release = is_override || is_match;
  const bool proceed = action >= 4;
  const int32_t h_pub = g.at(g.d->height, s.pub);
  const Mask vis_d = g.bools(g.d->vis_d);
  const int nv_pub = mask_count(votes_on(g, s.pub) & vis_d);
  if (is_release) {
    const int32_t tgt_h = is_override && nv_pub >= k ? h_pub + 1 : h_pub;
    const int tgt_v = is_match ? nv_pub : (nv_pub >= k ? 0 : nv_pub + 1);
    int32_t blk = g.chain_at_height(s.priv, tgt_h);
    blk = blk < 0 ? 0 : blk;
    const Mask child_blocks = g.children0(blk) & g.kind_is(kBlock);
    const bool has_prop = mask_any(child_blocks);
    int32_t first_prop = g.first_by_age(child_blocks);
    first_prop = first_prop < 0 ? 0 : first_prop;
    const bool use_prop = tgt_v >= k && has_prop;
    const int32_t rel_block = use_prop ? first_prop : blk;
    const int rel_votes_n = use_prop ? 0 : tgt_v;
    const Mask votes = votes_on(g, rel_block);
    Mask vote_mask = votes;
    if (!(mask_count(votes) < rel_votes_n || rel_votes_n > c.ctk)) {
      int32_t idx[kMaxTopK];
      bool valid[kMaxTopK];
      g.top_k_plane(g.d->born_at, votes, c.ctk, idx, valid);
      for (int i = 0; i < c.ctk; ++i) valid[i] = valid[i] && i < rel_votes_n;
      vote_mask = g.mask_of(idx, valid, c.ctk);
    }
    if (cpr::kRing)
      g.release_masked(rel_block, s.time);
    else
      g.release_chain(rel_block, s.time);
    g.release(vote_mask, s.time);
    const int32_t x = rel_block;
    const int32_t last = g.at(g.d->kind, x) == kBlock ? x : g.at(g.d->parents[0], x);
    s.pub = update_head(g, s.pub, last, g.bools(g.d->vis_d));
  }
  if (is_adopt) s.priv = s.pub;
  const Mask filter =
      proceed ? g.exists()
              : g.where(g.d->miner, [](int32_t m) { return m == kAtt; });
  s.x = append_proposal(g, s.priv, kAtt, filter, g.bools(g.d->vis_a), s.time,
                        c);
}

struct BkEnv {
  static constexpr int kObs = 8;

  // bk.py:303-326 on the logically reset DAG
  __device__ static void reset(LaneDag& g, Scal& s, uint2 key,
                               const EnvParams& p, const EnvConfig& c,
                               bool*) {
    g.clear_rows(2);
    cpr::zero_scal(s, key, kEvPow);
    Row root;
    for (int q = 0; q < g.P; ++q) root.p[q] = kNone;
    Block b;
    b.kind = kBlock;
    b.miner = kNone;
    b.progress = 0.f;
    b.auxf = cpr::f_inf();
    s.pub = s.priv = g.append_if(true, root, b);
    advance(g, s, p, c);
  }

  // bk.py:538-570
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c, bool*,
                              StepOut& o) {
    apply(g, s, action, c);
    advance(g, s, p, c);
    s.steps += 1;
    if (cpr::kRing) {  // bk.py:544: the ring's retirement
      const int32_t ca = g.common_ancestor(s.pub, s.priv);
      g.retire_below(g.at(g.d->gid, ca < 0 ? 0 : ca));
    }
    const int n_pub = mask_count(votes_on(g, s.pub));
    const int n_priv = mask_count(votes_on(g, s.priv));
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const bool pub_better = hp > hv || (hp == hv && n_pub > n_priv);
    const int32_t head = pub_better ? s.pub : s.priv;
    cpr::finish_step(s, p, g.at(g.d->cum_atk, head), g.at(g.d->cum_def, head),
                     (float)(g.at(g.d->height, head) * c.k),
                     g.at(g.d->born_at, head), g.overflow, o);
  }

  // bk.py:421-447
  __device__ static void obs_ints(const LaneDag& g, const Scal& s,
                                  const EnvConfig& c, int32_t* v) {
    int32_t ca = g.common_ancestor(s.pub, s.priv);
    ca = ca < 0 ? 0 : ca;
    const Mask votes_pub = votes_on(g, s.pub);
    const Mask votes_priv = votes_on(g, s.priv);
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const int32_t hc = g.at(g.d->height, ca);
    v[0] = hp - hc;
    v[1] = hv - hc;
    v[2] = hv - hp;
    v[3] = mask_count(votes_pub & g.bools(g.d->vis_d));
    v[4] = mask_count(votes_priv);
    v[5] = mask_count(votes_priv & g.where(g.d->miner, [](int32_t m) {
                        return m == kAtt;
                      }));
    const int32_t leader = g.argmin_where(g.d->pow_hash, votes_pub);
    v[6] = mask_any(votes_pub) && g.at(g.d->aux, leader) == kAtt;
    v[7] = s.event;
  }

  __device__ static void encode(const int32_t* v, const EnvConfig& c,
                                float* f) {
    const bool u = c.unit != 0;
    const float k = (float)c.k;
    f[0] = cpr::enc_uint(v[0], 1.f, u);
    f[1] = cpr::enc_uint(v[1], 1.f, u);
    f[2] = cpr::enc_int(v[2], 1.f, u);
    f[3] = cpr::enc_uint(v[3], k, u);
    f[4] = cpr::enc_uint(v[4], k, u);
    f[5] = cpr::enc_uint(v[5], k, u);
    f[6] = (float)v[6];
    f[7] = cpr::enc_discrete(v[7], 3, u);
  }

  // bk.py:584-611 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig& c) {
    const int32_t pub_b = v[0], priv_b = v[1], pub_v = v[3], priv_vi = v[4];
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

// K10-bk stream launch: as cpr_k2_stream (csrc/nakamoto_stream.cu) over
// the DAG state `dp` + scalars `ep`; `obs` [L, 8] (+2 under extend_obs).
cudaError_t cpr_k10_bk_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<BkEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                     length, p, c, policy_id, extend_obs,
                                     sums, n_done, traj, net, stream);
}

// K10-bk step_lanes launch; the carry (`dp`, `ep`, `obs`) is updated in
// place.
cudaError_t cpr_k10_bk_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<BkEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

// K14-dag launch with its host traffic (csrc/dag_env.cuh
// `launch_dag_burst`): the carry and, with `e`, the rings are updated in
// place.
cudaError_t cpr_k14_bk_burst_staged(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    const cpr::BurstArgs* b, const cpr::ExpPtrs* e, const void* h_in,
    void* d_in, int64_t in_bytes, const void* d_out, void* h_out,
    int64_t out_bytes, void* stream) {
  return cpr::launch_dag_burst<BkEnv>(dp, ep, obs, n_lanes, p, c, b, e, h_in,
                                    d_in, in_bytes, d_out, h_out, out_bytes,
                                    stream);
}

// K14-dag's static shared memory here and a block's limit
// (csrc/dag_env.cuh `dag_burst_smem`).
cudaError_t cpr_k14_bk_burst_smem(int* static_bytes, int* block_bytes) {
  return cpr::dag_burst_smem<BkEnv>(static_bytes, block_bytes);
}

const char* cpr_k10_bk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
