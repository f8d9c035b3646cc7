// Kernel K10-spar: the Spar withholding env's fused episode stream and its
// one-tick step_lanes, one warp per lane over K8's DAG (csrc/dag.cuh).
//
// Replaces: cpr_tpu/envs/spar.py:215-414 — `reset` (215), `_mine` (236: one
// mining draw, the gamma race), `observe` (282), `_apply` with the release
// targeting, the proposal fast path and the release-every-vote fallback
// (303-377), `step` with the ring retirement and the winner (379-414), and
// beneath them `confirming`, `last_block`, the four-key `cmp_blocks` /
// `update_head` and `_mine_one` with its own-first vote choice and the
// constant/block rewards (126-213), and the two policies (416-434) — under
// the drivers of cpr_tpu/envs/base.py:175-231, :259-301 and :342-506
// (csrc/dag_env.cuh). Plain twin: cpr_tpu_torch/envs/spar.py over
// cpr_tpu_torch/envs/base.py.
//
// Bound: latency of warp-collective steps: masked scans of the lane's
// planes, a top-k of k-1 passes when a block is drafted, one of up to k+8
// passes when a release ships votes, one append and 9 threefry blocks.
//
// Parity with the JAX package: integer state, keys, rewards and done are
// bit-identical; the time update is __fmul_rn/__fadd_rn as in K2; the
// vote score adds the horizon (the largest born_at over every slot of the
// plane, empty and retired ones included, + 1) with __fadd_rn, and its
// top-k breaks ties to the lowest slot as the reference's stable
// extraction does; the policies read the integer observation fields.

#include <cuda_runtime.h>

#include <cstdint>

#include "vote_env.cuh"

namespace {

using namespace cpr;

constexpr int kBlock = 0, kVote = 1;
constexpr int kEvPow = 0, kEvNetwork = 1;
constexpr int kWaitProlong = 3, kAdoptProceed = 4, kOverrideProceed = 5,
              kWaitProceed = 7;

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// spar.py:148-163: x strictly preferred over y by (height, filtered
// confirming votes, appended by `me`, earliest seen by `me`); the one
// copy the stream and step_lanes both run
__device__ bool cmp_blocks(const LaneDag& g, int32_t x, int32_t y, Mask filter,
                           int32_t me) {
  if (x == y) return false;
  const int32_t hx = g.at(g.d->height, x), hy = g.at(g.d->height, y);
  if (hx != hy) return hx > hy;
  const int nx = mask_count(confirming(g, x) & filter);
  const int ny = mask_count(confirming(g, y) & filter);
  if (nx != ny) return nx > ny;
  const bool ox = g.at(g.d->miner, x) == me, oy = g.at(g.d->miner, y) == me;
  if (ox != oy) return ox;
  const float* seen = me == kAtt ? g.d->born_at : g.d->vis_d_since;
  return g.at(seen, x) < g.at(seen, y);
}

// spar.py:165-168
__device__ __forceinline__ int32_t update_head(const LaneDag& g, int32_t old,
                                               int32_t cand, int32_t me) {
  const Mask m = me == kAtt ? g.exists() : g.bools(g.d->vis_d);
  return cmp_blocks(g, cand, old, m, me) ? cand : old;
}

// spar.py:144-146
__device__ __forceinline__ int32_t last_block(const LaneDag& g, int32_t x) {
  return g.at(g.d->kind, x) == kBlock ? x : g.at(g.d->signer, x);
}

// spar.py:170-211: a block on k-1 filtered votes (own first, then
// earliest seen), else a vote; returns the slot, `is_blk` its kind
__device__ int32_t mine_one(LaneDag& g, int32_t head, Mask view, Mask filter,
                            int32_t miner, float time, float powh,
                            const EnvConfig& c, bool& is_blk) {
  const int k = c.k;
  const Mask votes = confirming(g, head) & view & filter;
  const bool make_block = mask_count(votes) >= k - 1;
  Row row;
  row.p[0] = head;
  for (int p = 1; p < g.P; ++p) row.p[p] = kNone;
  Block b;
  if (make_block) {
    float horizon = -f_inf();
#pragma unroll
    for (int j = 0; j < kNS; ++j)
      if (g.in(j)) horizon = fmaxf(horizon, g.d->born_at[g.o(g.slot(j))]);
    horizon = __fadd_rn(warp_max_f(horizon), 1.f);
    const float* seen = miner == kAtt ? g.d->born_at : g.d->vis_d_since;
    float sc[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      sc[j] = 0.f;
      if (!g.in(j)) continue;
      const int64_t o = g.o(g.slot(j));
      sc[j] = g.d->miner[o] == miner ? seen[o] : __fadd_rn(seen[o], horizon);
    }
    int32_t idx[kMaxTopK];
    bool valid[kMaxTopK];
    g.top_k(sc, votes, k - 1, idx, valid);
    int na = 0, nd = 0;
    for (int i = 0; i < k - 1; ++i) {
      row.p[1 + i] = valid[i] ? idx[i] : kNone;
      const int32_t m = valid[i] ? g.at(g.d->miner, idx[i]) : kNone;
      na += m == kAtt;
      nd += m == kDef;
    }
    if (c.constant) {
      b.reward_atk = (float)(na + (miner == kAtt));
      b.reward_def = (float)(nd + (miner == kDef));
    } else {  // block: k to the block miner
      b.reward_atk = miner == kAtt ? (float)k : 0.f;
      b.reward_def = miner == kDef ? (float)k : 0.f;
    }
  }
  b.kind = make_block ? kBlock : kVote;
  b.height = g.at(g.d->height, head) + (make_block ? 1 : 0);
  b.signer = make_block ? kNone : head;
  b.pow_hash = powh;
  b.miner = miner;
  b.vis_a = true;
  b.vis_d = miner == kDef;
  b.time = time;
  b.progress = (float)(b.height * k + (make_block ? 0 : 1));
  is_blk = make_block;
  return g.append_if(true, row, b);
}

// spar.py:236-280; `s.x` is race_tip, `s.own` mining_excl.
__device__ void mine(LaneDag& g, Scal& s, const EnvParams& p,
                     const EnvConfig& c) {
  const Draws5 r = draw5(s.key);
  const float time = __fadd_rn(s.time, __fmul_rn(r.e, p.activation_delay));
  const bool attacker = r.u_mine < p.alpha;
  int32_t def_head = s.pub;
  if (!attacker) {
    if (s.x >= 0 && r.u_gamma < p.gamma &&
        g.at(g.d->height, s.x) == g.at(g.d->height, s.pub)) {
      const Mask vis_d = g.bools(g.d->vis_d);
      if (mask_count(confirming(g, s.x) & vis_d) ==
          mask_count(confirming(g, s.pub) & vis_d))
        def_head = s.x;
    }
    s.x = kNone;
  }
  const Mask filter =
      attacker && s.own
          ? g.where(g.d->miner, [](int32_t m) { return m == kAtt; })
          : g.exists();
  const int32_t head = attacker ? s.priv : def_head;
  const Mask view = g.bools(attacker ? g.d->vis_a : g.d->vis_d);
  const int32_t miner = attacker ? kAtt : kDef;
  bool is_blk;
  const int32_t idx =
      mine_one(g, head, view, filter, miner, time, r.u_hash, c, is_blk);
  if (attacker) {
    if (is_blk) s.priv = idx;
  } else {
    s.pub = is_blk ? update_head(g, def_head, idx, kDef) : def_head;
  }
  s.event = attacker ? kEvPow : kEvNetwork;
  s.time = time;
  s.nact += 1;
  s.key = r.key;
}

// spar_ssz.ml:255-317 (spar.py:303-377)
__device__ void apply(LaneDag& g, Scal& s, int action, const EnvConfig& c) {
  const int k = c.k;
  const bool is_adopt = action == 0 || action == 4;
  const bool is_override = action == 1 || action == 5;
  const bool is_match = action == 2 || action == 6;
  if (is_override || is_match) {
    // release targeting by the public head's (height, votes)
    const int32_t h_pub = g.at(g.d->height, s.pub);
    const int nv_pub = mask_count(confirming(g, s.pub) & g.bools(g.d->vis_d));
    const int32_t tgt_h = is_override && nv_pub >= k ? h_pub + 1 : h_pub;
    const int tgt_v = is_match ? nv_pub : (nv_pub >= k ? 0 : nv_pub + 1);
    int32_t blk = g.chain_first_at_most(s.priv, g.d->height, tgt_h);
    blk = blk < 0 ? 0 : blk;
    // the proposal fast path: the first block child by age
    const Mask child_blocks = g.children0(blk) & g.kind_is(kBlock);
    const bool use_prop = tgt_v >= k && mask_any(child_blocks);
    int32_t rel = blk;
    int rel_votes_n = tgt_v;
    if (use_prop) {
      rel = g.first_by_age(child_blocks);
      rel_votes_n = 0;
    }
    // the rel_votes_n oldest confirming votes, or every one of them
    // where the selection cannot hold the request
    const Mask votes = confirming(g, rel);
    Mask vote_mask = votes;
    if (!(mask_count(votes) < rel_votes_n || rel_votes_n > k + 8)) {
      vote_mask = 0;
      if (rel_votes_n > 0) {
        int32_t idx[kMaxTopK];
        bool valid[kMaxTopK];
        g.top_k_plane(g.d->born_at, votes, rel_votes_n, idx, valid);
        vote_mask = g.mask_of(idx, valid, rel_votes_n);
      }
    }
    g.release_masked(rel, s.time);
    g.release(vote_mask, s.time);
    // deliver to the simulated defender; a tie arms the gamma race
    const int32_t rb = last_block(g, rel);
    s.pub = update_head(g, s.pub, rb, kDef);
    bool tie = rb != s.pub && g.at(g.d->height, rb) == g.at(g.d->height, s.pub);
    if (tie) {
      const Mask vis_d = g.bools(g.d->vis_d);
      tie = mask_count(confirming(g, rb) & vis_d) ==
            mask_count(confirming(g, s.pub) & vis_d);
    }
    if (tie)
      s.x = rb;
    else if (is_override)
      s.x = kNone;
  }
  if (is_adopt) {
    s.priv = s.pub;
    s.x = kNone;
  }
  s.own = action < 4;
}

struct SparEnv {
  static constexpr int kObs = 7;

  // spar.py:215-234 on the logically reset DAG
  __device__ static void reset(LaneDag& g, Scal& s, uint2 key,
                               const EnvParams& p, const EnvConfig& c,
                               bool*) {
    g.clear_rows(2);
    zero_scal(s, key, kEvPow);
    s.own = false;
    Row root;
    for (int q = 0; q < g.P; ++q) root.p[q] = kNone;
    Block b;
    b.kind = kBlock;
    b.miner = kNone;
    b.progress = 0.f;
    s.pub = s.priv = g.append_if(true, root, b);
    mine(g, s, p, c);
  }

  // spar.py:379-412
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c, bool*,
                              StepOut& o) {
    apply(g, s, action, c);
    mine(g, s, p, c);
    s.steps += 1;
    const int32_t ca = g.common_ancestor(s.pub, s.priv);
    g.retire_below(g.at(g.d->gid, ca < 0 ? 0 : ca));
    s.x = g.drop_if_retired(s.x);
    const int n_pub = mask_count(confirming(g, s.pub));
    const int n_priv = mask_count(confirming(g, s.priv));
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const bool pub_better = hp > hv || (hp == hv && n_pub > n_priv);
    const int32_t head = pub_better ? s.pub : s.priv;
    finish_step(s, p, g.at(g.d->cum_atk, head), g.at(g.d->cum_def, head),
                (float)(g.at(g.d->height, head) * c.k),
                g.at(g.d->born_at, head), g.overflow, o);
  }

  // spar.py:282-301
  __device__ static void obs_ints(const LaneDag& g, const Scal& s,
                                  const EnvConfig& c, int32_t* v) {
    int32_t ca = g.common_ancestor(s.pub, s.priv);
    ca = ca < 0 ? 0 : ca;
    const Mask inc = confirming(g, s.priv);
    const int32_t hp = g.at(g.d->height, s.pub), hv = g.at(g.d->height, s.priv);
    const int32_t hc = g.at(g.d->height, ca);
    v[0] = hp - hc;
    v[1] = hv - hc;
    v[2] = hv - hp;
    v[3] = mask_count(confirming(g, s.pub) & g.bools(g.d->vis_d));
    v[4] = mask_count(inc);
    v[5] = mask_count(
        inc & g.where(g.d->miner, [](int32_t m) { return m == kAtt; }));
    v[6] = s.event;
  }

  __device__ static void encode(const int32_t* v, const EnvConfig& c,
                                float* f) {
    const bool u = c.unit != 0;
    const float q = (float)(c.k - 1);
    f[0] = enc_uint(v[0], 1.f, u);
    f[1] = enc_uint(v[1], 1.f, u);
    f[2] = enc_int(v[2], 1.f, u);
    f[3] = enc_uint(v[3], q, u);
    f[4] = enc_uint(v[4], q, u);
    f[5] = enc_uint(v[5], q, u);
    f[6] = enc_discrete(v[6], 2, u);
  }

  // spar.py:424-432 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig&) {
    const int32_t pub_b = v[0], priv_b = v[1];
    if (id == 0) return pub_b > 0 ? kAdoptProceed : kOverrideProceed;
    if (priv_b < pub_b) return kAdoptProceed;  // selfish
    if (priv_b == 0 && pub_b == 0) return kWaitProlong;
    return pub_b == 0 ? kWaitProceed : kOverrideProceed;
  }
};

}  // namespace

extern "C" {

// K10-spar stream launch: as cpr_k10_bk_stream (csrc/bk_stream.cu); `obs`
// [L, 7] (+2 under extend_obs).
cudaError_t cpr_k10_spar_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<SparEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                         length, p, c, policy_id, extend_obs,
                                         sums, n_done, traj, net, stream);
}

// K10-spar step_lanes launch; the carry is updated in place.
cudaError_t cpr_k10_spar_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<SparEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

const char* cpr_k10_spar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
