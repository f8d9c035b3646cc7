// Kernel K10-sdag: the Sdag withholding env's fused episode stream and its
// one-tick step_lanes, one warp per lane over K8's DAG (csrc/dag.cuh) and
// K9's candidate frame, altruistic selection, release prefixes and stale
// plane (csrc/quorum.cuh).
//
// Replaces: cpr_tpu/envs/sdag.py:201-477 — the reward-density heuristic
// `_select_heuristic` (201), `select` over the frame of multi-parent votes
// (242), `block_reward` under the constant and discount schemes (266),
// `_mine_one` (287), `reset` (320), `_mine` (342), `observe` (384),
// `_release_sets` and `_apply` (404-443), `step` with the ring retirement
// at the block LCA (445-475), and the six policies (479-546) — under the
// drivers of cpr_tpu/envs/base.py:175-231, :259-301 and :342-506
// (csrc/dag_env.cuh). Plain twin: cpr_tpu_torch/envs/sdag.py over
// cpr_tpu_torch/envs/base.py.
//
// The heuristic: each of up to k-1 greedy rounds scores every candidate c
// on S'_c = S | closure(c) by its own reward, the sum over own x in S'_c of
// |descendants of x in S'_c| + |closure(x) & S'_c| - 1. With the closure
// rows `abits[i]` as 64-bit masks that sum is
//   sum_{y in S'_c} |abits[y] & S'_c & own| + sum_{x in S'_c & own}
//   |abits[x] & S'_c| - |S'_c & own|,
// popcounts over at most k-1 members; no (C, C) products.
//
// Bound: latency of warp-collective steps: one candidate frame a step (a
// closure-row scan per candidate), the heuristic's rounds, the release
// scan when the attacker releases, masked scans of the lane's planes, one
// append and 9 threefry blocks.
//
// Parity with the JAX package: integer state, keys, rewards and done are
// bit-identical; the time update is __fmul_rn/__fadd_rn as in K2; the
// density is __fdiv_rn then __fsub_rn of __fmul_rn(c, 1e-7f), so that
// nothing contracts into an FMA; the discount rate is a product with the
// float32 reciprocal of k-1 and the votes' rates add up in XLA:CPU's
// order (envs/sdag.py `xla_row_sum`); the vote order's age fraction is a
// correctly rounded division; the policies read the integer observation
// fields.

#include <cuda_runtime.h>

#include <cstdint>

#include "vote_env.cuh"

namespace {

using namespace cpr;

constexpr int kBlock = 0, kVote = 1;
constexpr int kEvPow = 0, kEvNetwork = 1;
constexpr int kWaitProceed = 7, kAdoptProceed = 4, kOverrideProceed = 5,
              kMatchProceed = 6;
constexpr int kSchemeDiscount = 1;

// sdag.py:177-184: vote number desc, then insertion order
__device__ __forceinline__ float vote_score(const LaneDag& g, int32_t s) {
  const float age = (float)(g.at(g.d->gid, s) - g.live_floor);
  return __fsub_rn((float)g.at(g.d->aux, s), __fdiv_rn(age, (float)g.W));
}

// Own reward of the candidate set `m` under the constant scheme (see
// above); `own` the own candidates.
__device__ __forceinline__ int own_reward(const QScratch& q, uint64_t m,
                                          uint64_t own) {
  int r = -__popcll(m & own);
  for (uint64_t y = m; y; y &= y - 1) {
    const int i = __ffsll((long long)y) - 1;
    r += __popcll(q.abits[i] & m & own);
    if (bit(own, i)) r += __popcll(q.abits[i] & m);
  }
  return r;
}

// sdag.py:201-240: returns the selected set S (a union of closures), `n`
// its size.
__device__ uint64_t select_heuristic(const LaneDag& g, const QScratch& q,
                                     const QFrame& f, uint64_t own_c, int qn,
                                     int& n) {
  uint64_t S = 0;
  int mrn = 0;
  n = 0;
  const int rounds = qn > 1 ? qn : 1;
  for (int r = 0; r < rounds && n < qn; ++r) {
    float best = -f_inf();
    int bi = INT32_MAX;
    for (int i = g.t; i < f.C; i += 32) {
      if (!bit(f.cvalid, i) || bit(S, i)) continue;
      const uint64_t sc = S | q.abits[i];
      const int size = __popcll(sc);
      if (size > qn || size <= n) continue;
      const float gain = (float)max(size - n, 1);
      const float density =
          __fsub_rn(__fdiv_rn((float)(own_reward(q, sc, own_c) - mrn), gain),
                    __fmul_rn((float)i, 1e-7f));
      if (density > best || bi == INT32_MAX) {
        best = density;
        bi = i;
      }
    }
    warp_select<true>(best, bi);
    if (bi == INT32_MAX) break;  // the later rounds find nothing either
    S |= q.abits[bi];
    n = __popcll(S);
    mrn = own_reward(q, S, own_c);
  }
  return S;
}

// The discount scheme's reciprocal 1/max(q, 1) (envs/sdag.py
// `discount_factor`).
__device__ __forceinline__ float discount_factor(int qn) {
  return __fdiv_rn(1.f, (float)(qn > 1 ? qn : 1));
}

// sdag.py:266-285: the block miner earns 1, each selected vote r (1, or
// (fwd + bwd - 1)/(k-1) inside the selection), summed in XLA:CPU's order:
// a frame of C > 32 adds its two windows [0, split) and [split, C) apart
// (split = 32 - (64 - C) / 2), each from the first index.
__device__ void block_reward(const LaneDag& g, const QScratch& q,
                             const QFrame& f, uint64_t S, int32_t miner,
                             const EnvConfig& c, float& atk, float& dfn) {
  const uint64_t in_s = S & f.cvalid;
  const int qn = c.k - 1;
  const bool discount = c.scheme == kSchemeDiscount;
  const float rq = discount_factor(qn);
  const int split = f.C > 32 ? 32 - (64 - f.C) / 2 : 64;
  float w[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [party][window]
  for (uint64_t y = in_s; y; y &= y - 1) {
    const int i = __ffsll((long long)y) - 1;
    float r = 1.f;
    if (discount) {
      int fwd = 0;
      for (uint64_t z = in_s; z; z &= z - 1)
        fwd += bit(q.abits[__ffsll((long long)z) - 1], i);
      const int bwd = __popcll(q.abits[i] & in_s);
      r = __fmul_rn((float)(fwd + bwd - 1), rq);
    }
    const int32_t m = g.at(g.d->miner, q.cidx[i]);
    if (m == kAtt || m == kDef) {
      float& acc = w[m][i >= split];
      acc = __fadd_rn(acc, r);
    }
  }
  atk = __fadd_rn(__fadd_rn(w[kAtt][0], w[kAtt][1]), miner == kAtt ? 1.f : 0.f);
  dfn = __fadd_rn(__fadd_rn(w[kDef][0], w[kDef][1]), miner == kDef ? 1.f : 0.f);
}

// sdag.py:287-316: a block on a Full selection, else a vote on the
// leaves of the Partial one (on the block itself when it is empty);
// returns the slot, `is_blk` its kind
__device__ int32_t mine_one(LaneDag& g, QScratch& q, int32_t head, Mask view,
                            Mask filter, int32_t miner, float time, float powh,
                            const EnvConfig& c, bool& is_blk) {
  const int qn = c.k - 1;
  const QFrame f =
      candidate_frame(g, q, confirming(g, head) & filter & view, c.cmax,
                      kVote);
  const uint64_t own = cminer(g, q, f, miner);
  uint64_t S;
  int n;
  if (c.selection == kSelAltruistic) {
    const float* seen = miner == kAtt ? g.d->born_at : g.d->vis_d_since;
    uint64_t tips;
    int n_cand;
    n = q_altruistic(g, q, f, own, seen, g.d->aux, qn, tips, n_cand);
    S = 0;
    for (; tips; tips &= tips - 1) S |= q.abits[__ffsll((long long)tips) - 1];
  } else {
    S = select_heuristic(g, q, f, own & f.cvalid, qn, n);
  }
  const bool full = n == qn;
  // the true leaves: members of S in no other member's closure
  uint64_t desc = 0;
  for (uint64_t y = S; y; y &= y - 1) {
    const int i = __ffsll((long long)y) - 1;
    desc |= q.abits[i] & ~(1ull << i);
  }
  Row row;
  row.p[0] = head;
  for (int p = 1; p < g.P; ++p) row.p[p] = kNone;
  if (full || n > 0)
    leaves_to_row(g, q, f, S & ~desc,
                  [&g](int32_t s) { return vote_score(g, s); }, g.P, row.p);
  Block b;
  if (full) block_reward(g, q, f, S, miner, c, b.reward_atk, b.reward_def);
  b.kind = full ? kBlock : kVote;
  b.height = g.at(g.d->height, head) + (full ? 1 : 0);
  b.aux = full ? 0 : n + 1;
  b.signer = full ? kNone : head;
  b.aux2 = full ? head : kNone;
  b.pow_hash = powh;
  b.miner = miner;
  b.vis_a = true;
  b.vis_d = miner == kDef;
  b.time = time;
  b.progress = (float)(b.height * c.k + b.aux);
  is_blk = full;
  return g.append_if(true, row, b, full ? head : row.p[0]);
}

// sdag.py:342-382; `s.x` is race_tip, `s.own` mining_excl.
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
  const Mask filter =
      attacker && s.own
          ? g.where(g.d->miner, [](int32_t m) { return m == kAtt; })
          : g.exists();
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

// sdag.py:412-443
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
    stale = stale_after_adopt(g, s.pub, stale);
    s.x = kNone;
  }
  s.own = action < 4;
}

struct SdagEnv {
  static constexpr int kObs = 7;

  // sdag.py:320-340 on the logically reset DAG
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

  // sdag.py:445-475; the block chain rides the chain plane, so the
  // block LCA is the masked common ancestor
  __device__ static void step(LaneDag& g, Scal& s, int action,
                              const EnvParams& p, const EnvConfig& c,
                              bool* stale_plane, StepOut& o) {
    QScratch& q = q_scratch();
    Mask stale = g.bools(stale_plane);
    apply(g, q, s, stale, action, c);
    mine(g, q, s, stale, p, c);
    s.steps += 1;
    const int32_t ca = g.common_ancestor(s.pub, s.priv);
    g.retire_below(g.at(g.d->gid, ca < 0 ? 0 : ca));
    s.x = g.drop_if_retired(s.x);
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

  // sdag.py:384-402
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
    const float k = (float)c.k, q = (float)(c.k - 1 > 1 ? c.k - 1 : 1);
    f[0] = enc_uint(v[0], 1.f, u);
    f[1] = enc_uint(v[1], 1.f, u);
    f[2] = enc_int(v[2], 1.f, u);
    f[3] = enc_uint(v[3], k, u);
    f[4] = enc_uint(v[4], q, u);
    f[5] = enc_uint(v[5], q, u);
    f[6] = enc_discrete(v[6], 2, u);
  }

  // sdag.py:489-537 on the integer fields
  __device__ static int policy(int id, const int32_t* v, const EnvConfig& c) {
    const int32_t pub_b = v[0], priv_b = v[1], pub_v = v[3], priv_vi = v[4];
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
        if (priv_vi == 0 && priv_b == pub_b + 1) return kOverrideProceed;
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

// K10-sdag stream launch: as cpr_k10_bk_stream (csrc/bk_stream.cu); `obs`
// [L, 7] (+2 under extend_obs).
cudaError_t cpr_k10_sdag_stream(const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep,
    void* obs, const void* keys, int init_mode, int64_t n_lanes, int length,
    const cpr::ParamPtrs* p, const EnvConfig* c, int policy_id,
    int extend_obs, void* sums, void* n_done, const cpr::DagTrajPtrs* traj,
    const cpr::NetArgs* net, void* stream) {
  return cpr::launch_dag_stream<SdagEnv>(dp, ep, obs, keys, init_mode, n_lanes,
                                         length, p, c, policy_id, extend_obs,
                                         sums, n_done, traj, net, stream);
}

// K10-sdag step_lanes launch; the carry is updated in place.
cudaError_t cpr_k10_sdag_step_lanes(
    const cpr::DagPtrs* dp, const cpr::EnvPtrs* ep, void* obs,
    const void* actions, const void* admit, const cpr::DagPtrs* fdp,
    const cpr::EnvPtrs* fep, const void* fresh_obs, const void* step_mask,
    int64_t n_lanes, const cpr::ParamPtrs* p, const EnvConfig* c,
    int extend_obs, void* out_obs, void* reward, void* done, void* info,
    void* stream) {
  return cpr::launch_dag_step_lanes<SdagEnv>(
      dp, ep, obs, actions, admit, fdp, fep, fresh_obs, step_mask, n_lanes, p,
      c, extend_obs, out_obs, reward, done, info, stream);
}

const char* cpr_k10_sdag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
