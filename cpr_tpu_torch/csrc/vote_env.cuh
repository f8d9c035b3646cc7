// Pieces shared by the parallel-PoW env kernels K10-ts, K10-stree,
// K10-spar and K10-sdag (csrc/{tailstorm,stree,spar,sdag}_stream.cu) and
// K9's check (csrc/quorum_check.cu): the confirming-vote query, the
// Tailstorm and Stree/Sdag preferences, warp reductions over slots, the
// per-lane `stale` plane, and the quorum selection over K9
// (csrc/quorum.cuh) with each env's scores.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dag_env.cuh"
#include "quorum.cuh"

namespace cpr {

static_assert(kQWarps == kWarpsPerBlock, "K9 scratch: one per warp");

constexpr int kKind0 = 0, kVoteKind = 1;  // block/summary, vote
constexpr int kAtt = 0, kDef = 1;
constexpr int kSelAltruistic = 0, kSelHeuristic = 1, kSelOptimal = 2;

__device__ __forceinline__ bool scheme_discount(const EnvConfig& c) {
  return c.scheme == 1 || c.scheme == 3;
}
__device__ __forceinline__ bool scheme_punish(const EnvConfig& c) {
  return c.scheme == 2 || c.scheme == 3;
}

// votes confirming block s (tailstorm.py:179, stree.py:147): votes store
// their block in `signer`; newer_than guards a reclaimed slot
__device__ __forceinline__ Mask confirming(const LaneDag& g, int32_t s) {
  return g.exists() & g.kind_is(kVoteKind) &
         g.where(g.d->signer, [s](int32_t v) { return v == s; }) &
         g.newer_than(s);
}

// x strictly preferred over y: by height, then by the votes confirming
// each in `filter`, then, where `own` is given, by own[x] > own[y]
__device__ bool prefers(const LaneDag& g, int32_t x, int32_t y, Mask filter,
                        const float* own) {
  if (x == y) return false;
  const int32_t hx = g.at(g.d->height, x), hy = g.at(g.d->height, y);
  if (hx != hy) return hx > hy;
  const int nx = mask_count(confirming(g, x) & filter);
  const int ny = mask_count(confirming(g, y) & filter);
  if (nx != ny) return nx > ny;
  return own != nullptr && g.at(own, x) > g.at(own, y);
}

// tailstorm.py:271-290: the third key is the party's own reward
__device__ __forceinline__ bool cmp_summaries(const LaneDag& g, int32_t x,
                                              int32_t y, Mask filter,
                                              int32_t my) {
  return prefers(g, x, y, filter, my == kAtt ? g.d->auxf : g.d->auxg);
}

// stree.py:182-190: (height, filtered confirming votes) only
__device__ __forceinline__ bool cmp_blocks(const LaneDag& g, int32_t x,
                                           int32_t y, Mask filter) {
  return prefers(g, x, y, filter, nullptr);
}

__device__ __forceinline__ int32_t warp_max_i(int32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// max over m of the int plane, 0 when empty (where(m, x, 0).max() for
// x >= 0), and |m|
__device__ __forceinline__ int32_t max_where(const LaneDag& g,
                                             const int32_t* plane, Mask m) {
  int32_t v = 0;
#pragma unroll
  for (int j = 0; j < kNS; ++j)
    if ((m >> j) & 1u) v = max(v, plane[g.o(g.slot(j))]);
  return warp_max_i(v);
}

// argmax over m of score(slot) (the first slot among equals), NONE when m
// is empty
template <class Score>
__device__ __forceinline__ int32_t argmax_where(const LaneDag& g, Mask m,
                                                Score score) {
  float k = -f_inf();
  int s = INT32_MAX;
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (!((m >> j) & 1u)) continue;
    const float v = score(g.slot(j));
    if (v > k || s == INT32_MAX) {
      k = v;
      s = g.slot(j);
    }
  }
  warp_select<true>(k, s);
  return mask_any(m) ? s : kNone;
}

// the lowest slot of m, NONE when empty
__device__ __forceinline__ int32_t first_slot(const LaneDag& g, Mask m) {
  int s = INT32_MAX;
#pragma unroll
  for (int j = 0; j < kNS; ++j)
    if ((m >> j) & 1u) s = min(s, g.slot(j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = min(s, __shfl_xor_sync(kFull, s, off));
  return s == INT32_MAX ? kNone : s;
}

// The slot bit of s in this thread's Mask, if it owns it.
__device__ __forceinline__ Mask slot_bit(const LaneDag& g, int32_t s) {
  return (s >= 0 && (s & 31) == g.t) ? (1u << (s >> 5)) : 0u;
}

__device__ __forceinline__ void store_mask(const LaneDag& g, bool* plane,
                                           Mask m) {
#pragma unroll
  for (int j = 0; j < kNS; ++j)
    if (g.in(j)) plane[g.o(g.slot(j))] = (m >> j) & 1u;
  __syncwarp();
}

// The quorum of a block: candidates `cand`, selection by the env's
// options; `q` votes, `width` leaves in `row` from slot `row0`. Leaves the
// frame in the scratch for the reward. Returns found.
template <class Score>
__device__ bool select_quorum(const LaneDag& g, QScratch& q, QFrame& f,
                              Mask cand, int32_t voter, int qn, int width,
                              const EnvConfig& c, int depth_plus,
                              int miner_share, Score score, Row& row,
                              int row0, uint64_t& leaves) {
  f = candidate_frame(g, q, cand, c.cmax, kVoteKind);
  const uint64_t own = cminer(g, q, f, voter);
  bool found;
  if (c.selection == kSelAltruistic) {
    const float* seen = voter == kAtt ? g.d->born_at : g.d->vis_d_since;
    int n_cand;
    const int n = q_altruistic(g, q, f, own, seen, g.d->aux, qn, leaves,
                               n_cand);
    found = n == qn && n_cand >= qn;
  } else if (c.selection == kSelOptimal) {
    OptimalArgs a;
    a.window = c.opt_window;
    a.k = c.k;
    a.depth_plus = depth_plus;
    a.miner_share = miner_share;
    a.discount = scheme_discount(c);
    a.punish = scheme_punish(c);
    found = q_optimal_or_heuristic(g, q, f, own & f.cvalid, g.d->aux, score,
                                   qn, a, leaves);
  } else {
    found = q_heuristic(g, q, f, own & f.cvalid, qn, leaves);
  }
  leaves_to_row(g, q, f, leaves, score, width, row.p + row0);
  return found;
}

}  // namespace cpr
