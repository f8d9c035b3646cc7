// Kernel K9: the vote quorums of the parallel-PoW envs as device
// functions, one warp per lane, over K8's ring DAG with ancestry planes.
//
// Replaces: cpr_tpu/envs/quorum.py:56-471 — `last_of_kind_all` (56),
// `candidate_frame` (65-138, the ancestry-plane branch), the selectors
// `quorum_heuristic` (153), `quorum_altruistic` (182), `quorum_optimal`
// and its fallback (253-340) over the `optimal_combos` table (239, here
// unranked on the fly in the same order), `leaves_to_row` (343),
// `prefix_release_sets` (352) and `stale_after_adopt` (443, the plane
// branch). Plain twin: cpr_tpu_torch/envs/quorum.py. Its own check kernel
// is csrc/quorum_check.cu; on the main path it runs inside K10-ts,
// K10-stree and K10-sdag (csrc/{tailstorm,stree,sdag}_stream.cu).
//
// Layout: the candidate frame holds C <= 64 candidates; candidate i is
// handled by thread i % 32, and a set of candidates is a warp-uniform
// 64-bit mask (closure rows `abits[i]`, the selections, the validity).
// The frame's slots and closure rows, and the age-ordered release
// positions, live in a per-warp scratch in shared memory (`QScratch`).
// Compaction by age uses the ring's invariant that the live gids are the
// last W appended, one per slot: a live slot's age rank is gid - (n - W).
//
// Parity rules: a gather of a candidate value reads 0 where the value is
// not finite or the candidate lies outside the frame (the one-hot matmuls
// of the reference); an argmax takes the lowest index among equal keys;
// the optimal score is r * count in float32 with correctly rounded
// division (__fdiv_rn, __fmul_rn).
//
// Bound: warp-collective latency, as K8: every selection round is a few
// popcounts per candidate and one 5-shuffle butterfly.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dag.cuh"

namespace cpr {

constexpr int kQMaxC = 64;    // candidate frame, C = 4k + 16 (k <= 12)
constexpr int kQMaxR = 128;   // release scan and slots (W <= 128)
constexpr int kQWarps = 4;    // warps per block of the kernels that use K9

struct QScratch {
  int32_t cidx[kQMaxC];    // the frame's slots, age order
  uint64_t abits[kQMaxC];  // closure rows over candidates
  float f[kQMaxC];         // per-candidate float scratch
  int32_t d[kQMaxC];       // per-candidate int scratch
  int32_t pos[kQMaxR];     // age-ordered slots
  int32_t a[kQMaxR];       // per-position / per-slot scratch
  int32_t cnt[kQMaxR];     // per-slot scratch
};

// This warp's scratch (static shared memory of the calling kernel).
__device__ __forceinline__ QScratch& q_scratch() {
  __shared__ QScratch s[kQWarps];
  return s[(threadIdx.x >> 5) % kQWarps];
}

struct QFrame {
  int nC;           // candidates gathered: min(|cand|, C)
  int C;            // the frame's width
  uint64_t gvalid;  // bits [0, nC): the frame before escapes
  uint64_t cvalid;  // the candidates left after escapes
};

__device__ __forceinline__ uint64_t low_bits(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}
__device__ __forceinline__ bool bit(uint64_t m, int i) {
  return (m >> i) & 1ull;
}
__device__ __forceinline__ uint64_t warp_or64(uint64_t v) {
  const uint32_t lo = __reduce_or_sync(kFull, (uint32_t)v);
  const uint32_t hi = __reduce_or_sync(kFull, (uint32_t)(v >> 32));
  return ((uint64_t)hi << 32) | lo;
}
__device__ __forceinline__ float finite_or0(float v) {
  return isfinite(v) ? v : 0.f;
}

// The slots of `m` (live slots) in age order: the first `cap` go to
// out[], the return value is |m|. `tmp` holds W ints.
__device__ int compact_by_age(const LaneDag& g, Mask m, int cap, int32_t* out,
                              int32_t* tmp) {
  const int W = g.W, t = g.t;
  const int32_t lo = g.n > W ? g.n - W : 0;
  __syncwarp();  // the scratch's last readers are done
  for (int p = t; p < W; p += 32) tmp[p] = kNone;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (!((m >> j) & 1u)) continue;
    const int s = g.slot(j);
    const int p = g.d->gid[g.o(s)] - lo;
    if (p >= 0 && p < W) tmp[p] = s;
  }
  __syncwarp();
  int32_t local[4];
  int c = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = 4 * t + u;
    local[u] = p < W ? tmp[p] : kNone;
    c += local[u] >= 0;
  }
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (t >= off) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int base = incl - c;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (local[u] < 0) continue;
    if (base < cap) out[base] = local[u];
    ++base;
  }
  __syncwarp();
  return total;
}

// quorum.py:56: the block of every vertex (a vertex of `kind` is its own)
__device__ __forceinline__ int32_t last_of_kind(const LaneDag& g, int32_t x,
                                                int kind) {
  return g.at(g.d->kind, x) == kind ? x : g.at(g.d->signer, x);
}

// quorum.py:65-138 in ring mode with ancestry planes.
__device__ QFrame candidate_frame(const LaneDag& g, QScratch& q, Mask cand,
                                  int C, int vote_kind) {
  QFrame f;
  const int t = g.t;
  f.C = C;
  f.nC = min(compact_by_age(g, cand, C, q.cidx, q.pos), C);
  f.gvalid = low_bits(f.nC);
  for (int p = t; p < g.W; p += 32) q.cnt[p] = kNone;
  __syncwarp();
  for (int i = t; i < f.nC; i += 32) q.cnt[q.cidx[i]] = i;
  __syncwarp();
  const Mask votes = g.kind_is(vote_kind);
  int32_t gid_s[kNS], sig_s[kNS], cpos[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const bool ok = g.in(j);
    const int s = g.slot(j);
    gid_s[j] = ok ? g.d->gid[g.o(s)] : 0;
    sig_s[j] = ok ? g.d->signer[g.o(s)] : kNone;
    cpos[j] = ok ? q.cnt[s] : kNone;
  }
  uint64_t escaped = 0;
  for (int i = 0; i < f.nC; ++i) {
    const int32_t x = q.cidx[i];
    const int32_t gx = g.at(g.d->gid, x);
    const int32_t sig = g.at(g.d->signer, x);
    const int32_t gsig = sig >= 0 ? g.at(g.d->gid, sig) : 0;
    const bool* r = g.row(g.d->closure, x);
    uint64_t bits = 0;
    bool esc = false;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (!g.in(j)) continue;
      const int s = g.slot(j);
      const bool anc = r[s] && gid_s[j] <= gx && ((votes >> j) & 1u) &&
                       sig_s[j] == sig && gid_s[j] > gsig;
      if (!anc) continue;
      if (cpos[j] >= 0)
        bits |= 1ull << cpos[j];
      else
        esc = true;
    }
    esc = __any_sync(kFull, esc);
    bits = warp_or64(bits);
    if (t == 0) q.abits[i] = bits;
    if (esc) escaped |= 1ull << i;
  }
  f.cvalid = f.gvalid & ~escaped;
  __syncwarp();
  for (int i = t; i < C; i += 32)
    q.abits[i] = bit(f.cvalid, i) ? (q.abits[i] & f.cvalid) : 0ull;
  __syncwarp();
  return f;
}

// oh_gather of a per-slot plane at candidate i
template <typename T>
__device__ __forceinline__ float cgather(const LaneDag& g, const QScratch& q,
                                         const QFrame& f, const T* plane,
                                         int i) {
  return i < f.nC ? finite_or0((float)g.at(plane, q.cidx[i])) : 0.f;
}

// The candidates whose slot is set in the per-slot bool plane `plane`
// (gathered with the frame's validity, as oh_gather(...) > 0.5).
__device__ __forceinline__ uint64_t cbits(const LaneDag& g, const QScratch& q,
                                          const QFrame& f, const bool* plane) {
  uint64_t m = 0;
  for (int i = g.t; i < f.nC; i += 32)
    if (g.at(plane, q.cidx[i])) m |= 1ull << i;
  return warp_or64(m);
}
// The candidates whose miner is `who`.
__device__ __forceinline__ uint64_t cminer(const LaneDag& g, const QScratch& q,
                                           const QFrame& f, int32_t who) {
  uint64_t m = 0;
  for (int i = g.t; i < f.nC; i += 32)
    if (g.at(g.d->miner, q.cidx[i]) == who) m |= 1ull << i;
  return warp_or64(m);
}

// quorum.py:153: returns found; `leaves` the chosen tips.
__device__ bool q_heuristic(const LaneDag& g, const QScratch& q,
                            const QFrame& f, uint64_t own_c, int qn,
                            uint64_t& leaves) {
  uint64_t inc = 0;
  leaves = 0;
  int n_rem = qn;
  const int rounds = qn > 1 ? qn : 1;
  for (int r = 0; r < rounds; ++r) {
    int best = -1, bi = INT32_MAX;
    for (int i = g.t; i < f.C; i += 32) {
      const uint64_t fr = q.abits[i] & ~inc;
      const int fa = __popcll(fr), fo = __popcll(fr & own_c);
      const bool elig = bit(f.cvalid, i) && !bit(inc, i) && fa >= 1 &&
                        fa <= n_rem && n_rem > 0;
      const int sc = elig ? (((fo * (qn + 2) + fa) << 8) + (f.C - i)) : -1;
      if (sc > best) {
        best = sc;
        bi = i;
      }
    }
    warp_select<true>(best, bi);
    if (best < 0) break;  // the later rounds find nothing either
    const uint64_t row = q.abits[bi];
    n_rem -= __popcll(row & ~inc);
    inc |= row;
    leaves |= 1ull << bi;
  }
  return n_rem == 0 && __popcll(f.cvalid) >= qn;
}

// quorum.py:182: returns n (the votes selected); n_cand the candidates.
__device__ int q_altruistic(const LaneDag& g, QScratch& q, const QFrame& f,
                            uint64_t own_g, const float* seen,
                            const int32_t* depth, int qn, uint64_t& leaves,
                            int& n_cand) {
  const int d_max = (1 << 12) - 1;
  __syncwarp();
  for (int i = g.t; i < f.C; i += 32)
    q.f[i] = bit(f.cvalid, i) ? cgather(g, q, f, seen, i) : f_inf();
  __syncwarp();
  int32_t comp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = g.t + 32 * h;
    comp[h] = INT32_MAX;
    if (i >= f.C || !bit(f.cvalid, i)) continue;
    const float si = q.f[i];
    int rank = 0;
    for (int j = 0; j < f.C; ++j) {
      const float sj = q.f[j];
      rank += (sj < si) || (sj == si && j < i);
    }
    const int d = min((int)cgather(g, q, f, depth, i), d_max);
    const int notown = bit(own_g, i) ? 0 : 1;
    comp[h] = (((((d_max - d) << 1) | notown) << 8) + rank) << 8;
    comp[h] += i;
  }
  n_cand = __popcll(f.cvalid);
  uint64_t acc = 0, done = 0;
  leaves = 0;
  int n = 0;
  for (int it = 0; it < n_cand && n < qn; ++it) {
    int best = INT32_MAX, bi = INT32_MAX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = g.t + 32 * h;
      if (i < f.C && bit(f.cvalid, i) && !bit(done, i) && comp[h] < best) {
        best = comp[h];
        bi = i;
      }
    }
    warp_select<false>(best, bi);
    done |= 1ull << bi;
    const int fresh = __popcll(q.abits[bi] & ~acc);
    if (fresh >= 1 && n + fresh <= qn) {
      acc |= q.abits[bi];
      leaves |= 1ull << bi;
      n += fresh;
    }
  }
  return n;
}

__device__ __forceinline__ int binom(int n, int k) {
  if (k < 0 || n < k) return 0;
  int64_t r = 1;
  for (int i = 1; i <= k; ++i) r = r * (n - k + i) / i;
  return (int)r;
}

// The o-th size-q subset of [0, W) in itertools.combinations order.
__device__ __forceinline__ uint64_t unrank(int o, int W, int qn) {
  uint64_t sel = 0;
  int e = 0;
  for (int r = qn; r > 0; --r) {
    for (;;) {
      const int c = binom(W - e - 1, r - 1);
      if (o < c) {
        sel |= 1ull << e;
        ++e;
        break;
      }
      o -= c;
      ++e;
    }
  }
  return sel;
}

struct OptimalArgs {
  int window, k, depth_plus, miner_share;
  bool discount, punish;
};

// quorum.py:253-306; `leaf_score(slot)` the env's vote order.
template <class Score>
__device__ bool q_optimal(const LaneDag& g, QScratch& q, const QFrame& f,
                          uint64_t own_c, const int32_t* depth,
                          Score leaf_score, int qn, const OptimalArgs& a,
                          uint64_t& leaves) {
  __syncwarp();
  for (int i = g.t; i < f.C; i += 32) {
    const bool v = bit(f.cvalid, i);
    q.f[i] = v && i < f.nC ? finite_or0(leaf_score(q.cidx[i])) : -f_inf();
    q.d[i] = v ? (int32_t)cgather(g, q, f, depth, i) : -1;
  }
  __syncwarp();
  const int n_cand = __popcll(f.cvalid);
  const int n_opt = binom(a.window, qn);
  float best = -f_inf();
  int bo = INT32_MAX;
  bool any_valid = false;
  for (int o = g.t; o < n_opt; o += 32) {
    const uint64_t sel = unrank(o, a.window, qn);
    bool valid = (sel & ~f.cvalid) == 0 && n_cand >= qn;
    float dk = -f_inf();
    int deepest = 0;
    int32_t dmax = -1;
    for (int i = 0; i < f.C; ++i) {
      if (!bit(sel, i)) continue;
      if (q.abits[i] & ~sel) valid = false;
      if (q.f[i] > dk) {
        dk = q.f[i];
        deepest = i;
      }
      dmax = max(dmax, q.d[i]);
    }
    const float r = a.discount ? __fdiv_rn((float)(dmax + a.depth_plus),
                                           (float)a.k)
                               : 1.f;
    const uint64_t rewarded = a.punish ? q.abits[deepest] : sel;
    const int cnt = __popcll(rewarded & own_c) + a.miner_share;
    const float score = valid ? __fmul_rn(r, (float)cnt) : -f_inf();
    any_valid |= valid;
    if (score > best || bo == INT32_MAX) {
      best = score;
      bo = o;
    }
  }
  warp_select<true>(best, bo);
  const bool found = __any_sync(kFull, any_valid);
  const uint64_t sel = found ? unrank(bo, a.window, qn) : 0ull;
  uint64_t desc = 0;
  for (int i = 0; i < f.C; ++i)
    if (bit(sel, i)) desc |= q.abits[i] & ~(1ull << i);
  leaves = sel & ~desc;
  return found;
}

// quorum.py:309: the optimal selection unless a valid candidate lies
// beyond its window.
template <class Score>
__device__ __forceinline__ bool q_optimal_or_heuristic(
    const LaneDag& g, QScratch& q, const QFrame& f, uint64_t own_c,
    const int32_t* depth, Score leaf_score, int qn, const OptimalArgs& a,
    uint64_t& leaves) {
  const bool over = a.window < 64 && (f.cvalid >> a.window) != 0ull;
  if (over) return q_heuristic(g, q, f, own_c, qn, leaves);
  return q_optimal(g, q, f, own_c, depth, leaf_score, qn, a, leaves);
}

// The per-slot mask of a set of candidates.
__device__ __forceinline__ Mask cand_mask(const LaneDag& g, const QScratch& q,
                                          uint64_t c) {
  Mask m = 0;
  while (c) {
    const int i = __ffsll((long long)c) - 1;
    c &= c - 1;
    const int s = q.cidx[i];
    if ((s & 31) == g.t) m |= 1u << (s >> 5);
  }
  return m;
}

// quorum.py:343: `width` leaves by `score(slot)` descending, ties to the
// lowest slot, NONE-padded, into row[0, width).
template <class Score>
__device__ void leaves_to_row(const LaneDag& g, const QScratch& q,
                              const QFrame& f, uint64_t leaves, Score score,
                              int width, int32_t* row) {
  const Mask m = cand_mask(g, q, leaves & f.cvalid);
  float sc[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j)
    sc[j] = ((m >> j) & 1u) ? -score(g.slot(j)) : 0.f;
  int32_t idx[kMaxTopK];
  bool valid[kMaxTopK];
  g.top_k(sc, m, width, idx, valid);
  for (int i = 0; i < width; ++i) row[i] = valid[i] ? idx[i] : kNone;
}

struct Release {
  Mask ovr, mat;
  bool found;
  int32_t head;
};

// quorum.py:352-440. `extra` the per-slot tiebreak (nullptr: none);
// `all_flip()` the env's strict preference of the private tip once
// everything is visible, called only when the candidates overflow R.
template <class AllFlip>
__device__ Release prefix_release_sets(const LaneDag& g, QScratch& q,
                                       int32_t pub, int32_t priv, Mask cands,
                                       int R, int block_kind,
                                       const float* extra, AllFlip all_flip) {
  const int t = g.t, W = g.W;
  const int ncand = compact_by_age(g, cands, R, q.pos, q.a);
  const int nR = min(ncand, R);
  const bool overflow = ncand > R;
  // cnt[b]: defender-visible confirming votes of b younger than b
  for (int p = t; p < W; p += 32) q.cnt[p] = 0;
  __syncwarp();
  const Mask conf = g.exists() & g.bools(g.d->vis_d) &
                    g.where(g.d->signer, [](int32_t v) { return v >= 0; });
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (!((conf >> j) & 1u)) continue;
    const int s = g.slot(j);
    const int32_t b = g.d->signer[g.o(s)];
    if (b < W && g.d->gid[g.o(s)] > g.at(g.d->gid, b)) atomicAdd(&q.cnt[b], 1);
  }
  __syncwarp();
  // per position j = 4t + u: block, signer of candidate votes
  int32_t lb[4], hl[4];
  bool cv_pub[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int jp = 4 * t + u;
    const bool rv = jp < nR;
    const int32_t rs = rv ? q.pos[jp] : 0;
    lb[u] = rv ? last_of_kind(g, rs, block_kind) : 0;
    hl[u] = rv ? g.at(g.d->height, rs) : 0;
    const int32_t cs = rv ? g.at(g.d->signer, rs) : kNone;
    cv_pub[u] = rv && cs >= 0 && cs == pub;
    if (jp < R) q.a[jp] = rv && cs >= 0 ? cs : -2;
  }
  __syncwarp();
  // npub: an inclusive prefix count over positions
  int c = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) c += cv_pub[u];
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (t >= off) incl += v;
  }
  int run = incl - c;
  const int pub_vis = q.cnt[pub];
  const int32_t h_pub = g.at(g.d->height, pub);
  const float e_pub = extra != nullptr ? g.at(extra, pub < 0 ? 0 : pub) : 0.f;
  int first = INT32_MAX;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int jp = 4 * t + u;
    run += cv_pub[u];
    if (jp >= nR || lb[u] == pub) continue;
    bool flip = hl[u] > h_pub;
    if (!flip && hl[u] == h_pub) {
      int nconf = lb[u] >= 0 && lb[u] < W ? q.cnt[lb[u]] : 0;
      for (int i = 0; i <= jp; ++i) nconf += q.a[i] == lb[u];
      const int npub = pub_vis + run;
      flip = nconf > npub;
      if (!flip && extra != nullptr && nconf == npub) {
        const float e_lb =
            lb[u] >= 0 ? finite_or0(g.at(extra, lb[u])) : 0.f;
        flip = e_lb > e_pub;
      }
    }
    if (flip && jp < first) first = jp;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(kFull, first, off));
  Release out;
  const bool any_flip = first != INT32_MAX;
  out.found = any_flip && !overflow;
  if (overflow) {
    out.ovr = out.mat = cands;
    const bool af = all_flip();
    out.found = af;
    out.head = af ? priv : pub;
    return out;
  }
  // positions -> slots: 1 override, 2 match
  __syncwarp();
  for (int p = t; p < W; p += 32) q.cnt[p] = 0;
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int jp = 4 * t + u;
    if (jp >= nR) continue;
    const bool o = !out.found || jp <= first;
    const bool m = !out.found || jp < first;
    q.cnt[q.pos[jp]] = (o ? 1 : 0) | (m ? 2 : 0);
  }
  __syncwarp();
  Mask ovr = 0, mat = 0;
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (!g.in(j)) continue;
    const int v = q.cnt[g.slot(j)];
    if (v & 1) ovr |= 1u << j;
    if (v & 2) mat |= 1u << j;
  }
  __syncwarp();
  out.ovr = ovr;
  out.mat = mat;
  if (out.found) {
    // the block at j_stop, broadcast from its owner
    const int owner = first >> 2;
    int32_t l = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * t + u == first) l = lb[u];
    out.head = __shfl_sync(kFull, l, owner);
  } else {
    out.head = pub;
  }
  return out;
}

// quorum.py:443-471 (the plane branch): `stale` after an Adopt to `pub`.
__device__ __forceinline__ Mask stale_after_adopt(const LaneDag& g, int32_t pub,
                                                  Mask stale) {
  const Mask withheld = ~g.bools(g.d->vis_d) & g.exists() & ~stale;
  return stale | (withheld & ~g.descendants(pub));
}

}  // namespace cpr
