// The netsim's discrete-event engine as device functions, shared by
// K12-event (netsim_event.cu, the honest network running Nakamoto), its
// Bk, Ethereum and Spar branches K12-event-bk, K12-event-eth and
// K12-event-spar (netsim_event_{bk,eth,spar}.cu) and K13
// (netsim_attack.cu, an attacker at node 0).
//
// Replaces: cpr_tpu/netsim/engine.py:92-713 (`_lane_fn`: init, the step
// body, finalize, every protocol) and attack.py:116-408
// (`_attack_lane_fn`). Plain twins: cpr_tpu_torch/netsim/engine.py
// `EventLedger`, `event_plain`; attack.py `attack_plain`.
//
// One step of a lane: split the carry key (5 ways; 4 for K13); under Bk a
// proposal when some node wants to propose (no time advance); else an
// activation when the next one is due no later than the earliest queue
// entry, else a delivery wave: every queue entry at (earliest time, b),
// b the block of the lowest-sequenced such entry. A first arrival whose
// parent is not visible parks in the node's pending buffer; a delivery
// re-queues the node's parked children whose parent it made visible, at
// the delivering time; flooding re-shares on first delivery. After the
// last activation deliveries run only while they precede the next
// (never executed) activation. New queue entries (the re-queues, then
// the link sends, source-major) take sequence numbers in that order and
// the free slots in index order; what does not fit is dropped and
// counted.
//
// The protocols (kProto): Nakamoto mints a child of the miner's
// preference and prefers by height. Ethereum prefers by height
// (Byzantium) or work (whitepaper), strictly, and a mint takes up to U
// uncles: blocks visible to the miner in a W-slot window from its
// deepest 6-generation ancestor, children of those ancestors and not in
// the chain set, own first, then the lower preference key, then the
// lower slot. Bk mints votes on the preference; a node proposes on its
// preferred block once it sees k confirming votes, one its own, and its
// best own hash below the best visible replacement's; the lowest such
// node proposes, its quorum the k smallest own hashes padded with others'
// votes of larger hash in ledger order, searched in the W slots after the
// block; a failed search marks (node, block) until the node's next vote
// there. Spar mints a block on the preference when the miner sees k - 1
// confirming votes (the quorum own votes first, each group in ledger
// order), else a vote. Bk and Spar prefer the chain block (a vote's
// parent) by height, then visible confirming votes, then (Bk) the lower
// leader hash. A search whose window no longer holds every counted vote,
// an uncle scan that cannot see the whole range or (whitepaper) more
// than U candidates counts in `win_miss`.
//
// Design: one warp per lane, node n on thread n (N <= 32). The queue
// (time, block << 5 | node, sequence) and the pending buffers live in
// the warp's shared memory, the queue scanned M / 32 entries a thread
// with warp reductions for the earliest time and lowest sequence; the
// protocols' window scans compact their candidates into shared scratch
// with ballots and take the smallest by warp reductions, one a round.
// The ledger lives in global memory per lane: parent, height and miner
// [B] int32, and the nodes' visible and known bits as one 32-bit mask
// per block; the protocol's per-block fields [B] and per-(block, node)
// tallies [B, N] (node t reads its own column of a block's row), Bk's
// failed-proposal marks as one mask per block. A block's protocol row is
// written when it is appended, so no plane needs clearing. The JAX
// package's per-node arrival times (`vis_at`) are written and never read
// there, so the port carries none. The attacker's withheld blocks are a
// FIFO of block ids (K13): they are always a suffix of the private chain,
// so the lowest withheld id is the lowest height, and a release pops the
// front.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "nakamoto_policy.cuh"
#include "netsim.cuh"

namespace cpr {
namespace netsim {

enum : int { kNak = 0, kBk = 1, kEth = 2, kSpar = 3 };

// Per-lane global planes ([lanes, B] each) and sizes.
struct Ledger {
  int32_t* parent;
  int32_t* height;
  int32_t* miner;
  uint32_t* vis;    // bit n: visible at node n
  uint32_t* known;  // bit n: known (arrived) at node n
  int32_t* wq;      // K13: withheld FIFO
  int32_t B, M, F, S, A, WA;
};

// The Bk, Ethereum and Spar branches' per-lane planes (null where the
// protocol has none; [lanes, B], [lanes, B, n], [lanes, B, qw] or
// [lanes, B, U]), two per-lane outputs and the sizes.
struct Proto {
  int32_t* is_vote;   // Bk, Spar: the block is a vote
  int32_t* nvotes;    // Bk, Spar: votes appended on the block
  float* powh;        // Bk: a vote's hash (2 for the rest)
  float* lhash;       // Bk: a proposal's leader hash (2 for the rest)
  int32_t* conf;      // Bk, Spar [B, n]: confirming votes visible at n
  int32_t* conf_own;  // Bk, Spar [B, n]: node n's own votes on the block
  float* mybest;      // Bk [B, n]: node n's best own vote hash
  float* repl;        // Bk [B, n]: the best replacement visible at n
  uint32_t* noprop;   // Bk: bit n, node n's proposal search failed
  int32_t* quorum;    // Bk, Spar [B, qw]: a block's quorum (-1 padded)
  int32_t* work;      // Ethereum: cumulative work
  int32_t* uncles;    // Ethereum [B, U] (-1 padded)
  double* progress;   // [lanes] out
  double* on_chain;   // [lanes] out
  int32_t k, qw, W, U, byz, block_scheme;
};

struct LaneIn {
  const uint2* keys;         // [lanes]
  const double* delays;      // [lanes]
  const int32_t* policy;     // K13: [lanes] scripted policy ids
  int64_t n_lanes;
  int32_t strict_match;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Inclusive warp prefix sum.
__device__ __forceinline__ int warp_scan(int v) {
  const int t = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (t >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <class T>
__device__ __forceinline__ void advance(T*& p, int64_t n) {
  if (p) p += n;
}

// Entries of each scratch array (a window's compacted candidates, the
// first votes of each kind, a stored row).
__host__ __device__ inline int scratch_len(const Proto& p) {
  int n = p.W > p.qw ? p.W : p.qw;
  return n > p.U ? n : p.U;
}

template <bool kAttack, int kProto = kNak>
struct EventLane {
  // shared memory of this warp
  double* qt;
  int32_t* qbd;  // block << 5 | destination node
  int32_t* qs;
  int32_t* fl;   // free slots in index order, built per push
  int32_t* pend; // [32, F]
  float* sk;     // scratch: compacted keys
  int32_t* si;   // scratch: compacted block ids
  int32_t* sc;   // scratch: a row being built
  int32_t* sx;   // scratch: the first candidates of a second kind
  int32_t* inch; // scratch: Ethereum's chain set [7 + 6U]
  Ledger g;      // this lane's rows
  Proto p;
  Planes pl;
  const float* logw;
  int t, N;
  double ad;
  uint2 key;
  double now = 0.0, next_act = 0.0, tmin = INFINITY;
  int n_act = 0, nb = 1, seq = 0, steps = 0;
  int drop_q = 0, drop_p = 0, drop_b = 0;
  bool live = true;
  int pref = 0, node_act = 0;  // node t's
  unsigned want = 0;           // Bk: the nodes that would propose
  // K13
  int priv = 0, pub = 0, rel_h = -1, win_miss = 0, wq_head = 0,
      wq_tail = 0, pid = 0;
  bool strict = true;

  __device__ void init(uint2 lane_key) {
    const int kq = (g.M + 31) / 32;
    for (int j = 0; j < kq; ++j) {
      const int e = j * 32 + t;
      if (e < g.M) qt[e] = INFINITY;
    }
    for (int f = 0; f < g.F; ++f) pend[t * g.F + f] = -1;
    if (t == 0) {
      g.parent[0] = -1;
      g.height[0] = 0;
      g.miner[0] = -1;
      g.vis[0] = kFull;
      g.known[0] = kFull;
    }
    proto_row(0, false, 2.0f, 2.0f);
    if (kProto == kEth) {
      if (t == 0) p.work[0] = 0;
      for (int i = t; i < p.U; i += 32) p.uncles[i] = -1;
    }
    uint2 ks[2];
    split_n(lane_key, 2, ks);
    key = ks[0];
    next_act = __dmul_rn(exponential64(ks[1], 0), ad);
    __syncwarp();
  }

  // A new block's protocol row: Bk/Spar vote flag, vote count, tallies
  // and an empty quorum; Bk's hashes and marks.
  __device__ void proto_row(int id, bool vote, float ph, float lh) {
    if (kProto == kBk || kProto == kSpar) {
      if (t < N) {
        p.conf[id * N + t] = 0;
        p.conf_own[id * N + t] = 0;
      }
      if (t == 0) {
        p.is_vote[id] = vote;
        p.nvotes[id] = 0;
      }
      for (int i = t; i < p.qw; i += 32) p.quorum[id * p.qw + i] = -1;
    }
    if (kProto == kBk) {
      if (t < N) {
        p.mybest[id * N + t] = 2.0f;
        p.repl[id * N + t] = 2.0f;
      }
      if (t == 0) {
        p.powh[id] = ph;
        p.lhash[id] = lh;
        p.noprop[id] = 0u;
      }
    }
  }

  __device__ double queue_min() const {
    double v = INFINITY;
    for (int e = t; e < g.M; e += 32) v = fmin(v, qt[e]);
    return warp_min(v);
  }

  // The wave at tmin: pops it and returns its block and the nodes it
  // reaches (a mask).
  __device__ void pop_wave(int& b, unsigned& dmask) {
    int s_best = 0x7FFFFFFF, b_best = 0;
    for (int e = t; e < g.M; e += 32)
      if (qt[e] == tmin && qs[e] < s_best) {
        s_best = qs[e];
        b_best = qbd[e] >> 5;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const int s2 = __shfl_xor_sync(kFull, s_best, o);
      const int b2 = __shfl_xor_sync(kFull, b_best, o);
      if (s2 < s_best) {
        s_best = s2;
        b_best = b2;
      }
    }
    b = b_best;
    unsigned mask = 0;
    for (int e = t; e < g.M; e += 32)
      if (qt[e] == tmin && (qbd[e] >> 5) == b) {
        mask |= 1u << (qbd[e] & 31);
        qt[e] = INFINITY;
      }
    dmask = __reduce_or_sync(kFull, mask);
  }

  // Delivery of block b to the nodes in dmask at tmin: known/vis bits,
  // parking, preference. Returns whether node t delivered (`deliver`).
  __device__ bool deliver_wave(int b, unsigned dmask) {
    const bool dm = (dmask >> t) & 1u;
    const int pb = g.parent[b];
    const bool pv = pb < 0 || ((g.vis[pb] >> t) & 1u);
    const uint32_t vis_b = g.vis[b], known_b = g.known[b];
    const bool deliver = dm && !((vis_b >> t) & 1u) && pv;
    const bool blocked = dm && !((known_b >> t) & 1u) && !pv;
    const unsigned dl = __ballot_sync(kFull, deliver);
    __syncwarp();
    if (t == 0) {
      g.known[b] = known_b | dmask;
      g.vis[b] = vis_b | dl;
    }
    int* mine = pend + t * g.F;
    int slot = -1;
    for (int f = 0; f < g.F && slot < 0; ++f)
      if (mine[f] < 0) slot = f;
    if (blocked && slot >= 0) mine[slot] = b;
    drop_p += __popc(__ballot_sync(kFull, blocked && slot < 0));
    prefer(b, pb, deliver);
    __syncwarp();
    return deliver;
  }

  // Node t's preference after block b (parent pb) reached it
  // (engine.py:245-286); Bk and Spar tally a delivered vote first, and Bk
  // clears the voters' failed marks and lowers the replacement floor by a
  // delivered proposal's hash.
  __device__ void prefer(int b, int pb, bool deliver) {
    if (kProto == kNak) {
      if (deliver && g.height[b] > g.height[pref]) pref = b;
    } else if (kProto == kEth) {
      const int32_t* key_of = p.byz ? g.height : p.work;
      if (deliver && key_of[b] > key_of[pref]) pref = b;
    } else {
      const int pbc = pb > 0 ? pb : 0;
      const bool is_v = p.is_vote[b] != 0;
      if (deliver && is_v) p.conf[pbc * N + t] += 1;
      if (kProto == kBk) {
        const unsigned dv = __ballot_sync(kFull, deliver && is_v);
        if (t == 0 && dv) p.noprop[pbc] &= ~dv;
        if (deliver && !is_v) {
          const int e = pbc * N + t;
          p.repl[e] = fminf(p.repl[e], p.lhash[b]);
        }
      }
      if (deliver) {
        const int bb = is_v ? pbc : b;
        const int hb = g.height[bb], hp = g.height[pref];
        const int cb = p.conf[bb * N + t], cp = p.conf[pref * N + t];
        bool tie = cb > cp;
        if (kProto == kBk)
          tie = tie || (cb == cp && p.lhash[bb] < p.lhash[pref]);
        if (hb > hp || (hb == hp && tie)) pref = bb;
      }
    }
  }

  // Bk: the nodes whose preferred block has k visible confirming votes,
  // one of them their own, their best own hash below the best visible
  // replacement's, and no failed search since their last vote there.
  __device__ unsigned bk_want() const {
    bool w = false;
    if (t < N) {
      const int e = pref * N + t;
      w = p.conf[e] >= p.k && p.conf_own[e] >= 1 && p.mybest[e] < p.repl[e] &&
          !((p.noprop[pref] >> t) & 1u);
    }
    return __ballot_sync(kFull, w);
  }

  // The r smallest of the n compacted (sk, si), by key then block id (a
  // stable sort of the window), into dst[0, r).
  __device__ void select_smallest(int n, int r, int32_t* dst) {
    float lk = -INFINITY;
    int li = -1;
    for (int s = 0; s < r; ++s) {
      float bk = INFINITY;
      int bi = 0x7FFFFFFF;
      for (int e = t; e < n; e += 32) {
        const float kk = sk[e];
        const int ii = si[e];
        const bool after = kk > lk || (kk == lk && ii > li);
        if (after && (kk < bk || (kk == bk && ii < bi))) {
          bk = kk;
          bi = ii;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float k2 = __shfl_xor_sync(kFull, bk, o);
        const int i2 = __shfl_xor_sync(kFull, bi, o);
        if (k2 < bk || (k2 == bk && i2 < bi)) {
          bk = k2;
          bi = i2;
        }
      }
      if (t == 0) dst[s] = bi;
      lk = bk;
      li = bi;
    }
    __syncwarp();
  }

  // Block id's ledger row (its protocol row apart).
  __device__ void append_at(int id, int parent, int height, int src) {
    if (t == 0) {
      g.parent[id] = parent;
      g.height[id] = height;
      g.miner[id] = src;
      g.vis[id] = 1u << src;
      g.known[id] = 1u << src;
    }
  }

  // Ethereum's uncles for a mint by m on tip (engine.py:311-366) into
  // sc[0, U) (-1 padded); returns their count, `miss` the window miss.
  __device__ int eth_uncles(int m, int tip, bool& miss) {
    const int B = g.B, W = p.W, U = p.U;
    const int n_in = 7 + 6 * U;
    if (t == 0) {
      int cur = tip;
      inch[0] = tip;
      for (int i = 1; i < 7; ++i) {
        cur = cur > 0 ? g.parent[cur] : -1;
        inch[i] = cur;
      }
    }
    __syncwarp();
    for (int i = t; i < 6 * U; i += 32) {
      const int wb = inch[i / U];
      inch[7 + i] = p.uncles[(wb > 0 ? wb : 0) * U + i % U];
    }
    int lo = B;
    for (int i = 1; i < 7; ++i) {
      const int a = inch[i];
      if (a >= 0 && a < lo) lo = a;
    }
    const int start = clampi(lo < nb ? lo : nb, 0, B - W > 0 ? B - W : 0);
    __syncwarp();
    const int32_t* key_of = p.byz ? g.height : p.work;
    int n_cand = 0;
    for (int j = 0; j < W; j += 32) {
      const int w = start + j + t;
      bool cand = false;
      float kk = 0.0f;
      if (j + t < W && w < nb) {
        const int ep = g.parent[w];
        bool pa = false;
        for (int i = 1; i < 7; ++i) pa = pa || (inch[i] >= 0 && ep == inch[i]);
        if (pa && ((g.vis[w] >> m) & 1u)) {
          bool in = false;
          for (int i = 0; i < n_in; ++i) in = in || inch[i] == w;
          cand = !in;
          kk = __fadd_rn(g.miner[w] == m ? 0.0f : 1e6f, (float)key_of[w]);
        }
      }
      const unsigned cb = __ballot_sync(kFull, cand);
      if (cand) {
        const int r = n_cand + __popc(cb & lanemask_lt());
        sk[r] = kk;
        si[r] = w;
      }
      n_cand += __popc(cb);
    }
    __syncwarp();
    const int n_unc = n_cand < U ? n_cand : U;
    select_smallest(n_cand, n_unc, sc);
    for (int i = n_unc + t; i < U; i += 32) sc[i] = -1;
    __syncwarp();
    miss = nb > start + W || (!p.byz && n_cand > U);
    return n_unc;
  }

  // Spar's draft for a mint by m on pj (engine.py:368-407): whether it is
  // a block, and then its quorum into sc[0, qw) (-1 padded).
  __device__ bool spar_draft(int m, int pj) {
    const int B = g.B, W = p.W, kq = p.k - 1;
    const int e = pj * N + m;
    const int conf = p.conf[e], own = p.conf_own[e];
    const bool can_block = conf >= kq;
    const int start = clampi(pj + 1, 0, B - W > 0 ? B - W : 0);
    int n_mine = 0, n_their = 0;
    for (int j = 0; j < W; j += 32) {
      const int w = start + j + t;
      bool on = false, mine = false;
      if (j + t < W && w < nb) {
        on = g.parent[w] == pj && p.is_vote[w] && ((g.vis[w] >> m) & 1u);
        mine = on && g.miner[w] == m;
      }
      const unsigned lt = lanemask_lt();
      const unsigned mb = __ballot_sync(kFull, mine);
      const unsigned tb = __ballot_sync(kFull, on && !mine);
      if (mine) {
        const int r = n_mine + __popc(mb & lt);
        if (r < kq) si[r] = w;
      }
      if (on && !mine) {
        const int r = n_their + __popc(tb & lt);
        if (r < kq) sx[r] = w;
      }
      n_mine += __popc(mb);
      n_their += __popc(tb);
    }
    __syncwarp();
    if (can_block && !(n_mine == own && n_their == conf - own)) ++win_miss;
    const int take = n_mine < kq ? n_mine : kq;
    const int n_th = n_their < kq ? n_their : kq;
    // a quorum slot the window cannot fill takes the window's first slot,
    // as the JAX package's rank scatter reads its zero there
    for (int i = t; i < p.qw; i += 32) {
      int v = -1;
      if (i < kq)
        v = i < take ? si[i] : (i - take < n_th ? sx[i - take] : start);
      sc[i] = v;
    }
    __syncwarp();
    return can_block;
  }

  // Bk's proposal step (engine.py:409-458, :460-509): the lowest node
  // that wants proposes on its preferred block, or marks it failed.
  __device__ void propose(unsigned& send, int& s_blk) {
    const int js = __ffs(want) - 1;
    const int pjs = __shfl_sync(kFull, pref, js);
    const int B = g.B, W = p.W, k = p.k;
    const int start = clampi(pjs + 1, 0, B - W > 0 ? B - W : 0);
    const int ce = pjs * N + js;
    const float mb = p.mybest[ce];
    int n_mine = 0, n_their = 0, n_cand = 0;
    for (int j = 0; j < W; j += 32) {
      const int w = start + j + t;
      bool on = false, mine = false, cand = false;
      float ph = 0.0f;
      if (j + t < W && w < nb) {
        on = g.parent[w] == pjs && p.is_vote[w] && ((g.vis[w] >> js) & 1u);
        if (on) {
          mine = g.miner[w] == js;
          ph = p.powh[w];
          cand = !mine && ph > mb;
        }
      }
      const unsigned lt = lanemask_lt();
      const unsigned mbal = __ballot_sync(kFull, mine);
      const unsigned cbal = __ballot_sync(kFull, cand);
      if (mine) {
        const int r = n_mine + __popc(mbal & lt);
        sk[r] = ph;
        si[r] = w;
      }
      if (cand) {
        const int r = n_cand + __popc(cbal & lt);
        if (r < k) sx[r] = w;
      }
      n_mine += __popc(mbal);
      n_cand += __popc(cbal);
      n_their += __popc(__ballot_sync(kFull, on && !mine));
    }
    __syncwarp();
    if (!(n_mine == p.conf_own[ce] && n_their == p.conf[ce] - p.conf_own[ce]))
      ++win_miss;
    const bool feasible = n_mine >= k || n_mine + n_cand >= k;
    const int id = nb;
    if (!feasible || id >= B) {
      if (t == 0) p.noprop[pjs] |= 1u << js;
      __syncwarp();
      return;
    }
    const int take = n_mine < k ? n_mine : k;
    select_smallest(n_mine, take, sc);
    const int n_c = n_cand < k ? n_cand : k;
    for (int i = take + t; i < k; i += 32)
      sc[i] = i - take < n_c ? sx[i - take] : start;
    __syncwarp();
    append_at(id, pjs, g.height[pjs] + 1, js);
    proto_row(id, false, 2.0f, mb);
    __syncwarp();
    for (int i = t; i < k; i += 32) p.quorum[id * p.qw + i] = sc[i];
    if (t == 0) p.repl[ce] = fminf(p.repl[ce], mb);
    if (t == js) pref = id;
    ++nb;
    send = 1u << js;
    s_blk = id;
    __syncwarp();
  }

  // A mint by m on `parent` under Bk, Ethereum or Spar.
  __device__ void mint(int m, int parent, uint2 k_pow, unsigned& send,
                       int& s_blk) {
    const int id = nb;
    if (kProto == kBk) {
      const float ph = uniform_of_bits(random_bits(k_pow, 0));
      if (id >= g.B) {
        ++drop_b;
        return;
      }
      append_at(id, parent, g.height[parent], m);
      proto_row(id, true, ph, 2.0f);
      __syncwarp();
      if (t == 0) {
        const int e = parent * N + m;
        p.conf[e] += 1;
        p.conf_own[e] += 1;
        p.mybest[e] = fminf(p.mybest[e], ph);
        p.noprop[parent] &= ~(1u << m);
        p.nvotes[parent] += 1;
      }
    } else if (kProto == kEth) {
      bool miss;
      const int n_unc = eth_uncles(m, parent, miss);
      if (miss) ++win_miss;
      if (id >= g.B) {
        ++drop_b;
        return;
      }
      append_at(id, parent, g.height[parent] + 1, m);
      if (t == 0) p.work[id] = p.work[parent] + 1 + n_unc;
      for (int i = t; i < p.U; i += 32) p.uncles[id * p.U + i] = sc[i];
      if (t == m) pref = id;
    } else {
      const bool block = spar_draft(m, parent);
      if (id >= g.B) {
        ++drop_b;
        return;
      }
      append_at(id, parent, g.height[parent] + (block ? 1 : 0), m);
      proto_row(id, !block, 2.0f, 2.0f);
      __syncwarp();
      if (block) {
        for (int i = t; i < p.qw; i += 32) p.quorum[id * p.qw + i] = sc[i];
        if (t == m) pref = id;
      } else if (t == 0) {
        const int e = parent * N + m;
        p.conf[e] += 1;
        p.conf_own[e] += 1;
        p.nvotes[parent] += 1;
      }
    }
    ++nb;
    send = 1u << m;
    s_blk = id;
    __syncwarp();
  }

  // The queue slots of `n_new` candidates: builds the free list and
  // returns how many fit.
  __device__ int free_slots(int n_new) {
    int base = 0;
    for (int j = 0; j * 32 < g.M && base < n_new; ++j) {
      const int e = j * 32 + t;
      const bool free = e < g.M && !isfinite(qt[e]);
      const unsigned fb = __ballot_sync(kFull, free);
      if (free) {
        const int r = base + __popc(fb & lanemask_lt());
        if (r < n_new) fl[r] = e;
      }
      base += __popc(fb);
    }
    __syncwarp();
    return base < n_new ? base : n_new;
  }

  __device__ void put(int rank, int n_place, double time, int blk, int dst) {
    if (rank < n_place) {
      const int e = fl[rank];
      qt[e] = time;
      qbd[e] = (blk << 5) | dst;
      qs[e] = seq + rank + 1;
    }
  }

  // Push: node t's parked children unlocked by its delivery (when
  // `deliver`), re-queued at now2, then block s_blk down the links of
  // every node in `send` at now2 + the link's delay.
  __device__ void push(bool deliver, unsigned send, int s_blk, double now2,
                       uint2 k_delay) {
    int* mine = pend + t * g.F;
    int n_unl = 0;
    if (deliver)
      for (int f = 0; f < g.F; ++f) {
        const int c = mine[f];
        if (c >= 0) {
          const int par = g.parent[c];
          if (par < 0 || ((g.vis[par] >> t) & 1u)) ++n_unl;
        }
      }
    const int unl_end = warp_scan(n_unl);
    const int n_unl_all = __shfl_sync(kFull, unl_end, 31);
    int n_send = 0;
    for (unsigned s = send; s; s &= s - 1) {
      const int src = __ffs(s) - 1;
      n_send += __popc(__ballot_sync(
          kFull, t < N && pl.kind[src * N + t] >= 0));
    }
    const int n_valid = n_unl_all + n_send;
    if (n_valid == 0) return;
    const int n_place = free_slots(n_valid);
    int rank = unl_end - n_unl;
    if (deliver)
      for (int f = 0; f < g.F; ++f) {
        const int c = mine[f];
        if (c >= 0) {
          const int par = g.parent[c];
          if (par < 0 || ((g.vis[par] >> t) & 1u)) {
            put(rank++, n_place, now2, c, t);
            mine[f] = -1;
          }
        }
      }
    if (send) {
      const uint2 k_u = split_key(k_delay, 0), k_e = split_key(k_delay, 1);
      rank = n_unl_all;
      for (unsigned s = send; s; s &= s - 1) {
        const int src = __ffs(s) - 1;
        const int e = src * N + t;
        const bool linked = t < N && pl.kind[e] >= 0;
        const unsigned lb = __ballot_sync(kFull, linked);
        if (linked)
          put(rank + __popc(lb & lanemask_lt()), n_place,
              __dadd_rn(now2, link_delay(pl, e, k_u, k_e, (uint32_t)e)),
              s_blk, t);
        rank += __popc(lb);
      }
    }
    seq += n_valid;
    drop_q += n_valid - n_place;
    __syncwarp();
  }

  // Appends block nb (parent, miner m) where there is room.
  __device__ bool append(int parent, int m) {
    if (nb >= g.B) {
      ++drop_b;
      return false;
    }
    append_at(nb, parent, g.height[parent] + 1, m);
    __syncwarp();
    return true;
  }

  // One engine step (engine.py:189-597; attack.py:151-357).
  __device__ void step() {
    uint2 ks[5];
    split_n(key, kAttack ? 4 : 5, ks);
    const uint2 k_mine = ks[1];
    const uint2 k_pow = ks[2];
    const uint2 k_next = kAttack ? ks[2] : ks[3];
    const uint2 k_delay = kAttack ? ks[3] : ks[4];
    const bool can_act = n_act < g.A;
    const bool has_q = isfinite(tmin);
    bool is_rel = false;
    int rb = 0;
    if (kAttack && wq_head < wq_tail) {
      rb = g.wq[wq_head];
      is_rel = g.height[rb] <= rel_h;
    }
    const bool is_prop = kProto == kBk && want != 0u;
    const bool act_now = can_act && next_act <= tmin;
    const bool recv_ok = has_q && !(!can_act && tmin >= next_act);
    const bool is_act = !is_rel && !is_prop && act_now;
    const bool is_recv = !is_rel && !is_prop && !act_now && recv_ok;
    const double now2 = is_act ? next_act : (is_recv ? tmin : now);

    bool deliver = false;
    int b = 0;
    if (is_recv) {
      unsigned dmask;
      pop_wave(b, dmask);
      deliver = deliver_wave(b, dmask);
    }
    unsigned send = 0;
    int s_blk = 0;
    if (is_recv) {
      s_blk = b;
      if (flooding) {
        const int mb = g.miner[b];
        send = __ballot_sync(kFull, deliver && mb != t);
      }
    }
    if (kAttack) {
      if (is_recv) {
        const bool d0 = __shfl_sync(kFull, deliver, 0);
        if (d0 && g.height[b] > g.height[pub]) {
          pub = b;
          handle(kEvNetwork);
        }
      }
      if (is_rel) {
        ++wq_head;
        if (wq_head == wq_tail || g.height[g.wq[wq_head]] > rel_h) rel_h = -1;
        if (g.height[rb] > g.height[pub]) pub = rb;
        send = 1u;
        s_blk = rb;
      }
    }
    if (is_prop) propose(send, s_blk);
    if (is_act) {
      const float* lw = logw;
      const int m = draw_miner(k_mine, 0, lw, N);
      next_act = __dadd_rn(next_act, __dmul_rn(exponential64(k_next, 0), ad));
      ++n_act;
      if (t == m) ++node_act;
      const bool atk = kAttack && m == 0;
      const int parent = atk ? priv : __shfl_sync(kFull, pref, m);
      if (kProto != kNak) {
        mint(m, parent, k_pow, send, s_blk);
      } else {
        const int id = nb;
        if (append(parent, m)) {
          ++nb;
          if (atk) {
            priv = id;
            if (t == 0) g.wq[wq_tail] = id;
            ++wq_tail;
            __syncwarp();
            handle(kEvPow);
          } else {
            if (t == m) pref = id;
            send = 1u << m;
            s_blk = id;
          }
        }
      }
    }
    push(deliver, send, s_blk, now2, k_delay);
    key = ks[0];
    now = now2;
    ++steps;
    tmin = queue_min();
    bool rel_pending = false;
    if (kAttack && wq_head < wq_tail)
      rel_pending = g.height[g.wq[wq_head]] <= rel_h;
    if (kProto == kBk) {
      __syncwarp();
      want = bk_want();
    }
    live = (kProto == kBk && want != 0u) || rel_pending || n_act < g.A ||
           (tmin < next_act && isfinite(tmin));
  }

  // K13's SSZ handle after an own mint or a public-view advance: the
  // common ancestor, the observation's (a, h), the policy, and its effect
  // (attack.py:257-299).
  __device__ void handle(int ev) {
    int x = priv, y = pub, i = 0;
    while (x != y && i < g.WA) {
      const int hx = g.height[x], hy = g.height[y];
      const int px = g.parent[x], py = g.parent[y];
      if (hx >= hy) x = px > 0 ? px : 0;
      if (hy >= hx) y = py > 0 ? py : 0;
      ++i;
    }
    if (x != y) ++win_miss;
    const int h_ca = g.height[x];
    const int a = g.height[priv] - h_ca;
    const int h = g.height[pub] - h_ca;
    const int action = policy(pid, a, h);
    const bool match_ok = !strict || ev == kEvNetwork;
    if (action == kAdopt) {
      priv = pub;
      wq_head = wq_tail;
    } else if (action == kOverride && a > h) {
      rel_h = g.height[pub] + 1;
    } else if (action == kMatch && a >= h && h > 0 && match_ok) {
      rel_h = g.height[pub];
    }
  }

  // The winner and the reward walk under Bk, Ethereum or Spar
  // (engine.py:599-704): Bk and Spar score a preferred block by
  // h * (A + 1) + its votes in float64, Ethereum by its preference key,
  // the first maximum wins; node t's float32 reward (every amount is
  // dyadic, so the sum is exact in any order) and the lane's progress
  // and on_chain.
  __device__ void finalize(const Out& out, int64_t lane) {
    double sc_t = -INFINITY;
    int j = t < N ? t : 32;
    const int32_t* key_of = p.byz ? g.height : p.work;
    if (t < N) {
      if (kProto == kEth)
        sc_t = (double)key_of[pref];
      else
        sc_t = __dadd_rn(__dmul_rn((double)g.height[pref], (double)g.A + 1.0),
                         (double)p.nvotes[pref]);
    }
    warp_argmax(sc_t, j);
    const int head = __shfl_sync(kFull, pref, j);
    const int hh = g.height[head];
    const int walk = kProto == kEth ? g.A + 2 : g.A / (p.k > 1 ? p.k : 1) + 3;
    float rew = 0.0f;
    int onc = 0;
    int cur = head;
    for (int s = 0; s < walk && cur > 0; ++s) {
      const int mn = g.miner[cur];
      if (kProto == kEth) {
        const int32_t* urow = p.uncles + (int64_t)cur * p.U;
        int nu = 0;
        for (int i = 0; i < p.U; ++i) nu += urow[i] >= 0 ? 1 : 0;
        if (t == mn)
          rew = __fadd_rn(rew, __fadd_rn(1.0f, __fmul_rn((float)nu, 0.03125f)));
        for (int i = 0; i < p.U; ++i) {
          const int u = urow[i];
          if (u >= 0 && g.miner[u] == t)
            rew = __fadd_rn(
                rew, p.byz ? __fdiv_rn(__fsub_rn(8.0f, (float)(g.height[cur] -
                                                                 g.height[u])),
                                       8.0f)
                           : 0.9375f);
        }
        onc += 1 + nu;
      } else if (p.block_scheme) {
        if (t == mn) rew = __fadd_rn(rew, (float)p.k);
      } else {
        if (kProto == kSpar && t == mn) rew = __fadd_rn(rew, 1.0f);
        const int32_t* q = p.quorum + (int64_t)cur * p.qw;
        for (int i = 0; i < p.qw; ++i)
          if (q[i] >= 0 && g.miner[q[i]] == t) rew = __fadd_rn(rew, 1.0f);
      }
      cur = g.parent[cur];
    }
    if (t < N) {
      out.node_act[lane * N + t] = node_act;
      out.reward[lane * N + t] = rew;
    }
    if (t == 0) {
      out.head[lane] = head;
      out.head_height[lane] = hh;
      if (kProto == kEth) {
        p.progress[lane] = (double)(p.byz ? p.work[head] : hh);
        p.on_chain[lane] = (double)onc;
      } else {
        p.progress[lane] = (double)hh * p.k;
        p.on_chain[lane] = (double)hh * (kProto == kBk ? p.k + 1 : p.k);
      }
    }
  }

  bool flooding = false;
};

// Dynamic shared memory of one warp (one block) for queue capacity M,
// pending capacity F and (protocols but Nakamoto) the scratch.
__host__ __device__ inline size_t event_smem(int M, int F) {
  return (size_t)M * (sizeof(double) + 3 * sizeof(int32_t)) +
         (size_t)32 * F * sizeof(int32_t);
}

__host__ __device__ inline size_t proto_smem(const Proto& p) {
  return ((size_t)4 * scratch_len(p) + 7 + 6 * (size_t)p.U) * sizeof(int32_t);
}

// One warp (one block) a lane: init, steps while live and under S, then
// the winner and the reward walk.
template <bool kAttack, int kProto>
__global__ void __launch_bounds__(32)
event_kernel(LaneIn in, Ledger led, Planes pl, int flooding, Proto pr,
             Out out) {
  const int64_t lane = blockIdx.x;
  if (lane >= in.n_lanes) return;
  extern __shared__ double smem[];
  EventLane<kAttack, kProto> L;
  L.qt = smem;
  L.qbd = reinterpret_cast<int32_t*>(smem + led.M);
  L.qs = L.qbd + led.M;
  L.fl = L.qs + led.M;
  L.pend = L.fl + led.M;
  L.g = led;
  const int64_t row = lane * (int64_t)led.B;
  L.g.parent += row;
  L.g.height += row;
  L.g.miner += row;
  L.g.vis += row;
  L.g.known += row;
  if (kAttack) {
    L.g.wq += row;
    L.pid = in.policy[lane];
    L.strict = in.strict_match != 0;
  }
  if (kProto != kNak) {
    const int S1 = scratch_len(pr);
    L.sk = reinterpret_cast<float*>(L.pend + 32 * led.F);
    L.si = reinterpret_cast<int32_t*>(L.sk + S1);
    L.sc = L.si + S1;
    L.sx = L.sc + S1;
    L.inch = L.sx + S1;
    L.p = pr;
    const int64_t n = pl.n;
    advance(L.p.is_vote, row);
    advance(L.p.nvotes, row);
    advance(L.p.powh, row);
    advance(L.p.lhash, row);
    advance(L.p.noprop, row);
    advance(L.p.work, row);
    advance(L.p.conf, row * n);
    advance(L.p.conf_own, row * n);
    advance(L.p.mybest, row * n);
    advance(L.p.repl, row * n);
    advance(L.p.quorum, row * pr.qw);
    advance(L.p.uncles, row * pr.U);
  }
  L.pl = pl;
  L.logw = kAttack ? pl.logw + lane * pl.n : pl.logw;
  L.t = threadIdx.x & 31;
  L.N = pl.n;
  L.ad = in.delays[lane];
  L.flooding = flooding != 0;
  L.init(in.keys[lane]);
  while (L.live && L.steps < led.S) L.step();

  const int t = L.t, N = L.N;
  if (kProto != kNak) {
    L.finalize(out, lane);
  } else {
    int hp = -1, j = t < N ? t : 32;
    if (t < N && (!kAttack || t >= 1)) hp = L.g.height[L.pref];
    int best = hp;
    warp_argmax(best, j);
    int head = __shfl_sync(kFull, L.pref, j);
    if (kAttack && L.g.height[L.priv] >= best) head = L.priv;
    const int32_t head_height = L.g.height[head];
    const int count =
        chain_rewards(head, L.nb - 1, L.g.parent, L.g.miner, 0, N);
    if (t < N) {
      out.node_act[lane * N + t] = L.node_act;
      out.reward[lane * N + t] = (float)count;
    }
    if (t == 0) {
      out.head[lane] = head;
      out.head_height[lane] = head_height;
    }
  }
  if (t == 0) {
    out.sim_time[lane] = L.now;
    out.n_blocks[lane] = L.nb - 1;
    out.n_act[lane] = L.n_act;
    out.steps[lane] = L.steps;
    out.drop_q[lane] = L.drop_q;
    out.drop_p[lane] = L.drop_p;
    out.drop_b[lane] = L.drop_b;
    out.win_miss[lane] = L.win_miss;
    out.exhausted[lane] = L.live && L.steps >= led.S;
  }
}

template <bool kAttack, int kProto>
cudaError_t launch_event(const LaneIn& in, const Ledger& led,
                         const Planes& pl, int flooding, const Proto& pr,
                         const Out& out, cudaStream_t stream) {
  if (in.n_lanes <= 0) return cudaSuccess;
  const size_t smem =
      event_smem(led.M, led.F) + (kProto == kNak ? 0 : proto_smem(pr));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        event_kernel<kAttack, kProto>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  event_kernel<kAttack, kProto><<<(unsigned)in.n_lanes, 32, smem, stream>>>(
      in, led, pl, flooding, pr, out);
  return cudaGetLastError();
}

// The Nakamoto engine (K12-event, K13): no protocol planes.
template <bool kAttack>
cudaError_t launch_event(const LaneIn& in, const Ledger& led,
                         const Planes& pl, int flooding, const Out& out,
                         cudaStream_t stream) {
  return launch_event<kAttack, kNak>(in, led, pl, flooding, Proto{}, out,
                                     stream);
}

}  // namespace netsim
}  // namespace cpr
