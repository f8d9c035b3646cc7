// Kernel K8: the block-DAG primitives as device functions, one warp per
// lane, in one of three modes fixed per compilation (`CPR_DAG_MODE`, one
// library per mode): a ring window with ancestry planes (0, the default),
// full capacity (1), and full capacity with binary-lifting planes (2).
//
// Replaces: cpr_tpu/core/dag.py:168-860 — `empty` (168-231, the lifting
// planes), `append_if` (252-366), `retire_below` (369),
// `_valid_row`/`chain_mask`/`closure_mask` (383-407),
// `release`/`release_masked`/`select_vis` (409, 486, 529),
// `common_ancestor_masked` (418), `chain_first_at_most` (428),
// `drop_if_retired` (441), `first_by_age` (454), `last_by_age` (463),
// `descendants_mask` (471), `newer_than`/`children0_mask` (499-527), the
// full mode's walks `release_chain` (596-647), `release_closure`
// (649-682), `walk_back` (684-725), `block_at_height` (728-749) and
// `common_ancestor_by_height` (751-817), `mask_of`/`top_k_by` (820-860).
// Plain twin: cpr_tpu_torch/core/dag.py. Its own check kernel is
// csrc/dag_script.cu; on the main path it runs inside K10
// (csrc/bk_stream.cu, csrc/ethereum_stream.cu, csrc/tailstorm_stream.cu,
// csrc/stree_stream.cu, csrc/spar_stream.cu, csrc/sdag_stream.cu).
//
// Layout: a lane's DAG is the slice `lane` of the port's lane-batched
// planes: `[L][W]` per field and per parent slot, `[L][W][W]` bool for
// the chain and closure rows (ring), `[L][W]` per lifting plane (lifted).
// Thread t of the lane's warp owns slots t, t + 32, ..., t + 32 (kNS - 1)
// (kNS = 4 in a ring, W <= 128; 17 in full mode, W <= 544), so a plane
// read is 32 consecutive words per instruction, and a row read 32
// consecutive bytes. A mask over the slots is a `Mask`: bit j of thread t
// is slot t + 32 j. Per-lane scalars (n, live_floor, overflow, indices)
// are warp-uniform registers. In full mode a slot's age is its index,
// `exists` is slot < n, and an append past the capacity pins the last
// slot and sets `overflow`, as in the reference.
//
// Bound: memory latency and warp-collective steps. Every query is a few
// plane reads and a butterfly of 5 shuffles over (key, slot) pairs; the
// lane's planes stay in device memory (45 KB a bk lane in a ring), read
// through L1. The full mode's walks are chains of dependent loads, one
// node an iteration, every thread of the warp walking the same path.
//
// Parity rules: an argmin/argmax takes the lowest slot among equal keys
// (jnp.argmin/argmax), `top_k_by` extracts k <= 16 entries by k passes
// of it and returns slot 0 with valid false once the mask runs out;
// `first_by_age` orders by gid (ring) or slot (full). Writes made by one
// thread are read by others only after a __syncwarp(), which every
// mutating function ends with, and `append_if` reads every input before
// it writes. A walk stops after `walk_bound()` iterations, as the plain
// twin's do: a DAG that filled up can hold a parent cycle on its pinned
// last slot, where the reference's walks never end.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cpr {

#ifndef CPR_DAG_MODE
#define CPR_DAG_MODE 0
#endif

constexpr int kDagRing = 0, kDagFull = 1, kDagFullLift = 2;
constexpr int kDagMode = CPR_DAG_MODE;
static_assert(kDagMode >= kDagRing && kDagMode <= kDagFullLift, "CPR_DAG_MODE");
constexpr bool kRing = kDagMode == kDagRing;
constexpr bool kLifted = kDagMode == kDagFullLift;
constexpr int kDagMaxParents = 17;  // bk k <= 16
constexpr int kNS = kRing ? 4 : 17;  // slots per thread: W <= 128 | 544
constexpr int kMaxSlots = 32 * kNS;

// The loops over a thread's slots: unrolled in a ring (4 slots), a loop
// in full mode (17), which keeps its libraries' code and build time small
// (their per-slot arrays then live in local memory, read through L1).
#if CPR_DAG_MODE == 0
#define CPR_SLOT_LOOP _Pragma("unroll")
#else
#define CPR_SLOT_LOOP _Pragma("unroll 1")
#endif
constexpr int kMaxTopK = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kNone = -1;

// The planes of a lane-batched core.dag.Dag (laid out like
// cpr_tpu_torch/kernels/__init__.py `_DagPtrs`); a plane the mode lacks
// (gid, chain, closure in full mode; anc outside the lifted one) is null.
struct DagPtrs {
  int32_t* parents[kDagMaxParents];
  float* auxf;
  float* auxg;
  int32_t* aux2;
  int32_t* anc[4];  // anc2, anc4, anc8, anc16
  int32_t* gid;
  int32_t* live_floor;
  bool* chain;
  bool* closure;
  int32_t* kind;
  int32_t* height;
  int32_t* aux;
  float* pow_hash;
  int32_t* signer;
  int32_t* miner;
  bool* vis_a;
  bool* vis_d;
  float* vis_d_since;
  float* born_at;
  float* cum_atk;
  float* cum_def;
  float* cum_prog;
  int32_t* n;
  bool* overflow;
  int32_t W;
  int32_t P;
};

using Mask = uint32_t;

// One value per parent slot of a row to append.
struct Row {
  int32_t p[kDagMaxParents];
};

// Fields of a block to append (dag.py:252-256 keywords); every caller
// gives its progress (the reference's default, the precursor's + 1, has
// none on the card).
struct Block {
  int32_t kind = 0, height = 0, aux = 0, signer = kNone, miner = kNone;
  int32_t aux2 = kNone;
  float pow_hash = __builtin_huge_valf(), auxf = 0.f, auxg = 0.f;
  bool vis_a = true, vis_d = true;
  float time = 0.f, reward_atk = 0.f, reward_def = 0.f, progress = 0.f;
};

__device__ __forceinline__ float f_inf() { return __builtin_huge_valf(); }

// -- warp reductions over the lane's slots -----------------------------------

__device__ __forceinline__ int mask_count(Mask m) {
  int c = 0;
CPR_SLOT_LOOP
  for (int j = 0; j < kNS; ++j) c += __popc(__ballot_sync(kFull, (m >> j) & 1u));
  return c;
}

__device__ __forceinline__ bool mask_any(Mask m) {
  return __any_sync(kFull, m != 0u);
}

// Warp-wide (key, slot) selection: the smallest key (or largest with
// MAX), the lowest slot among equals. `s` is INT32_MAX for "no slot".
template <bool MAX, typename K>
__device__ __forceinline__ void warp_select(K& k, int& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const K ok = __shfl_xor_sync(kFull, k, off);
    const int os = __shfl_xor_sync(kFull, s, off);
    const bool better = MAX ? (ok > k) : (ok < k);
    if (better || (ok == k && os < s)) {
      k = ok;
      s = os;
    }
  }
}

struct LaneDag {
  const DagPtrs* d;  // a __grid_constant__ kernel parameter
  int64_t lane;
  int W, P, t;
  int32_t n, live_floor;
  bool overflow;

  __device__ void bind(const DagPtrs& ptrs, int64_t lane_) {
    d = &ptrs;
    lane = lane_;
    W = ptrs.W;
    P = ptrs.P;
    t = threadIdx.x & 31;
  }
  __device__ void load_scalars() {
    n = d->n[lane];
    live_floor = d->live_floor[lane];
    overflow = d->overflow[lane];
  }
  __device__ void store_scalars() const {
    if (t == 0) {
      d->n[lane] = n;
      d->live_floor[lane] = live_floor;
      d->overflow[lane] = overflow;
    }
  }

  __device__ __forceinline__ int slot(int j) const { return t + 32 * j; }
  __device__ __forceinline__ bool in(int j) const { return slot(j) < W; }
  __device__ __forceinline__ int64_t o(int s) const { return lane * W + s; }
  template <typename T>
  __device__ __forceinline__ T at(const T* plane, int32_t s) const {
    return plane[o(s)];
  }
  __device__ __forceinline__ bool* row(bool* plane, int32_t x) const {
    return plane + (lane * W + x) * (int64_t)W;
  }

  // -- masks -----------------------------------------------------------------

  // Mask of slots whose value of `plane` satisfies `pred`.
  template <typename T, typename F>
  __device__ __forceinline__ Mask where(const T* plane, F pred) const {
    Mask m = 0;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j)
      if (in(j) && pred(plane[o(slot(j))])) m |= 1u << j;
    return m;
  }
  __device__ __forceinline__ Mask bools(const bool* plane) const {
    return where(plane, [](bool v) { return v; });
  }
  // every slot of the window
  __device__ __forceinline__ Mask all_slots() const {
    Mask m = 0;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j)
      if (in(j)) m |= 1u << j;
    return m;
  }
  // ring: gid in [0, n) (rejects stale occupants surviving a reset);
  // full: slot < n
  __device__ __forceinline__ Mask exists() const {
    const int32_t nn = n;
    if (!kRing) {
      Mask m = 0;
CPR_SLOT_LOOP
      for (int j = 0; j < kNS; ++j)
        if (in(j) && slot(j) < nn) m |= 1u << j;
      return m;
    }
    return where(d->gid, [nn](int32_t g) { return g >= 0 && g < nn; });
  }
  __device__ __forceinline__ Mask kind_is(int32_t k) const {
    return where(d->kind, [k](int32_t v) { return v == k; });
  }
  // blocks appended after v (the ring's stale-pointer guard, dag.py:499)
  __device__ __forceinline__ Mask newer_than(int32_t v) const {
    if (!kRing) return all_slots();
    const int32_t gv = at(d->gid, v < 0 ? 0 : v);
    return where(d->gid, [gv](int32_t g) { return g > gv; });
  }
  // dag.py:520: precursor (parent slot 0) is v
  __device__ __forceinline__ Mask children0(int32_t v) const {
    return exists() & where(d->parents[0], [v](int32_t p) { return p == v; }) &
           newer_than(v);
  }
  // dag.py:383: the bits of row x that still mean their original blocks
  __device__ __forceinline__ Mask valid_row(bool* plane, int32_t x) const {
    if (x < 0) return 0u;
    const int32_t gx = at(d->gid, x);
    const bool* r = row(plane, x);
    Mask m = 0;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int s = slot(j);
      const int32_t g = d->gid[o(s)];
      if (r[s] && g <= gx && g >= 0) m |= 1u << j;
    }
    return m;
  }
  __device__ __forceinline__ Mask chain_mask(int32_t x) const {
    return valid_row(d->chain, x);
  }
  __device__ __forceinline__ Mask closure_mask(int32_t x) const {
    return valid_row(d->closure, x);
  }
  // the mask with slot idx[i] set where valid[i] (dag.py:820)
  __device__ __forceinline__ Mask mask_of(const int32_t* idx,
                                          const bool* valid, int k) const {
    Mask m = 0;
    for (int i = 0; i < k; ++i) {
      if (!valid[i]) continue;
      const int s = idx[i];
      if ((s & 31) == t && (s >> 5) < kNS) m |= 1u << (s >> 5);
    }
    return m;
  }

  // -- selections ----------------------------------------------------------

  // argmax over slots of where(m, plane, -1) among all slots; NONE if m
  // is empty (common_ancestor_masked / chain_first_at_most's reduction)
  __device__ int32_t argmax_height(Mask m) const {
    int32_t k = INT32_MIN;
    int s = INT32_MAX;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int32_t v = (m >> j) & 1u ? d->height[o(slot(j))] : -1;
      if (v > k) {
        k = v;
        s = slot(j);
      }
    }
    warp_select<true>(k, s);
    return mask_any(m) ? s : kNone;
  }

  // dag.py:418
  __device__ int32_t common_ancestor_masked(int32_t a, int32_t b) const {
    return argmax_height(chain_mask(a) & chain_mask(b));
  }
  // dag.py:428 with an int32 `values` plane
  __device__ int32_t chain_first_at_most(int32_t tip, const int32_t* values,
                                         int32_t target) const {
    return argmax_height(chain_mask(tip) &
                         where(values, [target](int32_t v) { return v <= target; }));
  }
  // dag.py:441
  __device__ int32_t drop_if_retired(int32_t idx) const {
    if (!kRing) return idx;
    return (idx >= 0 && at(d->gid, idx) < live_floor) ? kNone : idx;
  }
  // the insertion-order key (dag.py:159): the ring's gid, else the slot
  __device__ __forceinline__ int32_t age(int s) const {
    return kRing ? d->gid[o(s)] : s;
  }
  // dag.py:454: earliest appended in m
  __device__ int32_t first_by_age(Mask m) const {
    int32_t k = INT32_MAX;
    int s = INT32_MAX;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int32_t v = (m >> j) & 1u ? age(slot(j)) : (1 << 30);
      if (v < k) {
        k = v;
        s = slot(j);
      }
    }
    warp_select<false>(k, s);
    return mask_any(m) ? s : kNone;
  }
  // dag.py:463: latest appended in m
  __device__ int32_t last_by_age(Mask m) const {
    int32_t k = INT32_MIN;
    int s = INT32_MAX;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int32_t v = (m >> j) & 1u ? age(slot(j)) : -1;
      if (v > k) {
        k = v;
        s = slot(j);
      }
    }
    warp_select<true>(k, s);
    return mask_any(m) ? s : kNone;
  }
  // dag.py:471: blocks with `a` on their chain row (a column of the chain
  // plane), the ring guard gid >= gid[a]
  __device__ Mask descendants(int32_t a) const {
    if (a < 0) return 0u;
    const int32_t ga = at(d->gid, a);
    Mask m = 0;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int s = slot(j);
      if (row(d->chain, s)[a] && d->gid[o(s)] >= ga) m |= 1u << j;
    }
    return m & exists();
  }
  // min over m of a float plane, +inf when empty (jnp.where(m, x, inf).min())
  __device__ float min_where(const float* plane, Mask m) const {
    float k = f_inf();
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j)
      if (in(j) && ((m >> j) & 1u)) k = fminf(k, plane[o(slot(j))]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      k = fminf(k, __shfl_xor_sync(kFull, k, off));
    return k;
  }
  // argmin over all slots of where(m, plane, inf)
  __device__ int32_t argmin_where(const float* plane, Mask m) const {
    float k = f_inf();
    int s = INT32_MAX;
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const float v = (m >> j) & 1u ? plane[o(slot(j))] : f_inf();
      if (v < k || s == INT32_MAX) {
        k = v;
        s = slot(j);
      }
    }
    warp_select<false>(k, s);
    return s;
  }
  // dag.py:830 for k <= 16, ascending: `score[j]` holds this thread's
  // keys (any value where masked out), overwritten.
  __device__ void top_k(float (&score)[kNS], Mask m, int k, int32_t* idx,
                        bool* valid) const {
    const float inf = f_inf();
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j)
      if (!((m >> j) & 1u)) score[j] = inf;
    for (int i = 0; i < k; ++i) {
      float key = inf;
      int s = INT32_MAX;
CPR_SLOT_LOOP
      for (int j = 0; j < kNS; ++j) {
        if (!in(j)) continue;
        if (score[j] < key || s == INT32_MAX) {
          key = score[j];
          s = slot(j);
        }
      }
      warp_select<false>(key, s);
      idx[i] = s;
      valid[i] = key != inf;
      if ((s & 31) == t) score[s >> 5] = inf;
    }
  }
  // top_k of a float plane under m
  __device__ void top_k_plane(const float* plane, Mask m, int k, int32_t* idx,
                              bool* valid) const {
    float sc[kNS];
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) sc[j] = in(j) ? plane[o(slot(j))] : 0.f;
    top_k(sc, m, k, idx, valid);
  }

  // -- mutations -------------------------------------------------------------

  // dag.py:529: newly visible = m & ~vis_d & exists
  __device__ void release(Mask m, float time) {
    const Mask newly = m & ~bools(d->vis_d) & exists();
CPR_SLOT_LOOP
    for (int j = 0; j < kNS; ++j) {
      if ((newly >> j) & 1u) {
        d->vis_d[o(slot(j))] = true;
        d->vis_d_since[o(slot(j))] = time;
      }
    }
    __syncwarp();
  }
  __device__ void release_masked(int32_t tip, float time) {
    release(closure_mask(tip), time);
  }
  __device__ void retire_below(int32_t floor_gid) {
    if (kRing) live_floor = max(live_floor, floor_gid);
  }

  // dag.py:252-366; the ring's chain row follows `chain_parent` (row.p[0]
  // when < -1). Full mode claims slot min(n, W - 1) and flags `overflow`
  // when n reached W; the lifted mode writes the jump pointers of the new
  // block from its precursor's.
  __device__ int32_t append_if(bool cond, const Row& r, const Block& b,
                               int32_t chain_parent = -2) {
    const int32_t idx = kRing ? n % W : min(n, W - 1);
    bool ovf = overflow;
    if (kRing) {
      const int32_t evicted = at(d->gid, idx);
      ovf = ovf || (cond && evicted >= 0 && evicted < n &&
                    evicted >= live_floor);
    } else {
      ovf = ovf || (cond && n >= W);
    }
    const int32_t p0 = r.p[0];
    const bool has = p0 >= 0;
    const int32_t base = has ? p0 : 0;
    const float cum_atk = (has ? at(d->cum_atk, base) : 0.f) + b.reward_atk;
    const float cum_def = (has ? at(d->cum_def, base) : 0.f) + b.reward_def;
    Mask crow = 0, orow = 0;
    if (kRing) {
      const int32_t cp = chain_parent < -1 ? p0 : chain_parent;
      crow = chain_mask(cp);
      for (int p = 0; p < P; ++p) orow |= closure_mask(r.p[p]);
      if ((idx & 31) == t) {
        crow |= 1u << (idx >> 5);
        orow |= 1u << (idx >> 5);
      }
    }
    int32_t jump[4] = {kNone, kNone, kNone, kNone};
    if (kLifted) {  // dag.py:305-366: 2, 4, 8, 16 precursors up
      jump[0] = p0 >= 0 ? at(d->parents[0], p0) : kNone;
#pragma unroll
      for (int l = 1; l < 4; ++l)
        jump[l] = jump[l - 1] >= 0 ? at(d->anc[l - 1], jump[l - 1]) : kNone;
    }
    __syncwarp();
    if (cond) {
      if (t == 0) {
        const int64_t q = o(idx);
        for (int p = 0; p < P; ++p) d->parents[p][q] = r.p[p];
        d->auxf[q] = b.auxf;
        d->auxg[q] = b.auxg;
        d->aux2[q] = b.aux2;
        if (kLifted)
          for (int l = 0; l < 4; ++l) d->anc[l][q] = jump[l];
        if (kRing) d->gid[q] = n;
        d->kind[q] = b.kind;
        d->height[q] = b.height;
        d->aux[q] = b.aux;
        d->pow_hash[q] = b.pow_hash;
        d->signer[q] = b.signer;
        d->miner[q] = b.miner;
        d->vis_a[q] = b.vis_a;
        d->vis_d[q] = b.vis_d;
        d->vis_d_since[q] = b.vis_d ? b.time : f_inf();
        d->born_at[q] = b.time;
        d->cum_atk[q] = cum_atk;
        d->cum_def[q] = cum_def;
        d->cum_prog[q] = b.progress;
      }
      if (kRing) {
        bool* cr = row(d->chain, idx);
        bool* orr = row(d->closure, idx);
CPR_SLOT_LOOP
        for (int j = 0; j < kNS; ++j) {
          if (!in(j)) continue;
          cr[slot(j)] = (crow >> j) & 1u;
          orr[slot(j)] = (orow >> j) & 1u;
        }
      }
      n = kRing ? n + 1 : min(n + 1, W);
    }
    overflow = ovf;
    __syncwarp();
    return cond ? idx : kNone;
  }

  // -- the full mode's walks (dag.py:596-817) ------------------------------

  // The iteration bound of every walk, as the plain twin's: a walk of a
  // DAG without a cycle ends well within it.
  __device__ __forceinline__ int walk_bound() const { return 2 * W + 2; }
  __device__ __forceinline__ bool exists_at(int32_t s) const {
    if (s < 0) return false;
    if (kRing) {
      const int32_t g = at(d->gid, s);
      return g >= 0 && g < n;
    }
    return s < n;
  }

  // dag.py:684-725: follow parent slot 0 from `tip` while !stop(i); the
  // lifted DAG jumps to the largest anc plane whose landing node does not
  // yet stop. Returns the first node that stops, NONE past the root.
  template <class Stop>
  __device__ int32_t walk_back(int32_t tip, Stop stop) const {
    auto ok = [&](int32_t j) { return j >= 0 && !stop(j); };
    int32_t i = tip;
    for (int it = 0; it < walk_bound() && ok(i); ++it) {
      int32_t nxt = at(d->parents[0], i);
      if (kLifted) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int32_t j = at(d->anc[l], i);
          if (ok(j)) nxt = j;
        }
      }
      i = nxt;
    }
    return i;
  }

  // dag.py:728-749 without `is_block_fn`: the first block at height <=
  // target down the precursor chain from `tip`
  __device__ int32_t block_at_height(int32_t tip, int32_t target) const {
    return walk_back(tip, [&](int32_t i) { return at(d->height, i) <= target; });
  }

  // dag.py:751-817: the common ancestor of two chain tips by a
  // height-synchronized walk; on a lifted DAG the binary-lifting LCA
  // (equalize by the largest jump <= the height difference, then descend
  // both by the largest level whose ancestors still differ).
  __device__ int32_t common_ancestor_by_height(int32_t a, int32_t b) const {
    const int32_t* p0 = d->parents[0];
    int32_t x = a, y = b;
    for (int it = 0; it < walk_bound() && x != y && x >= 0 && y >= 0; ++it) {
      const int32_t hx = at(d->height, x), hy = at(d->height, y);
      int32_t nx, ny;
      if (kLifted) {
        auto down = [&](int32_t i, int32_t dist) {
          int32_t out = at(p0, i);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int32_t j = at(d->anc[l], i);
            if (dist >= (2 << l) && j >= 0) out = j;
          }
          return out;
        };
        int32_t ex = at(p0, x), ey = at(p0, y);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int32_t jx = at(d->anc[l], x), jy = at(d->anc[l], y);
          if (jx >= 0 && jy >= 0 && jx != jy) {
            ex = jx;
            ey = jy;
          }
        }
        const int32_t dh = hx - hy;
        nx = dh > 0 ? down(x, dh) : (dh < 0 ? x : ex);
        ny = dh < 0 ? down(y, -dh) : (dh > 0 ? y : ey);
      } else {
        nx = hx >= hy ? at(p0, x) : x;
        ny = hy >= hx ? at(p0, y) : y;
      }
      x = nx;
      y = ny;
    }
    return x;
  }

  // dag.py:596-647: release `tip` and its parent row, then walk down the
  // precursor chain until a block that was defender-visible before the
  // call (each next tip's visibility read before its row is released).
  // Thread u <= P releases row entry u (u == P: the tip itself).
  __device__ void release_chain(int32_t tip, float time) {
    int32_t x = tip;
    bool x_vis = at(d->vis_d, tip < 0 ? 0 : tip);
    for (int it = 0; it < walk_bound() && x >= 0 && !x_vis; ++it) {
      const int32_t nxt = at(d->parents[0], x);
      const bool nxt_vis = at(d->vis_d, nxt < 0 ? 0 : nxt);
      const int32_t s = t < P ? at(d->parents[t], x) : (t == P ? x : kNone);
      __syncwarp();
      if (exists_at(s) && !at(d->vis_d, s)) {
        d->vis_d[o(s)] = true;
        d->vis_d_since[o(s)] = time;
      }
      __syncwarp();
      x = nxt;
      x_vis = nxt_vis;
    }
  }

  // dag.py:649-682: release_chain, then the visibility closure: every
  // parent of a defender-visible block becomes visible (the same least
  // fixpoint as the reference's rounds; every new block gets `time`).
  __device__ void release_closure(int32_t tip, float time) {
    release_chain(tip, time);
    for (;;) {
      const Mask vis = bools(d->vis_d) & exists();
      bool changed = false;
CPR_SLOT_LOOP
      for (int j = 0; j < kNS; ++j) {
        if (!((vis >> j) & 1u)) continue;
        const int s = slot(j);
        for (int p = 0; p < P; ++p) {
          const int32_t v = d->parents[p][o(s)];
          if (exists_at(v) && !at(d->vis_d, v)) {
            d->vis_d[o(v)] = true;
            d->vis_d_since[o(v)] = time;
            changed = true;
          }
        }
      }
      __syncwarp();
      if (!__any_sync(kFull, changed)) break;
    }
  }

  // The envs' queries of either mode (bk.py:336-338, 470-474, spar.py,
  // ethereum.py, stree.py): the common ancestor of two chain tips (the
  // chain planes' intersection in a ring, the height walk in full mode),
  // the first chain block at height <= target.
  __device__ int32_t common_ancestor(int32_t a, int32_t b) const {
    return kRing ? common_ancestor_masked(a, b)
                 : common_ancestor_by_height(a, b);
  }
  __device__ int32_t chain_at_height(int32_t tip, int32_t target) const {
    return kRing ? chain_first_at_most(tip, d->height, target)
                 : block_at_height(tip, target);
  }

  // Rows [0, R) of every plane back to core.dag.empty's values and the
  // scalars to zero: the in-place form of the logical reset's fresh rows
  // (rows >= R keep their stale contents, as in the reference).
  __device__ void clear_rows(int R) {
    __syncwarp();  // every thread's reads of the old rows are done
    for (int x = 0; x < R && x < W; ++x) {
      if (t == 0) {
        const int64_t q = o(x);
        for (int p = 0; p < P; ++p) d->parents[p][q] = kNone;
        d->auxf[q] = 0.f;
        d->auxg[q] = 0.f;
        d->aux2[q] = kNone;
        if (kLifted)
          for (int l = 0; l < 4; ++l) d->anc[l][q] = kNone;
        if (kRing) d->gid[q] = kNone;
        d->kind[q] = 0;
        d->height[q] = 0;
        d->aux[q] = 0;
        d->pow_hash[q] = f_inf();
        d->signer[q] = kNone;
        d->miner[q] = kNone;
        d->vis_a[q] = false;
        d->vis_d[q] = false;
        d->vis_d_since[q] = 0.f;
        d->born_at[q] = 0.f;
        d->cum_atk[q] = 0.f;
        d->cum_def[q] = 0.f;
        d->cum_prog[q] = 0.f;
      }
      if (!kRing) continue;
      bool* cr = row(d->chain, x);
      bool* orr = row(d->closure, x);
CPR_SLOT_LOOP
      for (int j = 0; j < kNS; ++j) {
        if (!in(j)) continue;
        cr[slot(j)] = false;
        orr[slot(j)] = false;
      }
    }
    n = 0;
    live_floor = 0;
    overflow = false;
    __syncwarp();
  }

  // Every row of every plane back to core.dag.empty's values and the
  // scalars to zero, warp-cooperative: the whole-lane form of
  // `clear_rows` (the DAG of a fresh `init_lanes` carry, before its reset).
  __device__ void clear_all() {
    __syncwarp();
    const int64_t base = lane * W;
    for (int s = t; s < W; s += 32) {
      const int64_t q = base + s;
      for (int p = 0; p < P; ++p) d->parents[p][q] = kNone;
      d->auxf[q] = 0.f;
      d->auxg[q] = 0.f;
      d->aux2[q] = kNone;
      if (kLifted)
        for (int l = 0; l < 4; ++l) d->anc[l][q] = kNone;
      if (kRing) d->gid[q] = kNone;
      d->kind[q] = 0;
      d->height[q] = 0;
      d->aux[q] = 0;
      d->pow_hash[q] = f_inf();
      d->signer[q] = kNone;
      d->miner[q] = kNone;
      d->vis_a[q] = false;
      d->vis_d[q] = false;
      d->vis_d_since[q] = 0.f;
      d->born_at[q] = 0.f;
      d->cum_atk[q] = 0.f;
      d->cum_def[q] = 0.f;
      d->cum_prog[q] = 0.f;
    }
    if (kRing) {
      const int64_t rows = (int64_t)W * W;
      bool* cr = d->chain + lane * rows;
      bool* orr = d->closure + lane * rows;
      for (int64_t w = t; w < rows; w += 32) {
        cr[w] = false;
        orr[w] = false;
      }
    }
    n = 0;
    live_floor = 0;
    overflow = false;
    __syncwarp();
  }

  // Copy this lane's whole DAG from `src` (same shape), warp-cooperative.
  __device__ void copy_from(const DagPtrs& src) {
    const int64_t base = lane * W;
    for (int s = t; s < W; s += 32) {
      const int64_t q = base + s;
      for (int p = 0; p < P; ++p) d->parents[p][q] = src.parents[p][q];
      d->auxf[q] = src.auxf[q];
      d->auxg[q] = src.auxg[q];
      d->aux2[q] = src.aux2[q];
      if (kLifted)
        for (int l = 0; l < 4; ++l) d->anc[l][q] = src.anc[l][q];
      if (kRing) d->gid[q] = src.gid[q];
      d->kind[q] = src.kind[q];
      d->height[q] = src.height[q];
      d->aux[q] = src.aux[q];
      d->pow_hash[q] = src.pow_hash[q];
      d->signer[q] = src.signer[q];
      d->miner[q] = src.miner[q];
      d->vis_a[q] = src.vis_a[q];
      d->vis_d[q] = src.vis_d[q];
      d->vis_d_since[q] = src.vis_d_since[q];
      d->born_at[q] = src.born_at[q];
      d->cum_atk[q] = src.cum_atk[q];
      d->cum_def[q] = src.cum_def[q];
      d->cum_prog[q] = src.cum_prog[q];
    }
    if (kRing) copy_rows_from(src);
    n = src.n[lane];
    live_floor = src.live_floor[lane];
    overflow = src.overflow[lane];
    __syncwarp();
  }
  __device__ void copy_rows_from(const DagPtrs& src) {
    const int64_t rows = (int64_t)W * W;
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(src.chain + lane * rows);
    const uint32_t* so = reinterpret_cast<const uint32_t*>(src.closure + lane * rows);
    uint32_t* dc = reinterpret_cast<uint32_t*>(d->chain + lane * rows);
    uint32_t* dd = reinterpret_cast<uint32_t*>(d->closure + lane * rows);
    if ((rows & 3) == 0) {  // W even: 4-byte words stay aligned per lane
      for (int64_t w = t; w < rows / 4; w += 32) {
        dc[w] = sc[w];
        dd[w] = so[w];
      }
    } else {
      for (int64_t w = t; w < rows; w += 32) {
        d->chain[lane * rows + w] = src.chain[lane * rows + w];
        d->closure[lane * rows + w] = src.closure[lane * rows + w];
      }
    }
  }
};

}  // namespace cpr
