// Kernel K8: the block-DAG primitives as device functions, one warp per
// lane, for ring windows with ancestry planes (the mode the env streams
// run on the card).
//
// Replaces: cpr_tpu/core/dag.py:234-860 — `append_if` (252-366),
// `retire_below` (369), `_valid_row`/`chain_mask`/`closure_mask`
// (383-407), `release`/`release_masked`/`select_vis` (409, 486, 529),
// `common_ancestor_masked` (418), `chain_first_at_most` (428),
// `drop_if_retired` (441), `first_by_age` (454), `last_by_age` (463),
// `descendants_mask` (471), `newer_than`/
// `children0_mask` (499-527), `mask_of`/`top_k_by` (820-860). Plain twin:
// cpr_tpu_torch/core/dag.py. Its own check kernel is csrc/dag_script.cu;
// on the main path it runs inside K10 (csrc/bk_stream.cu,
// csrc/ethereum_stream.cu, csrc/tailstorm_stream.cu, csrc/stree_stream.cu,
// csrc/spar_stream.cu, csrc/sdag_stream.cu).
//
// Layout: a lane's DAG is the slice `lane` of the port's lane-batched
// planes: `[L][W]` per field and per parent slot, `[L][W][W]` bool for
// the chain and closure rows. Thread t of the lane's warp owns slots
// t, t + 32, t + 64, t + 96 (W <= 128), so a plane read is 32 consecutive
// words per instruction, and a row read 32 consecutive bytes. A mask over
// the slots is a `Mask`: bit j of thread t is slot t + 32 j. Per-lane
// scalars (n, live_floor, overflow, indices) are warp-uniform registers.
//
// Bound: memory latency and warp-collective steps. Every query is a few
// plane reads and a butterfly of 5 shuffles over (key, slot) pairs; the
// lane's planes stay in device memory (45 KB a bk lane), read through L1.
//
// Parity rules: an argmin/argmax takes the lowest slot among equal keys
// (jnp.argmin/argmax), `top_k_by` extracts k <= 16 entries by k passes
// of it and returns slot 0 with valid false once the mask runs out;
// `first_by_age` orders by gid. Writes made by one thread are read by
// others only after a __syncwarp(), which every mutating function ends
// with, and `append_if` reads every input before it writes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cpr {

constexpr int kDagMaxParents = 17;  // bk k <= 16
constexpr int kNS = 4;              // slots per thread: W <= 128
constexpr int kMaxTopK = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kNone = -1;

// The planes of a lane-batched core.dag.Dag in ring mode with ancestry
// planes (laid out like cpr_tpu_torch/kernels/__init__.py `_DagPtrs`).
struct DagPtrs {
  int32_t* parents[kDagMaxParents];
  float* auxf;
  float* auxg;
  int32_t* aux2;
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
#pragma unroll
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
#pragma unroll
    for (int j = 0; j < kNS; ++j)
      if (in(j) && pred(plane[o(slot(j))])) m |= 1u << j;
    return m;
  }
  __device__ __forceinline__ Mask bools(const bool* plane) const {
    return where(plane, [](bool v) { return v; });
  }
  __device__ __forceinline__ Mask exists() const {
    const int32_t nn = n;
    return where(d->gid, [nn](int32_t g) { return g >= 0 && g < nn; });
  }
  __device__ __forceinline__ Mask kind_is(int32_t k) const {
    return where(d->kind, [k](int32_t v) { return v == k; });
  }
  // blocks appended after v (the ring's stale-pointer guard, dag.py:499)
  __device__ __forceinline__ Mask newer_than(int32_t v) const {
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
#pragma unroll
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
#pragma unroll
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
  __device__ int32_t common_ancestor(int32_t a, int32_t b) const {
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
    return (idx >= 0 && at(d->gid, idx) < live_floor) ? kNone : idx;
  }
  // dag.py:454: earliest gid in m
  __device__ int32_t first_by_age(Mask m) const {
    int32_t k = INT32_MAX;
    int s = INT32_MAX;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int32_t v = (m >> j) & 1u ? d->gid[o(slot(j))] : (1 << 30);
      if (v < k) {
        k = v;
        s = slot(j);
      }
    }
    warp_select<false>(k, s);
    return mask_any(m) ? s : kNone;
  }
  // dag.py:463: latest gid in m
  __device__ int32_t last_by_age(Mask m) const {
    int32_t k = INT32_MIN;
    int s = INT32_MAX;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (!in(j)) continue;
      const int32_t v = (m >> j) & 1u ? d->gid[o(slot(j))] : -1;
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
#pragma unroll
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
#pragma unroll
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
#pragma unroll
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
#pragma unroll
    for (int j = 0; j < kNS; ++j)
      if (!((m >> j) & 1u)) score[j] = inf;
    for (int i = 0; i < k; ++i) {
      float key = inf;
      int s = INT32_MAX;
#pragma unroll
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
#pragma unroll
    for (int j = 0; j < kNS; ++j) sc[j] = in(j) ? plane[o(slot(j))] : 0.f;
    top_k(sc, m, k, idx, valid);
  }

  // -- mutations -------------------------------------------------------------

  // dag.py:529: newly visible = m & ~vis_d & exists
  __device__ void release(Mask m, float time) {
    const Mask newly = m & ~bools(d->vis_d) & exists();
#pragma unroll
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
    live_floor = max(live_floor, floor_gid);
  }

  // dag.py:252-366 in ring mode with ancestry planes; the chain row
  // follows `chain_parent` (row.p[0] when < -1).
  __device__ int32_t append_if(bool cond, const Row& r, const Block& b,
                               int32_t chain_parent = -2) {
    const int32_t idx = n % W;
    const int32_t evicted = at(d->gid, idx);
    const bool ovf = overflow || (cond && evicted >= 0 && evicted < n &&
                                  evicted >= live_floor);
    const int32_t p0 = r.p[0];
    const bool has = p0 >= 0;
    const int32_t base = has ? p0 : 0;
    const float cum_atk = (has ? at(d->cum_atk, base) : 0.f) + b.reward_atk;
    const float cum_def = (has ? at(d->cum_def, base) : 0.f) + b.reward_def;
    const int32_t cp = chain_parent < -1 ? p0 : chain_parent;
    Mask crow = chain_mask(cp), orow = 0;
    for (int p = 0; p < P; ++p) orow |= closure_mask(r.p[p]);
    if ((idx & 31) == t) {
      crow |= 1u << (idx >> 5);
      orow |= 1u << (idx >> 5);
    }
    __syncwarp();
    if (cond) {
      if (t == 0) {
        const int64_t q = o(idx);
        for (int p = 0; p < P; ++p) d->parents[p][q] = r.p[p];
        d->auxf[q] = b.auxf;
        d->auxg[q] = b.auxg;
        d->aux2[q] = b.aux2;
        d->gid[q] = n;
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
      bool* cr = row(d->chain, idx);
      bool* orr = row(d->closure, idx);
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        if (!in(j)) continue;
        cr[slot(j)] = (crow >> j) & 1u;
        orr[slot(j)] = (orow >> j) & 1u;
      }
      n += 1;
    }
    overflow = ovf;
    __syncwarp();
    return cond ? idx : kNone;
  }

  // Rows [0, R) of every plane back to core.dag.empty's values and the
  // scalars to zero: the in-place form of the logical reset's fresh rows
  // (rows >= R keep their stale contents, as in the reference).
  __device__ void clear_rows(int R) {
    for (int x = 0; x < R && x < W; ++x) {
      if (t == 0) {
        const int64_t q = o(x);
        for (int p = 0; p < P; ++p) d->parents[p][q] = kNone;
        d->auxf[q] = 0.f;
        d->auxg[q] = 0.f;
        d->aux2[q] = kNone;
        d->gid[q] = kNone;
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
      bool* cr = row(d->chain, x);
      bool* orr = row(d->closure, x);
#pragma unroll
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

  // Copy this lane's whole DAG from `src` (same shape), warp-cooperative.
  __device__ void copy_from(const DagPtrs& src) {
    const int64_t base = lane * W;
    for (int s = t; s < W; s += 32) {
      const int64_t q = base + s;
      for (int p = 0; p < P; ++p) d->parents[p][q] = src.parents[p][q];
      d->auxf[q] = src.auxf[q];
      d->auxg[q] = src.auxg[q];
      d->aux2[q] = src.aux2[q];
      d->gid[q] = src.gid[q];
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
    n = src.n[lane];
    live_floor = src.live_floor[lane];
    overflow = src.overflow[lane];
    __syncwarp();
  }
};

}  // namespace cpr
