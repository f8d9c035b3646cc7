// The netsim's discrete-event engine as device functions, shared by
// K12-event (netsim_event.cu, the honest network) and K13
// (netsim_attack.cu, an attacker at node 0).
//
// Replaces: cpr_tpu/netsim/engine.py:123-310 and :460-715 (`_lane_fn`,
// Nakamoto: init, the step body, finalize) and attack.py:116-408
// (`_attack_lane_fn`). Plain twins: cpr_tpu_torch/netsim/engine.py
// `EventLedger`, `event_plain`; attack.py `attack_plain`.
//
// One step of a lane: split the carry key (5 ways; 4 for K13); an
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
// Design: one warp per lane, node n on thread n (N <= 32). The queue
// (time, block << 5 | node, sequence) and the pending buffers live in
// the warp's shared memory, the queue scanned M / 32 entries a thread
// with warp reductions for the earliest time and lowest sequence. The
// ledger lives in global memory per lane: parent, height and miner
// [B] int32, and the nodes' visible and known bits as one 32-bit mask
// per block. The JAX package's per-node arrival times (`vis_at`) are
// written and never read there, so the port carries none. The
// attacker's withheld blocks are a FIFO of block ids (K13): they are
// always a suffix of the private chain, so the lowest withheld id is the
// lowest height, and a release pops the front.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "nakamoto_policy.cuh"
#include "netsim.cuh"

namespace cpr {
namespace netsim {

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

template <bool kAttack>
struct EventLane {
  // shared memory of this warp
  double* qt;
  int32_t* qbd;  // block << 5 | destination node
  int32_t* qs;
  int32_t* fl;   // free slots in index order, built per push
  int32_t* pend; // [32, F]
  Ledger g;      // this lane's rows
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
    uint2 ks[2];
    split_n(lane_key, 2, ks);
    key = ks[0];
    next_act = __dmul_rn(exponential64(ks[1], 0), ad);
    __syncwarp();
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
    if (deliver && g.height[b] > g.height[pref]) pref = b;
    __syncwarp();
    return deliver;
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
        const int p = mine[f];
        if (p >= 0) {
          const int par = g.parent[p];
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
        const int p = mine[f];
        if (p >= 0) {
          const int par = g.parent[p];
          if (par < 0 || ((g.vis[par] >> t) & 1u)) {
            put(rank++, n_place, now2, p, t);
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
    if (t == 0) {
      g.parent[nb] = parent;
      g.height[nb] = g.height[parent] + 1;
      g.miner[nb] = m;
      g.vis[nb] = 1u << m;
      g.known[nb] = 1u << m;
    }
    __syncwarp();
    return true;
  }

  // One engine step (engine.py:189-597; attack.py:151-357).
  __device__ void step() {
    uint2 ks[5];
    split_n(key, kAttack ? 4 : 5, ks);
    const uint2 k_mine = ks[1];
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
    const bool act_now = can_act && next_act <= tmin;
    const bool recv_ok = has_q && !(!can_act && tmin >= next_act);
    const bool is_act = !is_rel && act_now;
    const bool is_recv = !is_rel && !act_now && recv_ok;
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
    if (is_act) {
      const float* lw = logw;
      const int m = draw_miner(k_mine, 0, lw, N);
      next_act = __dadd_rn(next_act, __dmul_rn(exponential64(k_next, 0), ad));
      ++n_act;
      if (t == m) ++node_act;
      const bool atk = kAttack && m == 0;
      const int parent = atk ? priv : __shfl_sync(kFull, pref, m);
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
    push(deliver, send, s_blk, now2, k_delay);
    key = ks[0];
    now = now2;
    ++steps;
    tmin = queue_min();
    bool rel_pending = false;
    if (kAttack && wq_head < wq_tail)
      rel_pending = g.height[g.wq[wq_head]] <= rel_h;
    live = rel_pending || n_act < g.A ||
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

  bool flooding = false;
};

// Dynamic shared memory of one warp (one block) for queue capacity M and
// pending capacity F.
__host__ __device__ inline size_t event_smem(int M, int F) {
  return (size_t)M * (sizeof(double) + 3 * sizeof(int32_t)) +
         (size_t)32 * F * sizeof(int32_t);
}

// One warp (one block) a lane: init, steps while live and under S, then
// the winner and the reward walk.
template <bool kAttack>
__global__ void __launch_bounds__(32)
event_kernel(LaneIn in, Ledger led, Planes pl, int flooding, Out out) {
  const int64_t lane = blockIdx.x;
  if (lane >= in.n_lanes) return;
  extern __shared__ double smem[];
  EventLane<kAttack> L;
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
  L.pl = pl;
  L.logw = kAttack ? pl.logw + lane * pl.n : pl.logw;
  L.t = threadIdx.x & 31;
  L.N = pl.n;
  L.ad = in.delays[lane];
  L.flooding = flooding != 0;
  L.init(in.keys[lane]);
  while (L.live && L.steps < led.S) L.step();

  const int t = L.t, N = L.N;
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

template <bool kAttack>
cudaError_t launch_event(const LaneIn& in, const Ledger& led,
                         const Planes& pl, int flooding, const Out& out,
                         cudaStream_t stream) {
  if (in.n_lanes <= 0) return cudaSuccess;
  const size_t smem = event_smem(led.M, led.F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        event_kernel<kAttack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  event_kernel<kAttack><<<(unsigned)in.n_lanes, 32, smem, stream>>>(
      in, led, pl, flooding, out);
  return cudaGetLastError();
}

}  // namespace netsim
}  // namespace cpr
