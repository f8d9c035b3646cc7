// Kernel K12-scan: the netsim's Nakamoto fast path for simple
// dissemination, one lane a (seed, activation delay) simulation of
// `activations` blocks.
//
// Replaces: cpr_tpu/netsim/engine.py:716-918 `_scan_lane_fn`. Plain twin:
// cpr_tpu_torch/netsim/engine.py `scan_plain`.
//
// Semantics. With simple dissemination every block goes once down each
// link at mint, so mint times t (a running sum of exponential gaps times
// the activation delay), miners (a Gumbel draw over the nodes' compute)
// and arrival times are independent of the state. The sequential part is
// each miner's preference at its activation: the best (height, earliest
// arrival) block visible to it, over a window of the last `lookback` L
// blocks, and a running best of the older ones (every block must have
// landed everywhere before it leaves the window, else `win_miss`). After
// the last activation, a per-node fold at t[A] (the first activation
// never executed) picks the winner; a walk down its chain counts the
// rewards.
//
// Design: one warp per lane; ring slot q of the window is held by thread
// q % 32 (q / 32 < KS slots a thread, L <= 32 * KS): its height, mint
// time, miner and block index. Node n is held by thread n % 32 in its
// slot n / 32 (NS node slots a thread, N <= 32 * NS; netsim.cuh). Nothing
// is presampled: the gaps are drawn 32 at a time and summed in order
// through shuffles (a first pass finds t[A], which the preference key's
// scale and the drain need), the miner's Gumbel row is drawn when its
// step comes, NS nodes a thread, and a random link delay is drawn where
// an arrival is asked for, from its counter (block * N + node) of the
// same key. The old-best fold stays in
// registers; the parents and miners go to a [lanes, A] scratch for the
// reward walk. Where every link is one constant D (the symmetric
// cliques; `kConst`) an arrival is t + D off the miner's node.
//
// Bound: the threefry work, one block for each miner draw per node and
// gap, two for each random delay asked. The steps are dependent, so a
// launch is latency-bound: about 10^4 warp steps of a few hundred
// instructions each.
//
// Parity: the gaps are summed in order, left to right, as in the plain
// version (XLA:CPU's float64 cumsum adds in another order, so the times
// equal the JAX package's to ~1e-12 relative); integer outputs are the
// plain version's wherever no two preference keys are closer than that.

#include <cuda_runtime.h>

#include <cstdint>

#include "netsim.cuh"

namespace {

using cpr::netsim::kFull;
using cpr::netsim::Out;
using cpr::netsim::Planes;

constexpr int kWarps = 4;  // lanes (warps) per block

struct ScanArgs {
  const uint2* keys;     // [lanes]
  const double* delays;  // [lanes] activation delays
  int32_t* parents;      // [lanes, A] scratch
  int32_t* miners;       // [lanes, A] scratch
  int64_t n_lanes;
  int32_t A;
  int32_t L;             // lookback, <= A
  double D;              // the constant link delay (kConst)
};

// Arrival time at node n of block g minted at tg by miner mg.
template <bool kConst>
__device__ __forceinline__ double arrival(const Planes& pl, uint2 k_u,
                                          uint2 k_e, double D, int g,
                                          double tg, int mg, int n) {
  if (n == mg) return tg;
  if (kConst) return __dadd_rn(tg, D);
  const int e = mg * pl.n + n;
  if (pl.kind[e] < 0) return INFINITY;
  return __dadd_rn(tg, cpr::netsim::link_delay(
                           pl, e, k_u, k_e, (uint32_t)(g * pl.n + n)));
}

// (key, block index, height) with the larger key, the smaller index among
// equal keys.
__device__ __forceinline__ void take_best(double& k, int& g, int& h,
                                          double k2, int g2, int h2) {
  if (k2 > k || (k2 == k && g2 < g)) {
    k = k2;
    g = g2;
    h = h2;
  }
}

__device__ __forceinline__ void warp_best(double& k, int& g, int& h) {
  for (int o = 16; o > 0; o >>= 1) {
    const double k2 = __shfl_xor_sync(kFull, k, o);
    const int g2 = __shfl_xor_sync(kFull, g, o);
    const int h2 = __shfl_xor_sync(kFull, h, o);
    take_best(k, g, h, k2, g2, h2);
  }
}

__device__ __forceinline__ double pref_key(int h, double big, double a) {
  return __dsub_rn(__dmul_rn((double)h, big), a);
}

template <bool kConst, int KS, int NS>
__global__ void __launch_bounds__(32 * kWarps)
scan_kernel(ScanArgs a, Planes pl, Out out) {
  const int64_t lane = blockIdx.x * (int64_t)kWarps + (threadIdx.x >> 5);
  if (lane >= a.n_lanes) return;
  const int t = threadIdx.x & 31;
  const int N = pl.n, A = a.A, L = a.L;
  uint2 ks[3];
  cpr::netsim::split_n(a.keys[lane], 3, ks);
  const uint2 k_gap = ks[0], k_mine = ks[1];
  const uint2 k_u = cpr::split_key(ks[2], 0), k_e = cpr::split_key(ks[2], 1);
  const double ad = a.delays[lane];

  // pass 1: t[A], the cutoff (the first activation never executed)
  double cum = 0.0;
  for (int base = 0; base <= A; base += 32) {
    const double g =
        base + t <= A ? cpr::netsim::exponential64(k_gap, base + t) : 0.0;
    for (int k = 0; k < 32 && base + k <= A; ++k)
      cum = __dadd_rn(cum, __shfl_sync(kFull, g, k));
  }
  const double tA = __dmul_rn(cum, ad);
  const double big = __dadd_rn(__dmul_rn(2.0, tA), 4.0);

  int sh[KS], sm[KS], sg[KS];
  double st[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) sg[k] = -1;
  int hmax_old = 0, bidx_old = 0, m_old = -1;
  double t_old = 0.0;
  int node_act[NS], miss = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) node_act[s] = 0;
  double sim_max = -INFINITY, t_i = 0.0;
  double gap = 0.0;
  cum = 0.0;
  int32_t* par = a.parents + lane * A;
  int32_t* mnr = a.miners + lane * A;

  for (int i = 0; i < A; ++i) {
    if ((i & 31) == 0)
      gap = i + t <= A ? cpr::netsim::exponential64(k_gap, i + t) : 0.0;
    cum = __dadd_rn(cum, __shfl_sync(kFull, gap, i & 31));
    t_i = __dmul_rn(cum, ad);
    const int mi = cpr::netsim::draw_miner<NS>(k_mine, (uint32_t)(i * N),
                                               pl.logw, N);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int nd = s * 32 + t;
      if (nd == mi) ++node_act[s];
      if (nd < N) {  // this block's arrival at node nd, for sim_time
        const double ar =
            arrival<kConst>(pl, k_u, k_e, a.D, i, t_i, mi, nd);
        if (ar < tA) sim_max = fmax(sim_max, ar);
      }
    }

    // the window's best visible block at the miner
    double kw = -INFINITY;
    int gw = A, hw = 0;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (sg[k] >= 0) {
        const double col =
            arrival<kConst>(pl, k_u, k_e, a.D, sg[k], st[k], sm[k], mi);
        const double key = col < t_i ? pref_key(sh[k], big, col) : -INFINITY;
        take_best(kw, gw, hw, key, sg[k], sh[k]);
      }
    }
    // with nothing visible (kw = -inf) the old best wins the >= below
    warp_best(kw, gw, hw);
    const double arr_old =
        bidx_old == 0 ? 0.0
                      : arrival<kConst>(pl, k_u, k_e, a.D, bidx_old - 1,
                                        t_old, m_old, mi);
    const bool use_old = pref_key(hmax_old, big, arr_old) >= kw;
    const int parent = use_old ? bidx_old : gw + 1;
    const int h_i = (use_old ? hmax_old : hw) + 1;
    if (t == 0) {
      par[i] = parent;
      mnr[i] = mi;
    }

    const int q = i % L, owner = q & 31, kq = q >> 5;
    if (i >= L) {  // block i - L leaves the window
      int hl = 0, ml = 0;
      double tl = 0.0;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (k == kq) {
          hl = sh[k];
          ml = sm[k];
          tl = st[k];
        }
      hl = __shfl_sync(kFull, hl, owner);
      ml = __shfl_sync(kFull, ml, owner);
      tl = __shfl_sync(kFull, tl, owner);
      const int r = i - L;
      bool late = false;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int nd = s * 32 + t;
        if (nd < N) {
          const double ar =
              arrival<kConst>(pl, k_u, k_e, a.D, r, tl, ml, nd);
          late = late || (isfinite(ar) && ar > t_i);
        }
      }
      if (__any_sync(kFull, late)) ++miss;
      if (hl > hmax_old) {
        hmax_old = hl;
        bidx_old = r + 1;
        t_old = tl;
        m_old = ml;
      }
    }
    if (t == owner) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (k == kq) {
          sh[k] = h_i;
          st[k] = t_i;
          sm[k] = mi;
          sg[k] = i;
        }
    }
  }

  // drain: each node's best at the cutoff, the window against the old best
  double kb[NS];
  int gb[NS], hb[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    kb[s] = -INFINITY;
    gb[s] = A;
    hb[s] = 0;
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    for (int src = 0; src < 32; ++src) {
      const int g = __shfl_sync(kFull, sg[k], src);
      if (g < 0) continue;  // uniform over the warp
      const int h = __shfl_sync(kFull, sh[k], src);
      const int mg = __shfl_sync(kFull, sm[k], src);
      const double tg = __shfl_sync(kFull, st[k], src);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int nd = s * 32 + t;
        if (nd < N) {
          const double ar = arrival<kConst>(pl, k_u, k_e, a.D, g, tg, mg, nd);
          const double key = ar < tA ? pref_key(h, big, ar) : -INFINITY;
          take_best(kb[s], gb[s], hb[s], key, g, h);
        }
      }
    }
  }
  // each node's best height and block; the first node of the best height
  int best = -1, j_star = NS == 1 ? 32 : cpr::netsim::kNoNode;
  int bidx[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int nd = s * 32 + t;
    bidx[s] = 0;
    if (nd < N) {
      const double arr_old =
          bidx_old == 0 ? 0.0
                        : arrival<kConst>(pl, k_u, k_e, a.D, bidx_old - 1,
                                          t_old, m_old, nd);
      const bool use_old = pref_key(hmax_old, big, arr_old) >= kb[s];
      const int bh = use_old ? hmax_old : hb[s];
      bidx[s] = use_old ? bidx_old : gb[s] + 1;
      if (s == 0 || bh > best) {
        best = bh;
        j_star = nd;
      }
    }
  }
  cpr::netsim::warp_argmax(best, j_star);
  const int head = cpr::netsim::slot_value<NS>(bidx, j_star);
  __syncwarp();  // the scratch rows are read back by other threads

  int count[NS];
  cpr::netsim::chain_rewards<NS>(head, A, par, mnr, 1, N, count);
  sim_max = cpr::netsim::warp_max(sim_max);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int nd = s * 32 + t;
    if (nd < N) {
      out.node_act[lane * N + nd] = node_act[s];
      out.reward[lane * N + nd] = (float)count[s];
    }
  }
  if (t == 0) {
    out.head[lane] = head;
    out.head_height[lane] = best;
    out.sim_time[lane] = fmax(t_i, sim_max);
    out.n_blocks[lane] = A;
    out.n_act[lane] = A;
    out.steps[lane] = A;
    out.drop_q[lane] = 0;
    out.drop_p[lane] = 0;
    out.drop_b[lane] = 0;
    out.win_miss[lane] = miss;
    out.exhausted[lane] = false;
  }
}

template <bool kConst, int KS, int NS>
cudaError_t launch(const ScanArgs& a, const Planes& pl, const Out& out,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n_lanes + kWarps - 1) / kWarps);
  scan_kernel<kConst, KS, NS><<<blocks, 32 * kWarps, 0, stream>>>(a, pl,
                                                                 out);
  return cudaGetLastError();
}

// The window's ring slots a thread: 1, 2, 4 or 8 up to 32 nodes; past
// them 1 or 8 (a lookback over 32 on a wide network scans 8 slots, the
// unused ones empty), which keeps the instantiations, and nvcc's time,
// down.
template <bool kConst, int NS>
cudaError_t launch_ks(const ScanArgs& a, const Planes& pl, const Out& out,
                      cudaStream_t stream) {
  if (a.L <= 32) return launch<kConst, 1, NS>(a, pl, out, stream);
  if constexpr (NS == 1) {
    if (a.L <= 64) return launch<kConst, 2, NS>(a, pl, out, stream);
    if (a.L <= 128) return launch<kConst, 4, NS>(a, pl, out, stream);
  }
  return launch<kConst, 8, NS>(a, pl, out, stream);
}

// The node buckets of the scan: 1 slot a thread up to 32 nodes, else the
// 8-slot build (33-256 nodes, the unused slots empty), which keeps the
// instantiations, and nvcc's time, down.
template <bool kConst>
cudaError_t launch_ns(const ScanArgs& a, const Planes& pl, const Out& out,
                      cudaStream_t stream) {
  if (cpr::netsim::node_slots(pl.n) == 1)
    return launch_ks<kConst, 1>(a, pl, out, stream);
  return launch_ks<kConst, 8>(a, pl, out, stream);
}

}  // namespace

extern "C" {

// K12-scan launch: keys [lanes, 2] uint32 (64-bit mode keys), delays
// [lanes] f64, the planes (logw [N] f32), scratch parents/miners [lanes, A]
// int32; `uniform_const` with the constant delay D where every link is D.
// A >= 1, 1 <= L <= min(A, 256), N <= 256 (checked by the wrapper).
cudaError_t cpr_k12_scan(const void* keys, const void* delays, void* parents,
                         void* miners, int64_t n_lanes, int A, int L,
                         int uniform_const, double D, const Planes* pl,
                         const Out* out, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  ScanArgs a{static_cast<const uint2*>(keys),
             static_cast<const double*>(delays),
             static_cast<int32_t*>(parents),
             static_cast<int32_t*>(miners),
             n_lanes, A, L, D};
  cudaStream_t s = (cudaStream_t)stream;
  if (pl->n > 32 * cpr::netsim::kMaxSlots) return cudaErrorInvalidValue;
  return uniform_const ? launch_ns<true>(a, *pl, *out, s)
                       : launch_ns<false>(a, *pl, *out, s);
}

const char* cpr_k12_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
