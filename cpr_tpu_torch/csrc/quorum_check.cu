// K9's check kernel: every function of K9 (csrc/quorum.cuh) on a batch of
// lane DAGs and selector inputs, one warp per lane, its outputs written
// out whole. It exists to hold K9 against its plain twin
// (cpr_tpu_torch/envs/quorum.py `check_plain`) and the JAX package's
// envs/quorum.py apart from the env kernels that run it.
//
// Per lane: the candidate frame of `cand` (slots, validity, closure
// rows); the three selections (heuristic, altruistic, optimal with its
// fallback), each as found, leaves and parent row; the release sets of
// the withheld non-stale vertices against (pub, priv) under the env's
// preference (Tailstorm: (height, votes, the defender's own reward) with
// auxg as the tiebreak; Stree: (height, votes)); the stale plane after an
// Adopt to pub.
//
// Bound: as K9 — warp-collective latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "vote_env.cuh"

namespace cpr {

struct CheckIn {
  const bool* cand;     // [L, W]
  const bool* own;      // [L, W]
  const float* seen;    // [L, W]
  const float* score;   // [L, W]
  const bool* stale;    // [L, W]
  const int32_t* pub;   // [L]
  const int32_t* priv;  // [L]
};

struct CheckCfg {
  int32_t env;  // 0 Tailstorm, 1 Stree
  int32_t C, q, k, width, window, discount, punish, depth_plus, miner_share,
      R;
};

struct CheckOut {
  int32_t* cidx;   // [L, C]
  bool* cvalid;    // [L, C]
  bool* abits;     // [L, C, C]
  bool* found;     // [3, L]
  bool* leaves;    // [3, L, C]
  int32_t* row;    // [3, L, width]
  bool* ovr;       // [L, W]
  bool* mat;       // [L, W]
  bool* rfound;    // [L]
  int32_t* head;   // [L]
  bool* stale;     // [L, W]
};

}  // namespace cpr

namespace {

using namespace cpr;

__global__ void __launch_bounds__(32 * kQWarps)
quorum_check_kernel(const __grid_constant__ DagPtrs dp, CheckIn in,
                    CheckCfg cfg, int64_t n_lanes, CheckOut out) {
  const int64_t lane = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (lane >= n_lanes) return;
  LaneDag g;
  g.bind(dp, lane);
  g.load_scalars();
  QScratch& q = q_scratch();
  const int t = g.t, W = g.W, C = cfg.C;
  const int64_t L = n_lanes;
  const Mask cand = g.bools(in.cand);
  const QFrame f = candidate_frame(g, q, cand, C, 1);
  for (int i = t; i < C; i += 32) {
    out.cidx[lane * C + i] = i < f.nC ? q.cidx[i] : kNone;
    out.cvalid[lane * C + i] = bit(f.cvalid, i);
    for (int j = 0; j < C; ++j)
      out.abits[(lane * C + i) * C + j] = bit(q.abits[i], j);
  }
  const uint64_t own = cbits(g, q, f, in.own);
  auto score = [&](int32_t s) { return in.score[lane * W + s]; };
  for (int sel = 0; sel < 3; ++sel) {
    uint64_t leaves = 0;
    bool found;
    if (sel == 0) {
      found = q_heuristic(g, q, f, own & f.cvalid, cfg.q, leaves);
    } else if (sel == 1) {
      int n_cand;
      const int n = q_altruistic(g, q, f, own, in.seen, g.d->aux, cfg.q,
                                 leaves, n_cand);
      found = n == cfg.q && n_cand >= cfg.q;
    } else {
      OptimalArgs a;
      a.window = cfg.window;
      a.k = cfg.k;
      a.depth_plus = cfg.depth_plus;
      a.miner_share = cfg.miner_share;
      a.discount = cfg.discount != 0;
      a.punish = cfg.punish != 0;
      found = q_optimal_or_heuristic(g, q, f, own & f.cvalid, g.d->aux, score,
                                     cfg.q, a, leaves);
    }
    int32_t row[kMaxTopK];
    leaves_to_row(g, q, f, leaves, score, cfg.width, row);
    const int64_t sl = sel * L + lane;
    if (t == 0) out.found[sl] = found;
    for (int i = t; i < C; i += 32) out.leaves[sl * C + i] = bit(leaves, i);
    if (t == 0)
      for (int i = 0; i < cfg.width; ++i) out.row[sl * cfg.width + i] = row[i];
  }
  const int32_t pub = in.pub[lane], priv = in.priv[lane];
  const Mask stale = g.bools(in.stale);
  const Mask cands = g.exists() & ~g.bools(g.d->vis_d) & ~stale;
  const int env = cfg.env;
  const Release rel = prefix_release_sets(
      g, q, pub, priv, cands, cfg.R, 0, env == 0 ? g.d->auxg : nullptr,
      [&]() {
        const Mask filter = g.bools(g.d->vis_d) | cands;
        return env == 0 ? cmp_summaries(g, priv, pub, filter, kDef)
                        : cmp_blocks(g, priv, pub, filter);
      });
  const Mask st = stale_after_adopt(g, pub, stale);
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (!g.in(j)) continue;
    const int64_t o = lane * W + g.slot(j);
    out.ovr[o] = (rel.ovr >> j) & 1u;
    out.mat[o] = (rel.mat >> j) & 1u;
    out.stale[o] = (st >> j) & 1u;
  }
  if (t == 0) {
    out.rfound[lane] = rel.found;
    out.head[lane] = rel.head;
  }
}

}  // namespace

extern "C" {

// K9 check launch over the DAGs `dp` (read only); see CheckIn/CheckOut.
cudaError_t cpr_k9_quorum_check(const cpr::DagPtrs* dp,
                                const cpr::CheckIn* in,
                                const cpr::CheckCfg* cfg, int64_t n_lanes,
                                const cpr::CheckOut* out, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  quorum_check_kernel<<<(unsigned)((n_lanes + cpr::kQWarps - 1) /
                                   cpr::kQWarps),
                        32 * cpr::kQWarps, 0, (cudaStream_t)stream>>>(
      *dp, *in, *cfg, n_lanes, *out);
  return cudaGetLastError();
}

const char* cpr_k9_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
