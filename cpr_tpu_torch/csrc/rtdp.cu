// Kernel K6: batched eps-greedy RTDP walkers over an explicit MDP, the
// whole walk in one launch.
//
// Replaces: cpr_tpu/mdp/explicit.py:884-943 `_rtdp_loop` (the scan: a
// fixed number of steps, keys split 5 ways a step) and
// cpr_tpu/mdp/rtdp_graph.py:51-131 `_rtdp_graph_loop` (the while loop:
// keys split 7 ways, visit counters, a top-k priority buffer of the
// largest backup deltas feeding restarts, the damped residual stop).
// Plain twin: cpr_tpu_torch/mdp/explicit.py `_rtdp_plain`.
//
// A step, for each of B walkers on state s: Q of every valid action from
// the step's V (sums over the action's rows in row order), the greedy
// backup written to V[s] and P[s], visits[s] += 1, then the eps-greedy
// behaviour action, a successor drawn from its rows, and a restart (from
// the start CDF, or in graph mode from the buffer with probability
// restart_p) where the successor has no valid action. The draws are
// jax.random's for the same key, element by element of jax's noise
// planes under jax_threefry_partitionable: the eps uniform [B] at b, the
// action gumbel [B, A] at b*A+a, the successor gumbel [B, K] at b*K+j
// (K the table's longest segment, padding slots with logit log(1e-30)),
// the start uniform [B] at b, and in graph mode the restart pick's gumbel
// [B, cap] at b*cap+j (categorical(shape=(B,)) lays the samples out
// first). Counter-based draws let a walker compute only the noise it
// uses. XLA:CPU contracts JAX's Q reduction into fused multiply-adds
// (x = fma(discount, V[dst], reward), q = fma(prob, x, q)), so this
// kernel calls fmaf there.
//
// Bound: latency. A step depends on the previous step's V, and B is small
// (256), so the loop is a chain of dependent global loads and block-wide
// barriers with little work per step: per walker ~2 segments of ~2.4 rows
// (16 bytes each, plus the V and P gathers) and about 25 threefry blocks
// (split, A + K + 2 gumbel/uniform draws). Design: one persistent block,
// no host round trips, as lax.while_loop runs: each thread owns walkers
// (b = tid, tid + blockDim, ...), barriers separate reading V (the
// backups) from writing it, so duplicate walkers write the same value;
// visits count every duplicate by an integer atomicAdd (deterministic);
// the buffer merge gives each of the cap + B entries its rank in
// (priority descending, older first) — what lax.top_k returns — and
// scatters the first cap into the other of two buffers; a restart from
// the buffer (up to cap gumbel draws) is shared by a warp; the stop rule
// is evaluated by the block. The residual peak is an atomicMax on the bits
// of deltas >= 0 (order-free).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "mdp_table.cuh"
#include "threefry.cuh"

namespace cpr {

// Laid out like `_RtdpArgs` in cpr_tpu_torch/kernels/__init__.py.
struct RtdpArgs {
  float* V;             // [S] values, updated in place
  float* P;             // [S] progress, updated in place
  int32_t* visits;      // [S] zeroed by the caller
  int32_t* buf_s[2];    // [cap] each: the buffer's state ids (ping-pong)
  float* buf_pri[2];    // [cap] each: priorities; buf_pri[0] starts -inf
  int32_t* walkers;     // [B] out: the walkers' states after the loop
  const float* cdf;     // [S] the start distribution's CDF
  int64_t* t_out;       // [1] steps run
  float* resid_out;     // [1] the damped residual at exit
  int64_t max_steps;
  uint32_t key0, key1;  // the key's two words
  int32_t batch, cap, graph, pad;
  float eps, restart_p, discount, stop_delta, decay;
};

}  // namespace cpr

namespace {

constexpr int kMaxThreads = 1024;

// jax's draw_start: u = uniform(k, (B,))[b] * cdf[-1], then
// searchsorted(cdf, u, side="right") clipped to S - 1.
__device__ int draw_start(uint2 k, int b, const float* __restrict__ cdf,
                          int64_t S) {
  const float u =
      __fmul_rn(cpr::uniform_of_bits(cpr::random_bits(k, (uint32_t)b)),
                cdf[S - 1]);
  int64_t lo = 0, hi = S;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (cdf[mid] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (int)(lo < S - 1 ? lo : S - 1);
}

__device__ bool any_valid(const cpr::SweepTable& tb, int s) {
  for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k)
    if (tb.seg_valid[k]) return true;
  return false;
}

__global__ void __launch_bounds__(kMaxThreads)
    rtdp_kernel(cpr::SweepTable tb, cpr::RtdpArgs a, int K) {
  extern __shared__ unsigned char smem[];
  const int B = a.batch, NT = blockDim.x, tid = threadIdx.x;
  int* cur = reinterpret_cast<int*>(smem);       // [B] walker states
  float* nv = reinterpret_cast<float*>(cur + B);  // [B] backed-up values
  float* np = nv + B;                             // [B] backed-up progress
  int* agr = reinterpret_cast<int*>(np + B);      // [B] greedy action
  float* dl = reinterpret_cast<float*>(agr + B);  // [B] |V' - V|
  int* pickq = reinterpret_cast<int*>(dl + B);    // [B] buffer restarts
  __shared__ float resid;
  __shared__ unsigned dmax;
  __shared__ int n_pick;

  const float* __restrict__ prob = static_cast<const float*>(tb.prob);
  const float* __restrict__ reward = static_cast<const float*>(tb.reward);
  const float* __restrict__ progress =
      static_cast<const float*>(tb.progress);
  const int64_t S = tb.n_states;
  const int A = tb.n_actions;
  float* V = a.V;
  float* P = a.P;

  // key, k0 = split(key)
  const uint2 key = make_uint2(a.key0, a.key1);
  uint2 kc = cpr::split_key(key, 0u);
  const uint2 k0 = cpr::split_key(key, 1u);
  for (int b = tid; b < B; b += NT) cur[b] = draw_start(k0, b, a.cdf, S);
  if (tid == 0) {
    resid = CUDART_INF_F;
    dmax = 0u;
  }
  int pp = 0;  // which buffer holds the current top-cap
  int64_t t = 0;
  __syncthreads();

  while (t < a.max_steps && (!a.graph || resid > a.stop_delta)) {
    uint2 ks[7];
    const int nk = a.graph ? 7 : 5;
    for (int i = 0; i < nk; ++i) ks[i] = cpr::split_key(kc, (uint32_t)i);

    // 1. greedy backups from this step's V
    for (int b = tid; b < B; b += NT) {
      const int s = cur[b];
      int best = -1;
      float bv = 0.f, bp = 0.f;
      for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
        if (!tb.seg_valid[k]) continue;
        float q = 0.f, qp = 0.f;
        for (int r = tb.seg_ptr[k], re = tb.seg_ptr[k + 1]; r < re; ++r) {
          const int d = tb.dst[r];
          q = fmaf(prob[r], fmaf(a.discount, V[d], reward[r]), q);
          qp = fmaf(prob[r], fmaf(a.discount, P[d], progress[r]), qp);
        }
        // segments come in action order: strict > keeps the lowest action
        if (best < 0 || q > bv) {
          best = tb.seg_act[k];
          bv = q;
          bp = qp;
        }
      }
      nv[b] = bv;
      np[b] = bp;
      agr[b] = best;
      dl[b] = fabsf(bv - V[s]);
    }
    __syncthreads();

    // 2. write the backups; duplicates write equal values (the restart
    //    queue is emptied here, between barriers no reader crosses)
    if (tid == 0) n_pick = 0;
    for (int b = tid; b < B; b += NT) {
      const int s = cur[b];
      V[s] = nv[b];
      P[s] = np[b];
      atomicAdd(&a.visits[s], 1);
      atomicMax(&dmax, __float_as_uint(dl[b]));
    }
    __syncthreads();

    // 3. (graph) merge this step's deltas into the top-cap buffer: rank
    //    in concat([buffer, deltas]) by (priority desc, index asc)
    const float* bpri = a.buf_pri[pp];
    const int32_t* bsid = a.buf_s[pp];
    if (a.graph) {
      float* npri = a.buf_pri[pp ^ 1];
      int32_t* nsid = a.buf_s[pp ^ 1];
      const int cap = a.cap;
      for (int i = tid; i < cap; i += NT) {
        const float x = bpri[i];
        int r = i;
        for (int c = 0; c < B; ++c) r += dl[c] > x;
        if (r < cap) {
          npri[r] = x;
          nsid[r] = bsid[i];
        }
      }
      for (int b = tid; b < B; b += NT) {
        const float x = dl[b];
        int lo = 0, hi = cap;  // buffer entries >= x (sorted descending)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (bpri[mid] >= x)
            lo = mid + 1;
          else
            hi = mid;
        }
        int r = lo;
        for (int c = 0; c < B; ++c) r += dl[c] > x || (dl[c] == x && c < b);
        if (r < cap) {
          npri[r] = x;
          nsid[r] = cur[b];
        }
      }
      pp ^= 1;
      bpri = npri;
      bsid = nsid;
      __syncthreads();
    }

    // 4. behaviour action, successor, restarts
    for (int b = tid; b < B; b += NT) {
      const int s = cur[b];
      const bool has = agr[b] >= 0;
      int a_rand = 0;
      bool seen = false;
      float gbest = 0.f;
      for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k) {
        if (!tb.seg_valid[k]) continue;
        const int act = tb.seg_act[k];
        const float g = cpr::gumbel_of_bits(
            cpr::random_bits(ks[1], (uint32_t)(b * A + act)));
        if (!seen || g > gbest) {
          seen = true;
          gbest = g;
          a_rand = act;
        }
      }
      const bool explore =
          cpr::uniform_of_bits(cpr::random_bits(ks[2], (uint32_t)b)) < a.eps;
      const int ab = has ? (explore ? a_rand : agr[b]) : 0;
      int r0 = 0, len = 0;
      for (int k = tb.state_seg[s], ke = tb.state_seg[s + 1]; k < ke; ++k)
        if (tb.seg_act[k] == ab) {
          r0 = tb.seg_ptr[k];
          len = tb.seg_ptr[k + 1] - r0;
          break;
        }
      int nxt = 0;
      float zbest = 0.f;
      for (int j = 0; j < K; ++j) {
        const float p = j < len ? prob[r0 + j] : 0.f;
        const float z = __fadd_rn(
            cpr::gumbel_of_bits(
                cpr::random_bits(ks[3], (uint32_t)(b * K + j))),
            logf(__fadd_rn(p, 1e-30f)));
        if (j == 0 || z > zbest) {
          zbest = z;
          nxt = j;
        }
      }
      int sn = nxt < len ? tb.dst[r0 + nxt] : 0;
      if (!(has && any_valid(tb, sn))) {
        if (a.graph) {
          // the filled entries (priority > 0) are a prefix of the sorted
          // buffer; unfilled logits are -inf and never win
          const bool use_buf =
              cpr::uniform_of_bits(cpr::random_bits(ks[5], (uint32_t)b)) <
                  a.restart_p &&
              bpri[0] > 0.f;
          if (use_buf) {
            pickq[atomicAdd(&n_pick, 1)] = b;  // drawn by a warp below
            continue;
          } else {
            sn = draw_start(ks[6], b, a.cdf, S);
          }
        } else {
          sn = draw_start(ks[4], b, a.cdf, S);
        }
      }
      cur[b] = sn;
    }

    // 4b. (graph) buffer restarts: the pick is an argmax of gumbel noise
    //     over the filled prefix of the buffer (up to cap draws), so a
    //     warp shares each: lane l draws j = l, l + 32, ..., then the
    //     warp keeps the largest, the lowest index among equals
    if (a.graph) {
      __syncthreads();
      const int lane = tid & 31, warp = tid >> 5, n_warps = NT >> 5;
      for (int q = warp; q < n_pick; q += n_warps) {
        const int b = pickq[q];
        float best = -CUDART_INF_F;
        int pick = a.cap;
        for (int j = lane; j < a.cap && bpri[j] > 0.f; j += 32) {
          const float g = cpr::gumbel_of_bits(
              cpr::random_bits(ks[4], (uint32_t)(b * a.cap + j)));
          if (g > best) {
            best = g;
            pick = j;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_down_sync(0xffffffffu, best, o);
          const int oj = __shfl_down_sync(0xffffffffu, pick, o);
          if (ob > best || (ob == best && oj < pick)) {
            best = ob;
            pick = oj;
          }
        }
        if (lane == 0) cur[b] = bsid[pick];
      }
    }

    // 5. the damped residual peak; the inf sentinel of step 0 is replaced
    if (tid == 0) {
      if (a.graph) {
        const float r = isinf(resid) ? 0.f : __fmul_rn(resid, a.decay);
        resid = fmaxf(r, __uint_as_float(dmax));
      }
      dmax = 0u;
    }
    kc = ks[0];
    ++t;
    __syncthreads();
  }

  for (int b = tid; b < B; b += NT) a.walkers[b] = cur[b];
  if (a.graph && pp == 1)
    for (int i = tid; i < a.cap; i += NT) {
      a.buf_pri[0][i] = a.buf_pri[1][i];
      a.buf_s[0][i] = a.buf_s[1][i];
    }
  if (tid == 0) {
    *a.t_out = t;
    *a.resid_out = resid;
  }
}

}  // namespace

extern "C" {

// K6: the whole RTDP loop in one single-block launch of `threads`
// threads (a multiple of 32) on `stream`; the walkers' scratch is
// 24 * batch bytes of dynamic shared memory. Returns the launch status.
cudaError_t cpr_k6_rtdp(const cpr::SweepTable* tb, const cpr::RtdpArgs* a,
                        int K, int threads, void* stream) {
  if (tb->n_states <= 0 || a->batch <= 0) return cudaSuccess;
  rtdp_kernel<<<1, threads, 24 * (size_t)a->batch, (cudaStream_t)stream>>>(
      *tb, *a, K);
  return cudaGetLastError();
}

const char* cpr_k6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
