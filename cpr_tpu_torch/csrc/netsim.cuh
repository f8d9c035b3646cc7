// Device functions shared by the netsim kernels K12-scan
// (netsim_scan.cu), K12-event (netsim_event.cu) and K13
// (netsim_attack.cu): the float64 draws, the per-link delay sampler, the
// miner draw, warp reductions and the reward walk down a chain.
//
// Replaces: cpr_tpu/netsim/compile.py:75-99 `sample_delay_matrix`, the
// `jax.random.categorical` miner draws (engine.py:298,777, attack.py:225)
// and the Nakamoto reward walks (engine.py:638-687, :886-898,
// attack.py:371-379). Plain twins: cpr_tpu_torch/netsim/compile.py
// `sample_delay_matrix`, engine.py `scan_plain`/`event_plain`,
// attack.py `attack_plain`.
//
// Layout: one warp per lane, one node per thread (N <= 32; the wrappers
// refuse more). Float64 arithmetic is written with __dadd_rn/__dmul_rn so
// nvcc forms no FMA the plain versions do not; log, log1p and ceil may
// differ from the host's by an ULP.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace cpr {
namespace netsim {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr double kGeomTailClamp = 1e-12;  // distributions.GEOM_TAIL_CLAMP

// The topology's per-link delay planes, row-major src * n + dst.
struct Planes {
  const int32_t* kind;  // -1 no link, 0 constant, 1 uniform, 2 exp, 3 geom
  const double* p0;
  const double* p1;
  const float* logw;    // [n] log(compute), or per lane [lanes, n] (K13)
  int32_t n;
};

// Per-lane outputs (cpr_tpu_torch/kernels/__init__.py `_NetOut`).
struct Out {
  int32_t* head;
  int32_t* head_height;
  double* sim_time;
  int32_t* n_blocks;
  int32_t* n_act;
  int32_t* node_act;  // [lanes, n]
  float* reward;      // [lanes, n]
  int32_t* steps;
  int32_t* drop_q;
  int32_t* drop_p;
  int32_t* drop_b;
  int32_t* win_miss;
  bool* exhausted;
};

__device__ __forceinline__ uint2 shfl_key(uint2 k, int src) {
  return make_uint2(__shfl_sync(kFull, k.x, src), __shfl_sync(kFull, k.y, src));
}

// split(key, n)[j] for j < n, computed by thread j and handed to all.
__device__ __forceinline__ void split_n(uint2 key, int n, uint2* out) {
  const int t = threadIdx.x & 31;
  const uint2 mine = t < n ? split_key(key, (uint32_t)t) : key;
  for (int j = 0; j < n; ++j) out[j] = shfl_key(mine, j);
}

// Element j of jax.random.exponential(key, ..., float64).
__device__ __forceinline__ double exponential64(uint2 key, uint32_t j) {
  return exponential64_of_words(threefry2x32(key.x, key.y, 0u, j));
}

// Element j of jax.random.uniform(key, ..., GEOM_TAIL_CLAMP, 1.0, float64):
// max(lo, u * (hi - lo) + lo), each step rounded.
__device__ __forceinline__ double clamped_uniform64(uint2 key, uint32_t j) {
  const double u = uniform64_of_words(threefry2x32(key.x, key.y, 0u, j));
  const double range = __dsub_rn(1.0, kGeomTailClamp);
  return fmax(kGeomTailClamp,
              __dadd_rn(__dmul_rn(u, range), kGeomTailClamp));
}

// The delay of link `e` (= src * n + dst) drawn at flat index j of the
// plane from k_u / k_e, the halves of split(k_delay): compile.py
// `sample_delay_matrix` for one element. Only linked entries are asked.
__device__ __forceinline__ double link_delay(const Planes& pl, int e,
                                             uint2 k_u, uint2 k_e,
                                             uint32_t j) {
  const double p0 = pl.p0[e];
  switch (pl.kind[e]) {
    case 0:
      return p0;
    case 1:
      return __dadd_rn(p0, __dmul_rn(clamped_uniform64(k_u, j),
                                     __dsub_rn(pl.p1[e], p0)));
    case 2:
      return __dmul_rn(exponential64(k_e, j), p0);
    default: {
      if (p0 >= 1.0) return 1.0;
      const double log1mp = log(fmin(fmax(__dsub_rn(1.0, p0), 1e-300), 1.0));
      return fmax(ceil(__ddiv_rn(log(clamped_uniform64(k_u, j)), log1mp)),
                  1.0);
    }
  }
}

// Warp argmax with the first index among equals.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

__device__ __forceinline__ void warp_argmax(int& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

__device__ __forceinline__ void warp_argmax(double& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const double v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// jax.random.categorical(key, logw) at draw offset `base`: argmax over
// nodes of gumbel(bits(key, base + node)) + logw[node], the first node
// among equals. Every thread returns the miner.
__device__ __forceinline__ int draw_miner(uint2 key, uint32_t base,
                                          const float* logw, int n) {
  const int t = threadIdx.x & 31;
  float v = -INFINITY;
  int i = 32;
  if (t < n) {
    v = __fadd_rn(gumbel_of_bits(random_bits(key, base + (uint32_t)t)),
                  logw[t]);
    i = t;
  }
  warp_argmax(v, i);
  return i;
}

// The reward walk down the chain of `head`: block ids 1..top, each with
// its parent (a smaller id) and miner at par[id - shift], mnr[id - shift].
// Ids are read 32 at a time from the top; the chain pointer moves through
// each chunk in order and skips the ids above it. Thread n (< n_nodes)
// returns the number of chain blocks node n mined.
__device__ __forceinline__ int chain_rewards(int head, int top,
                                             const int32_t* par,
                                             const int32_t* mnr, int shift,
                                             int n_nodes) {
  const int t = threadIdx.x & 31;
  int cur = head;
  int count = 0;
  int hi = cur < top ? cur : top;
  while (cur > 0) {
    const int id = hi - t;
    int p = 0, m = -1;
    if (id >= 1) {
      p = par[id - shift];
      m = mnr[id - shift];
    }
    bool hit = false;
    for (int k = 0; k < 32; ++k) {
      const int pk = __shfl_sync(kFull, p, k);
      if (hi - k == cur && hi - k >= 1) {
        if (t == k) hit = true;
        cur = pk;
      }
    }
    for (int nn = 0; nn < n_nodes; ++nn) {
      const unsigned b = __ballot_sync(kFull, hit && m == nn);
      if (t == nn) count += __popc(b);
    }
    hi = cur;  // every id of the chunk is above the pointer now
  }
  return count;
}

}  // namespace netsim
}  // namespace cpr
