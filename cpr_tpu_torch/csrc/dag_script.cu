// K8's check kernel: the register-machine script of
// cpr_tpu_torch/core/dag.py (`make_script`, `script_plain`) over K8's
// device functions (csrc/dag.cuh), one warp per lane, ring windows with
// ancestry planes. It exists to hold K8 against its plain twin and the
// JAX package's core/dag.py apart from the env kernels that run it.
//
// Bound: as K8 — warp-collective latency; the script's ops are a handful
// of plane scans and one or two reductions each.

#include <cuda_runtime.h>

#include <cstdint>

#include "dag.cuh"

namespace {

using cpr::Block;
using cpr::LaneDag;
using cpr::Mask;
using cpr::Row;
using cpr::kNone;
using cpr::mask_count;

constexpr int kRegs = 8, kTopK = 5, kOut = 4;
enum Op {
  kAppend = 0, kReleaseMasked, kSelectVis, kReleaseTopK, kRetire, kCa,
  kChainFirst, kFirstByAge, kTopKOp, kCounts, kLastByAge = 14, kDescendants
};

__global__ void __launch_bounds__(128)
dag_script_kernel(const __grid_constant__ cpr::DagPtrs dp,
                  const int32_t* __restrict__ ops, int n_ops,
                  const int32_t* __restrict__ args, int n_args,
                  const float* __restrict__ fargs, int64_t n_lanes,
                  int32_t* __restrict__ regs_out, int32_t* __restrict__ out) {
  const int64_t lane = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (lane >= n_lanes) return;
  LaneDag g;
  g.bind(dp, lane);
  g.load_scalars();
  const int t = g.t;
  int32_t regs[kRegs];
  for (int r = 0; r < kRegs; ++r) regs[r] = kNone;
  auto reg = [&](int32_t i) { return i >= 0 ? regs[i] : kNone; };
  auto hreg = [&](int32_t r) { return r >= 0 ? g.at(g.d->height, r) : 0; };
  auto visible = [&]() {
    return mask_count(g.bools(g.d->vis_d) & g.exists());
  };
  for (int step = 0; step < n_ops; ++step) {
    const int32_t* a = args + ((int64_t)step * n_lanes + lane) * n_args;
    const float* f = fargs + ((int64_t)step * n_lanes + lane) * 4;
    int32_t o[kOut] = {0, 0, 0, 0};
    const int32_t x = reg(a[0]);
    switch (ops[step]) {
      case kAppend: {
        Row row;
        for (int p = 0; p < g.P; ++p) row.p[p] = reg(a[8 + p]);
        Block b;
        b.kind = a[2];
        b.height = hreg(row.p[0]) + a[3];
        b.vis_d = a[4] != 0;
        b.miner = a[5];
        b.aux = a[6];
        b.time = f[0];
        b.reward_atk = f[1];
        b.reward_def = f[2];
        b.pow_hash = f[3];
        b.progress = a[7] != 0 ? (float)(b.height * 2)
                               : (row.p[0] >= 0 ? g.at(g.d->cum_prog, row.p[0])
                                                : 0.f) + 1.f;
        const int32_t idx = g.append_if(a[0] != 0, row, b);
        regs[a[1]] = idx;
        o[0] = idx;
        o[1] = g.n;
        o[2] = g.overflow;
        break;
      }
      case kReleaseMasked:
        g.release_masked(x, f[0]);
        o[0] = visible();
        break;
      case kSelectVis:
        if (a[1] != 0) g.release_masked(x, f[0]);
        o[0] = visible();
        break;
      case kReleaseTopK: {
        int32_t idx[cpr::kMaxTopK];
        bool valid[cpr::kMaxTopK];
        g.top_k_plane(g.d->born_at, g.children0(x), kTopK, idx, valid);
        int nv = 0;
        for (int i = 0; i < kTopK; ++i) {
          nv += valid[i];
          valid[i] = valid[i] && i < a[1];
        }
        g.release(g.mask_of(idx, valid, kTopK), f[0]);
        o[0] = visible();
        o[1] = nv;
        break;
      }
      case kRetire: {
        g.retire_below(x >= 0 ? g.at(g.d->gid, x) : 0);
        const int32_t r = a[1] < 0 ? 0 : a[1];
        regs[r] = g.drop_if_retired(reg(a[1]));
        o[0] = g.live_floor;
        o[1] = regs[r];
        break;
      }
      case kCa:
        o[0] = regs[a[2]] = g.common_ancestor(x, reg(a[1]));
        break;
      case kChainFirst:
        o[0] = regs[a[2]] = g.chain_first_at_most(x, g.d->height, hreg(x) - a[1]);
        break;
      case kFirstByAge:
        o[0] = regs[a[2]] = g.first_by_age(g.children0(x) & g.kind_is(a[1]));
        break;
      case kTopKOp: {
        int32_t idx[cpr::kMaxTopK];
        bool valid[cpr::kMaxTopK];
        g.top_k_plane(g.d->born_at, g.exists() & g.kind_is(a[1]), kTopK, idx,
                      valid);
        for (int i = 0; i < kTopK; ++i) {
          o[0] += valid[i] ? idx[i] : 0;
          o[1] += valid[i];
        }
        o[2] = idx[0];
        o[3] = idx[kTopK - 1];
        break;
      }
      case kLastByAge:
        o[0] = regs[a[2]] = g.last_by_age(g.children0(x) & g.kind_is(a[1]));
        break;
      case kDescendants: {
        const Mask m = g.descendants(x);
        o[0] = mask_count(m);
        o[1] = g.last_by_age(m);
        o[2] = g.first_by_age(m);
        o[3] = mask_count(m & g.bools(g.d->vis_d));
        break;
      }
      default: {  // kCounts
        const Mask ex = g.exists();
        o[0] = mask_count(ex);
        o[1] = mask_count(g.newer_than(x) & ex);
        o[2] = mask_count(g.children0(x));
        o[3] = g.first_by_age(ex);
        break;
      }
    }
    if (t < kOut) out[((int64_t)step * n_lanes + lane) * kOut + t] = o[t];
  }
  g.store_scalars();
  if (t < kRegs) regs_out[lane * kRegs + t] = regs[t];
}

}  // namespace

extern "C" {

// K8 check launch: `ops` [T] (host values copied to the card by the
// wrapper), `args` [T, L, n_args], `fargs` [T, L, 4] on the card; the DAG
// `dp` is updated in place; `regs_out` [L, 8], `out` [T, L, 4].
cudaError_t cpr_k8_dag_script(const cpr::DagPtrs* dp, const void* ops,
                              int n_ops, const void* args, int n_args,
                              const void* fargs, int64_t n_lanes,
                              void* regs_out, void* out, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  dag_script_kernel<<<(unsigned)((n_lanes + 3) / 4), 128, 0,
                      (cudaStream_t)stream>>>(
      *dp, static_cast<const int32_t*>(ops), n_ops,
      static_cast<const int32_t*>(args), n_args,
      static_cast<const float*>(fargs), n_lanes,
      static_cast<int32_t*>(regs_out), static_cast<int32_t*>(out));
  return cudaGetLastError();
}

const char* cpr_k8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
