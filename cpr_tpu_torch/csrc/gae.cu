// Kernel K11-gae: generalized advantage estimation, the reverse scan of
// cpr_tpu/train/ppo.py:154-164 over a trajectory [T, N].
//
// Plain twin: cpr_tpu_torch/train/ppo.py `gae_plain`.
//
// Bound: bytes. Per element the scan reads reward, value and done and
// writes adv and target (17 bytes) for 7 flops; the dependence runs
// along T only, so the design is a thread per lane walking T backwards,
// neighbouring lanes on neighbouring addresses.
//
// Parity: the arithmetic is the plain twin's, in its order, with
// __fmul_rn/__fadd_rn so nvcc forms no FMA the twin does not: exact
// against it.
//
//   nonterm = 1 - done[t]
//   delta   = (reward[t] + (gamma * v_next) * nonterm) - value[t]
//   adv[t]  = delta + (gamma_lambda * nonterm) * adv_next
//   target  = adv + value

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ reward, const float* __restrict__ value,
           const bool* __restrict__ done, const float* __restrict__ last_value,
           int n_steps, int64_t n_lanes, float gamma, float gamma_lambda,
           float* __restrict__ adv, float* __restrict__ target) {
  const int64_t n = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (n >= n_lanes) return;
  float adv_next = 0.f;
  float v_next = last_value[n];
  for (int t = n_steps - 1; t >= 0; --t) {
    const int64_t i = t * n_lanes + n;
    const float nonterm = __fsub_rn(1.f, done[i] ? 1.f : 0.f);
    const float v = value[i];
    const float delta = __fsub_rn(
        __fadd_rn(reward[i], __fmul_rn(__fmul_rn(gamma, v_next), nonterm)),
        v);
    const float a =
        __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lambda, nonterm), adv_next));
    adv[i] = a;
    target[i] = __fadd_rn(a, v);
    adv_next = a;
    v_next = v;
  }
}

}  // namespace

extern "C" {

// K11-gae launch: reward/value/done [T, N], last_value [N] -> adv,
// target [T, N]; `gamma` and `gamma_lambda` already rounded to float32.
cudaError_t cpr_k11_gae(const void* reward, const void* value,
                        const void* done, const void* last_value, int n_steps,
                        int64_t n_lanes, float gamma, float gamma_lambda,
                        void* adv, void* target, void* stream) {
  if (n_lanes <= 0 || n_steps <= 0) return cudaSuccess;
  gae_kernel<<<(unsigned)((n_lanes + kThreads - 1) / kThreads), kThreads, 0,
               (cudaStream_t)stream>>>(
      static_cast<const float*>(reward), static_cast<const float*>(value),
      static_cast<const bool*>(done), static_cast<const float*>(last_value),
      n_steps, n_lanes, gamma, gamma_lambda, static_cast<float*>(adv),
      static_cast<float*>(target));
  return cudaGetLastError();
}

const char* cpr_k11_gae_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
