// Kernel K11-adam: optax's chain(clip_by_global_norm(max_norm),
// adam(lr, eps)) over the flat parameter vector, one launch a step.
//
// Replaces: cpr_tpu/train/ppo.py:317-326 (the optax chain) and
// `TrainState.apply_gradients` (:195, :197): optax 0.2.6's global norm,
// the clip `(g / norm) * max_norm` where norm >= max_norm, the moment
// updates, bias correction at the incremented count, eps outside the
// square root, the step `-lr * u`. Plain twin: cpr_tpu_torch/train/
// optim.py `step_plain`; the host computes the count's scalars (bias
// corrections, -lr) in float32 for both.
//
// Bound: bytes. A step reads the parameters, gradient and both moments
// and writes three of them back (28 bytes a parameter; the nets here
// hold 10k-25k parameters). The global norm must be known before any
// update, so the design is one block of 1024 threads: a strided sum of
// squares in double, a fixed tree over the block (the same bits on every
// run), then the elementwise pass. The elementwise arithmetic is the
// plain twin's, in its order, with __f*_rn so that it matches it exactly;
// only the norm's summation order differs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;

struct Scalars {
  float neg_lr, bc1, bc2, b1, b2, omb1, omb2, eps, max_norm;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ mu, float* __restrict__ nu, int64_t n,
            Scalars s, float* __restrict__ norm_out) {
  __shared__ double red[kThreads];
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const double x = g[i];
    acc += x * x;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float norm = sqrtf((float)red[0]);
  const bool keep = norm < s.max_norm;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    float x = g[i];
    if (!keep) x = __fmul_rn(__fdiv_rn(x, norm), s.max_norm);
    const float m = __fadd_rn(__fmul_rn(s.omb1, x), __fmul_rn(s.b1, mu[i]));
    const float v =
        __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(x, x)), __fmul_rn(s.b2, nu[i]));
    mu[i] = m;
    nu[i] = v;
    const float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)),
                                        s.eps));
    p[i] = __fadd_rn(p[i], __fmul_rn(s.neg_lr, u));
  }
  if (threadIdx.x == 0 && norm_out != nullptr) *norm_out = norm;
}

}  // namespace

extern "C" {

// K11-adam launch: params, grads, mu, nu [n] float32 (params, mu, nu
// updated in place); `norm_out` [1] receives the gradient's global norm
// (may be null).
cudaError_t cpr_k11_adam(void* params, const void* grads, void* mu, void* nu,
                         int64_t n, float neg_lr, float bc1, float bc2,
                         float b1, float b2, float omb1, float omb2,
                         float eps, float max_norm, void* norm_out,
                         void* stream) {
  if (n <= 0) return cudaSuccess;
  adam_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(params), static_cast<const float*>(grads),
      static_cast<float*>(mu), static_cast<float*>(nu), n,
      Scalars{neg_lr, bc1, bc2, b1, b2, omb1, omb2, eps, max_norm},
      static_cast<float*>(norm_out));
  return cudaGetLastError();
}

const char* cpr_k11_adam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
