// Kernel K11-loss: the PPO loss head and its gradient, from the
// minibatch's logits [B, A] and value [B] (computed by the port's
// matrix products) on.
//
// Replaces: cpr_tpu/train/ppo.py:166-185 `loss_fn` after `net.apply`,
// and its part of `jax.grad` (:193): log_softmax, the gathered logp, the
// advantage normalisation by the minibatch's mean and population std,
// the clipped surrogate, the clipped value loss, the entropy and the
// approximate KL. Plain twin: cpr_tpu_torch/train/ppo.py `loss_plain`
// under autograd.
//
// Bound: bytes. The forward reads the minibatch's B (A + 6) floats (a
// pass for the mean, one for the variance, one for the terms; L2 holds
// the second and third) and writes five scalars; the backward reads them
// again and writes B (A + 1) floats. The forward's sums need one ordered
// reduction, so it is one block of 1024 threads, each summing a strided
// share in double, then a fixed tree: the same bits on every run. The
// backward is a thread per sample.
//
// Gradients follow autograd's rules for these operations: minimum and
// maximum split a tie half and half, clamp passes the gradient where the
// input lies inside its closed range, log_softmax's backward is
// g - exp(out) * sum(g).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxA = 24;
constexpr int kFwdThreads = 1024;
constexpr int kBwdThreads = 256;

struct Coefs {
  float clip_eps, vf_coef, ent_coef;
};

struct In {
  const float* logits;  // [B, A]
  const float* value;   // [B]
  const int32_t* action;
  const float* old_logp;
  const float* old_value;
  const float* adv;
  const float* target;
};

// log_softmax of one row into lp[A]: (x - max) - log(sum(exp(x - max)))
__device__ __forceinline__ void log_softmax_row(const float* x, int A,
                                                float* lp) {
  float m = x[0];
#pragma unroll
  for (int k = 0; k < kMaxA; ++k)
    if (k < A) m = fmaxf(m, x[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxA; ++k)
    if (k < A) s += expf(x[k] - m);
  const float lse = logf(s);
#pragma unroll
  for (int k = 0; k < kMaxA; ++k)
    if (k < A) lp[k] = (x[k] - m) - lse;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Sum over the block in a fixed order: each thread's value into red[],
// then a halving tree. Every thread gets the total.
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

// out = (total, pg_loss, v_loss, entropy, approx_kl); stats = (adv mean,
// std + 1e-8).
__global__ void __launch_bounds__(kFwdThreads)
loss_fwd_kernel(In in, int64_t B, int A, Coefs c, float* __restrict__ out,
                float* __restrict__ stats) {
  __shared__ double red[kFwdThreads];
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) acc += in.adv[i];
  const float mean = (float)(block_sum(acc, red) / (double)B);
  acc = 0.0;
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) {
    const double d = (double)in.adv[i] - (double)mean;
    acc += d * d;
  }
  const float denom =
      __fadd_rn(sqrtf((float)(block_sum(acc, red) / (double)B)), 1e-8f);
  double s_pg = 0.0, s_v = 0.0, s_ent = 0.0, s_kl = 0.0;
  const float lo = 1.f - c.clip_eps, hi = 1.f + c.clip_eps;
  for (int64_t i = threadIdx.x; i < B; i += blockDim.x) {
    float lp[kMaxA];
    log_softmax_row(in.logits + i * A, A, lp);
    float logp = lp[0], ent = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxA; ++k) {
      if (k >= A) break;
      if (k == in.action[i]) logp = lp[k];
      ent += expf(lp[k]) * lp[k];
    }
    const float an = __fdiv_rn(in.adv[i] - mean, denom);
    const float lr = logp - in.old_logp[i];
    const float ratio = expf(lr);
    s_pg += fminf(ratio * an, clampf(ratio, lo, hi) * an);
    const float v = in.value[i], ov = in.old_value[i], tg = in.target[i];
    const float vcl = ov + clampf(v - ov, -c.clip_eps, c.clip_eps);
    s_v += fmaxf((v - tg) * (v - tg), (vcl - tg) * (vcl - tg));
    s_ent += ent;
    s_kl += (expf(lr) - 1.f) - lr;
  }
  const double n = (double)B;
  const float pg = -(float)(block_sum(s_pg, red) / n);
  const float vl = 0.5f * (float)(block_sum(s_v, red) / n);
  const float en = -(float)(block_sum(s_ent, red) / n);
  const float kl = (float)(block_sum(s_kl, red) / n);
  if (threadIdx.x == 0) {
    out[0] = __fsub_rn(__fadd_rn(pg, __fmul_rn(c.vf_coef, vl)),
                       __fmul_rn(c.ent_coef, en));
    out[1] = pg;
    out[2] = vl;
    out[3] = en;
    out[4] = kl;
    stats[0] = mean;
    stats[1] = denom;
  }
}

// d total / d logits [B, A] and / d value [B], times g_total[0].
__global__ void __launch_bounds__(kBwdThreads)
loss_bwd_kernel(In in, int64_t B, int A, Coefs c,
                const float* __restrict__ stats,
                const float* __restrict__ g_total,
                float* __restrict__ dlogits, float* __restrict__ dvalue) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float gm = __fdiv_rn(g_total[0], (float)B);  // d total / d sample
  const float mean = stats[0], denom = stats[1];
  const float lo = 1.f - c.clip_eps, hi = 1.f + c.clip_eps;
  float lp[kMaxA];
  log_softmax_row(in.logits + i * A, A, lp);
  const int act = in.action[i];
  float logp = lp[0];
#pragma unroll
  for (int k = 0; k < kMaxA; ++k)
    if (k < A && k == act) logp = lp[k];
  const float an = __fdiv_rn(in.adv[i] - mean, denom);
  const float ratio = expf(logp - in.old_logp[i]);
  const float pg1 = ratio * an, pg2 = clampf(ratio, lo, hi) * an;
  // pg_loss = -mean(min(pg1, pg2))
  const float dmin = -gm;
  const float w1 = pg1 < pg2 ? 1.f : (pg1 == pg2 ? 0.5f : 0.f);
  const float w2 = pg2 < pg1 ? 1.f : (pg1 == pg2 ? 0.5f : 0.f);
  const float inside = (ratio >= lo && ratio <= hi) ? 1.f : 0.f;
  const float dratio = (dmin * w1) * an + ((dmin * w2) * an) * inside;
  const float dlogp = dratio * ratio;
  // entropy = -mean(sum(exp(lp) * lp)); total -= ent_coef * entropy
  const float ds = c.ent_coef * gm;
  float gl[kMaxA];
  float gsum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    if (k >= A) break;
    const float p = expf(lp[k]);
    float g = ds * lp[k] * p + ds * p;
    if (k == act) g += dlogp;
    gl[k] = g;
    gsum += g;
  }
#pragma unroll
  for (int k = 0; k < kMaxA; ++k) {
    if (k >= A) break;
    dlogits[i * A + k] = gl[k] - expf(lp[k]) * gsum;
  }
  // v_loss = 0.5 * mean(max((v - t)^2, (vcl - t)^2))
  const float v = in.value[i], ov = in.old_value[i], tg = in.target[i];
  const float d = v - ov;
  const float vcl = ov + clampf(d, -c.clip_eps, c.clip_eps);
  const float sq1 = (v - tg) * (v - tg), sq2 = (vcl - tg) * (vcl - tg);
  const float dmax = c.vf_coef * g_total[0] * 0.5f / (float)B;
  const float u1 = sq1 > sq2 ? 1.f : (sq1 == sq2 ? 0.5f : 0.f);
  const float u2 = sq2 > sq1 ? 1.f : (sq1 == sq2 ? 0.5f : 0.f);
  const float vin = (d >= -c.clip_eps && d <= c.clip_eps) ? 1.f : 0.f;
  dvalue[i] = (dmax * u1) * 2.f * (v - tg) +
              ((dmax * u2) * 2.f * (vcl - tg)) * vin;
}

In make_in(const void* const* p) {
  return In{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
            static_cast<const int32_t*>(p[2]),
            static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
            static_cast<const float*>(p[5]), static_cast<const float*>(p[6])};
}

}  // namespace

extern "C" {

// K11-loss forward: `in` the seven minibatch pointers (logits, value,
// action, old_logp, old_value, adv, target), `out` [5] and `stats` [2].
cudaError_t cpr_k11_loss_fwd(const void* const* in, int64_t B, int A,
                             float clip_eps, float vf_coef, float ent_coef,
                             void* out, void* stats, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxA) return cudaErrorInvalidValue;
  loss_fwd_kernel<<<1, kFwdThreads, 0, (cudaStream_t)stream>>>(
      make_in(in), B, A, Coefs{clip_eps, vf_coef, ent_coef},
      static_cast<float*>(out), static_cast<float*>(stats));
  return cudaGetLastError();
}

// K11-loss backward: the forward's inputs and `stats`, the incoming
// gradient `g_total` [1] -> dlogits [B, A], dvalue [B].
cudaError_t cpr_k11_loss_bwd(const void* const* in, int64_t B, int A,
                             float clip_eps, float vf_coef, float ent_coef,
                             const void* stats, const void* g_total,
                             void* dlogits, void* dvalue, void* stream) {
  if (B <= 0 || A <= 0 || A > kMaxA) return cudaErrorInvalidValue;
  loss_bwd_kernel<<<(unsigned)((B + kBwdThreads - 1) / kBwdThreads),
                    kBwdThreads, 0, (cudaStream_t)stream>>>(
      make_in(in), B, A, Coefs{clip_eps, vf_coef, ent_coef},
      static_cast<const float*>(stats), static_cast<const float*>(g_total),
      static_cast<float*>(dlogits), static_cast<float*>(dvalue));
  return cudaGetLastError();
}

const char* cpr_k11_loss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
