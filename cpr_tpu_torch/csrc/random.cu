// Kernel K1: batched threefry2x32 — key split/fold_in and uniform,
// exponential or raw bits, the `jax.random` stream bit for bit; float64
// uniform and exponential draws from the 64-bit bits, as the JAX package
// draws them in 64-bit mode (the netsim's clocks).
//
// Replaces: jax.random.split / fold_in / bits / uniform / exponential as
// XLA lowers them for cpr_tpu (bench.py:138 `split(PRNGKey(0), n)`,
// gym/envs.py:168-175 BatchedCore.reset). The plain twin is
// cpr_tpu_torch/random.py `threefry_plain`.
//
// Bound: integer ALU at large n (about 80 operations per output against
// 8 bytes written), and launch latency at the sizes the main path uses.
// Design: one thread per (key, counter) output, consecutive threads on
// consecutive counters of one key so the stores coalesce; a grid-stride
// loop covers any n_keys * n.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

enum Mode {
  kKeys = 0, kBits = 1, kUniform = 2, kExponential = 3, kUniform64 = 4,
  kExponential64 = 5
};

__global__ void threefry_kernel(const uint2* __restrict__ keys,
                                int64_t total, int64_t n, uint32_t offset,
                                int mode, void* __restrict__ out) {
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = t / n;
    const uint32_t j = offset + (uint32_t)(t - b * n);
    const uint2 key = keys[b];
    const uint2 x = cpr::threefry2x32(key.x, key.y, 0u, j);
    switch (mode) {
      case kKeys:
        static_cast<uint2*>(out)[t] = x;
        break;
      case kBits:
        static_cast<uint32_t*>(out)[t] = x.x ^ x.y;
        break;
      case kUniform:
        static_cast<float*>(out)[t] = cpr::uniform_of_bits(x.x ^ x.y);
        break;
      case kExponential:
        static_cast<float*>(out)[t] = cpr::exponential_of_bits(x.x ^ x.y);
        break;
      case kUniform64:
        static_cast<double*>(out)[t] = cpr::uniform64_of_words(x);
        break;
      default:
        static_cast<double*>(out)[t] = cpr::exponential64_of_words(x);
        break;
    }
  }
}

}  // namespace

extern "C" {

// keys: [n_keys, 2] uint32 words; out: [n_keys, n, 2] uint32 (mode 0) or
// [n_keys, n] uint32/float32 (modes 1-3) or float64 (modes 4, 5). Output j of key b uses counter
// (0, offset + j). Launches on `stream`; returns the launch status.
cudaError_t cpr_k1_threefry(const void* keys, int64_t n_keys, int64_t n,
                            uint32_t offset, int mode, void* out,
                            void* stream) {
  const int64_t total = n_keys * n;
  if (total <= 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  threefry_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(keys), total, n, offset, mode, out);
  return cudaGetLastError();
}

const char* cpr_k1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
