// Per-cell arithmetic shared by the log-einsum-exp forward kernels
// (log_einsum_exp_fwd.cu, grouped_fwd.cu).  Both kernels must compute a cell
// the same way, in the same order, so that a row's result depends on nothing
// but that row: not on the batch size, the batch tile or the kernel.
#pragma once

#include <cuda_runtime.h>

// The reference's stand-in for log(0) (repro/core/layers.py NEG_INF): the
// row max is clamped to it, so a row that is -inf everywhere exps to 0.
#define LEE_NEG_INF (-1e30f)

// v[0..K) <- exp(v - m) in place, with m = max(max_i v[i], NEG_INF); returns m.
__device__ __forceinline__ float lee_stabilize(float* v, int K) {
  float m = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < K; ++i) m = fmaxf(m, v[i]);
  m = fmaxf(m, LEE_NEG_INF);
  for (int i = 0; i < K; ++i) v[i] = expf(v[i] - m);
  return m;
}

// sum_i el[i] * (sum_j w[i*K + j] * er[j]): fp32 FMAs in a fixed (i, j) order.
__device__ __forceinline__ float lee_cell_sum(const float* w, const float* el,
                                              const float* er, int K) {
  float s = 0.f;
  for (int i = 0; i < K; ++i) {
    float t = 0.f;
    for (int j = 0; j < K; ++j) t = fmaf(w[i * K + j], er[j], t);
    s = fmaf(el[i], t, s);
  }
  return s;
}

// The message for a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* lee_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
