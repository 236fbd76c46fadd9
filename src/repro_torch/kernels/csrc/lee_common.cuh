// Per-cell arithmetic shared by the log-einsum-exp kernels, forward
// (log_einsum_exp_fwd.cu, grouped_fwd.cu) and backward
// (log_einsum_exp_bwd.cu, grouped_bwd.cu).  Every kernel computes a cell the
// same way, in the same order, so that a row's result depends on nothing but
// that row (not on the batch size, the batch tile or the kernel), and a
// backward kernel recomputes exactly the stabilized sum its forward logged.
#pragma once

#include <cuda_runtime.h>

// The reference's stand-in for log(0) (repro/core/layers.py NEG_INF): the
// row max is clamped to it, so a row that is -inf everywhere exps to 0.
#define LEE_NEG_INF (-1e30f)

// Floor for the stabilized sum when a backward divides the cotangent by it
// (the reference's _S_FLOOR): a normal float32, so a fully saturated row,
// whose sum is exactly 0, gets finite gradients.
#define LEE_S_FLOOR (1e-30f)

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

// How one depth's H weight cells, each (ko, K, K), are staged through w_cap
// floats of shared memory: `cells` whole cells at a time when one cell fits,
// else one cell's `kt` outputs at a time.
struct LeeChunks {
  int cells;
  int kt;
};

__host__ __device__ inline LeeChunks lee_chunks(int H, int ko, int KK,
                                                int w_cap) {
  const int cell = ko * KK;
  if (cell <= w_cap) return {H < w_cap / cell ? H : w_cap / cell, ko};
  return {1, w_cap / KK};
}

namespace {

// out[e] = sum_t part[t n + e], t = 0, 1, ... in order: the per-tile partial
// weight gradients of a backward kernel summed across the batch tiles in a
// fixed order, without atomics, so two calls give bitwise-equal gradients.
__global__ void lee_sum_tiles_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, long long n,
                                     int tiles) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float acc = part[e];
    for (int t = 1; t < tiles; ++t) acc += part[(long long)t * n + e];
    out[e] = acc;
  }
}

inline cudaError_t lee_sum_tiles(const float* part, float* out, long long n,
                                 int tiles, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  lee_sum_tiles_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, n,
                                                                 tiles);
  return cudaGetLastError();
}

}  // namespace

// The message for a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* lee_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
