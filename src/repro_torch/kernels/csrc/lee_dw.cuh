// The batch-summed weight gradient of a layer pair's backward: K2's dW
// kernel (log_einsum_exp_bwd.cu), shared with the fused backwards K4
// (grouped_bwd.cu) and K6 (gather_bwd.cu), which launch it on the rows and
// ginv they have written to device memory.
//
// dW[l, k, i, j] = sum_b ginv[b, l, k] el[b, l, i] er[b, l, j], over a
// (cell l, K_out tile, batch split) grid; a block walks its split's rows in
// order in chunks of kLeeDwChunk, stabilised again in shared memory, and
// keeps 4 outputs x JT columns of one (k-quad, i) a thread in registers.
// With more than one split each writes a partial of dW's size, summed in
// split order by lee_sum_tiles: no atomics.  With n_kt > 1 the first
// K_out tile's blocks also finish gl and gr from the K_out tiles' sums in
// gacc (K2's rows kernel); K4 and K6 pass n_kt = 1.
#pragma once

#include "lee_common.cuh"

namespace {

constexpr int kLeeDwThreads = 256;
constexpr int kLeeDwChunk = 32;  // rows a dW block stages at a time

// A thread's item is (k-quad kq, i, column group jg): outputs k0 + 4 kq +
// u (u < 4) and columns j = jg + a NJG (a < JT).
template <int JT>
__global__ void __launch_bounds__(kLeeDwThreads) lee_bwd_dw_kernel(
    const float* __restrict__ ln_l, const float* __restrict__ ln_r,
    const float* __restrict__ ginv, const float* __restrict__ gacc,
    float* __restrict__ gw_part, float* __restrict__ gl,
    float* __restrict__ gr, int B, int L, int K, int K_out, int ktw,
    int rows_per_split, int n_kt, long long l_sb, long long l_sl,
    long long r_sb, long long r_sl) {
  extern __shared__ float smem[];
  const int l = blockIdx.x;
  const int k0 = blockIdx.y * ktw;
  const int kn = min(ktw, K_out - k0);
  const int split = blockIdx.z;
  const int rb = split * rows_per_split;
  const int re = min(B, rb + rows_per_split);
  const int Kp = lee_pad(K);
  const int KK = K * K;
  const int njg = (K + JT - 1) / JT;
  const int items = (kn + 3) / 4 * K * njg;
  float* el = smem;                  // kLeeDwChunk Kp
  float* er = el + kLeeDwChunk * Kp;    // kLeeDwChunk Kp
  float* gs = er + kLeeDwChunk * Kp;    // kLeeDwChunk ktw: ginv of the chunk
  float* part = gw_part + (long long)split * L * K_out * KK;
  for (int base = 0; base < items; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool active = item < items;
    const int kq = item / (K * njg);
    const int rem = item - kq * K * njg;
    const int i = rem / njg;
    const int jg = rem - i * njg;
    float acc[4][JT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int a = 0; a < JT; ++a) acc[u][a] = 0.f;
    for (int c0 = rb; c0 < re; c0 += kLeeDwChunk) {
      const int cn = min(kLeeDwChunk, re - c0);
      // the previous chunk is done with el, er and gs
      __syncthreads();
      lee_stage_rows(el, ln_l + l * l_sl, l_sb, c0, cn, cn, K);
      lee_stage_rows(er, ln_r + l * r_sl, r_sb, c0, cn, cn, K);
      for (int t = threadIdx.x; t < cn * ktw; t += blockDim.x) {
        const int r = t / ktw;
        const int k = t - r * ktw;
        gs[t] = k < kn
                    ? ginv[((long long)(c0 + r) * L + l) * K_out + k0 + k]
                    : 0.f;
      }
      __syncthreads();
      for (int t = threadIdx.x; t < 2 * cn; t += blockDim.x) {
        lee_stabilize(t < cn ? el + t * Kp : er + (t - cn) * Kp, K);
      }
      __syncthreads();
      if (n_kt > 1 && blockIdx.y == 0 && base == 0) {
        // gl and gr of the chunk's rows: the rows kernel's K_out tile
        // partials summed in tile order, times el (er)
        const long long n = (long long)B * L * K;
        for (int t = threadIdx.x; t < cn * K; t += blockDim.x) {
          const int r = t / K;
          const int i = t - r * K;
          const long long off = ((long long)(c0 + r) * L + l) * K + i;
          float sl = gacc[off];
          float sr = gacc[n_kt * n + off];
          for (int z = 1; z < n_kt; ++z) {
            sl += gacc[z * n + off];
            sr += gacc[(n_kt + z) * n + off];
          }
          gl[off] = el[r * Kp + i] * sl;
          gr[off] = er[r * Kp + i] * sr;
        }
      }
      if (!active) continue;
      for (int r = 0; r < cn; ++r) {
        const float e = el[r * Kp + i];
        const float* err = er + r * Kp;
        const float* gr_ = gs + r * ktw + 4 * kq;
        float p[JT];
#pragma unroll
        for (int a = 0; a < JT; ++a) {
          const int j = jg + a * njg;
          p[a] = j < K ? e * err[j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float gv = 4 * kq + u < kn ? gr_[u] : 0.f;
#pragma unroll
          for (int a = 0; a < JT; ++a) acc[u][a] = fmaf(gv, p[a], acc[u][a]);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * kq + u;
      if (k >= kn) continue;
      float* dst = part + ((long long)l * K_out + k0 + k) * KK + i * K;
#pragma unroll
      for (int a = 0; a < JT; ++a) {
        const int j = jg + a * njg;
        if (j < K) dst[j] = acc[u][a];
      }
    }
  }
}

template <int JT>
cudaError_t launch_dw(const float* ln_l, const float* ln_r,
                      const float* ginv, const float* acc, float* gw_part,
                      float* gl, float* gr, int B, int L, int K, int K_out,
                      int ktw, int splits, int n_kt, long long l_sb,
                      long long l_sl, long long r_sb, long long r_sl,
                      cudaStream_t stream) {
  const long long smem =
      4LL * (2LL * kLeeDwChunk * lee_pad(K) + (long long)kLeeDwChunk * ktw);
  static const cudaError_t attr = cudaFuncSetAttribute(
      lee_bwd_dw_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  if (smem > kLeeSmemLimit) return cudaErrorInvalidValue;
  const int rows_per_split = (B + splits - 1) / splits;
  const dim3 grid(L, (K_out + ktw - 1) / ktw, splits);
  lee_bwd_dw_kernel<JT><<<grid, kLeeDwThreads, (size_t)smem, stream>>>(
      ln_l, ln_r, ginv, acc, gw_part, gl, gr, B, L, K, K_out, ktw,
      rows_per_split, n_kt, l_sb, l_sl, r_sb, r_sl);
  return cudaGetLastError();
}

// Launch the dW kernel with jt (4, 8 or 16) columns a thread and, with
// more than one split, sum the partials in gw_part into gw; with one
// split gw_part must be gw.
inline cudaError_t lee_dw(const float* ln_l, const float* ln_r,
                          const float* ginv, const float* acc, float* gw_part,
                          float* gw, float* gl, float* gr, int B, int L, int K,
                          int K_out, int jt, int ktw, int splits, int n_kt,
                          long long l_sb, long long l_sl, long long r_sb,
                          long long r_sl, cudaStream_t s) {
  cudaError_t err;
  if (jt == 4) {
    err = launch_dw<4>(ln_l, ln_r, ginv, acc, gw_part, gl, gr, B, L, K,
                       K_out, ktw, splits, n_kt, l_sb, l_sl, r_sb, r_sl, s);
  } else if (jt == 8) {
    err = launch_dw<8>(ln_l, ln_r, ginv, acc, gw_part, gl, gr, B, L, K,
                       K_out, ktw, splits, n_kt, l_sb, l_sl, r_sb, r_sl, s);
  } else {
    err = launch_dw<16>(ln_l, ln_r, ginv, acc, gw_part, gl, gr, B, L, K,
                        K_out, ktw, splits, n_kt, l_sb, l_sl, r_sb, r_sl, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return lee_sum_tiles(gw_part, gw, (long long)L * K_out * K * K, splits, s);
}

}  // namespace
