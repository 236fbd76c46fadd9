// K2's rows kernel, the per-pair log-einsum-exp backward
// (log_einsum_exp_bwd.cu, whose notes describe it; its dW kernel is in
// lee_dw.cuh), shared with the gather run's backward gather_bwd.cu (K6),
// which launches it depth by depth on child rows it has gathered.
#pragma once

#include "lee_dw.cuh"

namespace {

template <class Tile>
__global__ void __launch_bounds__(kLeeThreads, kLeeMinBlocks)
lee_bwd_rows_kernel(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, const float* __restrict__ g,
    float* __restrict__ ginv, float* __restrict__ gl, float* __restrict__ gr,
    float* __restrict__ gacc, int B, int L, int K, int K_out, int nsub,
    long long l_sb, long long l_sl, long long r_sb, long long r_sl) {
  extern __shared__ float smem[];
  constexpr int KT = Tile::KT;
  const int tb = nsub * Tile::ROWS;
  const int l = blockIdx.x;
  const int b0 = blockIdx.y * tb;
  const int k0 = blockIdx.z * KT;
  const int nb = min(tb, B - b0);
  const int kn = min(KT, K_out - k0);
  const int Kp = lee_pad(K);
  float* ws = smem;                         // KT lee_row_stride(K)
  float* el = ws + KT * lee_row_stride(K);  // tb Kp: left rows, then exps
  float* er = el + tb * Kp;                 // tb Kp: right rows, then exps
  float* T = er + tb * Kp;                  // tb KT Kp: t, then u
  float* gi = T + tb * KT * Kp;             // tb KT: ginv of the K_out tile

  lee_stage_weights(ws, w, (long long)K_out * K * K, l, 1, k0, kn, K);
  lee_stage_rows(el, ln_l + l * l_sl, l_sb, b0, nb, tb, K);
  lee_stage_rows(er, ln_r + l * r_sl, r_sb, b0, nb, tb, K);
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) {
    lee_stabilize(t < nb ? el + t * Kp : er + (t - nb) * Kp, K);
  }
  __syncthreads();
  lee_sweep<Tile, false>(ws, er, T, K, nsub);
  __syncthreads();
  for (int o = threadIdx.x; o < tb * KT; o += blockDim.x) {
    const int r = o / KT;
    const int k = o - r * KT;
    float v = 0.f;
    if (r < nb && k < kn) {
      const float* t = T + o * Kp;
      const float* e = el + r * Kp;
      float s = 0.f;
      for (int i = 0; i < K; ++i) s = fmaf(e[i], t[i], s);
      const long long off = ((long long)(b0 + r) * L + l) * K_out + k0 + k;
      v = g[off] / fmaxf(s, LEE_S_FLOOR);
      ginv[off] = v;
    }
    gi[o] = v;
  }
  // gl's and gr's terms of this tile, summed in k order: the answer itself
  // with one K_out tile, else the tile's partial (summed in tile order by
  // the dW kernel)
  const bool whole = gridDim.z == 1;
  const long long n = (long long)B * L * K;
  float* part_l = gacc + (long long)blockIdx.z * n;
  float* part_r = gacc + ((long long)gridDim.z + blockIdx.z) * n;
  __syncthreads();
  for (int o = threadIdx.x; o < nb * K; o += blockDim.x) {
    const int r = o / K;
    const int i = o - r * K;
    float a = 0.f;
    for (int k = 0; k < kn; ++k) {
      a = fmaf(gi[r * KT + k], T[(r * KT + k) * Kp + i], a);
    }
    const long long off = ((long long)(b0 + r) * L + l) * K + i;
    if (whole) {
      gl[off] = el[r * Kp + i] * a;
    } else {
      part_l[off] = a;
    }
  }
  __syncthreads();
  lee_sweep<Tile, true>(ws, el, T, K, nsub);
  __syncthreads();
  for (int o = threadIdx.x; o < nb * K; o += blockDim.x) {
    const int r = o / K;
    const int j = o - r * K;
    float a = 0.f;
    for (int k = 0; k < kn; ++k) {
      a = fmaf(gi[r * KT + k], T[(r * KT + k) * Kp + j], a);
    }
    const long long off = ((long long)(b0 + r) * L + l) * K + j;
    if (whole) {
      gr[off] = er[r * Kp + j] * a;
    } else {
      part_r[off] = a;
    }
  }
}

template <class Tile>
cudaError_t lee_bwd_rows_launch(const float* w, const float* ln_l,
                                const float* ln_r, const float* g, float* ginv,
                                float* gl, float* gr, float* acc, int B, int L,
                                int K, int K_out, int nsub, long long l_sb,
                                long long l_sl, long long r_sb, long long r_sl,
                                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      lee_bwd_rows_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int tb = nsub * Tile::ROWS;
  const long long smem =
      4LL * ((long long)Tile::KT * lee_row_stride(K) +
             (2LL + Tile::KT) * tb * lee_pad(K) + (long long)tb * Tile::KT);
  if (smem > kLeeSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(L, (B + tb - 1) / tb, (K_out + Tile::KT - 1) / Tile::KT);
  lee_bwd_rows_kernel<Tile><<<grid, kLeeThreads, (size_t)smem, stream>>>(
      w, ln_l, ln_r, g, ginv, gl, gr, acc, B, L, K, K_out, nsub, l_sb, l_sl,
      r_sb, r_sl);
  return cudaGetLastError();
}

template <class Tile>
cudaError_t lee_bwd_launch(const float* w, const float* ln_l,
                           const float* ln_r, const float* g, float* ginv,
                           float* acc, float* gw_part, float* gw, float* gl,
                           float* gr, int B, int L, int K, int K_out, int nsub,
                           int jt, int ktw, int splits, long long l_sb,
                           long long l_sl, long long r_sb, long long r_sl,
                           cudaStream_t s) {
  cudaError_t err = lee_bwd_rows_launch<Tile>(w, ln_l, ln_r, g, ginv, gl, gr,
                                              acc, B, L, K, K_out, nsub, l_sb,
                                              l_sl, r_sb, r_sl, s);
  if (err != cudaSuccess) return err;
  const int n_kt = (K_out + Tile::KT - 1) / Tile::KT;
  return lee_dw(ln_l, ln_r, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out,
                jt, ktw, splits, n_kt, l_sb, l_sl, r_sb, r_sl, s);
}

// K2 (rows kernel, dW kernel, split sum) with register tile `tile` (0: 16
// rows x 8 outputs, 1: 32 x 1, 2: 32 x 10; log_einsum_exp.py BWD_TILES):
// the arguments of lee_bwd.
inline cudaError_t lee_bwd_run(const float* w, const float* ln_l,
                               const float* ln_r, const float* g, float* ginv,
                               float* acc, float* gw_part, float* gw,
                               float* gl, float* gr, int B, int L, int K,
                               int K_out, int tile, int nsub, int jt, int ktw,
                               int splits, long long l_sb, long long l_sl,
                               long long r_sb, long long r_sl,
                               cudaStream_t s) {
  if (tile == 0) {
    return lee_bwd_launch<LeeTile<2, 2, 4>>(
        w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out,
        nsub, jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
  }
  if (tile == 2) {
    return lee_bwd_launch<LeeTile<2, 5, 2>>(
        w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out,
        nsub, jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
  }
  return lee_bwd_launch<LeeTile<1, 1, 1>>(
      w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out, nsub,
      jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
}

}  // namespace
