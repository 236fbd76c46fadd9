// K1, the per-pair log-einsum-exp forward (log_einsum_exp_fwd.cu, whose
// notes describe it), shared with the gather run's backward gather_bwd.cu
// (K6), which launches it depth by depth on child rows it has gathered.
#pragma once

#include "lee_common.cuh"

namespace {

template <class Tile>
__global__ void __launch_bounds__(kLeeThreads, kLeeMinBlocks) lee_fwd_kernel(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, float* __restrict__ out, int B, int L,
    int K, int K_out, int nsub, long long l_sb, long long l_sl,
    long long r_sb, long long r_sl) {
  extern __shared__ float smem[];
  constexpr int KT = Tile::KT;
  const int tb = nsub * Tile::ROWS;
  const int l = blockIdx.x;
  const int b0 = blockIdx.y * tb;
  const int k0 = blockIdx.z * KT;
  const int kn = min(KT, K_out - k0);
  const int nb = min(tb, B - b0);
  const int Kp = lee_pad(K);
  float* ws = smem;                       // KT lee_row_stride(K): W[l, k0:]
  float* el = ws + KT * lee_row_stride(K);  // tb Kp: left rows, then exps
  float* er = el + tb * Kp;               // tb Kp: right rows, then exps
  float* ml = er + tb * Kp;               // tb: clamped left maxes
  float* mr = ml + tb;                    // tb: clamped right maxes
  float* T = mr + tb;                     // tb KT Kp: t[r, k, i]

  lee_stage_weights(ws, w, (long long)K_out * K * K, l, 1, k0, kn, K);
  lee_stage_rows(el, ln_l + l * l_sl, l_sb, b0, nb, tb, K);
  lee_stage_rows(er, ln_r + l * r_sl, r_sb, b0, nb, tb, K);
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) {
    if (t < nb) {
      ml[t] = lee_stabilize(el + t * Kp, K);
    } else {
      mr[t - nb] = lee_stabilize(er + (t - nb) * Kp, K);
    }
  }
  __syncthreads();
  lee_sweep<Tile, false>(ws, er, T, K, nsub);
  __syncthreads();
  for (int o = threadIdx.x; o < nb * KT; o += blockDim.x) {
    const int r = o / KT;
    const int k = o - r * KT;
    if (k >= kn) continue;
    const float* t = T + o * Kp;
    const float* e = el + r * Kp;
    float s = 0.f;
    for (int i = 0; i < K; ++i) s = fmaf(e[i], t[i], s);
    out[((long long)(b0 + r) * L + l) * K_out + k0 + k] =
        (ml[r] + mr[r]) + logf(s);
  }
}

template <class Tile>
cudaError_t lee_fwd_launch(const float* w, const float* ln_l, const float* ln_r,
                   float* out, int B, int L, int K, int K_out, int nsub,
                   long long l_sb, long long l_sl, long long r_sb,
                   long long r_sl, cudaStream_t stream) {
  // the block's whole budget, allowed once; a launch asks for what it uses
  static const cudaError_t attr = cudaFuncSetAttribute(
      lee_fwd_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int tb = nsub * Tile::ROWS;
  const long long smem =
      4LL * ((long long)Tile::KT * lee_row_stride(K) + 2LL * tb +
             (2LL + Tile::KT) * tb * lee_pad(K));
  if (smem > kLeeSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(L, (B + tb - 1) / tb, (K_out + Tile::KT - 1) / Tile::KT);
  lee_fwd_kernel<Tile><<<grid, kLeeThreads, (size_t)smem, stream>>>(
      w, ln_l, ln_r, out, B, L, K, K_out, nsub, l_sb, l_sl, r_sb, r_sl);
  return cudaGetLastError();
}

// K1 with register tile `tile` (0: 32 rows x 8 outputs, 1: 64 x 1, 2: 32 x
// 10; log_einsum_exp.py FWD_TILES): the arguments of lee_fwd.
inline cudaError_t lee_fwd_run(const float* w, const float* ln_l,
                               const float* ln_r, float* out, int B, int L,
                               int K, int K_out, int tile, int nsub,
                               long long l_sb, long long l_sl, long long r_sb,
                               long long r_sl, cudaStream_t s) {
  if (tile == 0) {
    return lee_fwd_launch<LeeTile<4, 2, 4>>(w, ln_l, ln_r, out, B, L, K, K_out,
                                         nsub, l_sb, l_sl, r_sb, r_sl, s);
  }
  if (tile == 2) {
    return lee_fwd_launch<LeeTile<2, 5, 2>>(w, ln_l, ln_r, out, B, L, K, K_out,
                                         nsub, l_sb, l_sl, r_sb, r_sl, s);
  }
  return lee_fwd_launch<LeeTile<2, 1, 1>>(w, ln_l, ln_r, out, B, L, K, K_out,
                                       nsub, l_sb, l_sl, r_sb, r_sl, s);
}

}  // namespace
