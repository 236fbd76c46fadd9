// K1, the per-pair log-einsum-exp forward (log_einsum_exp_fwd.cu, whose
// notes describe it), shared with the gather run's forward gather_fwd.cu
// (K5), which launches it depth by depth with its child rows read by row
// id, and its backward gather_bwd.cu (K6), which launches it depth by
// depth on child rows it has gathered.
#pragma once

#include "lee_common.cuh"

// Where a gather depth's K1 (K5) reads and writes: cell l's left and right
// child rows are buffer rows left[l] and right[l], those below r_in rows of
// ln_l (and ln_r) at its batch and cell strides, the others rows id - r_in
// of the run's new rows nw (K floats a row, batch stride nw_sb); output
// (b, l) goes to out + b o_sb + l K_out.
struct LeeRowIds {
  const int* left;
  const int* right;
  const float* nw;
  long long nw_sb;
  long long o_sb;
  int r_in;
};

namespace {

// One K1 block.  IDS: the rows by id (LeeRowIds); otherwise cell l's rows
// at l times the cell strides, and out (B, L, K_out) contiguous.
template <class Tile, bool IDS>
__device__ __forceinline__ void lee_fwd_block(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, float* __restrict__ out, int B, int L,
    int K, int K_out, int nsub, long long l_sb, long long l_sl,
    long long r_sb, long long r_sl, const LeeRowIds& ids) {
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
  if constexpr (IDS) {
    const int il = ids.left[l];
    const int ir = ids.right[l];
    lee_stage_rows(el,
                   il < ids.r_in ? ln_l + il * l_sl
                                 : ids.nw + (long long)(il - ids.r_in) * K,
                   il < ids.r_in ? l_sb : ids.nw_sb, b0, nb, tb, K);
    lee_stage_rows(er,
                   ir < ids.r_in ? ln_r + ir * r_sl
                                 : ids.nw + (long long)(ir - ids.r_in) * K,
                   ir < ids.r_in ? r_sb : ids.nw_sb, b0, nb, tb, K);
  } else {
    lee_stage_rows(el, ln_l + l * l_sl, l_sb, b0, nb, tb, K);
    lee_stage_rows(er, ln_r + l * r_sl, r_sb, b0, nb, tb, K);
  }
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
    const float v = (ml[r] + mr[r]) + logf(s);
    if constexpr (IDS) {
      out[(long long)(b0 + r) * ids.o_sb + l * K_out + k0 + k] = v;
    } else {
      out[((long long)(b0 + r) * L + l) * K_out + k0 + k] = v;
    }
  }
}

template <class Tile>
__global__ void __launch_bounds__(kLeeThreads, kLeeMinBlocks) lee_fwd_kernel(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, float* __restrict__ out, int B, int L,
    int K, int K_out, int nsub, long long l_sb, long long l_sl,
    long long r_sb, long long r_sl) {
  lee_fwd_block<Tile, false>(w, ln_l, ln_r, out, B, L, K, K_out, nsub, l_sb,
                             l_sl, r_sb, r_sl, LeeRowIds{});
}

template <class Tile>
__global__ void __launch_bounds__(kLeeThreads, kLeeMinBlocks)
    lee_fwd_ids_kernel(const float* __restrict__ w,
                       const float* __restrict__ x, float* __restrict__ out,
                       int B, int L, int K, int nsub, long long x_sb,
                       LeeRowIds ids) {
  lee_fwd_block<Tile, true>(w, x, x, out, B, L, K, K, nsub, x_sb, K, x_sb, K,
                            ids);
}

// The launch of K1, or with IDS of a gather depth's K1 (ln_l = ln_r = x,
// K_out = K, cell strides K).
template <class Tile, bool IDS = false>
cudaError_t lee_fwd_launch(const float* w, const float* ln_l, const float* ln_r,
                   float* out, int B, int L, int K, int K_out, int nsub,
                   long long l_sb, long long l_sl, long long r_sb,
                   long long r_sl, cudaStream_t stream,
                   const LeeRowIds& ids = LeeRowIds{}) {
  // the block's whole budget, allowed once; a launch asks for what it uses
  static const cudaError_t attr = [] {
    if constexpr (IDS) {
      return cudaFuncSetAttribute(lee_fwd_ids_kernel<Tile>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kLeeSmemLimit);
    } else {
      return cudaFuncSetAttribute(lee_fwd_kernel<Tile>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kLeeSmemLimit);
    }
  }();
  if (attr != cudaSuccess) return attr;
  const int tb = nsub * Tile::ROWS;
  const long long smem =
      4LL * ((long long)Tile::KT * lee_row_stride(K) + 2LL * tb +
             (2LL + Tile::KT) * tb * lee_pad(K));
  if (smem > kLeeSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(L, (B + tb - 1) / tb, (K_out + Tile::KT - 1) / Tile::KT);
  if constexpr (IDS) {
    lee_fwd_ids_kernel<Tile><<<grid, kLeeThreads, (size_t)smem, stream>>>(
        w, ln_l, out, B, L, K, nsub, l_sb, ids);
  } else {
    lee_fwd_kernel<Tile><<<grid, kLeeThreads, (size_t)smem, stream>>>(
        w, ln_l, ln_r, out, B, L, K, K_out, nsub, l_sb, l_sl, r_sb, r_sl);
  }
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
