// Log-einsum-exp backward for one (product, sum) layer pair, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/log_einsum_exp.py
// log_einsum_exp_bwd_pallas (_bwd_kernel).  For each layer cell l and row b,
// in the forward's own frame (lee_stabilize, lee_cell_sum):
//   el = exp(ln_l - a), er = exp(ln_r - a'), s[k] = sum_ij W[k,i,j] el_i er_j
//   ginv[k] = g[b,l,k] / max(s[k], 1e-30)
//   gw[l,k,i,j] = sum_b ginv[k] el_i er_j
//   gl[b,l,i]   = el_i sum_j er_j (sum_k ginv[k] W[k,i,j])
//   gr[b,l,j]   = er_j sum_i el_i (sum_k ginv[k] W[k,i,j])
//
// Layout: one block per (cell l, tile of rows).  The block stabilises its
// rows in shared memory, then walks K_out in tiles of kt weight cells (all
// of K_out when one cell's W fits beside the rows, as for K1): stage the
// tile's W, compute s and ginv for each (row, k), add the tile's share of gl
// and gr into per-row accumulators, and write the tile's partial dW for its
// rows.  The Pallas kernel summed dW across batch tiles by revisiting one
// block along its sequential grid axis; here blocks run in no order, so each
// block writes its own partial and a second kernel (lee_sum_tiles) adds the
// partials in tile order: no atomics, and two calls give bitwise-equal gw.
// gl and gr are computed a row at a time, so they do not depend on the
// batch.  Rows past the end of the batch are neither read nor written; an
// input at -inf has el = 0 and so a gradient of exactly 0.
//
// What bounds it on the H100, at einet_rat's first pair (B = 2048, L = 80,
// K = K_out = 10): it must read ln_l and ln_r (13.1 MB), g (6.6 MB) and W
// (0.32 MB) and write gl and gr (13.1 MB) and gw (0.32 MB), about 33 MB or
// 10.0 us at 3.35 TB/s; the three contractions (s, the c = ginv W of gl and
// gr, dW) are 2 K^2 K_out flops each per cell and row, and the row and
// column sums of c 4 K^2 more, 1.05 GFLOP in all, 15.7 us at the
// 67 TFLOP/s fp32 (non-tensor) rate.  So it is bound by operations.  The partials add 64 tiles x 0.32 MB written and read back.
//
// Later work, not done here: tensor cores for the three contractions,
// larger row tiles or a persistent loop over tiles to cut the partials.

#include "lee_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) lee_bwd_kernel(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, const float* __restrict__ g,
    float* __restrict__ gw_part, float* __restrict__ gl,
    float* __restrict__ gr, int B, int L, int K, int K_out, int tile_b,
    int kt, long long l_sb, long long l_sl, long long r_sb, long long r_sl) {
  extern __shared__ float smem[];
  const int l = blockIdx.x;
  const int tile = blockIdx.y;
  const int b0 = tile * tile_b;
  const int nb = min(tile_b, B - b0);
  const int KK = K * K;
  float* ws = smem;                  // kt * K^2: W[l, k0:k0+kn]
  float* el = ws + kt * KK;          // tile_b * K: left rows, then their exps
  float* er = el + tile_b * K;       // tile_b * K: right rows, then exps
  float* accl = er + tile_b * K;     // tile_b * K: gl before the factor el
  float* accr = accl + tile_b * K;   // tile_b * K: gr before the factor er
  float* ginv = accr + tile_b * K;   // tile_b * kt: g / s of the K_out tile

  for (int t = threadIdx.x; t < nb * K; t += blockDim.x) {
    const int r = t / K;
    const int i = t - r * K;
    const long long b = b0 + r;
    el[t] = ln_l[b * l_sb + l * l_sl + i];
    er[t] = ln_r[b * r_sb + l * r_sl + i];
    accl[t] = 0.f;
    accr[t] = 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) {
    if (t < nb) {
      lee_stabilize(el + t * K, K);
    } else {
      lee_stabilize(er + (t - nb) * K, K);
    }
  }
  for (int k0 = 0; k0 < K_out; k0 += kt) {
    const int kn = min(kt, K_out - k0);
    // the rows are stabilised, and the previous tile is done with ws/ginv
    __syncthreads();
    const float* wl = w + ((long long)l * K_out + k0) * KK;
    for (int t = threadIdx.x; t < kn * KK; t += blockDim.x) ws[t] = wl[t];
    __syncthreads();
    for (int o = threadIdx.x; o < nb * kn; o += blockDim.x) {
      const int r = o / kn;
      const int k = o - r * kn;
      const float s = lee_cell_sum(ws + k * KK, el + r * K, er + r * K, K);
      ginv[r * kt + k] =
          g[((long long)(b0 + r) * L + l) * K_out + k0 + k] /
          fmaxf(s, LEE_S_FLOOR);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb * K; t += blockDim.x) {
      const int r = t / K;
      const int i = t - r * K;
      const float* gi = ginv + r * kt;
      const float* elr = el + r * K;
      const float* err = er + r * K;
      float al = 0.f;  // sum_j er_j c[i, j]
      float ar = 0.f;  // sum_i' el_i' c[i', i]
      for (int j = 0; j < K; ++j) {
        float cl = 0.f;
        float cr = 0.f;
        for (int k = 0; k < kn; ++k) {
          cl = fmaf(gi[k], ws[k * KK + i * K + j], cl);
          cr = fmaf(gi[k], ws[k * KK + j * K + i], cr);
        }
        al = fmaf(cl, err[j], al);
        ar = fmaf(cr, elr[j], ar);
      }
      accl[t] += al;
      accr[t] += ar;
    }
    float* part = gw_part + ((long long)tile * L + l) * K_out * KK +
                  (long long)k0 * KK;
    for (int o = threadIdx.x; o < kn * KK; o += blockDim.x) {
      const int k = o / KK;
      const int ij = o - k * KK;
      const int i = ij / K;
      const int j = ij - i * K;
      float acc = 0.f;
      for (int r = 0; r < nb; ++r) {
        acc = fmaf(ginv[r * kt + k], el[r * K + i] * er[r * K + j], acc);
      }
      part[o] = acc;
    }
  }
  for (int t = threadIdx.x; t < nb * K; t += blockDim.x) {
    const int r = t / K;
    const int i = t - r * K;
    const long long off = ((long long)(b0 + r) * L + l) * K + i;
    gl[off] = el[t] * accl[t];
    gr[off] = er[t] * accr[t];
  }
}

}  // namespace

// w (L, K_out, K, K) contiguous; ln_l / ln_r (B, L, K) with unit stride over
// K and the given batch and cell strides; g (B, L, K_out) contiguous.
// Writes gl / gr (B, L, K) contiguous and gw (L, K_out, K, K).  With more
// than one row tile, gw_part holds ceil(B / tile_b) partials of gw's size
// and is summed into gw in tile order; with one tile, pass gw_part == gw.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int lee_bwd(const float* w, const float* ln_l, const float* ln_r,
                       const float* g, float* gw_part, float* gw, float* gl,
                       float* gr, int B, int L, int K, int K_out, int tile_b,
                       int kt, long long l_sb, long long l_sl, long long r_sb,
                       long long r_sl, void* stream) {
  const long long smem = 4LL * ((long long)kt * K * K + 4LL * tile_b * K +
                                (long long)tile_b * kt);
  cudaError_t err = cudaFuncSetAttribute(
      lee_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + tile_b - 1) / tile_b;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(L, tiles);
  lee_bwd_kernel<<<grid, kThreads, (size_t)smem, s>>>(
      w, ln_l, ln_r, g, gw_part, gl, gr, B, L, K, K_out, tile_b, kt, l_sb,
      l_sl, r_sb, r_sl);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  return (int)lee_sum_tiles(gw_part, gw, (long long)L * K_out * K * K, tiles,
                            s);
}
