// Log-einsum-exp forward for one (product, sum) layer pair, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/log_einsum_exp.py
// log_einsum_exp_pallas (_fwd_kernel).  For each layer cell l and row b:
//   a  = max(NEG_INF, max_i ln_l[b,l,i]),  a' = the same for ln_r
//   s  = sum_{i,j} W[l,k,i,j] exp(ln_l[b,l,i] - a) exp(ln_r[b,l,j] - a')
//   out[b,l,k] = (a + a') + log s
//
// Layout: one block per (cell l, tile of rows, tile of K_out); the wrapper
// uses 32-row tiles.  The block
// stages W[l] (its K_out tile) and the tile's ln rows in shared memory,
// stabilises each row once in place, then each thread produces (row, k)
// outputs with lee_cell_sum: fp32 FMAs in a fixed (i, j) order.  A row's
// result therefore does not depend on the batch size or the tile.  Rows
// past the end of the batch are neither read nor written.  Where one cell's
// W does not fit beside the tile's rows in 227 KB, the wrapper tiles K_out
// (grid z); at K = 40 a whole cell is 256 KB.
//
// What bounds it on the H100, at einet_rat's first pair (B = 2048, L = 80,
// K = K_out = 10): it must read ln_l and ln_r (13.1 MB) and W (0.32 MB) and
// write out (6.6 MB), about 20 MB or 6.0 us at 3.35 TB/s; the contraction is
// 2 B L K_out K^2 = 0.33 GFLOP, 4.9 us at the 67 TFLOP/s fp32 (non-tensor)
// rate.  So it is bound by bytes, and each input byte is read once.  At the
// root pair (L = 10, K_out = 1) the bytes (1.7 MB) dominate further.
//
// Later work, not done here: tensor cores (TF32 or split-precision wgmma for
// the K^2 x K_out product), cp.async/TMA staging, and larger tiles.

#include "lee_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) lee_fwd_kernel(
    const float* __restrict__ w, const float* __restrict__ ln_l,
    const float* __restrict__ ln_r, float* __restrict__ out, int B, int L,
    int K, int K_out, int tile_b, int kt, long long l_sb, long long l_sl,
    long long r_sb, long long r_sl) {
  extern __shared__ float smem[];
  const int l = blockIdx.x;
  const int b0 = blockIdx.y * tile_b;
  const int k0 = blockIdx.z * kt;
  const int kn = min(kt, K_out - k0);
  const int nb = min(tile_b, B - b0);
  const int KK = K * K;
  float* ws = smem;              // kt * K^2: W[l, k0:k0+kn]
  float* el = ws + kt * KK;      // tile_b * K: left rows, then their exps
  float* er = el + tile_b * K;   // tile_b * K: right rows, then their exps
  float* ml = er + tile_b * K;   // tile_b: clamped left maxes
  float* mr = ml + tile_b;       // tile_b: clamped right maxes

  const float* wl = w + ((long long)l * K_out + k0) * KK;
  for (int t = threadIdx.x; t < kn * KK; t += blockDim.x) ws[t] = wl[t];
  for (int t = threadIdx.x; t < nb * K; t += blockDim.x) {
    const int r = t / K;
    const int i = t - r * K;
    const long long b = b0 + r;
    el[t] = ln_l[b * l_sb + l * l_sl + i];
    er[t] = ln_r[b * r_sb + l * r_sl + i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) {
    if (t < nb) {
      ml[t] = lee_stabilize(el + t * K, K);
    } else {
      mr[t - nb] = lee_stabilize(er + (t - nb) * K, K);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nb * kn; o += blockDim.x) {
    const int r = o / kn;
    const int k = o - r * kn;
    const float s = lee_cell_sum(ws + k * KK, el + r * K, er + r * K, K);
    out[((long long)(b0 + r) * L + l) * K_out + k0 + k] =
        (ml[r] + mr[r]) + logf(s);
  }
}

}  // namespace

// w (L, K_out, K, K) contiguous; ln_l / ln_r (B, L, K) with unit stride over
// K and the given batch and cell strides; out (B, L, K_out) contiguous.
// tile_b rows and kt outputs per block (the wrapper sizes them so that the
// shared memory below fits).  Launches on `stream`; returns cudaGetLastError().
extern "C" int lee_fwd(const float* w, const float* ln_l, const float* ln_r,
                       float* out, int B, int L, int K, int K_out, int tile_b,
                       int kt, long long l_sb, long long l_sl, long long r_sb,
                       long long r_sl, void* stream) {
  const long long smem =
      4LL * ((long long)kt * K * K + 2LL * tile_b * K + 2LL * tile_b);
  cudaError_t err = cudaFuncSetAttribute(
      lee_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L, (B + tile_b - 1) / tile_b, (K_out + kt - 1) / kt);
  lee_fwd_kernel<<<grid, kThreads, (size_t)smem,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      w, ln_l, ln_r, out, B, L, K, K_out, tile_b, kt, l_sb, l_sl, r_sb, r_sl);
  return (int)cudaGetLastError();
}
