// Log-einsum-exp backward for one (product, sum) layer pair, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/log_einsum_exp.py
// log_einsum_exp_bwd_pallas (_bwd_kernel).  For each layer cell l and row b,
// in the forward's own frame (lee_stabilize, and s with lee_cell_sum's FMA
// order):
//   el = exp(ln_l - a), er = exp(ln_r - a'), s[k] = sum_ij W[k,i,j] el_i er_j
//   ginv[k] = g[b,l,k] / max(s[k], 1e-30)
//   gw[l,k,i,j] = sum_b ginv[k] el_i er_j
//   gl[b,l,i]   = el_i sum_k ginv[k] t[k,i],   t[k,i] = sum_j W[k,i,j] er_j
//   gr[b,l,j]   = er_j sum_k ginv[k] u[k,j],   u[k,j] = sum_i W[k,i,j] el_i
//
// Two kernels and, with more than one batch split, a sum.
//
// lee_bwd_rows_kernel, one block per (cell l, row tile, K_out tile of
// LeeTile::KT weight rows), stages its rows of W (lee_stage_weights, odd
// stride), runs the forward's sweep (lee_sweep: register tiled,
// conflict-free, spread over the warps by (row subtile, i)) into shared
// memory, sums s from it in lee_cell_sum's order and turns it into ginv,
// which it also writes out for the dW kernel; then sums each row's
// sum_k ginv_k t[k,i] over its tile, and after the same sweep over i (u)
// each row's sum_k ginv_k u[k,j].  The t that s is made of is reused for
// gl, so s, gl and gr cost two sweeps, not three contractions.
// With one K_out tile (einet_rat's K = K_out = 10 in one 10-output tile,
// every K_out = 1 root) those sums times el (er) are gl (gr); with several
// (einet_pd's K_out = 40: 5 tiles) each tile writes its sums, and the dW
// kernel adds them in tile order.  Giving each K_out tile its own blocks,
// instead of walking the tiles in one block, quintuples einet_pd's blocks
// (its 512 rows and 4 cells alone make 128).  Every value depends on its
// row alone, and the tile (so the order of the sums) on K and K_out alone.
//
// lee_bwd_dw_kernel: dW sums over the batch, so its grid is (cell l,
// K_out tile, batch split).  A block walks its split's rows in order in
// chunks of 32 (stabilised again in shared memory, ginv read back), and
// each thread keeps 4 outputs x JT columns j of one (k-quad, i) in
// registers, so an el_i er_j product it forms feeds 4 FMAs and a ginv
// JT.  The blocks of the first K_out tile also finish gl and gr of their
// rows from the rows kernel's tile sums.  The wrapper picks the split
// count from the grid (about eight blocks an SM, at most one split per 32
// rows); the splits' partials are summed in split order by lee_sum_tiles.
// No atomics: two calls give bitwise equal gradients.  einet_rat's first
// pair writes 14 partials and einet_pd's K = 40 pairs 16 (a partial per
// 32-row tile would be 64 and 16).
//
// Rows past the end of the batch are neither read nor written; an input
// at -inf has el = 0 and so a gradient of exactly 0.
//
// What bounds it on the H100: at einet_rat's first pair (B = 2048, L = 80,
// K = K_out = 10) it must read ln_l and ln_r (13.1 MB), g (6.6 MB) and W
// (0.32 MB) and write gl and gr (13.1 MB) and gw (0.32 MB), about 33 MB or
// 10.0 us at 3.35 TB/s; the contractions (s, gl's and gr's, dW) are counted
// as 6 K^2 K_out flops and 4 K^2 more per cell and row, 1.05 GFLOP or
// 15.7 us at the 67 TFLOP/s fp32 (non-tensor) rate: bound by operations,
// and so at einet_pd's (B = 512, L = 4, K = K_out = 40: 0.80 GFLOP, 11.9
// us).
//
// Later work, not done here: the contractions on tensor cores (TF32, or
// an error-compensated 3xTF32 split to keep fp32 accuracy: every FMA here
// is fp32), cp.async or TMA staging overlapped with the sweeps.

#include "lee_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDwChunk = 32;  // rows a dW block stages at a time
// blocks an SM the rows kernel is compiled for (registers: at most 64 a
// thread: at 80 to 102, where the compiler puts them unbounded, only two
// blocks fit and the rows kernel's chain of barriers is latency bound)
constexpr int kMinBlocks = 4;

template <class Tile>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lee_bwd_rows_kernel(
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

// A thread's item is (k-quad kq, i, column group jg): outputs k0 + 4 kq +
// u (u < 4) and columns j = jg + a NJG (a < JT).
template <int JT>
__global__ void __launch_bounds__(kThreads) lee_bwd_dw_kernel(
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
  float* el = smem;                  // kDwChunk Kp
  float* er = el + kDwChunk * Kp;    // kDwChunk Kp
  float* gs = er + kDwChunk * Kp;    // kDwChunk ktw: ginv of the chunk
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
    for (int c0 = rb; c0 < re; c0 += kDwChunk) {
      const int cn = min(kDwChunk, re - c0);
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

template <class Tile>
cudaError_t launch_rows(const float* w, const float* ln_l, const float* ln_r,
                        const float* g, float* ginv, float* gl, float* gr,
                        float* acc, int B, int L, int K, int K_out, int nsub,
                        long long l_sb, long long l_sl, long long r_sb,
                        long long r_sl, cudaStream_t stream) {
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
  lee_bwd_rows_kernel<Tile><<<grid, kThreads, (size_t)smem, stream>>>(
      w, ln_l, ln_r, g, ginv, gl, gr, acc, B, L, K, K_out, nsub, l_sb, l_sl,
      r_sb, r_sl);
  return cudaGetLastError();
}

template <int JT>
cudaError_t launch_dw(const float* ln_l, const float* ln_r,
                      const float* ginv, const float* acc, float* gw_part,
                      float* gl, float* gr, int B, int L, int K, int K_out,
                      int ktw, int splits, int n_kt, long long l_sb,
                      long long l_sl, long long r_sb, long long r_sl,
                      cudaStream_t stream) {
  const long long smem =
      4LL * (2LL * kDwChunk * lee_pad(K) + (long long)kDwChunk * ktw);
  static const cudaError_t attr = cudaFuncSetAttribute(
      lee_bwd_dw_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  if (smem > kLeeSmemLimit) return cudaErrorInvalidValue;
  const int rows_per_split = (B + splits - 1) / splits;
  const dim3 grid(L, (K_out + ktw - 1) / ktw, splits);
  lee_bwd_dw_kernel<JT><<<grid, kThreads, (size_t)smem, stream>>>(
      ln_l, ln_r, ginv, acc, gw_part, gl, gr, B, L, K, K_out, ktw,
      rows_per_split, n_kt, l_sb, l_sl, r_sb, r_sl);
  return cudaGetLastError();
}

template <class Tile>
cudaError_t launch_all(const float* w, const float* ln_l, const float* ln_r,
                       const float* g, float* ginv, float* acc,
                       float* gw_part, float* gw, float* gl, float* gr, int B,
                       int L, int K, int K_out, int nsub, int jt, int ktw,
                       int splits, long long l_sb, long long l_sl,
                       long long r_sb, long long r_sl, cudaStream_t s) {
  cudaError_t err = launch_rows<Tile>(w, ln_l, ln_r, g, ginv, gl, gr, acc, B,
                                      L, K, K_out, nsub, l_sb, l_sl, r_sb,
                                      r_sl, s);
  if (err != cudaSuccess) return err;
  const int n_kt = (K_out + Tile::KT - 1) / Tile::KT;
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

// w (L, K_out, K, K) contiguous; ln_l / ln_r (B, L, K) with unit stride over
// K and the given batch and cell strides; g (B, L, K_out) contiguous.
// Writes gl / gr (B, L, K) contiguous and gw (L, K_out, K, K), with ginv
// (B, L, K_out) as scratch and, with more than one K_out tile of the rows
// kernel, acc (2 tiles B L K floats) for gl's and gr's partials.  tile 0:
// 16-row subtiles x 8 outputs; tile 1: 32-row subtiles x 1 output; tile 2:
// 32-row subtiles x 10 outputs; nsub subtiles a rows block.  The dW kernel
// takes ktw outputs (a multiple of 4) and jt columns (4, 8 or 16) a
// thread; with splits > 1, gw_part holds `splits` partials of gw's size
// and is summed into gw in split order; with one split, pass gw_part ==
// gw.  Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int lee_bwd(const float* w, const float* ln_l, const float* ln_r,
                       const float* g, float* ginv, float* acc,
                       float* gw_part, float* gw, float* gl, float* gr, int B,
                       int L, int K, int K_out, int tile, int nsub, int jt,
                       int ktw, int splits, long long l_sb, long long l_sl,
                       long long r_sb, long long r_sl, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (tile == 0) {
    return (int)launch_all<LeeTile<2, 2, 4>>(
        w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out,
        nsub, jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
  }
  if (tile == 2) {
    return (int)launch_all<LeeTile<2, 5, 2>>(
        w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out,
        nsub, jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
  }
  return (int)launch_all<LeeTile<1, 1, 1>>(
      w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B, L, K, K_out, nsub,
      jt, ktw, splits, l_sb, l_sl, r_sb, r_sl, s);
}
