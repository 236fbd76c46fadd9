// Grouped log-einsum-exp backward: every depth's weight gradient and the
// input cotangent of G consecutive canonical depths in one launch, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// grouped_log_einsum_exp_bwd_pallas (_make_bwd_kernel, _depth_bwd).  The
// subtree geometry is grouped_fwd.cu's: output cell c of the run owns the
// depth-g cells {c + m L_out : m < 2^(G-1-g)}, and at each depth cell
// c + m L_out has left child row c + m L_out and right child row
// c + (m + 2^(G-1-g)) L_out of the layer below.
//
// Layout: one block per (output cell c, tile of rows), in three steps.
//  1. Residual recompute: load the tile's 2^G input rows of the subtree and
//     run the forward in shared memory, keeping every depth's stabilised
//     inputs (lee_stabilize) and their clamped maxes.  Nothing but x and the
//     weights was saved by the forward.
//  2. Walk the depths in reverse.  At each depth, per chunk of weight cells
//     (lee_chunks: the whole depth, a few cells, or one cell's K_out tile):
//     recompute s with lee_cell_sum, the forward's own arithmetic, turn the
//     output cotangent into ginv = g / max(s, 1e-30) in place, add the
//     chunk's share of the input cotangent, and write the chunk's partial dW
//     for the tile's rows.  The input cotangent, times the stabilised
//     inputs, is the next depth's output cotangent.
//  3. Write the input cotangent of depth 0 to gx.
// Each block writes its own partial dW; a second kernel (lee_sum_tiles) sums
// the partials in tile order: no atomics, and two calls give bitwise-equal
// gradients.  gx is computed a row at a time.  Rows past the end of the
// batch are neither read nor written; an input at -inf has a stabilised
// value of 0 and so a gradient of exactly 0.
//
// What bounds it on the H100, at einet_rat's fused run [0,4) (B = 2048,
// L_out = 10, x (2048, 160, 10), K = 10, K_out 10/10/10/1): it must read x
// (13.1 MB), g (82 KB) and the weights (56 KB) and write gx (13.1 MB) and
// dW (56 KB), about 26.4 MB or 7.9 us at 3.35 TB/s.  The work is the
// forward's contraction (s), the c = ginv W of the input cotangent and dW,
// 2 K^2 K_out flops each per cell and row over sum(cells K^2 K_out) = 141,000
// a row, plus 4 K^2 a cell for the row and column sums of c: about 906,000
// flops a row, 1.86 GFLOP in all, 27.7 us at the 67 TFLOP/s fp32 (non-
// tensor) rate.  So it is bound by operations.  Shared memory at a 32-row
// tile: one depth's weights (8,000 floats), the 16+8+4+2 stabilised rows
// and their maxes, and two cotangent areas (16 and 8 rows), 105 KB.
//
// Later work, not done here: tensor cores for the contractions, larger row
// tiles or a persistent loop over tiles to cut the partials.

#include "lee_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepths = 8;

struct GroupBwdArgs {
  const float* w[kMaxDepths];  // depth d: (L_out 2^(G-1-d), k_out[d], K, K)
  int k_out[kMaxDepths];
  long long gw_off[kMaxDepths];  // depth d's offset in one tile's partial
};

__global__ void __launch_bounds__(kThreads) grouped_bwd_kernel(
    GroupBwdArgs args, int G, const float* __restrict__ x,
    const float* __restrict__ g_out, float* __restrict__ gw_part,
    long long part_floats, float* __restrict__ gx, int B, int L_out, int K,
    int tile_b, long long x_sb, int w_floats, int c0_floats, int c1_floats) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int tile = blockIdx.y;
  const int b0 = tile * tile_b;
  const int nb = min(tile_b, B - b0);
  const int KK = K * K;
  const int M0 = 1 << G;
  // shared memory: weights, every depth's stabilised inputs (depth d holds
  // tile_b * 2^(G-d) rows of K at row offset tile_b (2^(G+1) - 2^(G+1-d))),
  // their maxes, and two cotangent areas
  float* wbuf = smem;
  float* ebuf = wbuf + w_floats;
  float* abuf = ebuf + (long long)tile_b * (2 * M0 - 2) * K;
  float* cot[2];
  cot[0] = abuf + tile_b * (2 * M0 - 2);
  cot[1] = cot[0] + c0_floats;

  for (int t = threadIdx.x; t < nb * M0 * K; t += blockDim.x) {
    const int r = t / (M0 * K);
    const int rem = t - r * M0 * K;
    const int m = rem / K;
    const int i = rem - m * K;
    ebuf[t] = x[(long long)(b0 + r) * x_sb +
                ((long long)c + (long long)m * L_out) * K + i];
  }
  // 1. forward recompute: stabilise depth d's inputs, then (below the last
  // depth) write depth d + 1's inputs
  for (int d = 0; d < G; ++d) {
    const int M = M0 >> d;
    const int H = M >> 1;
    float* cur = ebuf + (long long)tile_b * (2 * M0 - 2 * M) * K;
    float* amax = abuf + tile_b * (2 * M0 - 2 * M);
    __syncthreads();
    for (int t = threadIdx.x; t < nb * M; t += blockDim.x) {
      amax[t] = lee_stabilize(cur + t * K, K);
    }
    if (d == G - 1) break;
    float* nxt = cur + (long long)tile_b * M * K;
    const int ko = args.k_out[d];  // == K for an interior depth
    const float* wd = args.w[d];
    const LeeChunks ch = lee_chunks(H, ko, KK, w_floats);
    for (int m0 = 0; m0 < H; m0 += ch.cells) {
      const int mn = min(ch.cells, H - m0);
      for (int k0 = 0; k0 < ko; k0 += ch.kt) {
        const int kn = min(ch.kt, ko - k0);
        __syncthreads();
        for (int t = threadIdx.x; t < mn * kn * KK; t += blockDim.x) {
          const int m = t / (kn * KK);
          const int rem = t - m * kn * KK;
          wbuf[t] = wd[((long long)c + (long long)(m0 + m) * L_out) * ko * KK +
                       (long long)k0 * KK + rem];
        }
        __syncthreads();
        for (int o = threadIdx.x; o < nb * mn * kn; o += blockDim.x) {
          const int r = o / (mn * kn);
          const int rem = o - r * mn * kn;
          const int m = rem / kn;
          const int k = rem - m * kn;
          const int lrow = r * M + m0 + m;
          const int rrow = lrow + H;
          const float s = lee_cell_sum(wbuf + (m * kn + k) * KK,
                                       cur + lrow * K, cur + rrow * K, K);
          nxt[(r * H + m0 + m) * ko + k0 + k] =
              (amax[lrow] + amax[rrow]) + logf(s);
        }
      }
    }
  }
  // 2. the output cotangent of the last depth, then the depths in reverse
  const int kf = args.k_out[G - 1];
  {
    float* gcur = cot[(G - 1) & 1];
    for (int t = threadIdx.x; t < nb * kf; t += blockDim.x) {
      const int r = t / kf;
      const int k = t - r * kf;
      gcur[t] = g_out[((long long)(b0 + r) * L_out + c) * kf + k];
    }
  }
  for (int d = G - 1; d >= 0; --d) {
    const int M = M0 >> d;
    const int H = M >> 1;
    const int ko = args.k_out[d];
    const float* wd = args.w[d];
    const float* e = ebuf + (long long)tile_b * (2 * M0 - 2 * M) * K;
    float* gout = cot[d & 1];       // (row, m < H, k < ko), then ginv
    float* gin = cot[(d + 1) & 1];  // (row, m < M, i < K)
    float* part = gw_part + (long long)tile * part_floats + args.gw_off[d];
    __syncthreads();
    for (int t = threadIdx.x; t < nb * M * K; t += blockDim.x) gin[t] = 0.f;
    const LeeChunks ch = lee_chunks(H, ko, KK, w_floats);
    for (int m0 = 0; m0 < H; m0 += ch.cells) {
      const int mn = min(ch.cells, H - m0);
      for (int k0 = 0; k0 < ko; k0 += ch.kt) {
        const int kn = min(ch.kt, ko - k0);
        __syncthreads();
        for (int t = threadIdx.x; t < mn * kn * KK; t += blockDim.x) {
          const int m = t / (kn * KK);
          const int rem = t - m * kn * KK;
          wbuf[t] = wd[((long long)c + (long long)(m0 + m) * L_out) * ko * KK +
                       (long long)k0 * KK + rem];
        }
        __syncthreads();
        for (int o = threadIdx.x; o < nb * mn * kn; o += blockDim.x) {
          const int r = o / (mn * kn);
          const int rem = o - r * mn * kn;
          const int m = rem / kn;
          const int k = rem - m * kn;
          const int lrow = r * M + m0 + m;
          const float s = lee_cell_sum(wbuf + (m * kn + k) * KK, e + lrow * K,
                                       e + (lrow + H) * K, K);
          const int idx = (r * H + m0 + m) * ko + k0 + k;
          gout[idx] = gout[idx] / fmaxf(s, LEE_S_FLOOR);
        }
        __syncthreads();
        // the chunk's share of the input cotangent, before the factor e
        for (int t = threadIdx.x; t < nb * mn * K; t += blockDim.x) {
          const int r = t / (mn * K);
          const int rem = t - r * mn * K;
          const int m = rem / K;
          const int i = rem - m * K;
          const int lrow = r * M + m0 + m;
          const float* gi = gout + (r * H + m0 + m) * ko + k0;
          const float* wm = wbuf + m * kn * KK;
          const float* el = e + lrow * K;
          const float* er = e + (lrow + H) * K;
          float al = 0.f;  // sum_j er_j c[i, j]
          float ar = 0.f;  // sum_i' el_i' c[i', i]
          for (int j = 0; j < K; ++j) {
            float cl = 0.f;
            float cr = 0.f;
            for (int k = 0; k < kn; ++k) {
              cl = fmaf(gi[k], wm[k * KK + i * K + j], cl);
              cr = fmaf(gi[k], wm[k * KK + j * K + i], cr);
            }
            al = fmaf(cl, er[j], al);
            ar = fmaf(cr, el[j], ar);
          }
          gin[lrow * K + i] += al;
          gin[(lrow + H) * K + i] += ar;
        }
        // the chunk's partial dW over the tile's rows
        for (int o = threadIdx.x; o < mn * kn * KK; o += blockDim.x) {
          const int m = o / (kn * KK);
          const int rem = o - m * kn * KK;
          const int k = rem / KK;
          const int ij = rem - k * KK;
          const int i = ij / K;
          const int j = ij - i * K;
          float acc = 0.f;
          for (int r = 0; r < nb; ++r) {
            const int lrow = r * M + m0 + m;
            acc = fmaf(gout[(r * H + m0 + m) * ko + k0 + k],
                       e[lrow * K + i] * e[(lrow + H) * K + j], acc);
          }
          part[((long long)c + (long long)(m0 + m) * L_out) * ko * KK +
               (long long)(k0 + k) * KK + ij] = acc;
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb * M * K; t += blockDim.x) gin[t] *= e[t];
  }
  // 3. depth 0's input cotangent, in cot[1]
  __syncthreads();
  const float* g0 = cot[1];
  for (int t = threadIdx.x; t < nb * M0 * K; t += blockDim.x) {
    const int r = t / (M0 * K);
    const int rem = t - r * M0 * K;
    const int m = rem / K;
    const int i = rem - m * K;
    gx[((long long)(b0 + r) * L_out * M0 + (long long)c +
        (long long)m * L_out) * K + i] = g0[t];
  }
}

}  // namespace

// ws[d] (L_out 2^(G-1-d), k_outs[d], K, K) contiguous, interior k_outs == K;
// x (B, L_out 2^G, K) with unit strides over rows and K and batch stride
// x_sb; g_out (B, L_out, k_outs[G-1]) contiguous.  Writes gx (B, L_out 2^G,
// K) contiguous and gw, every depth's weight gradient in one flat buffer
// (depth d at gw_offs[d], laid out like ws[d]; part_floats in all).  With
// more than one row tile, gw_part holds ceil(B / tile_b) such buffers and
// is summed into gw in tile order; with one tile, pass gw_part == gw.
// w_floats (at least K^2), c0_floats and c1_floats size the shared-memory
// areas for a row tile of tile_b (the wrapper computes them).  Launches on
// `stream`; returns the first CUDA error, or 0, or cudaErrorInvalidValue
// for G outside [1, 8].
extern "C" int grouped_bwd(const float* const* ws, const int* k_outs,
                           const long long* gw_offs, int G, const float* x,
                           const float* g_out, float* gw_part, float* gw,
                           long long part_floats, float* gx, int B, int L_out,
                           int K, int tile_b, long long x_sb, int w_floats,
                           int c0_floats, int c1_floats, void* stream) {
  if (G < 1 || G > kMaxDepths) return (int)cudaErrorInvalidValue;
  GroupBwdArgs args = {};
  for (int d = 0; d < G; ++d) {
    args.w[d] = ws[d];
    args.k_out[d] = k_outs[d];
    args.gw_off[d] = gw_offs[d];
  }
  const long long rows = (2LL << G) - 2;  // stabilised rows per batch row
  const long long smem =
      4LL * ((long long)w_floats + (long long)tile_b * rows * (K + 1) +
             c0_floats + c1_floats);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + tile_b - 1) / tile_b;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(L_out, tiles);
  grouped_bwd_kernel<<<grid, kThreads, (size_t)smem, s>>>(
      args, G, x, g_out, gw_part, part_floats, gx, B, L_out, K, tile_b, x_sb,
      w_floats, c0_floats, c1_floats);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  return (int)lee_sum_tiles(gw_part, gw, part_floats, tiles, s);
}
