// Gather-grouped log-einsum-exp backward: every depth's weight gradient,
// every mixing depth's mixing-weight gradient and the input cotangent of a
// whole gather run (a Poon-Domingos interior) in one launch, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// gather_grouped_log_einsum_exp_bwd_pallas (_make_gather_bwd_kernel,
// _gather_depth_bwd).  One block per tile of rows, batch-only grid, in
// three steps:
//  1. Residual recompute: load the tile's input rows and run the forward
//     walk (gather_forward_sweep, the forward kernel's own code) in shared
//     memory: every row in the log domain and the stabilised copy and max
//     of every row that may be a child.  Nothing but x, the weights and the
//     tables was saved by the forward.
//  2. A cotangent buffer the size of the row buffer starts at 0 for the
//     input rows and at g_out for the new rows.  Walk the depths in
//     reverse; at each depth, in the plain version's order
//     (kernels/grouped.py gather_grouped_log_einsum_exp_bwd_plain):
//     a. mixing first: recompute the mixing frame, ginv = g / max(s, 1e-30),
//        the terms ge = ginv e (an exact 0 for a masked child), the tile's
//        partial gV (its rows' ge summed in row order), and add ge v into
//        the depth's einsum rows, slot by slot in (m, c) order;
//     b. then the pair: per chunk of weights (lee_chunks, as in the
//        forward) recompute s with the forward's cell sum, turn the einsum
//        rows' cotangent into ginv in place, add the chunk's share of the
//        children's input cotangent (before its factor el or er) and write
//        the chunk's partial dW for the tile's rows;
//     c. add the children's input cotangents el sl and er sr into their
//        rows: one thread a (batch row, i) walks the depth's right children
//        in order, then its left children, so a row reached from several
//        sides, depths and mixing slots always sums in the same order.
//  3. Write the input rows' cotangent to gx.
// Each block writes its own partial dW and dV; lee_sum_tiles sums the
// partials in tile order: no atomics, and two calls give bitwise-equal
// gradients, so EM statistics are reproducible run to run.  The partials
// are (tiles) x (all weights): the wrapper picks the tile for about one
// block an SM, as the forward's, and keeps them under 256 MB (einet_pd at
// B = 512: 4-row tiles, 128 partials of 1.79 MB).  Rows past the end of
// the batch are neither read nor written; an input at -inf has a
// stabilised value of 0 and so a gradient of exactly 0.
//
// What bounds it on the H100, at einet_pd's run [0,2) (B = 512, r_in = 4,
// K = 40, 7 cells, mixing (2, 2)): it must read x (328 KB), g_out (737 KB)
// and the weights (1.79 MB) and write gx (328 KB), dW (1.79 MB) and dV,
// about 5.0 MB or 1.5 us at 3.35 TB/s.  The work is the forward's
// contraction (s), c = ginv W for the input cotangent and dW, 2 K^3 flops
// each per cell and row, plus 4 K^2 for the row and column sums of c:
// 1.40 GFLOP in all, 20.9 us at the 67 TFLOP/s fp32 (non-tensor) rate.  So
// it is bound by operations.  Summing the partials moves 229 MB more.
//
// Later work, not done here: input-slice staging as in the forward's note,
// tensor cores, a persistent loop over tiles to cut the partials.

#include "gather_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_bwd_kernel(
    GatherParams p, const int* __restrict__ tab_g, int n_tab,
    const float* __restrict__ x, const float* __restrict__ g_out,
    float* __restrict__ part_all, long long part_floats,
    float* __restrict__ gx, int B, int K, int tile_b, long long x_sb,
    int w_floats, int R, int Rc, int l_max, int mc_max) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int b0 = tile * tile_b;
  const int nb = min(tile_b, B - b0);
  const int KK = K * K;
  const int KKp = lee_row_stride(K);
  float* wbuf = smem;
  GatherRows g;
  g.X = wbuf + w_floats;
  g.E = g.X + (long long)tile_b * R * K;
  g.A = g.E + (long long)tile_b * Rc * K;
  g.R = R;
  g.Rc = Rc;
  g.K = K;
  float* cot = g.A + tile_b * Rc;                // (row, R, K)
  float* sl = cot + (long long)tile_b * R * K;   // (row, L, K) left sums
  float* sr = sl + (long long)tile_b * l_max * K;
  float* ge = sr + (long long)tile_b * l_max * K;  // (row, M C, K)
  int* tab = reinterpret_cast<int*>(ge + (long long)tile_b * mc_max * K);
  for (int t = threadIdx.x; t < n_tab; t += blockDim.x) tab[t] = tab_g[t];
  __syncthreads();
  const int D = tab[0];
  const int r_in = tab[1];
  for (int t = threadIdx.x; t < nb * r_in * K; t += blockDim.x) {
    const int r = t / (r_in * K);
    const int rem = t - r * r_in * K;
    g.X[(long long)r * R * K + rem] = x[(long long)(b0 + r) * x_sb + rem];
  }
  // 1. the forward, recomputed
  gather_forward_sweep(tab, p, g, nb, wbuf, w_floats);
  // 2. the cotangent buffer, then the depths in reverse
  const int nk = (R - r_in) * K;
  for (int t = threadIdx.x; t < nb * R * K; t += blockDim.x) {
    const int r = t / (R * K);
    const int rem = t - r * R * K;
    cot[t] = rem < r_in * K
                 ? 0.f
                 : g_out[(long long)(b0 + r) * nk + rem - r_in * K];
  }
  float* part = part_all + (long long)tile * part_floats;
  for (int t = D - 1; t >= 0; --t) {
    const GatherDepth d = gather_depth(tab, t);
    const int* left = tab + d.left;
    const int* right = tab + d.right;
    __syncthreads();
    if (d.M > 0) {
      // a. the mixing backward
      const float* v = p.v[d.vi];
      const int* child = tab + d.child;
      const int* mask = child + d.M * d.C;
      const int MC = d.M * d.C;
      for (int o = threadIdx.x; o < nb * d.M * K; o += blockDim.x) {
        const int r = o / (d.M * K);
        const int rem = o - r * d.M * K;
        const int mi = rem / K;
        const int k = rem - mi * K;
        float s;
        const float a = gather_mix_frame(g, tab, d, v, r, mi, k, &s);
        const float ginv =
            cot[((long long)r * R + d.base + d.L + mi) * K + k] /
            fmaxf(s, LEE_S_FLOOR);
        for (int c = 0; c < d.C; ++c) {
          const int q = mi * d.C + c;
          ge[((long long)r * MC + q) * K + k] =
              mask[q] ? __fmul_rn(ginv, expf(gather_mix_child(
                                              g, tab, d, r, mi, c, k) - a))
                      : 0.f;
        }
      }
      __syncthreads();
      for (int o = threadIdx.x; o < nb * d.L * K; o += blockDim.x) {
        const int r = o / (d.L * K);
        const int rem = o - r * d.L * K;
        const int li = rem / K;
        const int k = rem - li * K;
        float* c = cot + ((long long)r * R + d.base + li) * K + k;
        float acc = *c;
        for (int q = 0; q < MC; ++q) {
          if (mask[q] && child[q] == li) {
            acc = __fadd_rn(acc, __fmul_rn(ge[((long long)r * MC + q) * K + k],
                                           v[q * K + k]));
          }
        }
        *c = acc;
      }
      for (int o = threadIdx.x; o < MC * K; o += blockDim.x) {
        float acc = 0.f;
        for (int r = 0; r < nb; ++r) acc += ge[(long long)r * MC * K + o];
        part[p.v_off[d.vi] + o] = acc;
      }
      __syncthreads();
    }
    // b. the pair's backward, chunk by chunk
    for (int t2 = threadIdx.x; t2 < nb * d.L * K; t2 += blockDim.x) {
      sl[t2] = 0.f;
      sr[t2] = 0.f;
    }
    const LeeChunks ch = lee_chunks(d.L, K, KKp, w_floats);
    for (int m0 = 0; m0 < d.L; m0 += ch.cells) {
      const int mn = min(ch.cells, d.L - m0);
      for (int k0 = 0; k0 < K; k0 += ch.kt) {
        const int kn = min(ch.kt, K - k0);
        __syncthreads();
        lee_stage_weights(wbuf, p.w[t], (long long)K * K * K, m0, mn, k0,
                          kn, K);
        __syncthreads();
        for (int o = threadIdx.x; o < nb * mn * kn; o += blockDim.x) {
          const int r = o / (mn * kn);
          const int rem = o - r * mn * kn;
          const int m = rem / kn;
          const int k = rem - m * kn;
          const float s = gather_cell_sum(
              wbuf + (m * kn + k) * KKp,
              g.E + ((long long)r * Rc + left[m0 + m]) * K,
              g.E + ((long long)r * Rc + right[m0 + m]) * K, K);
          float* c = cot + ((long long)r * R + d.base + m0 + m) * K + k0 + k;
          *c = *c / fmaxf(s, LEE_S_FLOOR);
        }
        __syncthreads();
        // the chunk's share of the children's input cotangent; the batch
        // row runs fastest, so a warp reads few weight addresses at once
        for (int o = threadIdx.x; o < nb * mn * K; o += blockDim.x) {
          const int m = o / (K * nb);
          const int rem = o - m * K * nb;
          const int i = rem / nb;
          const int r = rem - i * nb;
          const float* gi = cot + ((long long)r * R + d.base + m0 + m) * K + k0;
          const float* wm = wbuf + m * kn * KKp;
          const float* el = g.E + ((long long)r * Rc + left[m0 + m]) * K;
          const float* er = g.E + ((long long)r * Rc + right[m0 + m]) * K;
          float al = 0.f;  // sum_j er_j c[i, j]
          float ar = 0.f;  // sum_i' el_i' c[i', i]
          for (int j = 0; j < K; ++j) {
            float cl = 0.f;
            float cr = 0.f;
#pragma unroll 4
            for (int k = 0; k < kn; ++k) {
              cl = fmaf(gi[k], wm[k * KKp + i * K + j], cl);
              cr = fmaf(gi[k], wm[k * KKp + j * K + i], cr);
            }
            al = fmaf(cl, er[j], al);
            ar = fmaf(cr, el[j], ar);
          }
          sl[((long long)r * d.L + m0 + m) * K + i] += al;
          sr[((long long)r * d.L + m0 + m) * K + i] += ar;
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
            acc = fmaf(cot[((long long)r * R + d.base + m0 + m) * K + k0 + k],
                       g.E[((long long)r * Rc + left[m0 + m]) * K + i] *
                           g.E[((long long)r * Rc + right[m0 + m]) * K + j],
                       acc);
          }
          part[p.w_off[t] + ((long long)(m0 + m) * K + k0 + k) * KK + ij] = acc;
        }
      }
    }
    __syncthreads();
    // c. into the children's rows: right children first, then left
    for (int o = threadIdx.x; o < nb * K; o += blockDim.x) {
      const int r = o / K;
      const int i = o - r * K;
      for (int li = 0; li < d.L; ++li) {
        const int row = right[li];
        float* c = cot + ((long long)r * R + row) * K + i;
        *c = __fadd_rn(*c, __fmul_rn(g.E[((long long)r * Rc + row) * K + i],
                                     sr[((long long)r * d.L + li) * K + i]));
      }
      for (int li = 0; li < d.L; ++li) {
        const int row = left[li];
        float* c = cot + ((long long)r * R + row) * K + i;
        *c = __fadd_rn(*c, __fmul_rn(g.E[((long long)r * Rc + row) * K + i],
                                     sl[((long long)r * d.L + li) * K + i]));
      }
    }
  }
  // 3. the input rows' cotangent
  __syncthreads();
  for (int t = threadIdx.x; t < nb * r_in * K; t += blockDim.x) {
    const int r = t / (r_in * K);
    const int rem = t - r * r_in * K;
    gx[(long long)(b0 + r) * r_in * K + rem] = cot[(long long)r * R * K + rem];
  }
}

}  // namespace

// ws[t] (L_t, K, K, K) and vs[q] (M_q, C_q, K) contiguous; w_offs[t] and
// v_offs[q] their offsets in one flat gradient of part_floats floats; tab
// the packed tables (n_tab int32) on the device; x (B, r_in, K) with unit
// strides over rows and K and batch stride x_sb; g_out (B, R - r_in, K)
// contiguous.  Writes gx (B, r_in, K) contiguous and gwv, every weight's
// and mixing weight's gradient laid out like ws and vs at their offsets.
// With more than one row tile, part holds ceil(B / tile_b) such buffers and
// is summed into gwv in tile order; with one tile, pass part == gwv.
// w_floats (at least K^2) sizes the weight staging area for a row tile of
// tile_b; R, Rc, l_max (most cells of a depth) and mc_max (largest M C)
// size the row areas (the wrapper computes them all).  Launches on
// `stream`; returns the first CUDA error, or 0, or cudaErrorInvalidValue
// for more than 16 depths or mixing depths.
extern "C" int gather_bwd(const float* const* ws, const float* const* vs,
                          const long long* w_offs, const long long* v_offs,
                          int D, int n_mix, const int* tab, int n_tab,
                          const float* x, const float* g_out, float* part,
                          float* gwv, long long part_floats, float* gx, int B,
                          int K, int tile_b, long long x_sb, int w_floats,
                          int R, int Rc, int l_max, int mc_max, void* stream) {
  if (D < 1 || D > kGatherMaxDepths || n_mix < 0 || n_mix > kGatherMaxDepths)
    return (int)cudaErrorInvalidValue;
  GatherParams p = {};
  for (int t = 0; t < D; ++t) {
    p.w[t] = ws[t];
    p.w_off[t] = w_offs[t];
  }
  for (int q = 0; q < n_mix; ++q) {
    p.v[q] = vs[q];
    p.v_off[q] = v_offs[q];
  }
  const long long rows = (long long)R * K + (long long)Rc * (K + 1) +
                         (long long)R * K + 2LL * l_max * K +
                         (long long)mc_max * K;
  const long long smem =
      4LL * ((long long)w_floats + (long long)tile_b * rows + n_tab);
  cudaError_t err = cudaFuncSetAttribute(
      gather_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + tile_b - 1) / tile_b;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  gather_bwd_kernel<<<tiles, kThreads, (size_t)smem, s>>>(
      p, tab, n_tab, x, g_out, part, part_floats, gx, B, K, tile_b, x_sb,
      w_floats, R, Rc, l_max, mc_max);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  return (int)lee_sum_tiles(part, gwv, part_floats, tiles, s);
}
