// Gather-grouped log-einsum-exp backward: every depth's weight gradient,
// every mixing depth's mixing-weight gradient and the input cotangent of a
// whole gather run (a Poon-Domingos interior) in one call, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// gather_grouped_log_einsum_exp_bwd_pallas (_make_gather_bwd_kernel,
// _gather_depth_bwd).  A gather run's children come from anywhere below a
// depth (gather_common.cuh), so there is no subtree to keep in shared
// memory: a block holding a row tile's whole row buffer has few rows (4 at
// einet_pd's B = 512 for one block an SM) and must stage every weight of
// the run for them, twice, and write a partial dW of all of them.  Instead
// the run goes depth by depth over grids of (cell, row tile, K_out tile),
// with the row buffer in device memory (1.1 MB at einet_pd: it stays in the
// 50 MB L2), through the per-pair kernels K1 and K2 (lee_fwd.cuh, lee_bwd.cuh):
//  1. Residual recompute, depth by depth: gather each cell's left and right
//     child rows from the row buffer X (the tables' left/right rows), run
//     K1 on them (register-tiled lee_sweep, lee_cell_sum's order: K5's rows
//     bit for bit), and write the depth's rows and, where it mixes, its
//     mixing rows (gather_mix_frame, as K5 mixes) into X.  The gathered
//     child rows are kept for step 2.
//  2. A cotangent buffer like X starts at 0 for the input rows and at g_out
//     for the new rows.  The depths in reverse, in the plain version's
//     order (kernels/grouped.py gather_grouped_log_einsum_exp_bwd_plain):
//     a. the mixing backward, a thread a (row, k): the frame, ginv =
//        g / max(s, 1e-30), the terms ge = ginv e (an exact 0 for a masked
//        child), added as ge v into the depth's einsum rows slot by slot in
//        (m, c) order; gV sums ge over the batch in a fixed order;
//     b. K2 on the depth's einsum rows' cotangent: its rows kernel (s,
//        ginv, gl from the same sweep, gr from one more) over (cell, row
//        tile, K_out tile), its dW kernel over (cell, K_out tile, batch
//        split), the splits summed in split order;
//     c. gl and gr into the children's rows: a thread a (row, i) adds the
//        right children's in table order, then the left children's, so a
//        row reached from several sides, depths and slots always sums in
//        the same order.
//  3. The input rows' cotangent goes to gx.
// No atomics: two calls give bitwise-equal gradients; a row's gx depends on
// that row alone (K1's and K2's geometry follows K and K_out, and the glue
// works a row at a time).  An input at -inf has a stabilised value of 0 and
// so a gradient of exactly 0.
//
// What bounds it on the H100, at einet_pd's run [0,2) (B = 512, r_in = 4,
// K = 40, 7 cells, mixing (2, 2)): it must read x (328 KB), g_out (737 KB)
// and the weights (1.79 MB) and write gx (328 KB), dW (1.79 MB) and dV,
// about 5.0 MB or 1.5 us at 3.35 TB/s.  The work is the forward's
// contraction (s), c = ginv W for the input cotangent and dW, 2 K^3 flops
// each per cell and row, plus 4 K^2 for the row and column sums of c:
// 1.40 GFLOP in all, 20.9 us at the 67 TFLOP/s fp32 (non-tensor) rate:
// bound by operations.  The recompute adds K1's 2 K^3 a cell and row.
// The dW partials are K2's: 16 splits of a depth's weights (at most 16.4
// MB at einet_pd), where a partial of all the run's weights per 4-row tile
// would be 229 MB.
//
// Later work, not done here: folding the gathers into K1's and K2's
// staging (a row-index table instead of a stride), a CUDA graph for the
// ~20 launches, tensor cores.

#include "gather_common.cuh"
#include "lee_bwd.cuh"
#include "lee_fwd.cuh"

namespace {

constexpr int kThreads = kGatherThreads;

// X[b, row < r_in] = x[b, row]; cot[b, row] = 0 for an input row, else
// g_out[b, row - r_in].
__global__ void __launch_bounds__(kThreads) init_kernel(
    const float* __restrict__ x, long long x_sb,
    const float* __restrict__ g_out, float* __restrict__ X,
    float* __restrict__ cot, int B, int r_in, int R, int K) {
  GATHER_LOOP((long long)B * R * K) {
    const long long b = o / ((long long)R * K);
    const int rem = (int)(o - b * R * K);
    const int row = rem / K;
    if (row < r_in) {
      X[o] = x[b * x_sb + rem];
      cot[o] = 0.f;
    } else {
      cot[o] = g_out[b * (R - r_in) * K + rem - r_in * K];
    }
  }
}

// lg[b, l] = X[b, left[l]], rg[b, l] = X[b, right[l]] (depth t's tables).
__global__ void __launch_bounds__(kThreads) gather_children_kernel(
    const float* __restrict__ X, const int* __restrict__ tab, int t,
    float* __restrict__ lg, float* __restrict__ rg, int B, int R, int K) {
  const GatherDepth d = gather_depth(tab, t);
  const long long n = (long long)B * d.L * K;
  GATHER_LOOP(2 * n) {
    const bool right = o >= n;
    const long long e = right ? o - n : o;
    const long long b = e / ((long long)d.L * K);
    const int rem = (int)(e - b * d.L * K);
    const int l = rem / K;
    const int row = tab[(right ? d.right : d.left) + l];
    (right ? rg : lg)[e] = X[(b * R + row) * K + rem - l * K];
  }
}

// Depth t's einsum rows from K1's out (B, L, K) into X, then its mixing
// rows, a thread a (b, k) (gather_mix_frame, as K5 mixes).
__global__ void __launch_bounds__(kThreads) scatter_mix_kernel(
    const float* __restrict__ out, float* __restrict__ X,
    const int* __restrict__ tab, int t, const float* __restrict__ v, int B,
    int R, int K) {
  const GatherDepth d = gather_depth(tab, t);
  GatherRows g;
  g.X = X;
  g.R = R;
  g.K = K;
  GATHER_LOOP((long long)B * K) {
    const int b = (int)(o / K);
    const int k = (int)(o - (long long)b * K);
    for (int l = 0; l < d.L; ++l) {
      X[((long long)b * R + d.base + l) * K + k] =
          out[((long long)b * d.L + l) * K + k];
    }
    for (int mi = 0; mi < d.M; ++mi) {
      float s;
      const float a = gather_mix_frame(g, tab, d, v, b, mi, k, &s);
      X[((long long)b * R + d.base + d.L + mi) * K + k] = a + logf(s);
    }
  }
}

// The mixing backward of depth t, a thread a (b, k): ge[b, q, k] for every
// slot q = (mi, c), then ge v added into the einsum rows in slot order.
__global__ void __launch_bounds__(kThreads) mix_bwd_kernel(
    const float* __restrict__ X, float* __restrict__ cot,
    float* __restrict__ ge, const int* __restrict__ tab, int t,
    const float* __restrict__ v, int B, int R, int K) {
  const GatherDepth d = gather_depth(tab, t);
  const int* child = tab + d.child;
  const int* mask = child + d.M * d.C;
  const int MC = d.M * d.C;
  GatherRows g;
  g.X = const_cast<float*>(X);
  g.R = R;
  g.K = K;
  GATHER_LOOP((long long)B * K) {
    const int b = (int)(o / K);
    const int k = (int)(o - (long long)b * K);
    float* geb = ge + (long long)b * MC * K + k;
    for (int mi = 0; mi < d.M; ++mi) {
      float s;
      const float a = gather_mix_frame(g, tab, d, v, b, mi, k, &s);
      const float ginv = cot[((long long)b * R + d.base + d.L + mi) * K + k] /
                         fmaxf(s, LEE_S_FLOOR);
      for (int c = 0; c < d.C; ++c) {
        const int q = mi * d.C + c;
        geb[q * K] = mask[q] ? __fmul_rn(ginv, expf(gather_mix_child(
                                             g, tab, d, b, mi, c, k) - a))
                             : 0.f;
      }
    }
    for (int li = 0; li < d.L; ++li) {
      float* c = cot + ((long long)b * R + d.base + li) * K + k;
      float acc = *c;
      for (int q = 0; q < MC; ++q) {
        if (mask[q] && child[q] == li) {
          acc = __fadd_rn(acc, __fmul_rn(geb[q * K], v[q * K + k]));
        }
      }
      *c = acc;
    }
  }
}

// gv[q, k] = sum_b ge[b, q, k], a block an output: thread t sums rows t,
// t + 256, ... in order, then the block's sums are added in a fixed tree.
__global__ void __launch_bounds__(kThreads) gv_sum_kernel(
    const float* __restrict__ ge, float* __restrict__ gv, int B, int n) {
  __shared__ float part[kThreads];
  const int o = blockIdx.x;
  float acc = 0.f;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    acc += ge[(long long)b * n + o];
  }
  part[threadIdx.x] = acc;
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
  }
  if (threadIdx.x == 0) gv[o] = part[0];
}

// gs[b, l] = cot[b, base + l]: the cotangent of depth t's einsum rows.
__global__ void __launch_bounds__(kThreads) gather_cot_kernel(
    const float* __restrict__ cot, const int* __restrict__ tab, int t,
    float* __restrict__ gs, int B, int R, int K) {
  const GatherDepth d = gather_depth(tab, t);
  GATHER_LOOP((long long)B * d.L * K) {
    const long long b = o / ((long long)d.L * K);
    const int rem = (int)(o - b * d.L * K);
    gs[o] = cot[(b * R + d.base) * K + rem];
  }
}

// gl and gr of depth t into the children's rows, a thread a (b, i): the
// right children in table order, then the left.
__global__ void __launch_bounds__(kThreads) accumulate_kernel(
    float* __restrict__ cot, const float* __restrict__ gl,
    const float* __restrict__ gr, const int* __restrict__ tab, int t, int B,
    int R, int K) {
  const GatherDepth d = gather_depth(tab, t);
  const int* left = tab + d.left;
  const int* right = tab + d.right;
  GATHER_LOOP((long long)B * K) {
    const long long b = o / K;
    const int i = (int)(o - b * K);
    for (int li = 0; li < d.L; ++li) {
      float* c = cot + (b * R + right[li]) * K + i;
      *c = __fadd_rn(*c, gr[(b * d.L + li) * K + i]);
    }
    for (int li = 0; li < d.L; ++li) {
      float* c = cot + (b * R + left[li]) * K + i;
      *c = __fadd_rn(*c, gl[(b * d.L + li) * K + i]);
    }
  }
}

// gx[b, row] = cot[b, row] for the input rows.
__global__ void __launch_bounds__(kThreads) gx_kernel(
    const float* __restrict__ cot, float* __restrict__ gx, int B, int r_in,
    int R, int K) {
  GATHER_LOOP((long long)B * r_in * K) {
    const long long b = o / ((long long)r_in * K);
    gx[o] = cot[b * R * K + (o - b * r_in * K)];
  }
}

}  // namespace

// ws[t] (L_t, K, K, K) and vs[q] (M_q, C_q, K) contiguous; gw_offs[t] and
// gv_offs[q] their offsets in gwv, one flat gradient laid out like ws and
// vs; tab the packed tables (n_tab int32) on the device and tab_h the same
// on the host; x (B, r_in, K) with unit strides over rows and K and batch
// stride x_sb; g_out (B, R - r_in, K) contiguous.  Writes gx (B, r_in, K)
// contiguous and gwv.  geo[7 t .. 7 t + 6] is depth t's K1 (tile, nsub)
// and K2 (tile, nsub, JT, K_out tile, batch splits), as the wrapper picks
// them for the pair (B, L_t, K, K).  Scratch (the wrapper sizes it): the
// row buffer X and the cotangent buffer cot (B, R, K) each; lr, every
// depth's gathered left then right child rows (2 B L_t K a depth, in depth
// order); buf (B l_max K: K1's output, then a depth's einsum rows'
// cotangent); K2's ginv (B l_max K), gl and gr (glr, 2 B l_max K) and
// K_out-tile sums acc; the mixing terms ge (B mc_max K); and K2's dW
// split partials (part).  Launches on `stream`;
// returns the first CUDA error, or 0, or cudaErrorInvalidValue for more
// than 16 depths or mixing depths.
extern "C" int gather_bwd(const float* const* ws, const float* const* vs,
                          const long long* gw_offs, const long long* gv_offs,
                          int D, int n_mix, const int* tab, const int* tab_h,
                          const float* x, long long x_sb, const float* g_out,
                          float* gwv, float* gx, int B, int K, const int* geo,
                          float* X, float* cot, float* lr, float* buf,
                          float* ginv, float* glr, float* acc, float* ge,
                          float* part, void* stream) {
  if (D < 1 || D > kGatherMaxDepths || n_mix < 0 || n_mix > kGatherMaxDepths)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int r_in = tab_h[1];
  const int R = tab_h[2];
  const long long rows = (long long)B * R * K;
  init_kernel<<<gather_grid(rows), kThreads, 0, s>>>(x, x_sb, g_out, X, cot, B,
                                                   r_in, R, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 1. the forward, recomputed
  long long lr_off[kGatherMaxDepths];
  long long off = 0;
  for (int t = 0; t < D; ++t) {
    const GatherDepth d = gather_depth(tab_h, t);
    const long long n = (long long)B * d.L * K;
    float* lg = lr + off;
    lr_off[t] = off;
    off += 2 * n;
    const int* gt = geo + 7 * t;
    gather_children_kernel<<<gather_grid(2 * n), kThreads, 0, s>>>(
        X, tab, t, lg, lg + n, B, R, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = lee_fwd_run(ws[t], lg, lg + n, buf, B, d.L, K, K, gt[0], gt[1],
                      (long long)d.L * K, K, (long long)d.L * K, K, s);
    if (err != cudaSuccess) return (int)err;
    scatter_mix_kernel<<<gather_grid((long long)B * K), kThreads, 0, s>>>(
        buf, X, tab, t, d.M > 0 ? vs[d.vi] : nullptr, B, R, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 2. the depths in reverse
  for (int t = D - 1; t >= 0; --t) {
    const GatherDepth d = gather_depth(tab_h, t);
    const long long n = (long long)B * d.L * K;
    const int* gt = geo + 7 * t;
    if (d.M > 0) {
      mix_bwd_kernel<<<gather_grid((long long)B * K), kThreads, 0, s>>>(
          X, cot, ge, tab, t, vs[d.vi], B, R, K);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int nv = d.M * d.C * K;
      gv_sum_kernel<<<nv, kThreads, 0, s>>>(ge, gwv + gv_offs[d.vi], B, nv);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    gather_cot_kernel<<<gather_grid(n), kThreads, 0, s>>>(cot, tab, t, buf, B,
                                                        R, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const float* lg = lr + lr_off[t];
    float* gw = gwv + gw_offs[t];
    err = lee_bwd_run(ws[t], lg, lg + n, buf, ginv, acc,
                      gt[6] > 1 ? part : gw, gw, glr, glr + n, B, d.L, K, K,
                      gt[2], gt[3], gt[4], gt[5], gt[6], (long long)d.L * K, K,
                      (long long)d.L * K, K, s);
    if (err != cudaSuccess) return (int)err;
    accumulate_kernel<<<gather_grid((long long)B * K), kThreads, 0, s>>>(
        cot, glr, glr + n, tab, t, B, R, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 3. the input rows' cotangent
  gx_kernel<<<gather_grid((long long)B * r_in * K), kThreads, 0, s>>>(
      cot, gx, B, r_in, R, K);
  return (int)cudaGetLastError();
}
