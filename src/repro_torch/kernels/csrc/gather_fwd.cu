// Gather-grouped log-einsum-exp forward: a whole gather run of depths
// (a Poon-Domingos interior, mixing layers included) in one call, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// gather_grouped_log_einsum_exp_pallas (_make_gather_fwd_kernel,
// _gather_fwd_sweep, _gather_depth_fwd, _gather_mix_frame).  A gather run's
// children come from anywhere below a depth (gather_common.cuh), so there
// is no subtree to keep in shared memory.  The Pallas kernel's batch-only
// grid, one block holding a row tile's whole row buffer, would here give a
// block 4 rows at einet_pd's B = 512 for one block an SM, and every block
// would restage all of the run's weights (1.79 MB) for them.  Instead the
// run goes depth by depth, with the new rows in device memory (out, 0.74
// MB at einet_pd: it stays in the 50 MB L2), through K1's kernel
// (lee_fwd.cuh) over a grid of (cell, row tile, K_out tile):
//  1. per depth t, K1 on its L_t cells, reading each cell's child rows by
//     row id from the tables while it stages them (ids below r_in address
//     x, the others the new rows already written), and writing its outputs
//     straight into the depth's rows of out.  K1 keeps lee_cell_sum's FMA
//     order (register-tiled lee_sweep, then s = sum_i el_i t_i in order),
//     so the rows are bit for bit those of the per-layer plan's K1
//     launches and of K6's recompute, which runs K1 at the same geometry
//     on gathered copies of the same rows;
//  2. where the depth mixes, one small kernel a thread per (row, slot,
//     output): the masked mixing (gather_mix_frame, K6's own code) into the
//     depth's mixing rows.
// So einet_pd's run [0,2) takes three launches (K1, K1, mixing), with no
// gather or scatter copy and no per-tile weight restaging.  The wrapper
// picks each depth's K1 geometry as the per-pair wrapper does for the pair
// (B, L_t, K, K) (kernels/grouped.py gather_fwd_geometry).  A row's result
// depends on that row alone; rows past the end of the batch are neither
// read nor written.
//
// What bounds it on the H100, at einet_pd's run [0,2) (B = 512, r_in = 4,
// K = 40, depth 0: 3 cells, depth 1: 4 cells and 2 mixing rows of 2
// children): it must read x (328 KB) and the weights (7 cells of 40^3
// floats, 1.79 MB) and write the 9 new rows (737 KB), 2.9 MB or 0.85 us at
// 3.35 TB/s; the contractions are 2 K^3 flops per cell and row, 459 MFLOP
// in all, 6.8 us at the 67 TFLOP/s fp32 (non-tensor) rate.  So it is bound
// by operations, and K1's sweep by shared-memory bandwidth (R + KO words
// for R KO FMAs a lane).
//
// Later work, not done here: a CUDA graph (or one persistent launch) for
// the walk, tensor cores.

#include "gather_common.cuh"
#include "lee_fwd.cuh"

namespace {

// A gather depth's K1 (K5): L cells of w (L, K, K, K), child rows by id
// (ids) from x (batch stride x_sb, K floats a row) or the new rows, outputs
// at out + b ids.o_sb + l K; tile (0: 32 rows x 8 outputs, 1: 64 x 1,
// 2: 32 x 10) and nsub as in lee_fwd_run.
inline cudaError_t lee_fwd_ids_run(const float* w, const float* x, float* out,
                                   int B, int L, int K, int tile, int nsub,
                                   long long x_sb, const LeeRowIds& ids,
                                   cudaStream_t s) {
  if (tile == 0) {
    return lee_fwd_launch<LeeTile<4, 2, 4>, true>(
        w, x, x, out, B, L, K, K, nsub, x_sb, K, x_sb, K, s, ids);
  }
  if (tile == 2) {
    return lee_fwd_launch<LeeTile<2, 5, 2>, true>(
        w, x, x, out, B, L, K, K, nsub, x_sb, K, x_sb, K, s, ids);
  }
  return lee_fwd_launch<LeeTile<2, 1, 1>, true>(
      w, x, x, out, B, L, K, K, nsub, x_sb, K, x_sb, K, s, ids);
}

// Depth t's mixing rows, a thread a (b, mi, k): the masked mixing of the
// depth's einsum rows, which K1 has written into out (B, r_new, K).
__global__ void __launch_bounds__(kGatherThreads) mix_kernel(
    float* __restrict__ out, const int* __restrict__ tab, int t,
    const float* __restrict__ v, int B, int r_in, int r_new, int K) {
  GatherDepth d = gather_depth(tab, t);
  d.base -= r_in;  // rows of out
  GatherRows g;
  g.X = out;
  g.R = r_new;
  g.K = K;
  GATHER_LOOP((long long)B * d.M * K) {
    const int b = (int)(o / ((long long)d.M * K));
    const int rem = (int)(o - (long long)b * d.M * K);
    const int mi = rem / K;
    const int k = rem - mi * K;
    float s;
    const float a = gather_mix_frame(g, tab, d, v, b, mi, k, &s);
    out[((long long)b * r_new + d.base + d.L + mi) * K + k] = a + logf(s);
  }
}

}  // namespace

// ws[t] (L_t, K, K, K) and vs[q] (M_q, C_q, K) contiguous; tab the packed
// tables on the device and tab_h the same on the host; x (B, r_in, K) with
// unit strides over rows and K and batch stride x_sb; out (B, R - r_in, K)
// contiguous.  geo[2 t], geo[2 t + 1] is depth t's K1 (tile, nsub), as the
// wrapper picks them for the pair (B, L_t, K, K).  Launches on `stream`;
// returns the first CUDA error, or 0, or cudaErrorInvalidValue for more
// than 16 depths or mixing depths.
extern "C" int gather_fwd(const float* const* ws, const float* const* vs,
                          int D, int n_mix, const int* tab, const int* tab_h,
                          const float* x, long long x_sb, float* out, int B,
                          int K, const int* geo, void* stream) {
  if (D < 1 || D > kGatherMaxDepths || n_mix < 0 || n_mix > kGatherMaxDepths)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int r_in = tab_h[1];
  const int r_new = tab_h[2] - r_in;
  for (int t = 0; t < D; ++t) {
    const GatherDepth d = gather_depth(tab_h, t);
    LeeRowIds ids;
    ids.left = tab + d.left;
    ids.right = tab + d.right;
    ids.nw = out;
    ids.nw_sb = (long long)r_new * K;
    ids.o_sb = (long long)r_new * K;
    ids.r_in = r_in;
    cudaError_t err =
        lee_fwd_ids_run(ws[t], x, out + (long long)(d.base - r_in) * K, B,
                        d.L, K, geo[2 * t], geo[2 * t + 1], x_sb, ids, s);
    if (err != cudaSuccess) return (int)err;
    if (d.M > 0) {
      mix_kernel<<<gather_grid((long long)B * d.M * K), kGatherThreads, 0,
                   s>>>(out, tab, t, vs[d.vi], B, r_in, r_new, K);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
