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
// Two kernels and, with more than one batch split, a sum (the kernels are
// in lee_bwd.cuh and lee_dw.cuh, which K6 and, for dW, K4 share).
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
// lee_bwd_dw_kernel (lee_dw.cuh, shared with K4 and K6): dW sums over
// the batch, so its grid is (cell l, K_out tile, batch split).  A block
// walks its split's rows in order in chunks of 32 (stabilised again in
// shared memory, ginv read back), and
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

#include "lee_bwd.cuh"

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
  return (int)lee_bwd_run(w, ln_l, ln_r, g, ginv, acc, gw_part, gw, gl, gr, B,
                          L, K, K_out, tile, nsub, jt, ktw, splits, l_sb,
                          l_sl, r_sb, r_sl,
                          reinterpret_cast<cudaStream_t>(stream));
}
