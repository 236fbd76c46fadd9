// Log-einsum-exp forward for one (product, sum) layer pair, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/log_einsum_exp.py
// log_einsum_exp_pallas (_fwd_kernel).  For each layer cell l and row b:
//   a  = max(NEG_INF, max_i ln_l[b,l,i]),  a' = the same for ln_r
//   s  = sum_{i,j} W[l,k,i,j] exp(ln_l[b,l,i] - a) exp(ln_r[b,l,j] - a')
//   out[b,l,k] = (a + a') + log s
//
// Layout (lee_fwd_kernel in lee_fwd.cuh, which K6 also launches): one
// block per (cell l, row tile, K_out tile).  The block stages
// its K_out tile of W[l] (lee_stage_weights: float4 loads, each weight row
// at the odd stride lee_row_stride) and its rows (at the odd stride
// lee_pad), stabilises the rows once in place (lee_stabilize), then runs
// lee_sweep: every t[r,k,i] = sum_j W[k,i,j] er[r,j] of the tile, register
// tiled (a lane holds R rows x KO outputs, so a weight it loads feeds R
// FMAs and an activation KO) and spread over the warps by (row subtile, i),
// into shared memory.  Last, a thread per output sums s = sum_i el_i t_i.
// Each output keeps lee_cell_sum's FMA order exactly (i outer, t over j
// from 0, then s += el_i t), so the bits are those of K3's and K5's
// cells, and a row's result depends on that row alone.  Rows past the
// end of the batch are neither read nor written.
//
// Bank conflicts: with weight rows K^2 floats apart and consecutive k on
// consecutive lanes, every lane of a warp would hit one bank on each of
// its 1,600 weight loads at K = 40 (K^2 = 50 x 32).  Here every warp-wide
// load of the sweep reads rows at an odd stride, or one word for many
// lanes (a broadcast), and the sum reads T at the odd stride lee_pad(K).
//
// Filling the card: the wrapper (kernels/log_einsum_exp.py launch_geometry)
// picks the register tile (32 rows x 8 or 10 outputs, whichever pads K_out
// less; 64 rows x 1 output for K_out = 1 and for a K too large for 8 weight
// rows) and the number of row subtiles a block holds (1 to 8): the most
// that still leave about two blocks an SM and three blocks' shared memory
// an SM, so that a launch keeps many warps in flight.  The registers are
// capped at 64 a thread (kMinBlocks) for the same reason.  einet_pd's pairs
// (B = 512, 3 or 4 cells, K = K_out = 40) run 240 or 320 blocks of one
// subtile, whose 8 warps split the 40 values of i; einet_rat's (B = 2048,
// K = 10) blocks of 128 rows and all 10 outputs.  Several cells a block
// are not needed for that: at K = 10 one cell's weights are 4 KB and a
// block's 128 rows give its warps 40 items.
//
// What bounds it on the H100: at einet_rat's first pair (B = 2048, L = 80,
// K = K_out = 10) it must read ln_l and ln_r (13.1 MB) and W (0.32 MB) and
// write out (6.6 MB), about 20 MB or 6.0 us at 3.35 TB/s, against 0.33
// GFLOP or 4.9 us at the 67 TFLOP/s fp32 (non-tensor) rate: bound by bytes.
// At einet_pd's (B = 512, L = 4, K = K_out = 40) it reads 1.3 MB and does
// 0.26 GFLOP, 3.9 us: bound by operations.  The K_out = 1 root pairs are
// bound by bytes.
//
// Later work, not done here: the contraction on tensor cores (TF32, or
// an error-compensated 3xTF32 split to keep fp32 accuracy: every FMA here
// is fp32), cp.async or TMA staging overlapped with the sweep, and a
// persistent grid.

#include "lee_fwd.cuh"

// w (L, K_out, K, K) contiguous; ln_l / ln_r (B, L, K) with unit stride over
// K and the given batch and cell strides; out (B, L, K_out) contiguous.
// tile 0: 32-row subtiles x 8 outputs; tile 1: 64-row subtiles x 1 output;
// tile 2: 32-row subtiles x 10 outputs; nsub subtiles a block (the wrapper
// checks that the block fits).  Launches on `stream`; returns the first
// CUDA error, or 0.
extern "C" int lee_fwd(const float* w, const float* ln_l, const float* ln_r,
                       float* out, int B, int L, int K, int K_out, int tile,
                       int nsub, long long l_sb, long long l_sl,
                       long long r_sb, long long r_sl, void* stream) {
  return (int)lee_fwd_run(w, ln_l, ln_r, out, B, L, K, K_out, tile, nsub,
                          l_sb, l_sl, r_sb, r_sl,
                          reinterpret_cast<cudaStream_t>(stream));
}
