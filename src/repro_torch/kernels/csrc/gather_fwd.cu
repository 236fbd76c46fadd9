// Gather-grouped log-einsum-exp forward: a whole gather run of depths
// (a Poon-Domingos interior, mixing layers included) in one launch, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// gather_grouped_log_einsum_exp_pallas (_make_gather_fwd_kernel,
// _gather_fwd_sweep, _gather_depth_fwd, _gather_mix_frame).  The run's
// child rows come from anywhere below a depth, so there is no subtree to
// tile by output cell: as in the Pallas kernel the grid is batch-only, and
// one block owns a tile of rows and keeps the tile's whole row buffer in
// shared memory, (r_in + r_new) K floats a row, for the whole walk (depth
// t + 1 may read any row written at depths <= t).  The walk itself is
// gather_forward_sweep (gather_common.cuh): per depth, the children's
// stabilised copies (lee_stabilize, made once a row), every output in
// lee_cell_sum's fixed FMA order, the masked mixing in a fixed order of
// adds.  So a row's result depends on nothing but that row, and equals
// the per-layer kernel's (K1) output cell for cell.  The tables are not
// compile-time constants here (see gather_common.cuh): the wrapper passes
// them packed in one int32 tensor, copied into shared memory.
//
// Shared memory: the weight staging area (a whole depth when it fits, else
// equal chunks of whole cells or of one cell's K_out tile: einet_pd's K =
// 40 cells are 256 KB each), the row buffer X (R K a row), the stabilised
// child rows E (Rc K) and their maxes A (Rc), and the tables.  The wrapper
// picks the row tile for about one block an SM at einet_pd's B = 512 (4
// rows, 128 blocks); each block then stages all of the run's weights from
// L2.  It refuses a run only when one row's buffer and one weight row do
// not fit.  Rows past the end of the batch are neither read nor written.
//
// What bounds it on the H100, at einet_pd's run [0,2) (B = 512, r_in = 4,
// K = 40, depth 0: 3 cells, depth 1: 4 cells and 2 mixing rows of 2
// children): it must read x (328 KB) and the weights (7 cells of 40^3
// floats, 1.79 MB) and write the 9 new rows (737 KB), 2.9 MB or 0.85 us at
// 3.35 TB/s; the contractions are 2 K^3 flops per cell and row, 459 MFLOP
// in all, 6.8 us at the 67 TFLOP/s fp32 (non-tensor) rate.  So it is bound
// by operations.
//
// Later work, not done here: staging the weights by input slice (all K_out
// of a few i at a time) so that a chunk has L K_out outputs a row in
// flight instead of one cell's K_out tile, tensor cores, and overlapping
// the next chunk's staging with this chunk's arithmetic.

#include "gather_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_fwd_kernel(
    GatherParams p, const int* __restrict__ tab_g, int n_tab,
    const float* __restrict__ x, float* __restrict__ out, int B, int K,
    int tile_b, long long x_sb, int w_floats, int R, int Rc) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * tile_b;
  const int nb = min(tile_b, B - b0);
  float* wbuf = smem;
  GatherRows g;
  g.X = wbuf + w_floats;
  g.E = g.X + (long long)tile_b * R * K;
  g.A = g.E + (long long)tile_b * Rc * K;
  g.R = R;
  g.Rc = Rc;
  g.K = K;
  int* tab = reinterpret_cast<int*>(g.A + tile_b * Rc);
  for (int t = threadIdx.x; t < n_tab; t += blockDim.x) tab[t] = tab_g[t];
  __syncthreads();
  const int r_in = tab[1];
  for (int t = threadIdx.x; t < nb * r_in * K; t += blockDim.x) {
    const int r = t / (r_in * K);
    const int rem = t - r * r_in * K;
    g.X[(long long)r * R * K + rem] = x[(long long)(b0 + r) * x_sb + rem];
  }
  gather_forward_sweep(tab, p, g, nb, wbuf, w_floats);
  const int nk = (R - r_in) * K;
  for (int t = threadIdx.x; t < nb * nk; t += blockDim.x) {
    const int r = t / nk;
    const int rem = t - r * nk;
    out[(long long)(b0 + r) * nk + rem] =
        g.X[(long long)r * R * K + (long long)r_in * K + rem];
  }
}

}  // namespace

// ws[t] (L_t, K, K, K) and vs[q] (M_q, C_q, K) contiguous; tab the packed
// tables (n_tab int32) on the device; x (B, r_in, K) with unit strides over
// rows and K and batch stride x_sb; out (B, R - r_in, K) contiguous.
// w_floats (at least K^2) sizes the weight staging area for a row tile of
// tile_b (the wrapper computes it); R and Rc are the tables' row counts.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for more than 16 depths or mixing depths.
extern "C" int gather_fwd(const float* const* ws, const float* const* vs,
                          int D, int n_mix, const int* tab, int n_tab,
                          const float* x, float* out, int B, int K, int tile_b,
                          long long x_sb, int w_floats, int R, int Rc,
                          void* stream) {
  if (D < 1 || D > kGatherMaxDepths || n_mix < 0 || n_mix > kGatherMaxDepths)
    return (int)cudaErrorInvalidValue;
  GatherParams p = {};
  for (int t = 0; t < D; ++t) p.w[t] = ws[t];
  for (int q = 0; q < n_mix; ++q) p.v[q] = vs[q];
  const long long smem =
      4LL * ((long long)w_floats + (long long)tile_b * R * K +
             (long long)tile_b * Rc * (K + 1) + n_tab);
  cudaError_t err = cudaFuncSetAttribute(
      gather_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + tile_b - 1) / tile_b;
  gather_fwd_kernel<<<blocks, kThreads, (size_t)smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      p, tab, n_tab, x, out, B, K, tile_b, x_sb, w_floats, R, Rc);
  return (int)cudaGetLastError();
}
