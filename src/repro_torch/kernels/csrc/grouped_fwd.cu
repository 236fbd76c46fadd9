// Grouped log-einsum-exp forward: G consecutive canonical depths in one
// launch, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// grouped_log_einsum_exp_pallas (_make_fwd_kernel, _depth_fwd).  A canonical
// run is a forest of complete binary trees over its L_out output cells: the
// depth-g cells that feed output cell c are {c + m L_out : m < 2^(G-g)}, and
// at each depth cell c + m L_out has left child row c + m L_out and right
// child row c + (m + 2^(G-1-g)) L_out of the layer below.
//
// Layout: one block per (output cell c, tile of rows).  The block loads the
// tile's 2^G input rows of its subtree into shared memory, then walks the G
// depths there: stabilise every row in place (clamped max, exp), then stage
// that depth's 2^(G-1-g) weight cells and write each (row, m, k) output with
// lee_cell_sum, the per-cell arithmetic of the per-layer kernel.  Only the
// final depth's (tile, K_out) outputs go back to device memory.  Buffers
// ping-pong between two activation areas.  The wrapper picks the largest
// row tile whose activations fit in 227 KB beside at least one weight row
// (K^2 floats), and gives the rest to the weights: a depth whose cells do
// not fit is staged a few whole cells at a time, or one cell's K_out tile at
// a time (lee_chunks) -- einet_rat_large's K = 64 cells are 1 MB each.  It
// refuses a subtree only when one row and one weight row do not fit.  Rows
// past the end of the batch are neither read nor written, and a row's result
// depends on nothing but that row, whatever the staging.
//
// What bounds it on the H100, at einet_rat's fused run [0,4) (B = 2048,
// L_out = 10, x (2048, 160, 10), K = 10, K_out 10/10/10/1): it must read x
// (13.1 MB) and the weights (56 KB) and write (2048, 10, 1) (82 KB), about
// 13.3 MB or 4.0 us at 3.35 TB/s; the contractions are 2 K^2 K_out per cell
// and row, 282,000 flops a row, 0.58 GFLOP in all, 8.6 us at the 67 TFLOP/s
// fp32 (non-tensor) rate.  So it is bound by operations: fusion removed the
// round trips of the intermediate depths, and what is left is arithmetic.
//
// Later work, not done here: tensor cores (TF32 or split-precision wgmma),
// cp.async/TMA staging of the next depth's weights, and larger tiles.

#include "lee_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepths = 8;

struct GroupWeights {
  const float* w[kMaxDepths];  // depth d: (L_out 2^(G-1-d), k_out[d], K, K)
  int k_out[kMaxDepths];
};

__global__ void __launch_bounds__(kThreads) grouped_fwd_kernel(
    GroupWeights gw, int G, const float* __restrict__ x,
    float* __restrict__ out, int B, int L_out, int K, int tile_b,
    long long x_sb, int w_floats, int a_floats, int b_floats) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * tile_b;
  const int nb = min(tile_b, B - b0);
  const int KK = K * K;
  float* wbuf = smem;             // a chunk of one depth's weight cells
  float* bufa = wbuf + w_floats;  // inputs, then odd depths' outputs
  float* bufb = bufa + a_floats;  // even depths' outputs
  float* amax = bufb + b_floats;  // tile_b * 2^G clamped row maxes

  int M = 1 << G;
  // block-local row m of the subtree is input row c + m L_out
  for (int t = threadIdx.x; t < nb * M * K; t += blockDim.x) {
    const int r = t / (M * K);
    const int rem = t - r * M * K;
    const int m = rem / K;
    const int i = rem - m * K;
    bufa[t] = x[(long long)(b0 + r) * x_sb +
                ((long long)c + (long long)m * L_out) * K + i];
  }
  float* cur = bufa;
  float* nxt = bufb;
  for (int d = 0; d < G; ++d) {
    const int H = M >> 1;
    const int ko = gw.k_out[d];
    const float* wd = gw.w[d];
    const LeeChunks ch = lee_chunks(H, ko, KK, w_floats);
    // the previous depth's outputs are complete, and nothing reads wbuf or
    // amax any more
    __syncthreads();
    for (int t = threadIdx.x; t < nb * M; t += blockDim.x) {
      amax[t] = lee_stabilize(cur + t * K, K);
    }
    for (int m0 = 0; m0 < H; m0 += ch.cells) {
      const int mn = min(ch.cells, H - m0);
      for (int k0 = 0; k0 < ko; k0 += ch.kt) {
        const int kn = min(ch.kt, ko - k0);
        // stage cells [m0, m0+mn), outputs [k0, k0+kn) of this depth, once
        // the previous chunk's outputs are written
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
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    M = H;
  }
  __syncthreads();
  const int kf = gw.k_out[G - 1];
  for (int t = threadIdx.x; t < nb * kf; t += blockDim.x) {
    const int r = t / kf;
    const int k = t - r * kf;
    out[((long long)(b0 + r) * L_out + c) * kf + k] = cur[t];
  }
}

}  // namespace

// ws[d] (L_out 2^(G-1-d), k_outs[d], K, K) contiguous, interior k_outs == K;
// x (B, L_out 2^G, K) with unit strides over rows and K and batch stride
// x_sb; out (B, L_out, k_outs[G-1]) contiguous.  w_floats (at least K^2),
// a_floats and b_floats size the shared-memory areas for a row tile of
// tile_b (the wrapper computes them).  Launches on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for G outside [1, 8].
extern "C" int grouped_fwd(const float* const* ws, const int* k_outs, int G,
                           const float* x, float* out, int B, int L_out, int K,
                           int tile_b, long long x_sb, int w_floats,
                           int a_floats, int b_floats, void* stream) {
  if (G < 1 || G > kMaxDepths) return (int)cudaErrorInvalidValue;
  GroupWeights gw = {};
  for (int d = 0; d < G; ++d) {
    gw.w[d] = ws[d];
    gw.k_out[d] = k_outs[d];
  }
  const long long smem =
      4LL * ((long long)w_floats + a_floats + b_floats + (long long)tile_b * (1 << G));
  cudaError_t err = cudaFuncSetAttribute(
      grouped_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L_out, (B + tile_b - 1) / tile_b);
  grouped_fwd_kernel<<<grid, kThreads, (size_t)smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      gw, G, x, out, B, L_out, K, tile_b, x_sb, w_floats, a_floats, b_floats);
  return (int)cudaGetLastError();
}
