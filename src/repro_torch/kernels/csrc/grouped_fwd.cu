// Grouped log-einsum-exp forward: G consecutive canonical depths in one
// launch, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// grouped_log_einsum_exp_pallas (_make_fwd_kernel, _depth_fwd).  The
// subtree geometry is grouped_common.cuh's: one block owns one output cell
// c and a tile of tb rows, loads the tile's 2^G input rows of c's subtree
// into shared memory and walks the G depths there, so the intermediate
// depths never reach device memory; only the last depth's outputs are
// written.
//
// Per block:
//  * the rows of two depths at a time, ping-ponging (the depth being read,
//    2^(G-d) slots, and the one being written, 2^(G-1-d)), each row at the
//    odd stride Kq = (K + 1) | 1 with its clamped max in float K
//    (lee_stabilize in place), so no separate max area;
//  * one weight area: per depth, chunks of whole cells, or of one cell's
//    K_out rows when a cell does not fit (einet_rat_large's K = 64 cells
//    are 1 MB), staged as K4 stages them (grouped_stage: float4 loads,
//    weight rows at the odd stride lee_row_stride); the input rows are
//    loaded and stabilised as K4 does it too (grouped_load_stabilized);
//  * no sweep buffer: a lane of a warp owns a register tile of R rows x KO
//    outputs (LeeTile) and keeps their s in registers, looping over i in
//    order, forming t_i = sum_j W[k, i, j] er[r, j] over j from 0 and then
//    s = fma(el_i, t_i, s): lee_cell_sum's FMA order, so every output is
//    bit for bit that of K1 and of K4's recompute, and a row's result
//    depends on that row alone.  Each weight value a lane loads feeds R
//    FMAs and each activation KO, and a lane forms several t_i at once
//    (independent chains sharing each activation load); the work items
//    (chunk cell, row subtile, K_out tile) go round the block's warps.
// Bank conflicts: a warp's lanes read weight rows lee_row_stride(K) apart
// and activation rows Kq apart, both odd, or one word (a broadcast), so no
// load of the sweep conflicts at any K.  Lanes whose rows or outputs fall
// past the tile or the chunk read the last valid one (their results are
// dropped), so a tile never reads past its data and the row tile need not
// be a multiple of the register tile's rows.
// The wrapper (kernels/grouped.py fwd_geometry) picks the register tiles,
// the row tile (64 rows or more where the grid still fills the card, and
// at einet_rat_large's B = 64 the whole batch, so that its 1.6 GB of
// weights are read once) and each depth's chunk.  It refuses a subtree
// only when one row and one weight row do not fit.  Rows past the end of
// the batch are neither read nor written.
//
// What bounds it on the H100, at einet_rat's fused run [0,4) (B = 2048,
// L_out = 10, x (2048, 160, 10), K = 10, K_out 10/10/10/1): it must read x
// (13.1 MB) and the weights (56 KB) and write (2048, 10, 1) (82 KB), about
// 13.3 MB or 4.0 us at 3.35 TB/s; the contractions are 2 K^2 K_out per cell
// and row, 282,000 flops a row, 0.58 GFLOP in all, 8.6 us at the 67 TFLOP/s
// fp32 (non-tensor) rate: bound by operations.  At einet_rat_large's [0,2)
// (B = 64, K = 64, 1,536 cells of 1 MB) it reads 1.6 GB of weights (0.48
// ms) for 51.5 GFLOP (0.77 ms): bound by operations too.  A lane's tile
// reads R + KO words of shared memory for R KO FMAs, so the sweep is bound
// by shared-memory bandwidth below the FMA peak.
//
// Later work, not done here: tensor cores (3xTF32 to keep fp32 accuracy),
// cp.async or TMA staging of the next chunk during this chunk's sweep.

#include "grouped_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepths = kGroupedMaxDepths;

struct GroupFwdArgs {
  const float* w[kMaxDepths];  // depth d: (L_out 2^(G-1-d), k_out[d], K, K)
  int k_out[kMaxDepths];
  int cells[kMaxDepths];  // weight cells a chunk
  int kt[kMaxDepths];     // outputs a chunk (k_out[d] for whole cells)
};

// A row's stride in K3's row areas: odd (no bank conflicts between rows),
// with float K free for the row's clamped max.
__host__ __device__ __forceinline__ int fwd_stride(int K) {
  return (K + 1) | 1;
}

struct FwdBlk {
  float* U;  // the weight area
  int G, K, Kq, KKp, tb, nb, b0, c, L_out;
};

// A lane's sweep over NI consecutive i from i0: for each, t = sum_j W[k, i,
// j] er[r, j] over j from 0 for its R rows x KO outputs (weight rows at
// U + wo[u], row areas at xo[v]), then s = fma(el[r, i], t, s) in the order
// of i, lee_cell_sum's order.  The NI values of t are independent FMA
// chains that share each activation load.
template <class Tile, int NI>
__device__ __forceinline__ void sweep_rows(const float* U, const int* wo,
                                           const float* er, const float* el,
                                           const int* xo, int K, int i0,
                                           float (&s)[Tile::R][Tile::KO]) {
  constexpr int R = Tile::R;
  constexpr int KO = Tile::KO;
  const float* wi = U + i0 * K;
  float t[NI][R][KO];
#pragma unroll
  for (int q = 0; q < NI; ++q)
#pragma unroll
    for (int v = 0; v < R; ++v)
#pragma unroll
      for (int u = 0; u < KO; ++u) t[q][v][u] = 0.f;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    float wv[NI][KO];
    float xv[R];
#pragma unroll
    for (int q = 0; q < NI; ++q)
#pragma unroll
      for (int u = 0; u < KO; ++u) wv[q][u] = wi[wo[u] + q * K + j];
#pragma unroll
    for (int v = 0; v < R; ++v) xv[v] = er[xo[v] + j];
#pragma unroll
    for (int q = 0; q < NI; ++q)
#pragma unroll
      for (int v = 0; v < R; ++v)
#pragma unroll
        for (int u = 0; u < KO; ++u)
          t[q][v][u] = fmaf(wv[q][u], xv[v], t[q][v][u]);
  }
#pragma unroll
  for (int q = 0; q < NI; ++q)
#pragma unroll
    for (int v = 0; v < R; ++v) {
      const float e = el[xo[v] + i0 + q];
#pragma unroll
      for (int u = 0; u < KO; ++u) s[v][u] = fmaf(e, t[q][v][u], s[v][u]);
    }
}

// Depth d: every output of the depth's H cells for the tile's nb rows, from
// the stabilised rows E (2H slots; a row's max at float K) into En (H slots,
// then stabilised in place), or at the last depth into out (B, L_out,
// k_out) in device memory.
template <class Tile>
__device__ void fwd_depth(const FwdBlk& b, const GroupFwdArgs& a, int d,
                          const float* E, float* En, float* out) {
  constexpr int R = Tile::R;
  constexpr int KO = Tile::KO;
  constexpr int NKG = Tile::NKG;
  constexpr int NRG = Tile::NRG;
  // i values a lane's sweep takes at once: more for the small tiles, whose
  // R KO chains alone would leave the FMA pipes waiting on loads
  constexpr int IU = R * KO >= 8 ? 2 : 8;
  const int H = 1 << (b.G - 1 - d);
  const int ko = a.k_out[d];
  const int K = b.K, Kq = b.Kq, KKp = b.KKp, tb = b.tb, nb = b.nb;
  const int lane = threadIdx.x & 31;
  const int kg = lane % NKG;
  const int rg = lane / NKG;
  const int nwarps = blockDim.x >> 5;
  const int nsub = (nb + Tile::ROWS - 1) / Tile::ROWS;
  for (int m0 = 0; m0 < H; m0 += a.cells[d]) {
    const int mn = min(a.cells[d], H - m0);
    for (int k0 = 0; k0 < ko; k0 += a.kt[d]) {
      const int kn = min(a.kt[d], ko - k0);
      // the rows are stabilised; the previous chunk is done with U
      __syncthreads();
      grouped_stage(b.U, kn * KKp, a.w[d], b.c, b.L_out, ko, m0, mn, k0, kn,
                    K);
      __syncthreads();
      const int nkt = (kn + Tile::KT - 1) / Tile::KT;
      const int per_cell = nsub * nkt;
      for (int item = threadIdx.x >> 5; item < mn * per_cell;
           item += nwarps) {
        const int m = item / per_cell;
        const int rest = item - m * per_cell;
        const int sub = rest / nkt;
        const int r0 = sub * Tile::ROWS + rg;
        const int kb = (rest - sub * nkt) * Tile::KT + kg;
        int wo[KO];
        int xo[R];
#pragma unroll
        for (int u = 0; u < KO; ++u)
          wo[u] = (m * kn + min(kb + u * NKG, kn - 1)) * KKp;
#pragma unroll
        for (int v = 0; v < R; ++v) xo[v] = min(r0 + v * NRG, nb - 1) * Kq;
        const float* el = E + (m0 + m) * tb * Kq;
        const float* er = E + (H + m0 + m) * tb * Kq;
        float s[R][KO];
#pragma unroll
        for (int v = 0; v < R; ++v)
#pragma unroll
          for (int u = 0; u < KO; ++u) s[v][u] = 0.f;
        int i = 0;
        for (; i + IU <= K; i += IU)
          sweep_rows<Tile, IU>(b.U, wo, er, el, xo, K, i, s);
        for (; i < K; ++i) sweep_rows<Tile, 1>(b.U, wo, er, el, xo, K, i, s);
#pragma unroll
        for (int v = 0; v < R; ++v) {
          const int r = r0 + v * NRG;
          if (r >= nb) continue;
          const float amax = el[r * Kq + K] + er[r * Kq + K];
#pragma unroll
          for (int u = 0; u < KO; ++u) {
            const int k = kb + u * NKG;
            if (k >= kn) continue;
            const float val = amax + logf(s[v][u]);
            if (out != nullptr) {
              out[((long long)(b.b0 + r) * b.L_out + b.c) * ko + k0 + k] = val;
            } else {
              En[((m0 + m) * tb + r) * Kq + k0 + k] = val;
            }
          }
        }
      }
    }
  }
  if (out != nullptr) return;
  __syncthreads();
  for (int t = threadIdx.x; t < H * nb; t += blockDim.x) {
    const int m = t / nb;
    float* row = En + (m * tb + t - m * nb) * Kq;
    row[K] = lee_stabilize(row, K);
  }
}

template <class TI, class TF>
__global__ void __launch_bounds__(kThreads, 2) grouped_fwd_kernel(
    GroupFwdArgs args, int G, const float* __restrict__ x,
    float* __restrict__ out, int B, int L_out, int K, int tb,
    long long x_sb) {
  extern __shared__ float smem[];
  FwdBlk b;
  b.G = G;
  b.K = K;
  b.Kq = fwd_stride(K);
  b.KKp = lee_row_stride(K);
  b.tb = tb;
  b.c = blockIdx.x;
  b.b0 = blockIdx.y * tb;
  b.nb = min(tb, B - b.b0);
  b.L_out = L_out;
  const int M0 = 1 << G;
  float* A = smem;                     // the inputs, then odd depths' rows
  float* Bn = A + M0 * tb * b.Kq;      // even depths' rows
  b.U = Bn + (G > 1 ? M0 / 2 * tb * b.Kq : 0);
  grouped_load_stabilized(A, b.Kq, A + K, b.Kq, x, x_sb, b.b0, b.nb, b.nb,
                          tb, b.c, L_out, M0, K);
  float* cur = A;
  float* nxt = Bn;
  for (int d = 0; d + 1 < G; ++d) {
    fwd_depth<TI>(b, args, d, cur, nxt, nullptr);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  fwd_depth<TF>(b, args, G - 1, cur, nullptr, out);
}

template <class TI, class TF>
cudaError_t launch(const GroupFwdArgs& args, int G, const float* x,
                   float* out, int B, int L_out, int K, int tb,
                   long long x_sb, int u_floats, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_fwd_kernel<TI, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  const long long kq = fwd_stride(K);
  const long long rows =
      ((1LL << G) + (G > 1 ? 1LL << (G - 1) : 0)) * tb * kq;
  const long long smem = 4LL * (rows + u_floats);
  if (smem > kLeeSmemLimit || tb < 1) return cudaErrorInvalidValue;
  for (int d = 0; d < G; ++d) {
    if (args.cells[d] < 1 || args.kt[d] < 1 ||
        (long long)args.cells[d] * args.kt[d] * lee_row_stride(K) > u_floats)
      return cudaErrorInvalidValue;
  }
  const dim3 grid(L_out, (B + tb - 1) / tb);
  grouped_fwd_kernel<TI, TF><<<grid, kThreads, (size_t)smem, stream>>>(
      args, G, x, out, B, L_out, K, tb, x_sb);
  return cudaGetLastError();
}

// the register tiles, by number: K1's forward tiles 0 (32 rows x 8
// outputs), 1 (64 x 1) and 2 (32 x 10), and 3 (32 x 1) for a last depth of
// one output
using Tile0 = LeeTile<4, 2, 4>;
using Tile1 = LeeTile<2, 1, 1>;
using Tile2 = LeeTile<2, 5, 2>;
using Tile3 = LeeTile<1, 1, 1>;

template <class TI>
cudaError_t launch_tf(bool one, const GroupFwdArgs& args, int G,
                      const float* x, float* out, int B, int L_out, int K,
                      int tb, long long x_sb, int u_floats, cudaStream_t s) {
  if (one)
    return launch<TI, Tile3>(args, G, x, out, B, L_out, K, tb, x_sb, u_floats,
                             s);
  return launch<TI, TI>(args, G, x, out, B, L_out, K, tb, x_sb, u_floats, s);
}

}  // namespace

// ws[d] (L_out 2^(G-1-d), k_outs[d], K, K) contiguous, interior k_outs == K;
// x (B, L_out 2^G, K) with unit strides over rows and K and batch stride
// x_sb; out (B, L_out, k_outs[G-1]) contiguous.  ti (0, 1 or 2) is the
// register tile of every depth, and tf (ti, or 3) that of the last; tb rows
// a block; cells[d] and kt[d] depth d's weight chunk (whole cells, kt =
// k_outs[d], or one cell's kt outputs), u_floats the weight area (at least
// every chunk's cells kt lee_row_stride(K) floats); the wrapper computes
// them all.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for G outside [1, 8] or a bad geometry.
extern "C" int grouped_fwd(const float* const* ws, const int* k_outs, int G,
                           const float* x, float* out, int B, int L_out, int K,
                           int tb, long long x_sb, int ti, int tf,
                           const int* cells, const int* kt, int u_floats,
                           void* stream) {
  if (G < 1 || G > kMaxDepths || ti < 0 || ti > 2 || (tf != ti && tf != 3))
    return (int)cudaErrorInvalidValue;
  GroupFwdArgs args = {};
  for (int d = 0; d < G; ++d) {
    args.w[d] = ws[d];
    args.k_out[d] = k_outs[d];
    args.cells[d] = cells[d];
    args.kt[d] = kt[d];
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool one = tf == 3;
  cudaError_t err =
      ti == 0 ? launch_tf<Tile0>(one, args, G, x, out, B, L_out, K, tb, x_sb,
                                 u_floats, s)
      : ti == 1 ? launch_tf<Tile1>(one, args, G, x, out, B, L_out, K, tb,
                                   x_sb, u_floats, s)
                : launch_tf<Tile2>(one, args, G, x, out, B, L_out, K, tb,
                                   x_sb, u_floats, s);
  return (int)err;
}
