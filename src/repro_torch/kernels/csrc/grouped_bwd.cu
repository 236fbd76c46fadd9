// Grouped log-einsum-exp backward: every depth's weight gradient and the
// input cotangent of G consecutive canonical depths in one launch, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/grouped.py
// grouped_log_einsum_exp_bwd_pallas (_make_bwd_kernel, _depth_bwd).  The
// subtree geometry is grouped_common.cuh's: output cell c of the run owns the
// depth-g cells {c + m L_out : m < 2^(G-1-g)}, and at each depth cell
// c + m L_out has left child row c + m L_out and right child row
// c + (m + 2^(G-1-g)) L_out of the layer below.  So a block that owns one
// output cell and a tile of rows keeps the whole subtree in shared memory:
// the intermediate depths never reach device memory, and that is what the
// fusion buys over the per-layer chain of K2 launches.
//
// One block per (output cell c, tile of tb rows):
//  1. Residual recompute.  Load the tile's 2^G input rows and stabilise
//     them (grouped_load_stabilized, as K3 does), and walk the depths
//     forward: per chunk of cells and K_out tile, stage the weight rows at
//     the odd stride lee_row_stride (grouped_stage, as K3 does), run the
//     register-tiled sweep t[r, k, i] =
//     sum_j W[k, i, j] er[r, j] over the chunk's cells (lee_sweep_cells)
//     and sum s = sum_i el_i t_i in lee_cell_sum's order, so the rows are
//     K3's bit for bit.  Every depth's stabilised rows, their maxes and its
//     s (the top depth's too) stay in shared memory.
//  2. The depths in reverse: ginv = g / max(s, 1e-30) in place of g, one
//     elementwise pass; then per chunk (here as many cells as the staging
//     area holds: einet_rat's whole depth) two sweeps, t on er and u on el
//     (TRANS), each reduced in registers and by warp shuffles into the
//     input cotangent, sum_k ginv_k t[k, i] and sum_k ginv_k u[k, j]: no
//     sweep buffer and no barrier between a sweep and its sums.  Times the
//     stabilised inputs these are gl and gr, the next depth's output
//     cotangent.
//     Depth 0's input cotangent goes straight to gx.
// Weight gradients, in one of two ways the wrapper picks:
//  * per tile (the partials of all tiles fit in 64 MB, as at einet_rat:
//    64 tiles x 564 KB): each chunk's dW[k, i, j] = sum_r ginv_k el_i er_j
//    over the tile's rows, 4 outputs x 4 columns a thread (each el er
//    product feeds 4 FMAs), written to the tile's partial; lee_sum_tiles
//    adds the partials in tile order;
//  * by batch split (einet_rat_large's K = 64 cells are 1 MB; a partial of
//    its [0,2) run is 1.6 GB): the block writes ginv and the interior
//    depths' rows to device memory instead, and K2's dW kernel
//    (lee_dw.cuh) runs a (cell, K_out tile, batch split) grid per depth.
// No atomics: two calls give bitwise-equal gradients.  A row's gx depends
// on that row alone: the tile templates, and so every order of operations,
// follow K and K_out, not the batch.  Rows past the end of the batch are
// zero in shared memory and never written; an input at -inf has a
// stabilised value of 0 and so a gradient of exactly 0.
//
// Bank conflicts: weight rows at lee_row_stride(K) and every row area
// (stabilised rows, cotangents, s) at an odd stride (lee_pad), so every
// warp-wide weight or activation load of the sweeps, of s and of dW reads
// distinct banks or one word (a broadcast), at any K.  Weight rows back to
// back at K^2 floats would put a warp's 32 loads in one bank at K = 64.
//
// What bounds it on the H100, at einet_rat's fused run [0,4) (B = 2048,
// L_out = 10, x (2048, 160, 10), K = 10, K_out 10/10/10/1): it must read x
// (13.1 MB), g (82 KB) and the weights (141,000 floats, 0.56 MB) and write
// gx (13.1 MB) and dW (0.56 MB), about 27.4 MB or 8.2 us at 3.35 TB/s.
// The work is the forward's contraction (s), the input cotangent's two and
// dW, 2 K^2 K_out flops each per cell and row over sum(cells K^2 K_out) =
// 141,000 a row, plus 4 K^2 a cell: about 906,000 flops a row, 1.86 GFLOP
// in all, 27.7 us at the 67 TFLOP/s fp32 (non-tensor) rate: bound by
// operations.  The recompute adds the top depth's s.
//
// Later work, not done here: tensor cores (3xTF32 to keep fp32 accuracy),
// cp.async/TMA staging overlapped with the sweeps, a persistent loop over
// row tiles that stages each weight chunk once for all of them.

#include "grouped_common.cuh"
#include "lee_dw.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepths = kGroupedMaxDepths;
constexpr int kJT = 4;  // dW columns a thread (tile mode)

struct GroupBwdArgs {
  const float* w[kMaxDepths];  // depth d: (L_out 2^(G-1-d), k_out[d], K, K)
  int k_out[kMaxDepths];
  long long gw_off[kMaxDepths];  // depth d's offset in gw (and a partial)
  float* xs[kMaxDepths];    // split mode: depth d >= 1's rows (B, 2 L_d, K)
  float* ginv[kMaxDepths];  // split mode: depth d's ginv (B, L_d, k_out)
};

// The block's shared memory and where it stands.  Every row area has an
// odd stride: Kp = lee_pad(K) for rows of K, lee_pad(k_out) for rows of
// K_out.
struct Blk {
  float* E;  // every depth's stabilised rows, slot-major: (slot, row, Kp)
  float* A;  // their clamped maxes (slot, row)
  float* S;  // every depth's s from the recompute: (cell, row, K_out)
  float* C[2];  // cotangent areas: depth d's output cotangent, then ginv,
                // in C[d & 1] (cell, row, K_out), its input cotangent in
                // the other (slot, row, Kp)
  float* U;  // chunk area: weight rows at lee_row_stride(K), then (in the
             // recompute) the sweep
  int G, K, Kp, KKp, tb, nb, b0, c, L_out, t_cells, u_floats;
};

// first slot of depth d: 2^(G+1) - 2^(G+1-d)
__device__ __forceinline__ int slot0(int G, int d) {
  return (2 << G) - (2 << (G - d));
}

// depth d's s in S: tb sum_{d' < d} H_d' lee_pad(k_out[d'])
__device__ __forceinline__ float* s_of(const Blk& b, const GroupBwdArgs& a,
                                       int d) {
  float* s = b.S;
  for (int e = 0; e < d; ++e)
    s += b.tb * (1 << (b.G - 1 - e)) * lee_pad(a.k_out[e]);
  return s;
}

// Stage cells [m0, m0 + mn), outputs [k0, k0 + kn) of depth d's weights
// into U, KT rows a cell apart (grouped_stage, as K3 stages them).
__device__ __forceinline__ void stage(const Blk& b, const GroupBwdArgs& a,
                                      int d, int m0, int mn, int k0, int kn,
                                      int KT) {
  grouped_stage(b.U, KT * b.KKp, a.w[d], b.c, b.L_out, a.k_out[d], m0, mn,
                k0, kn, b.K);
}

// Depth d of the recompute, chunk by chunk (t_cells cells, one K_out
// tile): the sweep t[r, k, i] = sum_j W[k, i, j] er[r, j] (lee_sweep_cells)
// into U after the weights, then s = sum_i el_i t_i in lee_cell_sum's
// order, kept in S; below the last depth also depth d + 1's rows, (a_l +
// a_r) + log s, stabilised in place (and in split mode written, in the log
// domain, to xs[d + 1]).
template <class Tile>
__device__ void fwd_depth(const Blk& b, const GroupBwdArgs& a, int d) {
  constexpr int KT = Tile::KT;
  const int H = 1 << (b.G - 1 - d);
  const int ko = a.k_out[d];
  const int kop = lee_pad(ko);
  const int tb = b.tb, Kp = b.Kp;
  const bool last = d == b.G - 1;
  const float* Ed = b.E + (long long)slot0(b.G, d) * tb * Kp;
  const float* Ad = b.A + slot0(b.G, d) * tb;
  float* Sd = s_of(b, a, d);
  float* En = last ? nullptr : b.E + (long long)slot0(b.G, d + 1) * tb * Kp;
  float* xs = last ? nullptr : a.xs[d + 1];
  const long long xs_sb = (long long)b.L_out * H * b.K;
  float* T = b.U + b.t_cells * KT * b.KKp;
  for (int m0 = 0; m0 < H; m0 += b.t_cells) {
    const int mn = min(b.t_cells, H - m0);
    for (int k0 = 0; k0 < ko; k0 += KT) {
      const int kn = min(KT, ko - k0);
      __syncthreads();  // the previous chunk is done with U
      stage(b, a, d, m0, mn, k0, kn, KT);
      __syncthreads();
      lee_sweep_cells<Tile, false>(b.U, KT * b.KKp, Ed + (H + m0) * tb * Kp,
                                   tb * Kp, T, tb * KT * Kp, b.K,
                                   tb / Tile::ROWS, mn);
      __syncthreads();
      for (int o = threadIdx.x; o < mn * tb * KT; o += blockDim.x) {
        const int k = o % KT;
        if (k >= kn) continue;
        const int mr = o / KT;  // (m, r)
        const int m = mr / tb;
        const int r = mr - m * tb;
        const int row = (m0 + m) * tb + r;
        const float* el = Ed + row * Kp;
        const float* t = T + o * Kp;
        float s = 0.f;
        for (int i = 0; i < b.K; ++i) s = fmaf(el[i], t[i], s);
        Sd[row * kop + k0 + k] = s;
        if (last) continue;
        const float v = (Ad[row] + Ad[row + H * tb]) + logf(s);
        En[row * Kp + k0 + k] = v;
        if (xs != nullptr && r < b.nb) {
          xs[(long long)(b.b0 + r) * xs_sb +
             ((long long)b.c + (long long)(m0 + m) * b.L_out) * b.K + k0 +
             k] = v;
        }
      }
    }
  }
  if (last) return;
  __syncthreads();
  float* An = b.A + slot0(b.G, d + 1) * tb;
  for (int t = threadIdx.x; t < H * tb; t += blockDim.x) {
    An[t] = lee_stabilize(En + t * Kp, b.K);
  }
}

// Where a cotangent sweep writes: the K_out tiles' sums go to acc (cell
// m's row r at acc + (m tb + r) Kp), and on the last tile, times their
// stabilised input e[(m tb + r) Kp + p], to out + m slot + r row (rows from
// `rows` on are not written there).  Above depth 0 out is acc; at depth 0
// out is gx, and with one K_out tile acc is not used.
struct CotOut {
  float* acc;
  float* out;
  long long slot, row;
  int rows;
  const float* e;  // NULL before the last K_out tile
};

// One cotangent sweep over the chunk's cells, items (cell, row subtile, p)
// round the warps: a lane forms lee_sweep's t (or with TRANS u) for R rows
// x KO outputs at p, weighs each output by its ginv and sums them; the
// warp's NKG k-groups are added by shuffles, and lane kg = 0 writes (first
// K_out tile) or adds the row's sum at p.  So
//   out[m, r, p] (+)= sum_k ginv[m, r, k] sum_q W[k, p, q] x[m, r, q]
// (TRANS: W[k, q, p]), times e on the last K_out tile: gl (gr), with no
// sweep buffer and no barrier between the sweep and the sums.
template <class Tile, bool TRANS>
__device__ __forceinline__ void cot_sweep(const Blk& b, const float* x,
                                          const float* gi, int kop, int kn,
                                          const CotOut& o, bool first,
                                          int mn) {
  constexpr int KT = Tile::KT;
  const int K = b.K, Kp = b.Kp, KKp = b.KKp, tb = b.tb;
  const int lane = threadIdx.x & 31;
  const int kg = lane % Tile::NKG;
  const int rg = lane / Tile::NKG;
  const int nwarps = blockDim.x >> 5;
  const int nsub = tb / Tile::ROWS;
  const int per_cell = nsub * K;
  for (int item = threadIdx.x >> 5; item < mn * per_cell; item += nwarps) {
    const int m = item / per_cell;
    const int rest = item - m * per_cell;
    const int sub = rest / K;
    const int p = rest - sub * K;
    const int r0 = sub * Tile::ROWS + rg;
    float t[Tile::R][Tile::KO];
    lee_tile<Tile, TRANS>(b.U + m * KT * KKp + kg * KKp + (TRANS ? p : p * K),
                          x + (m * tb + r0) * Kp, K, t);
#pragma unroll
    for (int v = 0; v < Tile::R; ++v) {
      const int row = m * tb + r0 + v * Tile::NRG;
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < Tile::KO; ++u) {
        const int k = kg + u * Tile::NKG;
        if (k < kn) acc = fmaf(gi[row * kop + k], t[v][u], acc);
      }
#pragma unroll
      for (int off = Tile::NKG / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int r = r0 + v * Tile::NRG;
      if (kg == 0) {
        float* sum = o.acc + row * Kp + p;
        const float val = first ? acc : *sum + acc;
        if (o.e == nullptr) {
          *sum = val;
        } else if (r < o.rows) {
          o.out[m * o.slot + r * o.row + p] = val * o.e[row * Kp + p];
        }
      }
    }
  }
}

// Depth d in reverse: ginv = g / max(s, 1e-30) in place of the output
// cotangent C[d & 1] (in split mode also to device memory), then chunk by
// chunk (as many cells' K_out tile as U holds) the two cotangent sweeps
// into C[(d + 1) & 1] (depth 0: straight into gx) and, in tile mode, the
// chunk's dW over the tile's rows into part.
template <class Tile>
__device__ void bwd_depth(const Blk& b, const GroupBwdArgs& a, int d,
                          float* part, float* gx) {
  constexpr int KT = Tile::KT;
  const int M = 1 << (b.G - d);
  const int H = M >> 1;
  const int ko = a.k_out[d];
  const int kop = lee_pad(ko);
  const int tb = b.tb, Kp = b.Kp, K = b.K;
  const int KK = K * K;
  const float* Ed = b.E + (long long)slot0(b.G, d) * tb * Kp;
  const float* Sd = s_of(b, a, d);
  float* gout = b.C[d & 1];
  float* gin = b.C[(d + 1) & 1];
  float* ginv_g = a.ginv[d];
  const long long L_d = (long long)b.L_out * H;
  __syncthreads();  // gout and the recompute's S are written
  for (int o = threadIdx.x; o < H * tb * ko; o += blockDim.x) {
    const int k = o % ko;
    const int row = o / ko;  // (m, r)
    const int m = row / tb;
    const int r = row - m * tb;
    float* gv = gout + row * kop + k;
    const float v = *gv / fmaxf(Sd[row * kop + k], LEE_S_FLOOR);
    *gv = v;
    if (ginv_g != nullptr && r < b.nb) {
      ginv_g[((long long)(b.b0 + r) * L_d + b.c +
              (long long)m * b.L_out) * ko + k] = v;
    }
  }
  const int cells = min(H, b.u_floats / (KT * b.KKp));
  for (int m0 = 0; m0 < H; m0 += cells) {
    const int mn = min(cells, H - m0);
    for (int k0 = 0; k0 < ko; k0 += KT) {
      const int kn = min(KT, ko - k0);
      __syncthreads();  // ginv is written; the previous chunk is done
      stage(b, a, d, m0, mn, k0, kn, KT);
      __syncthreads();
      const float* gi = gout + m0 * tb * kop + k0;
      const bool last = k0 + KT >= ko;
      for (int side = 0; side < 2; ++side) {
        const int slot = side == 0 ? m0 : H + m0;  // left, then right
        CotOut o;
        o.acc = gin + slot * tb * Kp;
        if (d == 0) {  // rows of x: row b0 + r, cell c + slot L_out
          o.out = gx + (long long)b.b0 * b.L_out * M * K +
                  ((long long)b.c + (long long)slot * b.L_out) * K;
          o.slot = (long long)b.L_out * K;
          o.row = (long long)b.L_out * M * K;
          o.rows = b.nb;
        } else {
          o.out = o.acc;
          o.slot = tb * Kp;
          o.row = Kp;
          o.rows = tb;
        }
        o.e = last ? Ed + slot * tb * Kp : nullptr;
        if (side == 0) {
          cot_sweep<Tile, false>(b, Ed + (H + m0) * tb * Kp, gi, kop, kn, o,
                                 k0 == 0, mn);
        } else {
          cot_sweep<Tile, true>(b, Ed + m0 * tb * Kp, gi, kop, kn, o,
                                k0 == 0, mn);
        }
      }
      if (part == nullptr) continue;
      // the chunk's dW over the tile's rows: a thread owns (cell m, k-quad
      // kq, i, column group jg), outputs k0 + 4 kq + u, columns jg + c njg
      const int njg = (K + kJT - 1) / kJT;
      const int nkq = (kn + 3) / 4;
      const int items = mn * nkq * K * njg;
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int jg = it % njg;
        int rest = it / njg;
        const int i = rest % K;
        rest /= K;
        const int kq = rest % nkq;
        const int m = rest / nkq;
        const float* el = Ed + (long long)(m0 + m) * tb * Kp + i;
        const float* er = Ed + (long long)(H + m0 + m) * tb * Kp;
        const float* gq = gi + m * tb * kop + 4 * kq;
        float acc[4][kJT];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < kJT; ++c) acc[u][c] = 0.f;
#pragma unroll 4
        for (int r = 0; r < b.nb; ++r) {
          const float e = el[r * Kp];
          float p[kJT];
#pragma unroll
          for (int c = 0; c < kJT; ++c) {
            const int j = jg + c * njg;
            p[c] = j < K ? e * er[r * Kp + j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float gv = 4 * kq + u < kn ? gq[r * kop + u] : 0.f;
#pragma unroll
            for (int c = 0; c < kJT; ++c) acc[u][c] = fmaf(gv, p[c], acc[u][c]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * kq + u;
          if (k >= kn) continue;
          float* dst = part + a.gw_off[d] +
                       (((long long)b.c + (long long)(m0 + m) * b.L_out) *
                            ko + k0 + k) * KK + i * K;
#pragma unroll
          for (int c = 0; c < kJT; ++c) {
            const int j = jg + c * njg;
            if (j < K) dst[j] = acc[u][c];
          }
        }
      }
    }
  }
}

template <class TI, class TF>
__global__ void __launch_bounds__(kThreads) grouped_bwd_kernel(
    GroupBwdArgs args, int G, const float* __restrict__ x,
    const float* __restrict__ g_out, float* __restrict__ gw_part,
    long long part_floats, float* __restrict__ gx, int B, int L_out, int K,
    int tb, long long x_sb, int t_cells, int c0_floats, int c1_floats,
    int s_floats) {
  extern __shared__ float smem[];
  constexpr int KTM = TI::KT > TF::KT ? TI::KT : TF::KT;
  Blk b;
  b.G = G;
  b.K = K;
  b.Kp = lee_pad(K);
  b.KKp = lee_row_stride(K);
  b.tb = tb;
  b.c = blockIdx.x;
  b.b0 = blockIdx.y * tb;
  b.nb = min(tb, B - b.b0);
  b.L_out = L_out;
  b.t_cells = t_cells;
  b.u_floats = t_cells * (KTM * b.KKp + tb * KTM * b.Kp);
  const int S = (2 << G) - 2;  // slots of all depths
  b.E = smem;
  b.A = b.E + (long long)S * tb * b.Kp;
  b.S = b.A + S * tb;
  b.C[0] = b.S + s_floats;
  b.C[1] = b.C[0] + c0_floats;
  b.U = b.C[1] + c1_floats;
  const int M0 = 1 << G;

  // the tile's input rows, zeros past the end of the batch, stabilised
  grouped_load_stabilized(b.E, b.Kp, b.A, 1, x, x_sb, b.b0, b.nb, tb, tb,
                          b.c, L_out, M0, K);
  // 1. the forward, recomputed: every depth's s, every interior depth's
  // rows
  for (int d = 0; d + 1 < G; ++d) fwd_depth<TI>(b, args, d);
  fwd_depth<TF>(b, args, G - 1);
  // 2. g_out, then the depths in reverse
  const int kf = args.k_out[G - 1];
  {
    float* gcur = b.C[(G - 1) & 1];
    const int kfp = lee_pad(kf);
    for (int t = threadIdx.x; t < tb * kf; t += blockDim.x) {
      const int r = t / kf;
      const int k = t - r * kf;
      gcur[r * kfp + k] =
          r < b.nb ? g_out[((long long)(b.b0 + r) * L_out + b.c) * kf + k]
                   : 0.f;
    }
  }
  float* part = gw_part == nullptr
                    ? nullptr
                    : gw_part + (long long)blockIdx.y * part_floats;
  for (int d = G - 1; d >= 0; --d) {
    if (d == G - 1) {
      bwd_depth<TF>(b, args, d, part, gx);
    } else {
      bwd_depth<TI>(b, args, d, part, gx);
    }
  }
}

template <class TI, class TF>
cudaError_t launch(const GroupBwdArgs& args, int G, const float* x,
                   const float* g_out, float* gw_part, long long part_floats,
                   float* gx, int B, int L_out, int K, int tb, long long x_sb,
                   int t_cells, int c0_floats, int c1_floats,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_bwd_kernel<TI, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLeeSmemLimit);
  if (attr != cudaSuccess) return attr;
  constexpr int KTM = TI::KT > TF::KT ? TI::KT : TF::KT;
  const long long S = (2LL << G) - 2;
  int s_floats = 0;
  for (int d = 0; d < G; ++d)
    s_floats += tb * (1 << (G - 1 - d)) * lee_pad(args.k_out[d]);
  const long long smem =
      4LL * (S * tb * (lee_pad(K) + 1) + s_floats + c0_floats + c1_floats +
             (long long)t_cells * KTM * lee_row_stride(K) +
             (long long)t_cells * tb * KTM * lee_pad(K));
  if (smem > kLeeSmemLimit || tb % TI::ROWS || tb % TF::ROWS)
    return cudaErrorInvalidValue;
  const dim3 grid(L_out, (B + tb - 1) / tb);
  grouped_bwd_kernel<TI, TF><<<grid, kThreads, (size_t)smem, stream>>>(
      args, G, x, g_out, gw_part, part_floats, gx, B, L_out, K, tb, x_sb,
      t_cells, c0_floats, c1_floats, s_floats);
  return cudaGetLastError();
}

// the register tiles, by number: 0 (16 rows x 8 outputs), 1 (32 x 1) and
// 2 (32 x 10), K2's backward tiles
using Tile0 = LeeTile<2, 2, 4>;
using Tile1 = LeeTile<1, 1, 1>;
using Tile2 = LeeTile<2, 5, 2>;

template <class TI>
cudaError_t launch_tf(int tf, const GroupBwdArgs& args, int G,
                      const float* x, const float* g_out, float* gw_part,
                      long long part_floats, float* gx, int B, int L_out,
                      int K, int tb, long long x_sb, int t_cells, int c0,
                      int c1, cudaStream_t s) {
  if (tf == 0)
    return launch<TI, Tile0>(args, G, x, g_out, gw_part, part_floats, gx, B,
                             L_out, K, tb, x_sb, t_cells, c0, c1, s);
  if (tf == 1)
    return launch<TI, Tile1>(args, G, x, g_out, gw_part, part_floats, gx, B,
                             L_out, K, tb, x_sb, t_cells, c0, c1, s);
  return launch<TI, Tile2>(args, G, x, g_out, gw_part, part_floats, gx, B,
                           L_out, K, tb, x_sb, t_cells, c0, c1, s);
}

}  // namespace

// ws[d] (L_out 2^(G-1-d), k_outs[d], K, K) contiguous, interior k_outs == K;
// x (B, L_out 2^G, K) with unit strides over rows and K and batch stride
// x_sb; g_out (B, L_out, k_outs[G-1]) contiguous.  Writes gx (B, L_out 2^G,
// K) contiguous and gw, every depth's weight gradient in one flat buffer
// (depth d at gw_offs[d], laid out like ws[d]; part_floats in all).
// ti (0 or 2) is the interior depths' register tile and tf (0, 1 or 2) the
// last depth's; tb rows a block (a multiple of both tiles' rows); t_cells
// cells a recompute chunk; c0_floats and c1_floats size the cotangent
// areas (the wrapper computes them all).
// Tile mode (scratch == NULL): with more than one row tile, gw_part holds
// ceil(B / tb) partials of part_floats, summed into gw in tile order; with
// one tile, pass gw_part == gw.
// Split mode (scratch != NULL): scratch holds the interior depths' rows
// (B, 2 L_d, K) for d = 1 .. G-1, then every depth's ginv (B, L_d,
// k_outs[d]), then the dW partials of the largest depth; dw[3 d .. 3 d + 2]
// are depth d's (JT, K_out tile, batch splits) of K2's dW kernel.
// Launches on `stream`; returns the first CUDA error, or 0, or
// cudaErrorInvalidValue for G outside [1, 8] or a bad geometry.
extern "C" int grouped_bwd(const float* const* ws, const int* k_outs,
                           const long long* gw_offs, int G, const float* x,
                           const float* g_out, float* gw_part, float* gw,
                           long long part_floats, float* gx, int B, int L_out,
                           int K, int tb, long long x_sb, int ti, int tf,
                           int t_cells, int c0_floats, int c1_floats,
                           float* scratch, const int* dw, void* stream) {
  if (G < 1 || G > kMaxDepths || (ti != 0 && ti != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  GroupBwdArgs args = {};
  long long off = 0;
  for (int d = 0; d < G; ++d) {
    args.w[d] = ws[d];
    args.k_out[d] = k_outs[d];
    args.gw_off[d] = gw_offs[d];
  }
  const bool split = scratch != nullptr;
  if (split) {
    for (int d = 1; d < G; ++d) {
      args.xs[d] = scratch + off;
      off += (long long)B * L_out * (2LL << (G - 1 - d)) * K;
    }
    for (int d = 0; d < G; ++d) {
      args.ginv[d] = scratch + off;
      off += (long long)B * L_out * (1LL << (G - 1 - d)) * k_outs[d];
    }
  }
  const int tiles = (B + tb - 1) / tb;
  float* part = split ? nullptr : gw_part;
  cudaError_t err =
      ti == 0 ? launch_tf<Tile0>(tf, args, G, x, g_out, part, part_floats, gx,
                                 B, L_out, K, tb, x_sb, t_cells, c0_floats,
                                 c1_floats, s)
              : launch_tf<Tile2>(tf, args, G, x, g_out, part, part_floats, gx,
                                 B, L_out, K, tb, x_sb, t_cells, c0_floats,
                                 c1_floats, s);
  if (err != cudaSuccess) return (int)err;
  if (!split) {
    if (tiles == 1) return 0;
    return (int)lee_sum_tiles(gw_part, gw, part_floats, tiles, s);
  }
  // split mode: K2's dW kernel on each depth's rows and ginv
  float* dw_part = scratch + off;
  for (int d = 0; d < G; ++d) {
    const int L_d = L_out << (G - 1 - d);
    const float* ln = d == 0 ? x : args.xs[d];
    const long long sb = d == 0 ? x_sb : 2LL * L_d * K;
    float* gw_d = gw + gw_offs[d];
    const int splits = dw[3 * d + 2];
    err = lee_dw(ln, ln + (long long)L_d * K, args.ginv[d], nullptr,
                 splits > 1 ? dw_part : gw_d, gw_d, nullptr, nullptr, B, L_d,
                 K, k_outs[d], dw[3 * d], dw[3 * d + 1], splits, 1, sb, K, sb,
                 K, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
