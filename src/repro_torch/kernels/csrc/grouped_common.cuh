// The canonical subtree of a grouped run, shared by the fused forward
// (grouped_fwd.cu, K3) and the fused backward's residual recompute
// (grouped_bwd.cu, K4): both load a subtree's input rows the same way and
// stage its weights the same way, so that K4 recomputes exactly the rows K3
// computed.
//
// A canonical run of G depths is a forest of complete binary trees over its
// L_out output cells: the depth-d cells that feed output cell c are
// {c + m L_out : m < 2^(G-1-d)}, and at each depth cell c + m L_out has left
// child row c + m L_out and right child row c + (m + 2^(G-1-d)) L_out of the
// layer below.  A block that owns output cell c and a tile of rows keeps
// the subtree's rows slot-major: slot m (row c + m L_out of a depth's
// input), then row r of the tile, then the row's floats.
#pragma once

#include "lee_common.cuh"

constexpr int kGroupedMaxDepths = 8;

// Rows a thread takes at once, and values of each it loads before it uses
// any.
constexpr int kRowsAtOnce = 4;
constexpr int kRowBatch = 16;

// The subtree's input rows, stabilised: for the M slots of the input and
// rows r < nrows of the tile, rows[(m tb + r) stride + i] = exp(x[b0 + r,
// c + m L_out, i] - a) and amax[(m tb + r) astride] = a, with a the
// NEG_INF-clamped row max (lee_stabilize's arithmetic); rows r >= nb are
// zeros before they are stabilised.  x has batch stride x_sb and K floats a
// row.  A thread takes kRowsAtOnce whole rows at a time, slot by slot with
// the rows fastest (so the lanes of a warp write rows `stride` apart), and
// loads kRowBatch values of each before it uses any, so that a block keeps
// many loads in flight.
__device__ __forceinline__ void grouped_load_stabilized(
    float* rows, int stride, float* amax, int astride, const float* x,
    long long x_sb, int b0, int nb, int nrows, int tb, int c, int L_out,
    int M, int K) {
  const int n = M * nrows;
  for (int t0 = threadIdx.x; t0 < n; t0 += kRowsAtOnce * blockDim.x) {
    int slot_row[kRowsAtOnce];  // m tb + r, or -1 past the last row
    const float* src[kRowsAtOnce];
    float a[kRowsAtOnce];
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      const int t = t0 + q * (int)blockDim.x;
      const int m = t / nrows;
      const int r = t - m * nrows;
      slot_row[q] = t < n ? m * tb + r : -1;
      src[q] = t < n && r < nb
                   ? x + (long long)(b0 + r) * x_sb +
                         ((long long)c + (long long)m * L_out) * K
                   : nullptr;
      a[q] = __int_as_float(0xff800000);  // -inf
    }
    for (int i0 = 0; i0 < K; i0 += kRowBatch) {
      float v[kRowsAtOnce][kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q)
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          v[q][u] = i0 + u < K && src[q] != nullptr ? src[q][i0 + u] : 0.f;
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        if (slot_row[q] < 0) continue;
        float* row = rows + slot_row[q] * stride;
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (i0 + u >= K) continue;
          a[q] = fmaxf(a[q], v[q][u]);
          row[i0 + u] = v[q][u];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      if (slot_row[q] < 0) continue;
      float* row = rows + slot_row[q] * stride;
      const float m = fmaxf(a[q], LEE_NEG_INF);
      for (int i = 0; i < K; ++i) row[i] = expf(row[i] - m);
      amax[slot_row[q] * astride] = m;
    }
  }
}

// Stage cells [m0, m0 + mn), outputs [k0, k0 + kn) of one depth's weights
// wd (L_out 2^(G-1-d) cells of (ko, K, K)) for output cell c into U: cell m
// of the chunk from U + m cell_stride, one weight row every
// lee_row_stride(K) floats (lee_stage_weights, a cell at a time).  One
// pass over all the chunk's cells at once, with a division more per value,
// ran slower on the H100, for K4 and for K3 at K = 64.
__device__ __forceinline__ void grouped_stage(float* U, int cell_stride,
                                              const float* wd, int c,
                                              int L_out, int ko, int m0,
                                              int mn, int k0, int kn, int K) {
  const long long kk = (long long)K * K;
  for (int m = 0; m < mn; ++m) {
    lee_stage_weights(U + m * cell_stride, wd + c * ko * kk,
                      (long long)L_out * ko * kk, m0 + m, 1, k0, kn, K);
  }
}
