// The forward walk of a gather run, shared by gather_fwd.cu (K5) and its
// residual recompute in gather_bwd.cu (K6), so the backward recomputes
// exactly the rows and frames the forward computed.
//
// A gather run (a Poon-Domingos interior, repro_torch/core/plan.py
// GatherTables) is a list of depths; depth t reads its L_t left and right
// child rows from anywhere in the row buffer below it and appends L_t einsum
// rows, then M_t mixing rows, each mixing a fixed set of C_t of the depth's
// einsum rows (masked children padded).  Row ids are global buffer rows:
// input rows [0, r_in), then every depth's new rows in order.
//
// The Pallas kernel bakes the tables into its trace as constants.  These
// kernels are built once from the sources, for every run of every model,
// so the tables cannot be constexpr-unrolled: the wrapper packs them into
// one int32 tensor per (tables, device), and a block copies it into shared
// memory before the walk.  Layout (kernels/grouped.py pack_gather_tables):
//   [0] D depths, [1] r_in, [2] R rows in all, [3] Rc rows that may be a
//   child (every row below the last depth);
//   then 8 ints a depth: L, M, C, base (its first row), the offsets of its
//   left rows, right rows and (M, C) mixing children (the 0/1 mask follows
//   the children), and its mixing ordinal (or -1 without mixing).
#pragma once

#include "lee_common.cuh"

constexpr int kGatherMaxDepths = 16;
constexpr int kGatherHeader = 4;
constexpr int kGatherDepthInts = 8;

struct GatherDepth {
  int L, M, C, base, left, right, child, vi;
};

__device__ __forceinline__ GatherDepth gather_depth(const int* tab, int t) {
  const int* d = tab + kGatherHeader + kGatherDepthInts * t;
  return {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7]};
}

struct GatherParams {
  const float* w[kGatherMaxDepths];  // depth t: (L_t, K, K, K)
  const float* v[kGatherMaxDepths];  // mixing ordinal q: (M, C, K)
  long long w_off[kGatherMaxDepths];  // backward: offsets in one partial
  long long v_off[kGatherMaxDepths];
};

// The shared-memory row areas of one block: the tile's row buffer in the
// log domain (R rows of K a batch row), the stabilised copy of every row
// that may be a child (Rc rows of K) and its clamped max.
struct GatherRows {
  float* X;
  float* E;
  float* A;
  int R, Rc, K;
};

// Stabilise rows [r0, r1) of every batch row: E = exp(X - m), A = m, with
// m the NEG_INF-clamped row max (lee_stabilize).
__device__ __forceinline__ void gather_stabilize(const GatherRows& g, int nb,
                                                 int r0, int r1) {
  const int n = r1 - r0;
  for (int t = threadIdx.x; t < nb * n; t += blockDim.x) {
    const int r = t / n;
    const int row = r0 + t - r * n;
    const float* xr = g.X + ((long long)r * g.R + row) * g.K;
    float* er = g.E + ((long long)r * g.Rc + row) * g.K;
    for (int i = 0; i < g.K; ++i) er[i] = xr[i];
    g.A[r * g.Rc + row] = lee_stabilize(er, g.K);
  }
}

// Child c of mixing slot (mi, k) in the log domain, NEG_INF where masked
// (the plain version's where(mask > 0, ln, NEG_INF)).
__device__ __forceinline__ float gather_mix_child(const GatherRows& g,
                                                  const int* tab,
                                                  const GatherDepth& d, int r,
                                                  int mi, int c, int k) {
  const int* child = tab + d.child;
  const int* mask = child + d.M * d.C;
  if (!mask[mi * d.C + c]) return LEE_NEG_INF;
  return g.X[((long long)r * g.R + d.base + child[mi * d.C + c]) * g.K + k];
}

// The mixing frame of slot (r, mi, k): returns the clamped max over the
// children and sets *s to sum_c v[mi, c, k] exp(ln_c - max), multiplied and
// added in child order without fused multiply-adds, as the plain version
// adds its terms.
__device__ __forceinline__ float gather_mix_frame(const GatherRows& g,
                                                  const int* tab,
                                                  const GatherDepth& d,
                                                  const float* v, int r,
                                                  int mi, int k, float* s) {
  float a = __int_as_float(0xff800000);  // -inf
  for (int c = 0; c < d.C; ++c) {
    a = fmaxf(a, gather_mix_child(g, tab, d, r, mi, c, k));
  }
  a = fmaxf(a, LEE_NEG_INF);
  float acc = 0.f;
  for (int c = 0; c < d.C; ++c) {
    const float e = expf(gather_mix_child(g, tab, d, r, mi, c, k) - a);
    const float term = __fmul_rn(v[(mi * d.C + c) * g.K + k], e);
    acc = c == 0 ? term : __fadd_rn(acc, term);
  }
  *s = acc;
  return a;
}

// Shared-memory stride of one staged weight row (one output k of a cell,
// K^2 floats): odd, so the rows that a warp's threads read at once (one k
// each) fall in different banks.  At K = 40 an unpadded row is 1,600
// floats, a multiple of the 32 banks, and every k would hit one bank.
__device__ __forceinline__ int gather_row_stride(int K) { return (K * K) | 1; }

// Stage cells [m0, m0 + mn), outputs [k0, k0 + kn) of a depth's weights wd
// (L, K, K, K) into wbuf, one weight row every gather_row_stride(K) floats.
// Each cell's part is one contiguous run of kn K^2 floats in device
// memory; a thread loads kStageBatch values before it stores any, as
// float4s where K^2 is a multiple of 4 and wd is 16-byte aligned, so that
// a block keeps many loads in flight (one at a time leaves the copy bound
// by the latency of each load).
constexpr int kStageBatch = 8;

__device__ __forceinline__ void gather_stage_weights(float* wbuf,
                                                     const float* wd, int m0,
                                                     int mn, int k0, int kn,
                                                     int K) {
  const int KK = K * K;
  const int KKp = gather_row_stride(K);
  const int n = kn * KK;  // floats of one cell's part
  const bool vec = KK % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(wd) % 16 == 0;
  for (int m = 0; m < mn; ++m) {
    const float* src = wd + (long long)(m0 + m) * K * KK + (long long)k0 * KK;
    float* dst = wbuf + m * kn * KKp;
    if (vec) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      const int n4 = n / 4;
      for (int b = threadIdx.x; b < n4; b += kStageBatch * blockDim.x) {
        float4 v[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int q = b + u * blockDim.x;
          if (q < n4) v[u] = src4[q];
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int q = b + u * blockDim.x;
          if (q < n4) {
            const int row = (4 * q) / KK;  // the 4 floats share a row
            float* d = dst + row * KKp + (4 * q - row * KK);
            d[0] = v[u].x;
            d[1] = v[u].y;
            d[2] = v[u].z;
            d[3] = v[u].w;
          }
        }
      }
    } else {
      for (int b = threadIdx.x; b < n; b += kStageBatch * blockDim.x) {
        float v[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int q = b + u * blockDim.x;
          if (q < n) v[u] = src[q];
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int q = b + u * blockDim.x;
          if (q < n) {
            const int row = q / KK;
            dst[row * KKp + (q - row * KK)] = v[u];
          }
        }
      }
    }
  }
}

// lee_cell_sum's arithmetic in its order (the same bits as every other
// kernel's cell), with the inner loop unrolled so that a thread keeps
// several shared-memory loads in flight ahead of its FMA chain.
__device__ __forceinline__ float gather_cell_sum(const float* w,
                                                 const float* el,
                                                 const float* er, int K) {
  float s = 0.f;
  for (int i = 0; i < K; ++i) {
    const float* wi = w + i * K;
    float t = 0.f;
#pragma unroll 8
    for (int j = 0; j < K; ++j) t = fmaf(wi[j], er[j], t);
    s = fmaf(el[i], t, s);
  }
  return s;
}

// The forward walk for the block's nb rows, whose input rows [0, r_in) are
// in X on entry.  Per depth: the weights go through wbuf in chunks
// (lee_chunks: whole cells, or one cell's K_out tile: a K = 40 cell is
// 256 KB), every (row, cell, k) output is gather_cell_sum on the stabilised
// children, then the masked mixing, then (below the last depth) the new
// rows are stabilised.  Returns with every row of X written and synced.
__device__ inline void gather_forward_sweep(const int* tab,
                                            const GatherParams& p,
                                            const GatherRows& g, int nb,
                                            float* wbuf, int w_floats) {
  const int K = g.K;
  const int KKp = gather_row_stride(K);
  const int D = tab[0];
  __syncthreads();
  gather_stabilize(g, nb, 0, tab[1]);
  for (int t = 0; t < D; ++t) {
    const GatherDepth d = gather_depth(tab, t);
    const int* left = tab + d.left;
    const int* right = tab + d.right;
    const LeeChunks ch = lee_chunks(d.L, K, KKp, w_floats);
    for (int m0 = 0; m0 < d.L; m0 += ch.cells) {
      const int mn = min(ch.cells, d.L - m0);
      for (int k0 = 0; k0 < K; k0 += ch.kt) {
        const int kn = min(ch.kt, K - k0);
        // the previous chunk's outputs and the stabilised rows are written
        __syncthreads();
        gather_stage_weights(wbuf, p.w[t], m0, mn, k0, kn, K);
        __syncthreads();
        for (int o = threadIdx.x; o < nb * mn * kn; o += blockDim.x) {
          const int r = o / (mn * kn);
          const int rem = o - r * mn * kn;
          const int m = rem / kn;
          const int k = rem - m * kn;
          const int l = left[m0 + m];
          const int rr = right[m0 + m];
          const float s = gather_cell_sum(
              wbuf + (m * kn + k) * KKp, g.E + ((long long)r * g.Rc + l) * K,
              g.E + ((long long)r * g.Rc + rr) * K, K);
          g.X[((long long)r * g.R + d.base + m0 + m) * K + k0 + k] =
              (g.A[r * g.Rc + l] + g.A[r * g.Rc + rr]) + logf(s);
        }
      }
    }
    __syncthreads();
    if (d.M > 0) {
      const float* v = p.v[d.vi];
      for (int o = threadIdx.x; o < nb * d.M * K; o += blockDim.x) {
        const int r = o / (d.M * K);
        const int rem = o - r * d.M * K;
        const int mi = rem / K;
        const int k = rem - mi * K;
        float s;
        const float a = gather_mix_frame(g, tab, d, v, r, mi, k, &s);
        g.X[((long long)r * g.R + d.base + d.L + mi) * K + k] = a + logf(s);
      }
      __syncthreads();
    }
    if (t < D - 1) gather_stabilize(g, nb, d.base, d.base + d.L + d.M);
  }
  __syncthreads();
}
