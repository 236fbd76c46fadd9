// The tables and the mixing of a gather run, shared by gather_fwd.cu (K5)
// and gather_bwd.cu (K6), so the backward recomputes exactly the rows and
// frames the forward computed.
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
// one int32 tensor per (tables, device), which the kernels read, and the
// host walks the same array to launch them.  Layout (kernels/grouped.py
// pack_gather_tables):
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

__host__ __device__ __forceinline__ GatherDepth gather_depth(const int* tab,
                                                             int t) {
  const int* d = tab + kGatherHeader + kGatherDepthInts * t;
  return {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7]};
}

// A row buffer in the log domain: R rows of K floats a batch row.
struct GatherRows {
  float* X;
  int R, K;
};

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

constexpr int kGatherThreads = 256;

// Blocks of kGatherThreads for a grid-stride loop over n items.
inline unsigned gather_grid(long long n) {
  long long blocks = (n + kGatherThreads - 1) / kGatherThreads;
  return (unsigned)(blocks > 4096 ? 4096 : blocks);
}

#define GATHER_LOOP(n)                                                      \
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       o < (n); o += (long long)gridDim.x * blockDim.x)
