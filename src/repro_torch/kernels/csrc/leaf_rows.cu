// Leaf rows: the input layer's exponential-family log-densities and the
// sums over each leaf's scope in one launch, for sm_90a.
//
// Replaces the TPU kernel: none.  The reference computes its leaf layer in
// XLA, outside any Pallas kernel (repro/core/einet.py leaf_log_prob, then
// _leaf_rows' segment_sum).  The port's plain version builds the whole
// (B, D, K, R) EF tensor, copies it three times (permute, a zero row,
// the scope gather) and sums each scope with one elementwise add a
// position: 767 launches at einet_pd.  This kernel reads x's statistics
// and the parameters and writes only the leaf rows:
//
//   rows[b, j, k] = sum over the scope positions s of leaf j, in order, of
//   term(b, v_s, k, r_j) = (log_h[b, v] + sum_i t[b, v, i] theta[v, k, r, i])
//                          - A[v, k, r],
//
// or exactly 0 where the marginalisation mask drops (b, v) and at a padded
// scope position (the plain version's zero row).  Every operation is the
// plain version's, rounded where it rounds: the dot as t_0 theta_0, then
// + t_i theta_i, then log_h + dot, then - A, then the scope sum from the
// first term on; __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from fusing
// any pair into an FMA.  So the rows are the plain version's bit for bit.
//
// Layout: one block per (row tile, leaf, K tile); a thread sums one
// component k of one row, k across consecutive lanes.  The wrapper packs theta and A as (D R, K, T + 1) rows, one row
// per (variable, replica), the gather table's index, and x's statistics,
// log h and the mask's keep flag as (B, D, T + 2).  The block walks its
// leaf's scope in chunks of sc positions: it stages the chunk's table
// entries, a record of each position's K-tile components (theta_0 ..
// theta_{T-1}, A) and of each row's statistics (t_0 .. t_{T-1}, log h,
// keep), then every thread adds the chunk's terms to its running sum.
// A padded position stages
// keep = 0, so it adds 0 as a marginalised variable does.  A row's
// records are shared by the lanes of its row (a broadcast) and a
// component's by the block's rows.  With one or two statistics (the
// Binomial, Bernoulli and Normal families) a record is 4 floats, read as
// one float4, and the term is branch-free; with more, records lie at odd
// strides (leaf_stride) and are read a float at a time.  The geometry
// (kt, sc: kernels/leaf_rows.py launch_geometry) depends on K, T and
// the scope width alone, never on B, and no sum is split: a row's result
// is the same alone, in a serving bucket and in a training batch.
//
// What bounds it on the H100: at einet_rat's training batch (B = 2,000,
// 160 leaves of 32 variables, K = R = 10, T = 2) it must read x's
// statistics (12.3 MB with log h) and the parameters (0.6 MB) and write
// the rows (12.8 MB), about 7.7 us at 3.35 TB/s, against 0.41 GFLOP of
// dot products (6.1 us at 67 TFLOP/s): bound by bytes.  At einet_pd's
// (B = 512, 4 leaves of 768 variables, K = 40, R = 1) 20.7 MB (6.2 us)
// against 0.25 GFLOP (3.8 us): bound by bytes.  At one or two statistics
// a term costs two float4 reads of shared memory and five arithmetic
// operations; einet_pd's 82 K outputs, each a chain of 768 terms, fill
// less than a third of the card's threads.

#include <cuda_runtime.h>

namespace {

constexpr int kLeafThreads = 256;

// Shared floats of one staged component record at more than two
// statistics (theta_0 .. theta_{T-1}, A): T + 1, made odd.
__host__ __device__ inline int leaf_stride(int T) { return (T + 1) | 1; }

// Shared floats of one staged component record and of one row record.
__host__ __device__ inline int leaf_param_width(int T) {
  return T <= 2 ? 4 : leaf_stride(T);
}
__host__ __device__ inline int leaf_row_width(int T) {
  return T <= 2 ? 4 : T + 2;
}

// One term from a staged row record xp and component record tp: the plain
// version's operations in its order, or 0 where keep (xp[T + 1]) is 0.
template <int TT>
__device__ inline float leaf_term(const float* xp, const float* tp, int T) {
  if constexpr (TT == 2) {
    const float4 x4 = *reinterpret_cast<const float4*>(xp);
    const float4 p4 = *reinterpret_cast<const float4*>(tp);
    const float dot = __fadd_rn(__fmul_rn(x4.x, p4.x), __fmul_rn(x4.y, p4.y));
    return x4.w != 0.0f ? __fsub_rn(__fadd_rn(x4.z, dot), p4.z) : 0.0f;
  } else if constexpr (TT == 1) {
    const float4 x4 = *reinterpret_cast<const float4*>(xp);
    const float4 p4 = *reinterpret_cast<const float4*>(tp);
    return x4.z != 0.0f
               ? __fsub_rn(__fadd_rn(x4.y, __fmul_rn(x4.x, p4.x)), p4.y)
               : 0.0f;
  } else {
    if (xp[T + 1] == 0.0f) return 0.0f;
    float dot = __fmul_rn(xp[0], tp[0]);
    for (int i = 1; i < T; ++i) dot = __fadd_rn(dot, __fmul_rn(xp[i], tp[i]));
    return __fsub_rn(__fadd_rn(xp[T], dot), tp[T]);
  }
}

// tha (D R, K, T + 1): theta then A of each (variable, replica) row;
// xs (B, D, T + 2): t, log h, keep (0 where the mask drops the variable);
// gather (L, S): each leaf's scope as (variable R + replica), padded with
// D R; out (B, L, K).  Grid (row tiles, L, K tiles), kLeafThreads threads:
// thread (kl, slot) sums component k0 + kl of row b0 + slot, bt =
// kLeafThreads / kt rows a block.  TT is T when it is 1 or 2 (float4
// records), else 0 (any T).
template <int TT>
__global__ void __launch_bounds__(kLeafThreads)
leaf_rows_kernel(const float* __restrict__ tha, const float* __restrict__ xs,
                 const long long* __restrict__ gather,
                 float* __restrict__ out, int B, int L, int S, int D, int R,
                 int K, int T, int kt, int sc) {
  extern __shared__ float4 smem4[];
  const int tw = T + 1;  // floats of one component's parameters
  const int tx = T + 2;  // floats of one (row, variable)'s statistics
  const int pw = leaf_param_width(T), xw = leaf_row_width(T);
  const int bt = kLeafThreads / kt;
  float* th = reinterpret_cast<float*>(smem4);           // sc x kt x pw
  float* xv = th + sc * kt * pw;                         // sc x bt x xw
  int* gs = reinterpret_cast<int*>(xv + sc * bt * xw);  // sc: row, or -1
  int* vs = gs + sc;                                     // sc: variable
  const int tid = threadIdx.x;
  const int kl = tid % kt, slot = tid / kt;
  const int k0 = blockIdx.z * kt, b0 = blockIdx.x * bt, j = blockIdx.y;
  const int nk = min(kt, K - k0), nb = min(bt, B - b0);
  const bool active = slot < nb && kl < nk;
  const int pad = D * R;
  const long long* gj = gather + static_cast<long long>(j) * S;
  float sum = 0.0f;
  for (int c0 = 0; c0 < S; c0 += sc) {
    const int n = min(sc, S - c0);
    __syncthreads();  // the previous chunk has been summed
    for (int s = tid; s < n; s += kLeafThreads) {
      const int g = static_cast<int>(gj[c0 + s]);
      gs[s] = g < pad ? g : -1;
      vs[s] = g < pad ? g / R : 0;
    }
    __syncthreads();
    for (int p = tid; p < n * nk; p += kLeafThreads) {
      const int s = p / nk, kk = p - s * nk;
      if (gs[s] >= 0) {
        const float* src =
            tha + (static_cast<long long>(gs[s]) * K + k0 + kk) * tw;
        float* dst = th + (s * kt + kk) * pw;
        for (int i = 0; i < tw; ++i) dst[i] = src[i];
      }
    }
    for (int p = tid; p < n * nb; p += kLeafThreads) {
      const int s = p / nb, bb = p - s * nb;
      float* dst = xv + (s * bt + bb) * xw;
      if (gs[s] < 0) {
        dst[T + 1] = 0.0f;  // a padded position adds 0
        continue;
      }
      const float* src =
          xs + (static_cast<long long>(b0 + bb) * D + vs[s]) * tx;
      if constexpr (TT == 2) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int c = 0; c < tx; ++c) dst[c] = src[c];
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int s = 0; s < n; ++s) {
        const float term = leaf_term<TT>(xv + (s * bt + slot) * xw,
                                         th + (s * kt + kl) * pw, T);
        sum = (c0 + s == 0) ? term : __fadd_rn(sum, term);
      }
    }
  }
  if (active) {
    out[(static_cast<long long>(b0 + slot) * L + j) * K + k0 + kl] = sum;
  }
}

}  // namespace

// The message for a CUDA error code, for the Python wrapper's exceptions.
extern "C" const char* lee_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` with the wrapper's geometry (kt components, sc
// scope positions a stage; the wrapper checks that the shared memory fits
// in 48 KB); returns the first CUDA error, or 0.
extern "C" int leaf_rows(const float* tha, const float* xs,
                         const long long* gather, float* out, int B, int L,
                         int S, int D, int R, int K, int T, int kt, int sc,
                         void* stream) {
  const int bt = kLeafThreads / kt;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(sc) *
      (static_cast<size_t>(kt) * leaf_param_width(T) +
       static_cast<size_t>(bt) * leaf_row_width(T) + 2);
  const dim3 grid((B + bt - 1) / bt, L, (K + kt - 1) / kt);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T == 2) {
    leaf_rows_kernel<2><<<grid, kLeafThreads, smem, st>>>(
        tha, xs, gather, out, B, L, S, D, R, K, T, kt, sc);
  } else if (T == 1) {
    leaf_rows_kernel<1><<<grid, kLeafThreads, smem, st>>>(
        tha, xs, gather, out, B, L, S, D, R, K, T, kt, sc);
  } else {
    leaf_rows_kernel<0><<<grid, kLeafThreads, smem, st>>>(
        tha, xs, gather, out, B, L, S, D, R, K, T, kt, sc);
  }
  return static_cast<int>(cudaGetLastError());
}
