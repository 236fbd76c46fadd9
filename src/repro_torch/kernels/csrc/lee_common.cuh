// Per-cell arithmetic shared by the log-einsum-exp kernels, forward
// (log_einsum_exp_fwd.cu, grouped_fwd.cu, gather_fwd.cu) and backward
// (log_einsum_exp_bwd.cu, grouped_bwd.cu, gather_bwd.cu).  Every kernel
// computes a cell the same way, in the same order, so that a row's result
// depends on nothing but that row (not on the batch size, the batch tile or
// the kernel), and a backward kernel recomputes exactly the stabilized sum
// its forward logged.
#pragma once

#include <cuda_runtime.h>

// The reference's stand-in for log(0) (repro/core/layers.py NEG_INF): the
// row max is clamped to it, so a row that is -inf everywhere exps to 0.
#define LEE_NEG_INF (-1e30f)

// Floor for the stabilized sum when a backward divides the cotangent by it
// (the reference's _S_FLOOR): a normal float32, so a fully saturated row,
// whose sum is exactly 0, gets finite gradients.
#define LEE_S_FLOOR (1e-30f)

// Shared memory one block may use on the H100 (227 KB).
constexpr int kLeeSmemLimit = 232448;

// Threads of a K1 or K2 rows block, and the blocks an SM they are compiled
// for (registers: at most 64 a thread: at 80 to 102, where the compiler
// puts them unbounded, only two blocks fit and the rows kernel's chain of
// barriers is latency bound)
constexpr int kLeeThreads = 256;
constexpr int kLeeMinBlocks = 4;

// v[0..K) <- exp(v - m) in place, with m = max(max_i v[i], NEG_INF); returns m.
__device__ __forceinline__ float lee_stabilize(float* v, int K) {
  float m = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < K; ++i) m = fmaxf(m, v[i]);
  m = fmaxf(m, LEE_NEG_INF);
  for (int i = 0; i < K; ++i) v[i] = expf(v[i] - m);
  return m;
}

// sum_i el[i] * (sum_j w[i*K + j] * er[j]): fp32 FMAs in a fixed (i, j) order,
// the order every kernel's cell keeps (their register-tiled sweeps form the
// same chains; this is its definition, which no kernel calls).
__device__ __forceinline__ float lee_cell_sum(const float* w, const float* el,
                                              const float* er, int K) {
  float s = 0.f;
  for (int i = 0; i < K; ++i) {
    float t = 0.f;
    for (int j = 0; j < K; ++j) t = fmaf(w[i * K + j], er[j], t);
    s = fmaf(el[i], t, s);
  }
  return s;
}

// Shared-memory stride of one staged weight row (one output k of a cell,
// K^2 floats): odd, so the rows that a warp's lanes read at once (one k
// each) fall in different banks.  At K = 40 an unpadded row is 1,600
// floats, a multiple of the 32 banks, and every k would hit one bank.
__host__ __device__ __forceinline__ int lee_row_stride(int K) {
  return (K * K) | 1;
}

// Shared-memory stride of one staged activation row (K floats of a batch
// row): odd for the same reason, for lanes that read one row each.
__host__ __device__ __forceinline__ int lee_pad(int K) { return K | 1; }

// Stage cells [m0, m0 + mn), outputs [k0, k0 + kn) of weights w, whose
// cells lie cell_floats apart and hold K^2-float rows one per output, into
// wbuf, one weight row every lee_row_stride(K) floats (cell m's rows from
// wbuf + m kn lee_row_stride(K)).  Each cell's part is one contiguous run
// of kn K^2 floats in device memory; a thread loads kStageBatch values
// before it stores any, as float4s where K^2 is a multiple of 4 and the
// run is 16-byte aligned, so that a block keeps many loads in flight (one
// at a time leaves the copy bound by the latency of each load).
constexpr int kStageBatch = 8;

__device__ __forceinline__ void lee_stage_weights(float* wbuf, const float* w,
                                                  long long cell_floats,
                                                  int m0, int mn, int k0,
                                                  int kn, int K) {
  const int KK = K * K;
  const int KKp = lee_row_stride(K);
  const int n = kn * KK;  // floats of one cell's part
  for (int m = 0; m < mn; ++m) {
    const float* src = w + (long long)(m0 + m) * cell_floats +
                       (long long)k0 * KK;
    float* dst = wbuf + m * kn * KKp;
    if (KK % 4 == 0 && reinterpret_cast<unsigned long long>(src) % 16 == 0) {
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

// The register-tiled sweep of the per-pair kernels (K1, K2).  A block owns
// nsub row subtiles of LeeTile::ROWS rows and a K_out tile of LeeTile::KT
// weight rows; a warp's 32 lanes are NKG k-groups x NRG row-groups, and
// lane (rg, kg) computes the R x KO micro-tile of rows rg + v NRG and
// outputs kg + u NKG.  Each weight value it loads feeds R FMAs and each
// activation KO, and since a warp's lanes read weight rows lee_row_stride
// apart and activation rows lee_pad apart (both odd), no load of the sweep
// has a bank conflict; lanes of one k (or one row) read the same word,
// which is a broadcast.
template <int R_, int KO_, int NKG_>
struct LeeTile {
  static constexpr int R = R_;
  static constexpr int KO = KO_;
  static constexpr int NKG = NKG_;
  static constexpr int NRG = 32 / NKG_;
  static constexpr int ROWS = NRG * R_;  // rows of a subtile
  static constexpr int KT = NKG_ * KO_;  // outputs of a K_out tile
};

// One item of a sweep: a lane's micro-tile t[v][u] = sum_q W[k, p, q]
// x[r, q] (TRANS: W[k, q, p]) for its rows r = v NRG (from xr, rows
// lee_pad(K) apart) and outputs k = u NKG (from wk, weight rows
// lee_row_stride(K) apart, offset to the lane's first row and p), q = 0,
// 1, ... in order, fp32 FMAs from 0.
template <class Tile, bool TRANS>
__device__ __forceinline__ void lee_tile(const float* wk, const float* xr,
                                         int K,
                                         float (&t)[Tile::R][Tile::KO]) {
  const int KKp = lee_row_stride(K);
  const int Kp = lee_pad(K);
  const int qs = TRANS ? K : 1;  // weight stride of q
#pragma unroll
  for (int v = 0; v < Tile::R; ++v)
#pragma unroll
    for (int u = 0; u < Tile::KO; ++u) t[v][u] = 0.f;
#pragma unroll 4
  for (int q = 0; q < K; ++q) {
    float wv[Tile::KO];
    float xv[Tile::R];
#pragma unroll
    for (int u = 0; u < Tile::KO; ++u)
      wv[u] = wk[u * Tile::NKG * KKp + q * qs];
#pragma unroll
    for (int v = 0; v < Tile::R; ++v) xv[v] = xr[v * Tile::NRG * Kp + q];
#pragma unroll
    for (int v = 0; v < Tile::R; ++v)
#pragma unroll
      for (int u = 0; u < Tile::KO; ++u)
        t[v][u] = fmaf(wv[u], xv[v], t[v][u]);
  }
}

// For every subtile row r, tile output k and outer index p < K:
//   T[(r KT + k) lee_pad(K) + p] = sum_q W[k, p, q] x[r, q]     (!TRANS)
//                                  sum_q W[k, q, p] x[r, q]     (TRANS)
// with q = 0, 1, ... in order, fp32 FMAs from 0: the first is
// lee_cell_sum's inner sum t_i (x = er), the second the same contraction
// over i (x = el), which K2's gr needs.  ws holds the tile's weight rows
// at lee_row_stride(K), x the rows at lee_pad(K).  The work items, one per
// (subtile, p), go round the block's warps, so that a block with few rows
// still keeps every warp busy: at einet_pd's K = 40 one subtile gives 40.
template <class Tile, bool TRANS>
__device__ __forceinline__ void lee_sweep(const float* ws, const float* x,
                                          float* T, int K, int nsub) {
  const int KKp = lee_row_stride(K);
  const int Kp = lee_pad(K);
  const int lane = threadIdx.x & 31;
  const int kg = lane % Tile::NKG;
  const int rg = lane / Tile::NKG;
  const int nwarps = blockDim.x >> 5;
  for (int item = threadIdx.x >> 5; item < nsub * K; item += nwarps) {
    const int sub = item / K;
    const int p = item - sub * K;
    const int r0 = sub * Tile::ROWS + rg;
    float t[Tile::R][Tile::KO];
    lee_tile<Tile, TRANS>(ws + kg * KKp + (TRANS ? p : p * K), x + r0 * Kp,
                          K, t);
#pragma unroll
    for (int v = 0; v < Tile::R; ++v)
#pragma unroll
      for (int u = 0; u < Tile::KO; ++u)
        T[((r0 + v * Tile::NRG) * Tile::KT + kg + u * Tile::NKG) * Kp + p] =
            t[v][u];
  }
}

// lee_sweep over ncells cells at once, for the fused backward kernels (K4):
// cell m's KT weight rows at ws + m ws_cell, its rows at x + m x_cell (tb
// rows at lee_pad(K)) and its T at T + m t_cell, each laid out as in
// lee_sweep.  The items, one per (cell, subtile, p), go round the block's
// warps; each output is the same FMA chain as lee_sweep's.
template <class Tile, bool TRANS>
__device__ __forceinline__ void lee_sweep_cells(const float* ws, int ws_cell,
                                                const float* x, int x_cell,
                                                float* T, int t_cell, int K,
                                                int nsub, int ncells) {
  const int KKp = lee_row_stride(K);
  const int Kp = lee_pad(K);
  const int lane = threadIdx.x & 31;
  const int kg = lane % Tile::NKG;
  const int rg = lane / Tile::NKG;
  const int nwarps = blockDim.x >> 5;
  const int per_cell = nsub * K;
  for (int item = threadIdx.x >> 5; item < ncells * per_cell;
       item += nwarps) {
    const int m = item / per_cell;
    const int rest = item - m * per_cell;
    const int sub = rest / K;
    const int p = rest - sub * K;
    const int r0 = sub * Tile::ROWS + rg;
    float* Tm = T + m * t_cell;
    float t[Tile::R][Tile::KO];
    lee_tile<Tile, TRANS>(ws + m * ws_cell + kg * KKp + (TRANS ? p : p * K),
                          x + m * x_cell + r0 * Kp, K, t);
#pragma unroll
    for (int v = 0; v < Tile::R; ++v)
#pragma unroll
      for (int u = 0; u < Tile::KO; ++u)
        Tm[((r0 + v * Tile::NRG) * Tile::KT + kg + u * Tile::NKG) * Kp + p] =
            t[v][u];
  }
}

// Copy rows [b0, b0 + nb) of one cell of ln (unit stride over K, batch
// stride sb) into x at lee_pad(K), rows nb..tb-1 zeroed.
__device__ __forceinline__ void lee_stage_rows(float* x, const float* ln,
                                               long long sb, int b0, int nb,
                                               int tb, int K) {
  const int Kp = lee_pad(K);
  for (int t = threadIdx.x; t < tb * K; t += blockDim.x) {
    const int r = t / K;
    const int i = t - r * K;
    x[r * Kp + i] = r < nb ? ln[(long long)(b0 + r) * sb + i] : 0.f;
  }
}

namespace {

// out[e] = sum_t part[t n + e], t = 0, 1, ... in order: the per-tile partial
// weight gradients of a backward kernel summed across the batch tiles in a
// fixed order, without atomics, so two calls give bitwise-equal gradients.
__global__ void lee_sum_tiles_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, long long n,
                                     int tiles) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float acc = part[e];
    for (int t = 1; t < tiles; ++t) acc += part[(long long)t * n + e];
    out[e] = acc;
  }
}

inline cudaError_t lee_sum_tiles(const float* part, float* out, long long n,
                                 int tiles, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  lee_sum_tiles_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, n,
                                                                 tiles);
  return cudaGetLastError();
}

}  // namespace

// The message for a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* lee_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
