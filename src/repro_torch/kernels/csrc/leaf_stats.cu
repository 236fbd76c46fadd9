// Leaf statistics: the E-step's sums of the leaf posteriors and of the
// posterior-weighted sufficient statistics, for sm_90a.
//
// Replaces the TPU kernel: none.  The reference computes its leaf
// statistics with XLA's einsum, outside any Pallas kernel.  The port's
// plain version (kernels/leaf_stats.py leaf_stats_plain) copies each
// leaf's (B, K) posterior to every (variable, replica) pair of its scope,
// a (B, P, K) tensor of 252 MB at einet_pd's B = 512 and 2 GB at the
// CelebA mixture's 4,096 rows, contracts it with the gathered statistics
// in a batched GEMM of output depth |T|, sums the copy again for s_den and
// scatters both to the parameter layout.  This kernel reads g_leaf and t
// through the leaf table and writes the statistics once:
//
//   s_phi[v, k, r, i] = sum_b g[b, j, k] t[b, v, i],
//   s_den[v, k, r]    = sum_b g[b, j, k],
//
// for each pair (v, r) of leaf j's scope; rows of no pair stay 0.  Leaf j
// is a skinny GEMM: C_j (K, S |T|) = G_j^T (K, B) X_j (B, S |T|), X_j's
// columns t[:, v_s, i] read through the table, column n = s |T| + i.
//
// What bounds it on the H100: g_leaf and t are read once (einet_pd B =
// 512: 0.33 + 12.6 MB; einet_rat B = 2,000: 12.8 + 8.2 MB) against 2 B P K
// |T| fp32 FMA flops (0.25 and 0.41 GFLOP): about 4 and 6 us at 3.35 TB/s
// and 67 TFLOP/s.  One CelebA component at 4,096 rows: 2.0 GFLOP, 31 us,
// bound by the FMAs.  The configurations run float32 with TF32 off, so the
// products run on the CUDA cores.  A 4 x 4 tile reads two float4 of
// shared memory for 16 FMAs, 2 bytes a FMA against the SM's 1 byte of
// shared memory a FMA cycle, so the sums run at half the FMA rate at most;
// a larger tile needs twice its registers (a chunk's sums and the
// totals), which cost more in occupancy than it saved, tried on the card.
//
// Design: a block owns one leaf, a tile of KT = 4 tk components and NT =
// 4 tn columns, and a slice of the batch, which it walks in chunks of cb
// rows staged in shared memory (g's rows of the tile's components, X's rows
// of its columns through the table).  A thread keeps a 4 x 4 register tile
// of outputs, as a SIMT GEMM does: per row one float4 of g and one of X
// from shared memory for 16 FMAs.  Small tiles (einet_rat: K = 10, 64
// columns a leaf) hold few threads, so `groups` copies of the tile's
// threads split each chunk's rows and their sums meet in a fixed pairwise
// tree in shared memory.  Where the leaves' tiles fill less than about two
// waves of the card, the wrapper splits the batch into `slices`, fixed by
// the shapes alone: each slice writes its partial sums to scratch in the
// order (slice, leaf, k, column) and leaf_stats_sum_kernel adds them in
// slice order and writes the parameter layout.  No atomics: every output
// is written once, so two calls agree bit for bit.
//
// Order of every sum: a thread's running sum over at most cb / groups <=
// 64 rows of a chunk, added to its total chunk after chunk, the groups'
// totals in a pairwise tree, then the slices in order.  s_den is each
// leaf's sum over the batch of g, summed in the same order by the threads
// of column tile 0 as they walk their rows (the same values in every
// column tile of a leaf), and written once to each pair.
//
// Staging is taken off the path: the block copies chunk c + 1 into a
// second buffer with cp.async (no registers, no wait) while it sums chunk
// c, in copies of up to 16 bytes (4 floats of g where K allows, a
// position's |T| statistics of t up to 4).  t comes variable-major, so a
// warp's copies of one column's rows are adjacent: einet_rat's leaves
// read 32 random variables of 512, and in t's (B, D, T) layout each
// (row, variable) would cost a 32-byte sector for its 8 bytes, with every
// variable read by R = 10 leaves.

#include <cuda_runtime.h>

namespace {

constexpr int kStatsThreads = 256;  // a block's threads, at most
constexpr int kTileK = 4;           // components of a thread's tile
constexpr int kTileN = 4;           // columns of a thread's tile
constexpr int kMaxGroups = 8;       // row groups of a block, at most
constexpr int kRed = kTileK * kTileN + kTileK;  // floats a thread reduces

// W floats copied from global to shared memory without a register
// (cp.async), or W zeros written where src is null.
template <int W>
__device__ inline void copy_async(float* dst, const float* src,
                                  const float* any) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src ? src : any), "n"(4 * W), "r"(src ? 4 * W : 0));
}

// The (rows, width) block dst of floats, rows `stride` floats apart, W at
// a time: thread tid copies units tid, tid + nthreads, ... in row order,
// or with rows_first in column order (the order in which a warp's copies
// are adjacent in global memory), its (row, column) stepped without a
// division; src(r, c) is the global address of the unit at row r and
// columns c .. c + W - 1, or null for zeros.
template <int W, typename Src>
__device__ inline void stage(float* dst, int rows, int width, int stride,
                             bool rows_first, int tid, int nthreads,
                             const float* any, Src src) {
  const int units = width / W;
  const int fast = rows_first ? rows : units;
  const int d_slow = nthreads / fast, d_fast = nthreads - d_slow * fast;
  for (int p = tid, i = tid % fast, o = tid / fast; p < rows * units;
       p += nthreads) {
    const int r = rows_first ? i : o, c = rows_first ? o : i;
    copy_async<W>(dst + r * stride + c * W, src(r, c * W), any);
    o += d_slow;
    i += d_fast;
    if (i >= fast) {
      i -= fast;
      ++o;
    }
  }
}

// stage() with the unit width w (1, 2 or 4) chosen at run time.
template <typename Src>
__device__ inline void stage_w(int w, float* dst, int rows, int width,
                               int stride, bool rows_first, int tid,
                               int nthreads, const float* any, Src src) {
  if (w == 4) {
    stage<4>(dst, rows, width, stride, rows_first, tid, nthreads, any, src);
  } else if (w == 2) {
    stage<2>(dst, rows, width, stride, rows_first, tid, nthreads, any, src);
  } else {
    stage<1>(dst, rows, width, stride, rows_first, tid, nthreads, any, src);
  }
}

// g (B, L, K), t laid out (D, B, T) (variable-major: a variable's rows
// are adjacent), gather (L, S): leaf j's (variable R + replica) rows in
// scope order, padded with D R.  Grid (column tiles, L x K tiles,
// slices); block groups x tk x tn threads, thread (grp, ti, tj) holding
// components k0 + 4 ti .. + 3 and columns n0 + 4 tj .. + 3; the threads
// of column tile 0 (tj = 0) also sum g for s_den.  With one slice the
// block writes s_phi (D, K, R, T) and s_den (D, K, R); with more it writes
// part (slices, L, K, S T) and, from its first column tile, part_den
// (slices, L, K).
__global__ void __launch_bounds__(kStatsThreads, 3)
leaf_stats_kernel(const float* __restrict__ g, const float* __restrict__ t,
                  const long long* __restrict__ gather,
                  float* __restrict__ s_phi, float* __restrict__ s_den,
                  float* __restrict__ part, float* __restrict__ part_den,
                  int B, int L, int S, int D, int R, int K, int T, int tk,
                  int tn, int groups, int cb, int rps, int wg, int wx) {
  extern __shared__ float4 smem4[];
  const int kt = tk * kTileK, nt = tn * kTileN;
  const int ns = S * T;  // columns of a leaf
  const int k_tiles = (K + kt - 1) / kt;
  const int j = blockIdx.y / k_tiles;
  const int k0 = (blockIdx.y - j * k_tiles) * kt;
  const int n0 = blockIdx.x * nt;
  const int slice = blockIdx.z, slices = gridDim.z;
  const int b_lo = slice * rps, b_hi = min(B, b_lo + rps);
  const int pad = D * R;
  const long long* gj = gather + static_cast<long long>(j) * S;

  const int tile_threads = tk * tn;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int grp = tid / tile_threads, lt = tid - grp * tile_threads;
  const int ti = lt / tn, tj = lt - ti * tn;
  const int rpg = cb / groups;  // rows of a chunk a group sums

  // two buffers of staged rows, or the groups' totals after the walk
  float* buf = reinterpret_cast<float*>(smem4);  // 2 x (cb x kt, cb x nt)
  // X's rows lie xw = nt + 4 floats apart where nt is a multiple of 8, so
  // that a warp copying one column's rows (rows_first) writes to 16 banks
  const int xw = nt % 8 == 0 ? nt + 4 : nt;
  const int per_buf = cb * (kt + xw);
  const int stage = max(2 * per_buf, groups > 1 ? nthreads * kRed : 0);
  int* col = reinterpret_cast<int*>(buf + stage);  // nt: v B T + i, or -1
  float* den_s = reinterpret_cast<float*>(col + nt);  // kt

  for (int c = tid; c < nt; c += nthreads) {
    const int n = n0 + c;
    int src = -1;
    if (n < ns) {
      const int s = n / T;
      const int row = static_cast<int>(gj[s]);
      if (row < pad)
        src = static_cast<int>(row / R) * B * T + (n - s * T);
    }
    col[c] = src;
  }
  __syncthreads();

  // the rows of the chunk at c0 into buffer `which`, asynchronously, wg
  // floats of g and wx of X a copy
  const float* gjk = g + static_cast<long long>(j) * K + k0;
  const long long lk = static_cast<long long>(L) * K;
  auto fetch = [&](int c0, int which) {
    float* gs = buf + which * per_buf;
    const int nrows = min(cb, b_hi - c0);
    stage_w(wg, gs, cb, kt, kt, false, tid, nthreads, g,
            [&](int r, int c) -> const float* {
              return r < nrows && k0 + c < K ? gjk + (c0 + r) * lk + c
                                             : nullptr;
            });
    stage_w(wx, gs + cb * kt, cb, nt, xw, true, tid, nthreads, t,
            [&](int r, int c) -> const float* {
              const int src = col[c];
              return r < nrows && src >= 0 ? t + src + (c0 + r) * T
                                           : nullptr;
            });
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float tot[kTileK][kTileN], tot_den[kTileK];
#pragma unroll
  for (int a = 0; a < kTileK; ++a) {
    tot_den[a] = 0.0f;
#pragma unroll
    for (int q = 0; q < kTileN; ++q) tot[a][q] = 0.0f;
  }

  // chunk c is summed from one buffer while chunk c + 1 lands in the other
  fetch(b_lo, 0);
  for (int c0 = b_lo, which = 0; c0 < b_hi; c0 += cb, which ^= 1) {
    if (c0 + cb < b_hi) {
      fetch(c0 + cb, which ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c has landed for every thread
    const float* gs = buf + which * per_buf;
    const float* xs = gs + cb * kt;
    const int nrows = min(cb, b_hi - c0);
    float acc[kTileK][kTileN], acc_den[kTileK];
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
      acc_den[a] = 0.0f;
#pragma unroll
      for (int q = 0; q < kTileN; ++q) acc[a][q] = 0.0f;
    }
    const int r_lo = grp * rpg, r_hi = min(r_lo + rpg, nrows);
#pragma unroll 4
    for (int r = r_lo; r < r_hi; ++r) {
      const float4 gv =
          *reinterpret_cast<const float4*>(gs + r * kt + ti * kTileK);
      const float ga[kTileK] = {gv.x, gv.y, gv.z, gv.w};
      float xa[kTileN];
#pragma unroll
      for (int q = 0; q < kTileN; q += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + r * xw + tj * kTileN + q);
        xa[q] = xv.x;
        xa[q + 1] = xv.y;
        xa[q + 2] = xv.z;
        xa[q + 3] = xv.w;
      }
#pragma unroll
      for (int a = 0; a < kTileK; ++a)
#pragma unroll
        for (int q = 0; q < kTileN; ++q)
          acc[a][q] = fmaf(ga[a], xa[q], acc[a][q]);
      if (tj == 0) {
#pragma unroll
        for (int a = 0; a < kTileK; ++a) acc_den[a] += ga[a];
      }
    }
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
      tot_den[a] += acc_den[a];
#pragma unroll
      for (int q = 0; q < kTileN; ++q) tot[a][q] += acc[a][q];
    }
    __syncthreads();  // the buffer is read before it is filled again
  }

  if (groups > 1) {  // the groups' totals in a pairwise tree
    float* red = buf;  // groups x tile_threads x kRed
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
#pragma unroll
      for (int q = 0; q < kTileN; ++q)
        red[(grp * tile_threads + lt) * kRed + a * kTileN + q] = tot[a][q];
      red[(grp * tile_threads + lt) * kRed + kTileK * kTileN + a] =
          tot_den[a];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < kRed; ++e) {
        float v[kMaxGroups];
        for (int h = 0; h < groups; ++h)
          v[h] = red[(h * tile_threads + lt) * kRed + e];
        for (int w = groups / 2; w >= 1; w /= 2)
          for (int h = 0; h < w; ++h) v[h] = v[h] + v[h + w];
        if (e < kTileK * kTileN) {
          tot[e / kTileN][e % kTileN] = v[0];
        } else {
          tot_den[e - kTileK * kTileN] = v[0];
        }
      }
    }
  }

  if (grp == 0) {
#pragma unroll
    for (int a = 0; a < kTileK; ++a) {
      const int k = k0 + ti * kTileK + a;
      if (k >= K) continue;
#pragma unroll
      for (int q = 0; q < kTileN; ++q) {
        const int n = n0 + tj * kTileN + q;
        if (n >= ns) continue;
        if (slices > 1) {
          part[((static_cast<long long>(slice) * L + j) * K + k) * ns + n] =
              tot[a][q];
        } else {
          const int s = n / T;
          const int row = static_cast<int>(gj[s]);
          if (row >= pad) continue;
          const int v = row / R, rr = row - v * R;
          s_phi[((static_cast<long long>(v) * K + k) * R + rr) * T +
                (n - s * T)] = tot[a][q];
        }
      }
      if (tj != 0) continue;
      if (slices > 1) {
        if (blockIdx.x == 0)
          part_den[(static_cast<long long>(slice) * L + j) * K + k] =
              tot_den[a];
      } else {
        den_s[ti * kTileK + a] = tot_den[a];
      }
    }
  }
  if (slices > 1) return;
  __syncthreads();
  // s_den of the tile's positions: those whose first column lies in it
  const int s_lo = (n0 + T - 1) / T, s_hi = min(S, (n0 + nt + T - 1) / T);
  const int nk = min(kt, K - k0);
  for (int p = tid; p < (s_hi - s_lo) * nk; p += nthreads) {
    const int s = s_lo + p / nk, kk = p % nk;
    const int row = static_cast<int>(gj[s]);
    if (row >= pad) continue;
    const int v = row / R, rr = row - v * R;
    s_den[(static_cast<long long>(v) * K + k0 + kk) * R + rr] = den_s[kk];
  }
}

// The slices' partial sums in slice order, to the parameter layout: one
// thread an (leaf, k, column) entry, `sum_blocks` blocks of kStatsThreads
// covering them; the entry of a position's first column also sums and
// writes its s_den.
__global__ void __launch_bounds__(kStatsThreads)
leaf_stats_sum_kernel(const float* __restrict__ part,
                      const float* __restrict__ part_den,
                      const long long* __restrict__ gather,
                      float* __restrict__ s_phi, float* __restrict__ s_den,
                      int L, int S, int D, int R, int K, int T, int slices) {
  // 32-bit indices (the wrapper keeps a slice's entries under 2^31):
  // a 64-bit division costs tens of instructions
  const int ns = S * T, total = L * K * ns;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int jk = e / ns, n = e - jk * ns;
  const int j = jk / K, k = jk - j * K;
  const int s = n / T, i = n - s * T;
  const int row = static_cast<int>(gather[static_cast<long long>(j) * S + s]);
  if (row >= D * R) return;
  float sum = part[e];
#pragma unroll 4
  for (int sl = 1; sl < slices; ++sl)
    sum += part[static_cast<long long>(sl) * total + e];
  const int v = row / R, rr = row - v * R;
  s_phi[((static_cast<long long>(v) * K + k) * R + rr) * T + i] = sum;
  if (i == 0) {
    float d = part_den[jk];
    for (int sl = 1; sl < slices; ++sl)
      d += part_den[static_cast<long long>(sl) * L * K + jk];
    s_den[(static_cast<long long>(v) * K + k) * R + rr] = d;
  }
}

}  // namespace

// The message for a CUDA error code, for the Python wrapper's exceptions.
extern "C" const char* lee_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` with the wrapper's geometry (launch_geometry in
// kernels/leaf_stats.py: tk, tn, groups, cb rows a chunk, rps rows a
// slice, `smem` bytes of shared memory, at most 48 KB; copies of wg floats
// of g and wx of t, each dividing its rows and aligned), then, with more
// than one slice, the sum over the slices; returns the first CUDA error,
// or 0.  s_phi and s_den hold zeros on entry (rows of no pair stay so);
// part and part_den are the wrapper's scratch, unused with one slice.
extern "C" int leaf_stats(const float* g, const float* t,
                          const long long* gather, float* s_phi,
                          float* s_den, float* part, float* part_den, int B,
                          int L, int S, int D, int R, int K, int T, int tk,
                          int tn, int groups, int cb, int rps, int slices,
                          int smem, int sum_blocks, int wg, int wx,
                          void* stream) {
  const int kt = tk * kTileK, nt = tn * kTileN;
  const dim3 grid((S * T + nt - 1) / nt, L * ((K + kt - 1) / kt), slices);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  leaf_stats_kernel<<<grid, groups * tk * tn, smem, st>>>(
      g, t, gather, s_phi, s_den, part, part_den, B, L, S, D, R, K, T, tk,
      tn, groups, cb, rps, wg, wx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  leaf_stats_sum_kernel<<<sum_blocks, kStatsThreads, 0, st>>>(
      part, part_den, gather, s_phi, s_den, L, S, D, R, K, T, slices);
  return static_cast<int>(cudaGetLastError());
}
