"""The E-step's leaf statistics in one hand-written kernel: s_phi and s_den
from the leaf rows' posteriors and the batch's sufficient statistics,
through the leaf table (``csrc/leaf_stats.cu``), beside its plain PyTorch
version.

Replaces no TPU kernel: the reference's statistics are XLA's einsum.  The
plain version is the port's composition as it stood: each leaf's (B, K)
posterior gathered to the P (variable, replica) pairs of its scope, a
(B, P, K) tensor, contracted with the gathered statistics in a batched
GEMM, summed for s_den and scattered to the parameter layout
(:func:`pair_scatter`).  The kernel builds none of that: each leaf is a
skinny GEMM it walks in batch chunks, its sums in a fixed order (so two
calls agree bit for bit), not the plain version's.

Arguments of both versions: g_leaf (B, num_leaves, K) float32, t (B, D,
|T|) float32, gather (num_leaves, S) int64, each leaf's (variable R +
replica) rows in scope order padded with D R, and num_replica R.  Both
return s_phi (D, K, R, |T|) and s_den (D, K, R); rows of no pair are 0.
The kernel takes t laid out variable-major, a transposed view of a
contiguous (D, B, |T|) tensor (``core.em.variable_major_statistics``), and
refuses another layout; the plain version takes any.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

THREADS = 256  # kStatsThreads: a block's threads, at most
TILE_K = 4  # kTileK: a thread's components
TILE_N = 4  # kTileN: a thread's columns
K_TILE_MAX = 64  # components of a block, at most (16 thread rows)
N_GROUPS_MAX = 64  # column groups of a block, at most
GROUPS_MAX = 8  # kMaxGroups: row groups of a block, at most
RED_FLOATS = TILE_K * TILE_N + TILE_K  # kRed: a thread's totals
CHUNK = 64  # rows a block stages at a time, at most
SMEM_LIMIT_BYTES = 48 * 1024  # dynamic shared memory without an opt-in
SLICES_MAX = 32
SMS = 132  # the H100's multiprocessors
RESIDENT_THREADS = 1024  # threads an SM is counted to hold for a wave
MAX_GRID_YZ = 65_535

_SIGNATURES = {
    "leaf_stats": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 17
    + [ctypes.c_void_p],
}

__all__ = ["leaf_stats_cuda", "leaf_stats_plain", "launch_geometry",
           "pair_scatter", "row_blocks"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, width: int, num_leaves: int, k: int,
                    num_stats: int) -> dict:
    """The launch of ``b`` rows over ``num_leaves`` leaves of ``width``
    scope positions, ``k`` components and ``num_stats`` statistics:

      * ``tk`` x ``tn`` threads hold a tile of 4 tk components (all K up
        to 64) and 4 tn of the leaf's width x |T| columns (up to 256, and
        at most a block of threads);
      * ``groups`` (a power of two, at most 8) copies of them split each
        chunk's rows, ``threads`` = groups tk tn in all;
      * ``cb`` rows a chunk (at most 64, a multiple of ``groups``, as many
        as fit twice in shared memory beside the table's columns: a chunk
        is summed while the next one is copied in);
      * ``slices`` of ``rps`` rows (a multiple of cb): one unless the
        leaves' tiles fill less than two waves of the card at
        RESIDENT_THREADS threads an SM, then as many as make two waves,
        at most SLICES_MAX and one a chunk;
      * ``grid`` (column tiles, leaves x K tiles, slices), ``smem`` bytes.

    Every choice follows from the shapes alone."""
    n_cols = width * num_stats
    tk = _cdiv(min(k, K_TILE_MAX), TILE_K)
    tn = min(_cdiv(n_cols, TILE_N), N_GROUPS_MAX, THREADS // tk)
    groups = min(GROUPS_MAX, _pow2_floor(THREADS // (tk * tn)))
    kt, nt = TILE_K * tk, TILE_N * tn
    xw = nt + 4 if nt % 8 == 0 else nt  # X's row stride in shared memory
    threads = groups * tk * tn
    smem_floats = SMEM_LIMIT_BYTES // 4 - nt - kt  # two chunks' buffers
    cb = min(CHUNK, smem_floats // (2 * (kt + xw))) // groups * groups
    if cb == 0:
        raise ValueError(f"leaf_stats: no chunk of rows fits {kt} x {nt}")
    grid_xy = (_cdiv(n_cols, nt), num_leaves * _cdiv(k, kt))
    tiles = grid_xy[0] * grid_xy[1]
    want = 2 * SMS * max(1, RESIDENT_THREADS // threads)
    slices = 1
    if tiles < want:
        slices = max(1, min(SLICES_MAX, _cdiv(want, tiles), _cdiv(b, cb)))
    rps = _cdiv(_cdiv(b, slices), cb) * cb
    slices = _cdiv(b, rps)
    stage = max(2 * cb * (kt + xw),
                threads * RED_FLOATS if groups > 1 else 0)
    return {"tk": tk, "tn": tn, "groups": groups, "threads": threads,
            "cb": cb, "rps": rps, "slices": slices,
            "grid": (*grid_xy, slices),
            "smem": 4 * (stage + nt + kt)}


def copy_width(n: int, ptr: int) -> int:
    """Floats of one asynchronous copy from a tensor at address ``ptr``
    whose rows hold ``n`` floats: 4, 2 or 1, dividing ``n`` and aligned to
    its bytes, so that no copy straddles a row or a component tile."""
    return next(w for w in (4, 2, 1) if n % w == 0 and ptr % (4 * w) == 0)


def row_blocks(b: int, geo: dict) -> list:
    """The kernel's order of the batch: for each slice, for each chunk, each
    group's rows ``range(lo, hi)``.  A thread sums its group's rows of a
    chunk, adds that to its total chunk after chunk, the groups' totals
    meet in a pairwise tree and the slices are added in order."""
    cb, rps, groups = geo["cb"], geo["rps"], geo["groups"]
    rpg = cb // groups
    out = []
    for lo in range(0, b, rps):
        hi = min(b, lo + rps)
        out.append([[(c0 + g * rpg, min(c0 + (g + 1) * rpg, hi))
                     for g in range(groups)]
                    for c0 in range(lo, hi, cb)])
    return out


def pair_scatter(flat: torch.Tensor, s_phi_pairs: torch.Tensor,
                 s_den_pairs: torch.Tensor, d: int, r: int):
    """Fan per-pair leaf statistics out to parameter layout: (P, K, |T|) ->
    (D, K, R, |T|) and (P, K) -> (D, K, R), pair p to row ``flat[p]`` =
    variable R + replica.

    Every (variable, replica) pair belongs to exactly one leaf, so this is a
    scatter to unique rows (``index_copy_``, no accumulation)."""
    k, tdim = s_phi_pairs.shape[1:]
    s_phi = s_phi_pairs.new_zeros((d * r, k, tdim)).index_copy_(
        0, flat, s_phi_pairs).reshape(d, r, k, tdim).transpose(1, 2)
    s_den = s_den_pairs.new_zeros((d * r, k)).index_copy_(
        0, flat, s_den_pairs).reshape(d, r, k).transpose(1, 2)
    return s_phi, s_den


def leaf_stats_plain(g_leaf: torch.Tensor, t: torch.Tensor,
                     gather: torch.Tensor, num_replica: int):
    """The statistics through the (B, P, K) copy, the yardstick the kernel
    is held to: the pairs in the table's order, each leaf's posterior and
    each pair's statistics gathered, one einsum, the copy's sum, the
    scatter."""
    d = t.shape[1]
    pair_leaf, pos = torch.nonzero(gather < d * num_replica, as_tuple=True)
    flat = gather[pair_leaf, pos]
    g_pairs = g_leaf[:, pair_leaf, :]  # (B, P, K)
    t_pairs = t[:, flat // num_replica, :]  # (B, P, |T|)
    s_phi_pairs = torch.einsum("bpk,bpt->pkt", g_pairs, t_pairs)
    return pair_scatter(flat, s_phi_pairs, g_pairs.sum(0), d, num_replica)


def _check(g_leaf, t, gather, num_replica):
    """Validate the operands; returns (B, L, K, D, |T|, S)."""
    if g_leaf.dim() != 3 or t.dim() != 3 or gather.dim() != 2:
        raise ValueError("leaf_stats: expected g_leaf (B, L, K), t (B, D, T), "
                         "gather (L, S)")
    b, n_leaves, k = g_leaf.shape
    d, n_t = t.shape[1:]
    if t.shape[0] != b or gather.shape[0] != n_leaves:
        raise ValueError(f"leaf_stats: shapes g_leaf {tuple(g_leaf.shape)}, t "
                         f"{tuple(t.shape)}, gather {tuple(gather.shape)} "
                         "disagree")
    for name, x in (("g_leaf", g_leaf), ("t", t)):
        if x.dtype != torch.float32:
            raise TypeError(f"leaf_stats: {name} is {x.dtype}, not float32")
    if gather.dtype != torch.int64:
        raise TypeError(f"leaf_stats: gather is {gather.dtype}, not int64")
    # t's memory as (D, B, |T|): contiguous when t is variable-major
    for name, x in (("g_leaf", g_leaf), ("t", t.transpose(0, 1)),
                    ("gather", gather)):
        if not x.is_contiguous():
            raise ValueError(f"leaf_stats: {name} is not contiguous")
        if x.device.type != "cuda":
            raise ValueError(f"leaf_stats: {name} is on {x.device}, not CUDA")
    if b == 0 or gather.numel() == 0 or num_replica < 1:
        raise ValueError("leaf_stats: empty batch or leaf layer")
    if max(d * num_replica * k * (n_t + 1), d * b * n_t,
           n_leaves * k * gather.shape[1] * n_t) >= 2 ** 31:
        raise ValueError("leaf_stats: the statistics exceed int32 indices")
    return b, n_leaves, k, d, n_t, gather.shape[1]


def leaf_stats_cuda(g_leaf: torch.Tensor, t: torch.Tensor,
                    gather: torch.Tensor, num_replica: int):
    """Launch the CUDA kernel on CUDA tensors; returns (s_phi, s_den) like
    ``leaf_stats_plain``, two views of one zeroed buffer."""
    b, n_leaves, k, d, n_t, width = _check(g_leaf, t, gather, num_replica)
    t_vm = t.transpose(0, 1)  # (D, B, |T|), contiguous
    geo = launch_geometry(b, width, n_leaves, k, n_t)
    if geo["grid"][1] > MAX_GRID_YZ:
        raise ValueError(f"leaf_stats: {n_leaves} leaves exceed the grid "
                         "limit")
    r = num_replica
    n_phi = d * k * r * n_t
    out = torch.zeros(n_phi + d * k * r, dtype=torch.float32,
                      device=g_leaf.device)
    s_phi, s_den = out[:n_phi].view(d, k, r, n_t), out[n_phi:].view(d, k, r)
    slices = geo["slices"]
    part = part_den = out  # unused with one slice
    sum_blocks = 1
    if slices > 1:
        n_part = n_leaves * k * width * n_t
        scratch = torch.empty(slices * (n_part + n_leaves * k),
                              dtype=torch.float32, device=g_leaf.device)
        part, part_den = scratch[:slices * n_part], scratch[slices * n_part:]
        sum_blocks = _cdiv(n_part, THREADS)
    lib = build.load("leaf_stats", _SIGNATURES)
    with torch.cuda.device(g_leaf.device):
        stream = torch.cuda.current_stream(g_leaf.device).cuda_stream
        err = lib.leaf_stats(
            g_leaf.data_ptr(), t_vm.data_ptr(), gather.data_ptr(),
            s_phi.data_ptr(), s_den.data_ptr(), part.data_ptr(),
            part_den.data_ptr(), b, n_leaves, width, d, r, k, n_t,
            geo["tk"], geo["tn"], geo["groups"], geo["cb"], geo["rps"],
            slices, geo["smem"], sum_blocks,
            copy_width(k, g_leaf.data_ptr()),
            copy_width(math.gcd(n_t, 4), t_vm.data_ptr()), stream)
    build.check(lib, err, "leaf_stats")
    return s_phi, s_den
