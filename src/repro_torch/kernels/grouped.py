"""Grouped (whole-subtree) log-einsum-exp, forward and backward, over the
two kinds of grouped plan segment, each kernel beside its plain PyTorch
version:

  * a canonical depth run (RAT): ``csrc/grouped_fwd.cu`` (K3) and
    ``csrc/grouped_bwd.cu`` (K4);
  * a gather run (Poon-Domingos, interior mixing included):
    ``csrc/gather_fwd.cu`` (K5) and ``csrc/gather_bwd.cu`` (K6).

Replaces ``repro/kernels/grouped.py`` ``grouped_log_einsum_exp_pallas``,
``grouped_log_einsum_exp_bwd_pallas``, ``gather_grouped_log_einsum_exp_pallas``
and ``gather_grouped_log_einsum_exp_bwd_pallas``.  A canonical run of G
depths is a forest of complete binary trees over its L_out output cells;
one CUDA block walks one cell's tree for a tile of rows in shared memory,
so the intermediate depths never reach device memory.  A gather run has no
such tree: its kernels walk the depths through the run's tables
(``GatherTables``, packed once per device into an int32 tensor), depth by
depth through the per-pair kernels, with the row buffer in device memory.
The backwards recompute the forward from x (residual recompute).  The TPU
kernels' lane padding is not carried over: the kernels take the unpadded
shapes.

``grouped_log_einsum_exp_plain`` is ``repro_torch.core.layers
.grouped_log_einsum_exp`` (the chained per-depth op), and
``grouped_log_einsum_exp_bwd_plain`` the chained per-depth backward of the
reference's custom VJP; ``gather_grouped_log_einsum_exp_plain`` is the
reference's chained gather path and ``gather_grouped_log_einsum_exp_bwd_plain``
the reference kernel's own backward order.  The wrappers in ``ops`` run the
plain versions for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernels against them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.layers import (
    S_FLOOR,
    log_mix_exp,
    mix_frame,
)
from repro_torch.core.layers import (
    grouped_log_einsum_exp as grouped_log_einsum_exp_plain,
)
from repro_torch.kernels import build
from repro_torch.kernels import log_einsum_exp as lee
from repro_torch.kernels.log_einsum_exp import (
    MAX_GRID_Y,
    SMEM_LIMIT_BYTES,
    log_einsum_exp_bwd_plain,
    log_einsum_exp_plain,
)

MAX_DEPTHS = 8  # kGroupedMaxDepths in grouped_common.cuh
# K3: rows a block, largest first; the blocks a launch aims for; the work
# items (chunk cell, row subtile, K_out tile) a chunk should give a block's
# eight warps
FWD_TB_CHOICES = (128, 64, 32, 16, 8, 4, 2, 1)
FWD_TARGET_BLOCKS = 2 * lee.SMS
FWD_MIN_ITEMS = 8
FWD_ONE_TILE = 3  # K3's register tile for a last depth of one output
# K4: rows a block, largest first (multiples of its register tiles' rows,
# K2's BWD_TILES); the blocks a launch aims for; its per-tile
# weight-gradient partials are kept under GROUPED_PART_LIMIT_BYTES, else it
# takes the batch-split dW
BWD_TB_CHOICES = (64, 32, 16)
BWD_TARGET_BLOCKS = 4 * lee.SMS
BWD_CHUNK_CELLS = 4
GROUPED_PART_LIMIT_BYTES = 64 * 2 ** 20

_SIGNATURES = {
    "grouped_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ws, k_outs, G
        ctypes.c_void_p, ctypes.c_void_p,  # x, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B L_out K tb
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int,  # ti, tf
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # cells, kt, u floats
        ctypes.c_void_p,  # stream
    ],
}
_BWD_SIGNATURES = {
    "grouped_bwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ws k_outs offs
        ctypes.c_int,  # G
        ctypes.c_void_p, ctypes.c_void_p,  # x, g_out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # parts, gw, n
        ctypes.c_void_p,  # gx
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B L_out K tb
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ti, tf, t_cells
        ctypes.c_int, ctypes.c_int,  # cot0 / cot1 floats
        ctypes.c_void_p, ctypes.c_void_p,  # split scratch (or NULL), dW geo
        ctypes.c_void_p,  # stream
    ],
}

__all__ = [
    "grouped_log_einsum_exp_cuda", "grouped_log_einsum_exp_plain",
    "grouped_log_einsum_exp_bwd_cuda", "grouped_log_einsum_exp_bwd_plain",
    "group_geometry", "fwd_geometry", "fwd_row_stride", "bwd_geometry",
    "bwd_dw_geometry", "bwd_partial_bytes",
    "depth_chunks",
    "gather_grouped_log_einsum_exp_cuda", "gather_grouped_log_einsum_exp_plain",
    "gather_grouped_log_einsum_exp_bwd_cuda",
    "gather_grouped_log_einsum_exp_bwd_plain", "gather_geometry",
    "pack_gather_tables", "gather_tables_tensor", "gather_fwd_geometry",
    "gather_fwd_plan", "gather_bwd_geometry", "gather_bwd_partial_bytes",
]


def group_geometry(ws: Sequence[torch.Tensor], x: torch.Tensor
                   ) -> Tuple[int, int, int, List[int]]:
    """Validate a canonical run's shapes; returns (G, L_out, K, k_outs)."""
    g = len(ws)
    if g < 1:
        raise ValueError("grouped_log_einsum_exp: empty run")
    if x.dim() != 3:
        raise ValueError(f"grouped_log_einsum_exp: x is {tuple(x.shape)}, "
                         "expected (B, rows, K)")
    _, rows, k = x.shape
    l_out = ws[-1].shape[0]
    if rows != l_out * 2 ** g:
        raise ValueError(
            f"group input has {rows} rows; a {g}-depth canonical run over "
            f"{l_out} output cells needs {l_out * 2 ** g}"
        )
    for d, w in enumerate(ws):
        if w.dim() != 4:
            raise ValueError(f"depth {d} weight is {tuple(w.shape)}")
        if w.shape[0] != l_out * 2 ** (g - 1 - d):
            raise ValueError(
                f"depth {d} has {w.shape[0]} cells, expected "
                f"{l_out * 2 ** (g - 1 - d)} (canonical halving)"
            )
        if w.shape[-1] != k or w.shape[-2] != k:
            raise ValueError(f"depth {d} weight K {tuple(w.shape[-2:])} != input K {k}")
        if d < g - 1 and w.shape[1] != k:
            raise ValueError(
                f"interior depth {d} K_out {w.shape[1]} != K {k}; interior "
                "outputs feed the next depth so K_out must equal K"
            )
    return g, l_out, k, [int(w.shape[1]) for w in ws]


def fwd_row_stride(k: int) -> int:
    """Shared floats of one row in K3's row areas (``fwd_stride`` in
    ``grouped_fwd.cu``): odd, and at least K + 1, float K holding the row's
    clamped max."""
    return (k + 1) | 1


def depth_chunks(cells: int, k_out: int, k: int, w_floats: int,
                 kt_tile: int = 1) -> Tuple[int, int]:
    """How a depth's ``cells`` weight cells, each K_out weight rows of
    ``row_stride(k)`` floats, go through ``w_floats`` of shared memory:
    (cells a chunk, K_out a chunk) -- as many whole cells as fit, else one
    cell's K_out rows at a time, a multiple of the register tile's
    ``kt_tile`` outputs where at least that many fit (0 when not one weight
    row fits)."""
    row = lee.row_stride(k)
    if k_out * row <= w_floats:
        return min(cells, w_floats // (k_out * row)), k_out
    kt = w_floats // row
    if kt >= kt_tile:
        kt -= kt % kt_tile
    return 1, kt


class FwdGeometry(NamedTuple):
    """A K3 launch (``grouped_fwd.cu``): register tiles ti (every depth,
    numbered as K1's ``FWD_TILES``) and tf (the last depth: ti, or
    FWD_ONE_TILE for one output); tb rows a block; each depth's weight
    chunk (cells, kt); the weight area's floats; the block's shared
    bytes."""
    ti: int
    tf: int
    tb: int
    cells: Tuple[int, ...]
    kt: Tuple[int, ...]
    u_floats: int
    smem_bytes: int


def _fwd_tile_shape(t: int) -> Tuple[int, int]:
    return (32, 1) if t == FWD_ONE_TILE else lee.tile_shape(lee.FWD_TILES[t])


def fwd_items(geo: FwdGeometry, b: int) -> int:
    """Work items of a K3 block's first chunk (cells, row subtiles of the
    block's rows, K_out tiles): what the block's eight warps share."""
    rows, kt = _fwd_tile_shape(geo.ti if len(geo.kt) > 1 else geo.tf)
    return (geo.cells[0] * -(-min(geo.tb, b) // rows)
            * -(-geo.kt[0] // kt))


@functools.lru_cache(maxsize=1024)
def fwd_geometry(g: int, k: int, k_outs: Tuple[int, ...], b: int,
                 l_out: int) -> FwdGeometry:
    """K3's launch geometry.  A block holds the rows of two depths at
    ``fwd_row_stride(k)`` (the read one, 2^(G-d) slots of tb rows, and the
    written one) and a weight area; each depth's weights go through it in
    chunks (``depth_chunks``).  For each row tile (largest first, none
    twice the batch) the register tile is the first of K1's order
    (``_tile_order``: the 8- or 10-output tile, then the one-output one)
    whose first chunk gives the block's warps FWD_MIN_ITEMS items; the last
    depth takes the same tile, or FWD_ONE_TILE for one output.  Then the
    largest row tile with enough items that still gives FWD_TARGET_BLOCKS
    blocks, else the smallest of at least 32 rows (a register tile's rows:
    a smaller tile would only restage the weights for fewer rows); tiles
    under 32 rows only where 32 do not fit.  Every output
    keeps lee_cell_sum's order whatever the tiles, so a row's result never
    depends on the batch.  Raises when one row and one weight row do not
    fit."""
    kq, row = fwd_row_stride(k), lee.row_stride(k)
    slots = 2 ** g + (2 ** (g - 1) if g > 1 else 0)
    fits = []
    for tb in FWD_TB_CHOICES:
        if tb > 32 and tb >= 2 * b:
            continue
        cap = SMEM_LIMIT_BYTES // 4 - slots * tb * kq
        options = []
        for ti in lee._tile_order(k):
            tf = FWD_ONE_TILE if k_outs[-1] == 1 else ti
            chunks = [depth_chunks(2 ** (g - 1 - d), ko, k, cap,
                                   _fwd_tile_shape(ti if d < g - 1 else tf)[1])
                      for d, ko in enumerate(k_outs)]
            if any(kt < 1 for _, kt in chunks):
                continue
            u = max(c * kt * row for c, kt in chunks)
            geo = FwdGeometry(ti, tf, tb, tuple(c for c, _ in chunks),
                              tuple(kt for _, kt in chunks), u,
                              4 * (slots * tb * kq + u))
            options.append((fwd_items(geo, b) >= FWD_MIN_ITEMS, geo))
        if options:
            fits.append(next((o for o in options if o[0]), options[-1]))
    if not fits:
        raise ValueError(
            f"grouped_log_einsum_exp: one output cell's {g}-depth subtree at "
            f"K={k}, K_out={list(k_outs)} needs "
            f"{4 * (slots * kq + row)} B of shared memory for a single row "
            f"and one weight row; the card allows {SMEM_LIMIT_BYTES} B")
    good = [geo for ok, geo in fits if ok] or [geo for _, geo in fits]
    good = [geo for geo in good if geo.tb >= 32] or good
    return next((geo for geo in good
                 if l_out * -(-b // geo.tb) >= FWD_TARGET_BLOCKS), good[-1])


class BwdGeometry(NamedTuple):
    """A K4 launch (``grouped_bwd.cu``): register tiles ti (interior
    depths) and tf (the last depth), numbered as K2's ``BWD_TILES``; tb
    rows a block; t_cells weight cells a recompute chunk; the cotangent areas c0 and c1 (floats); the block's shared
    bytes; and split, whether dW goes through K2's batch-split kernel
    instead of per-tile partials."""
    ti: int
    tf: int
    tb: int
    t_cells: int
    c0: int
    c1: int
    smem_bytes: int
    split: bool


def _bwd_block_floats(g, k, k_outs, tb, ktm, kt0):
    """(fixed floats, floats a chunk cell, c0, c1) of a K4 block: every
    depth's stabilised rows at lee_pad and their maxes, every depth's s,
    and the two cotangent areas (depth d's output cotangent in area d % 2,
    its input cotangent in the other; depth 0's goes straight to gx unless
    its K_out tiles, kt0 outputs each, are several), every row at an odd
    stride; a chunk cell's KTM weight rows at lee_row_stride and its
    sweep."""
    cells = [2 ** (g - 1 - d) for d in range(g)]
    kp = lee.pad(k)
    out = [cells[d] * lee.pad(k_outs[d]) for d in range(g)]
    c0 = tb * max([out[d] for d in range(0, g, 2)]
                  + [2 * cells[d] * kp for d in range(1, g, 2)])
    first = 2 if k_outs[0] <= kt0 else 0
    c1 = tb * max([out[d] for d in range(1, g, 2)]
                  + [2 * cells[d] * kp for d in range(first, g, 2)] + [0])
    slots = 2 ** (g + 1) - 2
    fixed = slots * tb * (kp + 1) + tb * sum(out) + c0 + c1
    return fixed, ktm * lee.row_stride(k) + tb * ktm * kp, c0, c1


@functools.lru_cache(maxsize=1024)
def bwd_geometry(g: int, k: int, k_outs: Tuple[int, ...], b: int,
                 l_out: int) -> BwdGeometry:
    """K4's launch geometry.  The tiles follow K and the K_outs alone (as
    K2's: the 8- or 10-output tile that pads K_out less, the one-output
    tile for K_out = 1), so a row's order of operations never depends on
    the batch.  Then the largest row tile (a multiple of both tiles' rows)
    whose block fits in 227 KB with at least one chunk cell and that still
    gives BWD_TARGET_BLOCKS blocks, else the smallest that fits; the rest
    of the budget goes to chunk cells, at most BWD_CHUNK_CELLS.  Raises
    when no block fits."""
    ti = lee._tile_order(k)[0]
    tf = lee._tile_order(k_outs[-1])[0]
    (ri, kti), (rf, ktf) = (lee.tile_shape(lee.BWD_TILES[t])
                            for t in (ti, tf))
    ktm = max(kti, ktf)
    rows = ri * rf // int(np.gcd(ri, rf))
    for budget in (SMEM_LIMIT_BYTES,):
        fits = []
        for tb in BWD_TB_CHOICES:
            if tb % rows:
                continue
            fixed, per_cell, c0, c1 = _bwd_block_floats(
                g, k, k_outs, tb, ktm, kti if g > 1 else ktf)
            cells = min(2 ** (g - 1), BWD_CHUNK_CELLS,
                        (budget // 4 - fixed) // per_cell)
            if cells >= 1:
                fits.append((tb, cells, c0, c1,
                             4 * (fixed + cells * per_cell)))
        if fits:
            good = [f for f in fits
                    if l_out * -(-b // f[0]) >= BWD_TARGET_BLOCKS]
            tb, cells, c0, c1, smem = good[0] if good else fits[-1]
            tiles = -(-b // tb)
            split = tiles > 1 and 4 * tiles * sum(
                _depth_sizes(g, k, k_outs, l_out)) > GROUPED_PART_LIMIT_BYTES
            return BwdGeometry(ti, tf, tb, cells, c0, c1, smem, split)
    raise ValueError(
        f"grouped_log_einsum_exp backward: one output cell's {g}-depth "
        f"subtree at K={k}, K_out={list(k_outs)} does not fit one row tile "
        f"and one weight chunk in {SMEM_LIMIT_BYTES} B of shared memory"
    )


def _depth_sizes(g, k, k_outs, l_out):
    """Floats of each depth's weights."""
    return [2 ** (g - 1 - d) * l_out * ko * k * k
            for d, ko in enumerate(k_outs)]


def bwd_dw_geometry(g: int, k: int, k_outs: Sequence[int], b: int,
                    l_out: int) -> List[Tuple[int, int, int]]:
    """Split mode: each depth's (JT, K_out tile, batch splits) of K2's dW
    kernel (``dw_geometry``, ``dw_splits``)."""
    return [lee.dw_geometry(k, ko)
            + (lee.dw_splits(b, l_out * 2 ** (g - 1 - d), k, ko),)
            for d, ko in enumerate(k_outs)]


def bwd_partial_bytes(g: int, k: int, k_outs: Sequence[int], b: int,
                      l_out: int) -> int:
    """Bytes of K4's weight-gradient partials: per-tile partials of all
    the run's weights, or in split mode the largest depth's batch-split
    partials (0 where K4 writes gw itself)."""
    geo = bwd_geometry(g, k, tuple(k_outs), b, l_out)
    sizes = _depth_sizes(g, k, k_outs, l_out)
    if not geo.split:
        tiles = -(-b // geo.tb)
        return 0 if tiles == 1 else 4 * tiles * sum(sizes)
    return max(4 * n * sp if sp > 1 else 0 for n, (_, _, sp) in zip(
        sizes, bwd_dw_geometry(g, k, k_outs, b, l_out)))


def _check_run(ws, x, what: str):
    g, l_out, k, k_outs = group_geometry(ws, x)
    if g > MAX_DEPTHS:
        raise ValueError(f"{what}: {g} depths > {MAX_DEPTHS}")
    for t in list(ws) + [x]:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {t.dtype}, not float32")
    if any(not w.is_contiguous() for w in ws):
        raise ValueError(f"{what}: weights must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != k:
        raise ValueError(f"{what}: x needs contiguous rows")
    if x.shape[0] == 0:
        raise ValueError(f"{what}: empty batch")
    return g, l_out, k, k_outs


@functools.lru_cache(maxsize=1024)
def _fwd_args(g: int, k: int, k_outs: Tuple[int, ...], b: int, l_out: int):
    """K3's launch constants, made once: its geometry and the addresses of
    the K_outs and each depth's chunk as C arrays (kept alive here)."""
    geo = fwd_geometry(g, k, k_outs, b, l_out)
    arrs = [(ctypes.c_int * g)(*v) for v in (k_outs, geo.cells, geo.kt)]
    return (geo, *[ctypes.addressof(a) for a in arrs], arrs)


def grouped_log_einsum_exp_cuda(ws: Sequence[torch.Tensor],
                                x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ws per depth, input side first, depth ``d``
    (L_out 2^(G-1-d), K_out_d, K, K); x (B, L_out 2^G, K); all float32 on one
    CUDA device.  Returns (B, L_out, K_out_final) float32."""
    g, l_out, k, k_outs = _check_run(ws, x, "grouped_log_einsum_exp")
    b = x.shape[0]
    geo, k_arr, cells, kts, _ = _fwd_args(g, k, tuple(k_outs), b, l_out)
    if -(-b // geo.tb) > MAX_GRID_Y:
        raise ValueError(f"grouped_log_einsum_exp: batch {b} exceeds the grid")
    out = torch.empty((b, l_out, k_outs[-1]), dtype=torch.float32,
                      device=x.device)
    w_ptrs = (ctypes.c_void_p * g)(*[w.data_ptr() for w in ws])
    lib = build.load("grouped_fwd", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_fwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            k_arr, g, x.data_ptr(), out.data_ptr(), b, l_out, k, geo.tb,
            x.stride(0), geo.ti, geo.tf, cells, kts, geo.u_floats, stream,
        )
    build.check(lib, err, "grouped_fwd")
    return out


def grouped_log_einsum_exp_bwd_plain(ws: Sequence[torch.Tensor],
                                     x: torch.Tensor, g_out: torch.Tensor):
    """The backward of ``grouped_log_einsum_exp`` as the reference's fused
    kernel computes it (``repro/kernels/grouped.py`` ``_make_bwd_kernel``,
    ``_depth_bwd``): recompute every depth's inputs from x, then walk the
    depths in reverse with the per-pair backward
    (``log_einsum_exp_bwd_plain``).  Returns (gws like ws, gx like x)."""
    acts = [x]
    for w in ws[:-1]:
        h = w.shape[0]
        acts.append(log_einsum_exp_plain(w, acts[-1][:, :h],
                                         acts[-1][:, h: 2 * h]))
    gws = [None] * len(ws)
    gcur = g_out
    for d in reversed(range(len(ws))):
        h = ws[d].shape[0]
        gws[d], gl, gr = log_einsum_exp_bwd_plain(
            ws[d], acts[d][:, :h], acts[d][:, h: 2 * h], gcur)
        gcur = torch.cat([gl, gr], dim=1)
    return gws, gcur


def grouped_log_einsum_exp_bwd_cuda(ws: Sequence[torch.Tensor],
                                    x: torch.Tensor, g_out: torch.Tensor):
    """Launch the CUDA backward kernel: ws and x as in the forward, g_out
    (B, L_out, K_out_final) contiguous, all float32 on one CUDA device.
    Returns (gws, gx) like ``grouped_log_einsum_exp_bwd_plain``; the gws are
    views of one buffer."""
    g, l_out, k, k_outs = _check_run(ws, x, "grouped_log_einsum_exp backward")
    b = x.shape[0]
    if (g_out.shape != (b, l_out, k_outs[-1])
            or g_out.dtype != torch.float32 or not g_out.is_contiguous()):
        raise ValueError(
            f"grouped_log_einsum_exp backward: g_out {tuple(g_out.shape)} "
            f"{g_out.dtype}, expected contiguous ({b}, {l_out}, "
            f"{k_outs[-1]}) float32")
    geo = bwd_geometry(g, k, tuple(k_outs), b, l_out)
    tiles = -(-b // geo.tb)
    if tiles > MAX_GRID_Y:
        raise ValueError(f"grouped_log_einsum_exp backward: batch {b} "
                         "exceeds the grid")
    sizes = [w.numel() for w in ws]
    offs = [sum(sizes[:d]) for d in range(g)]
    total = sum(sizes)
    dev = x.device
    gw_flat = torch.empty(total, dtype=torch.float32, device=dev)
    gx = torch.empty((b, l_out * 2 ** g, k), dtype=torch.float32, device=dev)
    dw = bwd_dw_geometry(g, k, k_outs, b, l_out)
    if geo.split:
        # the interior depths' rows, every depth's ginv, then the largest
        # depth's batch-split dW partials
        n_rows = sum(b * l_out * 2 ** (g - d) * k for d in range(1, g))
        n_ginv = sum(b * l_out * 2 ** (g - 1 - d) * ko
                     for d, ko in enumerate(k_outs))
        n_part = max(n * sp if sp > 1 else 0
                     for n, (_, _, sp) in zip(sizes, dw))
        scratch = torch.empty(n_rows + n_ginv + n_part, dtype=torch.float32,
                              device=dev)
        gw_part, scratch_ptr = gw_flat, scratch.data_ptr()
    else:
        gw_part = gw_flat if tiles == 1 else torch.empty(
            (tiles, total), dtype=torch.float32, device=dev)
        scratch_ptr = None
    w_ptrs = (ctypes.c_void_p * g)(*[w.data_ptr() for w in ws])
    k_arr = (ctypes.c_int * g)(*k_outs)
    off_arr = (ctypes.c_longlong * g)(*offs)
    dw_arr = (ctypes.c_int * (3 * g))(*[v for geo_d in dw for v in geo_d])
    lib = build.load("grouped_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.grouped_bwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(k_arr, ctypes.c_void_p),
            ctypes.cast(off_arr, ctypes.c_void_p), g,
            x.data_ptr(), g_out.data_ptr(), gw_part.data_ptr(),
            gw_flat.data_ptr(), total, gx.data_ptr(), b, l_out, k, geo.tb,
            x.stride(0), geo.ti, geo.tf, geo.t_cells, geo.c0, geo.c1,
            scratch_ptr, ctypes.cast(dw_arr, ctypes.c_void_p), stream,
        )
    build.check(lib, err, "grouped_bwd")
    gws = [gw_flat[o: o + n].view(w.shape) for o, n, w in zip(offs, sizes, ws)]
    return gws, gx


# ---------------------------------------------------------------------------
# gather runs (Poon-Domingos): K5 forward, K6 backward
# ---------------------------------------------------------------------------
GATHER_MAX_DEPTHS = 16  # kGatherMaxDepths in gather_common.cuh
_HEADER_INTS = 4  # D, r_in, R, Rc
_DEPTH_INTS = 8  # L, M, C, base, left, right, child, vi

_GATHER_SIGNATURES = {
    "gather_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ws vs D n_mix
        ctypes.c_void_p, ctypes.c_void_p,  # packed tables: device, host
        ctypes.c_void_p, ctypes.c_longlong,  # x, its batch stride
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # out B K
        ctypes.c_void_p,  # the depths' K1 geometry
        ctypes.c_void_p,  # stream
    ],
}
_GATHER_BWD_SIGNATURES = {
    "gather_bwd": [
        ctypes.c_void_p, ctypes.c_void_p,  # ws vs
        ctypes.c_void_p, ctypes.c_void_p,  # their offsets in gwv
        ctypes.c_int, ctypes.c_int,  # D n_mix
        ctypes.c_void_p, ctypes.c_void_p,  # packed tables: device, host
        ctypes.c_void_p, ctypes.c_longlong,  # x, its batch stride
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g_out gwv gx
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # B K, depths' geometry
        *[ctypes.c_void_p] * 9,  # X cot lr buf ginv glr acc ge part
        ctypes.c_void_p,  # stream
    ],
}


@functools.lru_cache(maxsize=None)
def _gather_shapes(tables, k: int):
    """(each depth's weight shape, (depth, shape) of each mixing depth's
    weights, new rows) a run's tables ask for at K."""
    ws = tuple((len(left), k, k, k) for left in tables.left)
    vs = tuple((t, (len(c), len(c[0]), k))
               for t, c in enumerate(tables.mix_child) if c is not None)
    return ws, vs, tables.num_new_rows


def gather_geometry(tables, ws: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], x: torch.Tensor
                    ) -> Tuple[int, int]:
    """Validate a gather run's shapes against its tables; returns (r_new,
    K).  Every depth is interior: its weights are (L_t, K, K, K), and a
    mixing depth's are (M_t, C_t, K)."""
    if x.dim() != 3:
        raise ValueError(f"gather_grouped_log_einsum_exp: x is "
                         f"{tuple(x.shape)}, expected (B, r_in, K)")
    _, r_in, k = x.shape
    if r_in != tables.num_in_rows:
        raise ValueError(f"gather input has {r_in} rows; tables expect "
                         f"{tables.num_in_rows}")
    want_ws, want_vs, r_new = _gather_shapes(tables, k)
    if len(ws) != len(want_ws):
        raise ValueError(f"{len(ws)} weight depths vs {len(want_ws)} "
                         "table depths")
    for t, (w, want) in enumerate(zip(ws, want_ws)):
        if tuple(w.shape) != want:
            raise ValueError(f"gather depth {t} weights {tuple(w.shape)} != "
                             f"{want} (interior depths keep K_out == K)")
    if len(vs) != len(want_vs):
        raise ValueError(f"{len(vs)} mixing depths vs {len(want_vs)} in "
                         "tables")
    for v, (t, want) in zip(vs, want_vs):
        if tuple(v.shape) != want:
            raise ValueError(f"gather mix depth {t} weights "
                             f"{tuple(v.shape)} != {want}")
    return r_new, k


@functools.lru_cache(maxsize=None)
def pack_gather_tables(tables) -> np.ndarray:
    """The run's tables as one int32 array, the layout ``gather_common.cuh``
    reads: a header (D, r_in, R rows in all, Rc rows that may be a child),
    then 8 ints a depth (L, M, C, the depth's first row, and the offsets of
    its left rows, right rows and mixing children, with the mask right
    after the children, and its mixing ordinal or -1), then the data.  Row
    ids are global buffer rows, and each child row must precede its depth;
    a mixing child is a local index into the depth's L einsum rows.  The
    tables are frozen and hashable, so one array serves every call."""
    d_n = tables.num_depths
    head = [d_n, tables.num_in_rows,
            tables.num_in_rows + tables.num_new_rows, 0]
    depths: List[int] = []
    data: List[int] = []
    base0 = _HEADER_INTS + _DEPTH_INTS * d_n
    base, vi = tables.num_in_rows, 0
    for t in range(d_n):
        left, right = tables.left[t], tables.right[t]
        child, mask = tables.mix_child[t], tables.mix_mask[t]
        n_l = len(left)
        if len(right) != n_l or n_l == 0:
            raise ValueError(f"gather depth {t}: {n_l} left, {len(right)} "
                             "right rows")
        if any(not 0 <= r < base for r in left + right):
            raise ValueError(f"gather depth {t}: a child row outside "
                             f"[0, {base})")
        m = c = 0
        if child is not None:
            m, c = len(child), len(child[0])
            flat_c = [int(v) for row in child for v in row]
            flat_m = [int(v) for row in mask for v in row]
            if (any(len(row) != c for row in child) or len(flat_m) != m * c
                    or any(not 0 <= v < n_l for v in flat_c)
                    or any(v not in (0, 1) for v in flat_m)):
                raise ValueError(f"gather depth {t}: bad mixing tables")
        off = base0 + len(data)
        depths += [n_l, m, c, base, off, off + n_l,
                   off + 2 * n_l if m else -1, vi if m else -1]
        data += list(left) + list(right)
        if m:
            data += flat_c + flat_m
            vi += 1
        if t == d_n - 1:
            head[3] = base  # rows of the last depth are never children
        base += n_l + m
    packed = np.asarray(head + depths + data, dtype=np.int32)
    packed.flags.writeable = False  # one array is shared by every caller
    return packed


_TABLE_TENSORS: Dict[Tuple[object, torch.device], torch.Tensor] = {}


def gather_tables_tensor(tables, device: torch.device) -> torch.Tensor:
    """``pack_gather_tables(tables)`` on ``device``, made once per
    (tables, device) and cached."""
    key = (tables, torch.device(device))
    t = _TABLE_TENSORS.get(key)
    if t is None:
        t = torch.tensor(pack_gather_tables(tables), device=device)
        _TABLE_TENSORS[key] = t
    return t


def _gather_sizes(tables) -> Tuple[int, int, int]:
    """(R rows in all, max cells of a depth, max M C of a mixing depth)."""
    l_max = max(len(l) for l in tables.left)
    mc_max = max([len(c) * len(c[0]) for c in tables.mix_child
                  if c is not None] + [0])
    return tables.num_in_rows + tables.num_new_rows, l_max, mc_max


def gather_fwd_geometry(tables, k: int, b: int) -> List[Tuple[int, int]]:
    """K5's K1 launches, depth by depth (``gather_fwd.cu``): (tile, nsub)
    at the depth's pair (B, L_t, K, K), as the per-pair wrapper picks them
    (and as K6's recompute does, so that both write the same bits)."""
    return [tuple(lee._geometry(b, len(left), k, k)[:2])
            for left in tables.left]


def gather_fwd_plan(tables, k: int, b: int) -> List[tuple]:
    """K5's launches in order, as ``gather_fwd`` makes them from the packed
    tables: per depth t, ("pair", t, left ids, right ids, first row, (tile,
    nsub)) -- K1 on the depth's cells, cell l reading buffer rows left[l]
    and right[l] (ids below r_in rows of x, the others new rows, id - r_in)
    and writing new row first + l -- then, where the depth mixes, ("mix",
    t, first mixing row, the depth's first row), the mixing of the depth's
    einsum rows into new rows first, first + 1, ...  Rows are rows of the
    new-row output (B, r_new, K)."""
    tab = pack_gather_tables(tables)
    r_in = int(tab[1])
    plan = []
    for t, geo in enumerate(gather_fwd_geometry(tables, k, b)):
        n_l, m, _, base, left, right = (int(v) for v in tab[
            _HEADER_INTS + _DEPTH_INTS * t: _HEADER_INTS + _DEPTH_INTS * t + 6])
        plan.append(("pair", t, tab[left: left + n_l].tolist(),
                     tab[right: right + n_l].tolist(), base - r_in, geo))
        if m:
            plan.append(("mix", t, base - r_in + n_l, base - r_in))
    return plan


def gather_bwd_geometry(tables, k: int, b: int
                        ) -> List[Tuple[int, int, int, int, int, int, int]]:
    """K6's launches, depth by depth (``gather_bwd.cu``): the geometry of
    K1 (tile, nsub) and of K2 (tile, nsub, JT, K_out tile, batch splits) at
    the depth's pair (B, L_t, K, K), as the per-pair wrappers pick them."""
    geo = []
    for left in tables.left:
        cells = len(left)
        f_tile, f_nsub, _, _ = lee._geometry(b, cells, k, k)
        b_tile, b_nsub, _, _ = lee._geometry(b, cells, k, k, backward=True)
        geo.append((f_tile, f_nsub, b_tile, b_nsub, *lee.dw_geometry(k, k),
                    lee.dw_splits(b, cells, k, k)))
    return geo


def gather_bwd_partial_bytes(tables, k: int, b: int) -> int:
    """Bytes of K6's weight-gradient partials, summed over the depths: K2's
    batch-split partials of each depth's weights (0 for a depth of one
    split)."""
    return sum(lee.dw_partial_bytes(b, len(left), k, k)
               for left in tables.left)


def gather_grouped_log_einsum_exp_plain(tables, ws: Sequence[torch.Tensor],
                                        vs: Sequence[torch.Tensor],
                                        x: torch.Tensor) -> torch.Tensor:
    """The reference's chained gather path (``repro/core/layers.py``
    ``gather_grouped_log_einsum_exp``, impl "xla"): per depth, the per-pair
    op on the buffer's gathered child rows, then the depth's mixing, the
    buffer grown by the new rows.  Returns the new rows only, (B, r_new, K),
    einsum rows then mixing rows per depth in global row order."""
    buf = x
    vi = 0
    for t in range(tables.num_depths):
        s = log_einsum_exp_plain(ws[t], buf[:, list(tables.left[t])],
                                 buf[:, list(tables.right[t])])
        piece = s
        if tables.mix_child[t] is not None:
            mask = torch.tensor(tables.mix_mask[t], dtype=torch.float32,
                                device=x.device)
            child = torch.tensor(tables.mix_child[t], device=x.device)
            m = log_mix_exp(vs[vi], s[:, child], mask)
            vi += 1
            piece = torch.cat([s, m], 1)
        buf = torch.cat([buf, piece], 1)
    return buf[:, x.shape[1]:]


def gather_grouped_log_einsum_exp_bwd_plain(tables, ws: Sequence[torch.Tensor],
                                            vs: Sequence[torch.Tensor],
                                            x: torch.Tensor,
                                            g_out: torch.Tensor):
    """The backward of ``gather_grouped_log_einsum_exp`` in the reference
    kernel's own order (``repro/kernels/grouped.py`` ``_make_gather_bwd_kernel``):
    recompute every row and frame from x, start the cotangent buffer at 0
    for the input rows and at ``g_out`` for the new rows, then walk the
    depths in reverse.  At each depth the mixing backward runs first (a
    masked child gives an exact 0 in gV and adds nothing), then the pair's
    backward (``log_einsum_exp_bwd_plain``), whose input cotangents are
    added into the child rows, the right children's first.  Returns (gws
    like ws, gvs like vs, gx like x)."""
    rows = list(x.unbind(1))
    frames = []
    vi = 0
    for t in range(tables.num_depths):
        lnl = torch.stack([rows[r] for r in tables.left[t]], 1)
        lnr = torch.stack([rows[r] for r in tables.right[t]], 1)
        s = log_einsum_exp_plain(ws[t], lnl, lnr)
        e_base = len(rows)
        rows += list(s.unbind(1))
        m_base = None
        if tables.mix_child[t] is not None:
            mask = torch.tensor(tables.mix_mask[t], dtype=torch.float32,
                                device=x.device)
            child = torch.tensor(tables.mix_child[t], device=x.device)
            a, _, ssum = mix_frame(vs[vi], s[:, child], mask)
            m_base = len(rows)
            rows += list((a[:, :, 0] + torch.log(ssum)).unbind(1))
            vi += 1
        frames.append((lnl, lnr, s, e_base, m_base))
    r_in = x.shape[1]
    cot = [torch.zeros_like(rows[0])] * r_in + list(g_out.unbind(1))
    gws: List[torch.Tensor] = [None] * tables.num_depths
    gvs: List[torch.Tensor] = [None] * len(vs)
    for t in reversed(range(tables.num_depths)):
        lnl, lnr, s, e_base, m_base = frames[t]
        child = tables.mix_child[t]
        if child is not None:
            vi -= 1
            v = vs[vi]
            mask = torch.tensor(tables.mix_mask[t], dtype=torch.float32,
                                device=x.device)
            _, e, ssum = mix_frame(
                v, s[:, torch.tensor(child, device=x.device)], mask)
            gm = torch.stack([cot[m_base + mi] for mi in range(len(child))], 1)
            ginv = gm / torch.clamp(ssum, min=S_FLOOR)
            gv = torch.zeros_like(v)
            for mi, row in enumerate(child):
                for ci, c in enumerate(row):
                    if tables.mix_mask[t][mi][ci]:
                        ge = ginv[:, mi] * e[:, mi, ci]
                        gv[mi, ci] = ge.sum(0)
                        cot[e_base + c] = cot[e_base + c] + ge * v[mi, ci]
            gvs[vi] = gv
        gs = torch.stack([cot[e_base + li]
                          for li in range(len(tables.left[t]))], 1)
        gws[t], gl, gr = log_einsum_exp_bwd_plain(ws[t], lnl, lnr, gs)
        for li, r in enumerate(tables.right[t]):
            cot[r] = cot[r] + gr[:, li]
        for li, r in enumerate(tables.left[t]):
            cot[r] = cot[r] + gl[:, li]
    return gws, gvs, torch.stack(cot[:r_in], 1)


def _check_gather(tables, ws, vs, x, what: str) -> int:
    _, k = gather_geometry(tables, ws, vs, x)
    if tables.num_depths > GATHER_MAX_DEPTHS or len(vs) > GATHER_MAX_DEPTHS:
        raise ValueError(f"{what}: {tables.num_depths} depths > "
                         f"{GATHER_MAX_DEPTHS}")
    for t in list(ws) + list(vs) + [x]:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {t.dtype}, not float32")
    if any(not t.is_contiguous() for t in list(ws) + list(vs)):
        raise ValueError(f"{what}: weights must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != k:
        raise ValueError(f"{what}: x needs contiguous rows")
    if x.shape[0] == 0:
        raise ValueError(f"{what}: empty batch")
    return k


def _pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])


@functools.lru_cache(maxsize=1024)
def _gather_fwd_args(tables, k: int, b: int):
    """K5's launch constants for (tables, K, B), made once: the address of
    the depths' K1 geometry as a C array (kept alive here), and that of the
    host tables."""
    geo = gather_fwd_geometry(tables, k, b)
    arr = (ctypes.c_int * (2 * len(geo)))(*[v for g in geo for v in g])
    return ctypes.addressof(arr), pack_gather_tables(tables).ctypes.data, arr


def gather_grouped_log_einsum_exp_cuda(tables, ws: Sequence[torch.Tensor],
                                       vs: Sequence[torch.Tensor],
                                       x: torch.Tensor) -> torch.Tensor:
    """Launch K5: ws (L_t, K, K, K) per depth, vs (M_t, C_t, K) per mixing
    depth, x (B, r_in, K), all float32 on one CUDA device.  Returns the new
    rows (B, r_new, K) float32."""
    k = _check_gather(tables, ws, vs, x, "gather_grouped_log_einsum_exp")
    b = x.shape[0]
    geo_arr, tab_h, _ = _gather_fwd_args(tables, k, b)
    dev = x.device
    tab = gather_tables_tensor(tables, dev)
    out = torch.empty((b, tables.num_new_rows, k), dtype=torch.float32,
                      device=dev)
    w_ptrs, v_ptrs = _pointers(ws), _pointers(vs)
    lib = build.load("gather_fwd", _GATHER_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_fwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(v_ptrs, ctypes.c_void_p), len(ws), len(vs),
            tab.data_ptr(), tab_h, x.data_ptr(), x.stride(0),
            out.data_ptr(), b, k, geo_arr, stream,
        )
    build.check(lib, err, "gather_fwd")
    return out


def gather_grouped_log_einsum_exp_bwd_cuda(tables,
                                           ws: Sequence[torch.Tensor],
                                           vs: Sequence[torch.Tensor],
                                           x: torch.Tensor,
                                           g_out: torch.Tensor,
                                           keep_rows: bool = False):
    """Launch K6: ws, vs and x as in the forward, g_out (B, r_new, K)
    contiguous, all float32 on one CUDA device.  Returns (gws, gvs, gx) like
    ``gather_grouped_log_einsum_exp_bwd_plain``; gws and gvs are views of
    one buffer.  With ``keep_rows`` it also returns the new rows its
    residual recompute wrote (B, r_new, K), which K5 must equal."""
    what = "gather_grouped_log_einsum_exp backward"
    k = _check_gather(tables, ws, vs, x, what)
    b = x.shape[0]
    if (tuple(g_out.shape) != (b, tables.num_new_rows, k)
            or g_out.dtype != torch.float32 or not g_out.is_contiguous()):
        raise ValueError(
            f"{what}: g_out {tuple(g_out.shape)} {g_out.dtype}, expected "
            f"contiguous ({b}, {tables.num_new_rows}, {k}) float32")
    geo = gather_bwd_geometry(tables, k, b)
    r_all, l_max, mc_max = _gather_sizes(tables)
    sizes = [t.numel() for t in list(ws) + list(vs)]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    dev = x.device
    tab = gather_tables_tensor(tables, dev)
    tab_h = pack_gather_tables(tables)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    gx = torch.empty((b, x.shape[1], k), dtype=torch.float32, device=dev)
    # one scratch tensor, cut as gather_bwd.cu lists it
    k_tiles = max(-(-k // lee.launch_geometry(b, len(left), k, k, True)[3])
                  for left in tables.left)
    n_row = b * l_max * k
    parts = [b * r_all * k, b * r_all * k,
             sum(2 * b * len(left) * k for left in tables.left),
             n_row, n_row, 2 * n_row,
             0 if k_tiles == 1 else 2 * k_tiles * n_row,
             b * mc_max * k,
             max(sp * len(left) * k ** 3 if sp > 1 else 0
                 for left, (*_, sp) in zip(tables.left, geo))]
    scratch = torch.empty(sum(parts), dtype=torch.float32, device=dev)
    ptrs, base = [], scratch.data_ptr()
    for n in parts:
        ptrs.append(base)
        base += 4 * n
    w_ptrs, v_ptrs = _pointers(ws), _pointers(vs)
    w_offs = (ctypes.c_longlong * len(ws))(*offs[:len(ws)])
    v_offs = (ctypes.c_longlong * max(1, len(vs)))(*offs[len(ws):])
    geo_arr = (ctypes.c_int * (7 * len(geo)))(*[v for g in geo for v in g])
    lib = build.load("gather_bwd", _GATHER_BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_bwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(v_ptrs, ctypes.c_void_p),
            ctypes.cast(w_offs, ctypes.c_void_p),
            ctypes.cast(v_offs, ctypes.c_void_p), len(ws), len(vs),
            tab.data_ptr(), tab_h.ctypes.data, x.data_ptr(), x.stride(0),
            g_out.data_ptr(), flat.data_ptr(), gx.data_ptr(), b, k,
            ctypes.cast(geo_arr, ctypes.c_void_p), *ptrs, stream,
        )
    build.check(lib, err, "gather_bwd")
    views = [flat[o: o + n].view(t.shape)
             for o, n, t in zip(offs, sizes, list(ws) + list(vs))]
    if keep_rows:
        rows = scratch[:b * r_all * k].view(b, r_all, k)[:, x.shape[1]:]
        return views[:len(ws)], views[len(ws):], gx, rows
    return views[:len(ws)], views[len(ws):], gx
