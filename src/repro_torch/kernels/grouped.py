"""Grouped (whole-subtree) log-einsum-exp over a canonical depth run, forward
and backward: the CUDA kernels ``csrc/grouped_fwd.cu`` (K3) and
``csrc/grouped_bwd.cu`` (K4), each beside its plain PyTorch version.

Replaces ``repro/kernels/grouped.py`` ``grouped_log_einsum_exp_pallas`` and
``grouped_log_einsum_exp_bwd_pallas``.  A canonical run of G depths is a
forest of complete binary trees over its L_out output cells; one CUDA block
walks one cell's tree for a tile of rows in shared memory, so the
intermediate depths never reach device memory.  The backward recomputes
them there from x (residual recompute).  The TPU kernels' lane padding is
not carried over: the kernels take the unpadded shapes.

``grouped_log_einsum_exp_plain`` is ``repro_torch.core.layers
.grouped_log_einsum_exp`` (the chained per-depth op), and
``grouped_log_einsum_exp_bwd_plain`` the chained per-depth backward of the
reference's custom VJP: the wrappers in ``ops`` run them for CPU tensors,
and the tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.layers import (
    grouped_log_einsum_exp as grouped_log_einsum_exp_plain,
)
from repro_torch.kernels import build
from repro_torch.kernels.log_einsum_exp import (
    MAX_GRID_Y,
    SMEM_LIMIT_BYTES,
    log_einsum_exp_bwd_plain,
    log_einsum_exp_plain,
)

MAX_DEPTHS = 8  # kMaxDepths in grouped_fwd.cu
TILE_B_CHOICES = (32, 16, 8, 4, 2, 1)  # rows per block, largest that fits

_SIGNATURES = {
    "grouped_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ws, k_outs, G
        ctypes.c_void_p, ctypes.c_void_p,  # x, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B L_out K tile
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w / a / b floats
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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B L_out K tile
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w / cot0 / cot1 floats
        ctypes.c_void_p,  # stream
    ],
}

__all__ = [
    "grouped_log_einsum_exp_cuda", "grouped_log_einsum_exp_plain",
    "grouped_log_einsum_exp_bwd_cuda", "grouped_log_einsum_exp_bwd_plain",
    "group_geometry", "smem_layout", "bwd_smem_layout", "pick_tile_b",
    "depth_chunks",
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


def _weight_floats(k: int, cells: Sequence[int], k_outs: Sequence[int],
                   row_floats: int) -> int:
    """Shared floats for staging weights beside ``row_floats`` of rows: one
    whole depth's cells when they fit, else what is left, but at least one
    weight row of K^2 floats (``depth_chunks`` stages through it)."""
    whole = max(c * ko * k * k for c, ko in zip(cells, k_outs))
    left = SMEM_LIMIT_BYTES // 4 - row_floats
    return max(k * k, min(whole, left))


def depth_chunks(cells: int, k_out: int, k: int,
                 w_floats: int) -> Tuple[int, int]:
    """How a depth's ``cells`` weight cells, each (K_out, K, K), go through
    ``w_floats`` of shared memory (``lee_chunks`` in ``lee_common.cuh``):
    (cells a chunk, K_out a chunk) -- whole cells when one fits, else one
    cell's K_out tile at a time."""
    cell = k_out * k * k
    if cell <= w_floats:
        return min(cells, w_floats // cell), k_out
    return 1, w_floats // (k * k)


def smem_layout(g: int, k: int, k_outs: Sequence[int],
                tile_b: int) -> Tuple[int, int, int, int]:
    """(w_floats, a_floats, b_floats, total bytes) of one forward block's
    shared memory (the layout in ``grouped_fwd_kernel``): weights staged a
    depth, or a chunk of one (``depth_chunks``), at a time, two ping-pong
    activation areas (the inputs and the odd depths' outputs in the first,
    the even depths' in the second) and one clamped max per input row."""
    cells = [2 ** (g - 1 - d) for d in range(g)]
    a_floats = tile_b * max(
        [2 ** g * k] + [cells[d] * k_outs[d] for d in range(1, g, 2)])
    b_floats = tile_b * max(cells[d] * k_outs[d] for d in range(0, g, 2))
    rows = a_floats + b_floats + tile_b * 2 ** g
    w_floats = _weight_floats(k, cells, k_outs, rows)
    return w_floats, a_floats, b_floats, 4 * (w_floats + rows)


def bwd_smem_layout(g: int, k: int, k_outs: Sequence[int],
                    tile_b: int) -> Tuple[int, int, int, int]:
    """(w_floats, cot0_floats, cot1_floats, total bytes) of one backward
    block's shared memory (the layout in ``grouped_bwd_kernel``): weights
    as in the forward, every depth's stabilised input rows (2^G + ... + 2
    rows of K a batch row) and their maxes, and two cotangent areas.  Depth
    d's output cotangent lives in area d % 2 and its input cotangent in the
    other; depth 0's input cotangent (2^G rows) is in area 1."""
    cells = [2 ** (g - 1 - d) for d in range(g)]
    cot0 = tile_b * max(cells[d] * k_outs[d] for d in range(0, g, 2))
    cot1 = tile_b * max(
        [2 ** g * k] + [cells[d] * k_outs[d] for d in range(1, g, 2)])
    rows = tile_b * (2 ** (g + 1) - 2) * (k + 1) + cot0 + cot1
    w_floats = _weight_floats(k, cells, k_outs, rows)
    return w_floats, cot0, cot1, 4 * (w_floats + rows)


def pick_tile_b(g: int, k: int, k_outs: Sequence[int],
                layout=smem_layout) -> int:
    """Largest row tile whose block (laid out by ``layout``: the forward's
    ``smem_layout`` or the backward's ``bwd_smem_layout``) fits in shared
    memory with at least one weight row; raises when even one row of the
    subtree and one K_out row of one weight cell do not fit."""
    for tb in TILE_B_CHOICES:
        if layout(g, k, k_outs, tb)[3] <= SMEM_LIMIT_BYTES:
            return tb
    raise ValueError(
        f"grouped_log_einsum_exp: one output cell's {g}-depth subtree at "
        f"K={k}, K_out={list(k_outs)} needs {layout(g, k, k_outs, 1)[3]} B "
        f"of shared memory for a single row and one weight row; the card "
        f"allows {SMEM_LIMIT_BYTES} B"
    )


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


def grouped_log_einsum_exp_cuda(ws: Sequence[torch.Tensor],
                                x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ws per depth, input side first, depth ``d``
    (L_out 2^(G-1-d), K_out_d, K, K); x (B, L_out 2^G, K); all float32 on one
    CUDA device.  Returns (B, L_out, K_out_final) float32."""
    g, l_out, k, k_outs = _check_run(ws, x, "grouped_log_einsum_exp")
    b = x.shape[0]
    tile_b = pick_tile_b(g, k, k_outs)
    if -(-b // tile_b) > MAX_GRID_Y:
        raise ValueError(f"grouped_log_einsum_exp: batch {b} exceeds the grid")
    w_floats, a_floats, b_floats, _ = smem_layout(g, k, k_outs, tile_b)
    out = torch.empty((b, l_out, k_outs[-1]), dtype=torch.float32,
                      device=x.device)
    w_ptrs = (ctypes.c_void_p * g)(*[w.data_ptr() for w in ws])
    k_arr = (ctypes.c_int * g)(*k_outs)
    lib = build.load("grouped_fwd", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_fwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(k_arr, ctypes.c_void_p), g,
            x.data_ptr(), out.data_ptr(), b, l_out, k, tile_b, x.stride(0),
            w_floats, a_floats, b_floats, stream,
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
    tile_b = pick_tile_b(g, k, k_outs, bwd_smem_layout)
    tiles = -(-b // tile_b)
    if tiles > MAX_GRID_Y:
        raise ValueError(f"grouped_log_einsum_exp backward: batch {b} "
                         "exceeds the grid")
    w_floats, cot0, cot1, _ = bwd_smem_layout(g, k, k_outs, tile_b)
    sizes = [w.numel() for w in ws]
    offs = [sum(sizes[:d]) for d in range(g)]
    total = sum(sizes)
    dev = x.device
    gw_flat = torch.empty(total, dtype=torch.float32, device=dev)
    gw_part = gw_flat if tiles == 1 else torch.empty(
        (tiles, total), dtype=torch.float32, device=dev)
    gx = torch.empty((b, l_out * 2 ** g, k), dtype=torch.float32, device=dev)
    w_ptrs = (ctypes.c_void_p * g)(*[w.data_ptr() for w in ws])
    k_arr = (ctypes.c_int * g)(*k_outs)
    off_arr = (ctypes.c_longlong * g)(*offs)
    lib = build.load("grouped_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.grouped_bwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(k_arr, ctypes.c_void_p),
            ctypes.cast(off_arr, ctypes.c_void_p), g,
            x.data_ptr(), g_out.data_ptr(), gw_part.data_ptr(),
            gw_flat.data_ptr(), total, gx.data_ptr(), b, l_out, k, tile_b,
            x.stride(0), w_floats, cot0, cot1, stream,
        )
    build.check(lib, err, "grouped_bwd")
    gws = [gw_flat[o: o + n].view(w.shape) for o, n, w in zip(offs, sizes, ws)]
    return gws, gx
