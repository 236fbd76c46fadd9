"""Grouped (whole-subtree) log-einsum-exp forward over a canonical depth run:
the CUDA kernel ``csrc/grouped_fwd.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/grouped.py`` ``grouped_log_einsum_exp_pallas``.  A
canonical run of G depths is a forest of complete binary trees over its
L_out output cells; one CUDA block walks one cell's tree for a tile of rows
in shared memory, so the intermediate depths never reach device memory.
The TPU kernel's lane padding is not carried over: the kernel takes the
unpadded shapes.

``grouped_log_einsum_exp_plain`` is ``repro_torch.core.layers
.grouped_log_einsum_exp`` (the chained per-depth op): the wrapper in ``ops``
runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
against it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.layers import (
    grouped_log_einsum_exp as grouped_log_einsum_exp_plain,
)
from repro_torch.kernels import build
from repro_torch.kernels.log_einsum_exp import MAX_GRID_Y, SMEM_LIMIT_BYTES

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

__all__ = [
    "grouped_log_einsum_exp_cuda", "grouped_log_einsum_exp_plain",
    "group_geometry", "smem_layout", "pick_tile_b",
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


def smem_layout(g: int, k: int, k_outs: Sequence[int],
                tile_b: int) -> Tuple[int, int, int, int]:
    """(w_floats, a_floats, b_floats, total bytes) of one block's shared
    memory (the layout in ``grouped_fwd_kernel``): one depth's weight cells
    at a time, two ping-pong activation areas (the inputs and the odd
    depths' outputs in the first, the even depths' in the second) and one
    clamped max per input row."""
    cells = [2 ** (g - 1 - d) for d in range(g)]
    w_floats = max(cells[d] * k_outs[d] * k * k for d in range(g))
    a_floats = tile_b * max(
        [2 ** g * k] + [cells[d] * k_outs[d] for d in range(1, g, 2)])
    b_floats = tile_b * max(cells[d] * k_outs[d] for d in range(0, g, 2))
    total = 4 * (w_floats + a_floats + b_floats + tile_b * 2 ** g)
    return w_floats, a_floats, b_floats, total


def pick_tile_b(g: int, k: int, k_outs: Sequence[int]) -> int:
    """Largest row tile whose block fits in shared memory; raises when even
    one row of one cell's subtree does not fit."""
    for tb in TILE_B_CHOICES:
        if smem_layout(g, k, k_outs, tb)[3] <= SMEM_LIMIT_BYTES:
            return tb
    raise ValueError(
        f"grouped_log_einsum_exp: one output cell's {g}-depth subtree at "
        f"K={k}, K_out={list(k_outs)} needs "
        f"{smem_layout(g, k, k_outs, 1)[3]} B of shared memory for a single "
        f"row; the card allows {SMEM_LIMIT_BYTES} B"
    )


def grouped_log_einsum_exp_cuda(ws: Sequence[torch.Tensor],
                                x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ws per depth, input side first, depth ``d``
    (L_out 2^(G-1-d), K_out_d, K, K); x (B, L_out 2^G, K); all float32 on one
    CUDA device.  Returns (B, L_out, K_out_final) float32."""
    g, l_out, k, k_outs = group_geometry(ws, x)
    if g > MAX_DEPTHS:
        raise ValueError(f"grouped_log_einsum_exp: {g} depths > {MAX_DEPTHS}")
    for t in list(ws) + [x]:
        if t.dtype != torch.float32:
            raise TypeError(f"grouped_log_einsum_exp: {t.dtype}, not float32")
    if any(not w.is_contiguous() for w in ws):
        raise ValueError("grouped_log_einsum_exp: weights must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != k:
        raise ValueError("grouped_log_einsum_exp: x needs contiguous rows")
    b = x.shape[0]
    if b == 0:
        raise ValueError("grouped_log_einsum_exp: empty batch")
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
