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
such tree: a block keeps its row tile's whole row buffer in shared memory
and walks the depths through the run's tables (``GatherTables``, packed
once per device into an int32 tensor).  The backwards recompute the
forward there from x (residual recompute).  The TPU kernels' lane padding
is not carried over: the kernels take the unpadded shapes.

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
from typing import Dict, List, Sequence, Tuple

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
    "gather_grouped_log_einsum_exp_cuda", "gather_grouped_log_einsum_exp_plain",
    "gather_grouped_log_einsum_exp_bwd_cuda",
    "gather_grouped_log_einsum_exp_bwd_plain", "gather_geometry",
    "pack_gather_tables", "gather_tables_tensor", "gather_smem_layout",
    "pick_gather_tile_b",
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


# ---------------------------------------------------------------------------
# gather runs (Poon-Domingos): K5 forward, K6 backward
# ---------------------------------------------------------------------------
GATHER_MAX_DEPTHS = 16  # kGatherMaxDepths in gather_common.cuh
# row tiles are picked for about one block an SM (the H100 has 132); the
# backward's every tile writes a partial gradient of all the run's weights,
# kept under GATHER_PART_LIMIT_BYTES
GATHER_TARGET_BLOCKS = 128
GATHER_PART_LIMIT_BYTES = 256 * 2 ** 20
_HEADER_INTS = 4  # D, r_in, R, Rc
_DEPTH_INTS = 8  # L, M, C, base, left, right, child, vi

_GATHER_SIGNATURES = {
    "gather_fwd": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ws vs D n_mix
        ctypes.c_void_p, ctypes.c_int,  # packed tables, their ints
        ctypes.c_void_p, ctypes.c_void_p,  # x, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B K tile
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w floats, R, Rc
        ctypes.c_void_p,  # stream
    ],
}
_GATHER_BWD_SIGNATURES = {
    "gather_bwd": [
        ctypes.c_void_p, ctypes.c_void_p,  # ws vs
        ctypes.c_void_p, ctypes.c_void_p,  # their offsets in a partial
        ctypes.c_int, ctypes.c_int,  # D n_mix
        ctypes.c_void_p, ctypes.c_int,  # packed tables, their ints
        ctypes.c_void_p, ctypes.c_void_p,  # x, g_out
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # parts, gwv, n
        ctypes.c_void_p,  # gx
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B K tile
        ctypes.c_longlong,  # x batch stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w floats, R, Rc
        ctypes.c_int, ctypes.c_int,  # max cells a depth, max M C a depth
        ctypes.c_void_p,  # stream
    ],
}


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
    if len(ws) != tables.num_depths:
        raise ValueError(f"{len(ws)} weight depths vs {tables.num_depths} "
                         "table depths")
    for t, w in enumerate(ws):
        want = (len(tables.left[t]), k, k, k)
        if tuple(w.shape) != want:
            raise ValueError(f"gather depth {t} weights {tuple(w.shape)} != "
                             f"{want} (interior depths keep K_out == K)")
    if len(vs) != tables.num_mix_depths:
        raise ValueError(f"{len(vs)} mixing depths vs "
                         f"{tables.num_mix_depths} in tables")
    vi = 0
    for t, child in enumerate(tables.mix_child):
        if child is None:
            continue
        want = (len(child), len(child[0]), k)
        if tuple(vs[vi].shape) != want:
            raise ValueError(f"gather mix depth {t} weights "
                             f"{tuple(vs[vi].shape)} != {want}")
        vi += 1
    return tables.num_new_rows, k


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


def _gather_sizes(tables) -> Tuple[int, int, int, int, int]:
    """(R, Rc, max cells of a depth, max M C of a mixing depth, table ints)."""
    tab = pack_gather_tables(tables)
    l_max = max(len(l) for l in tables.left)
    mc_max = max([len(c) * len(c[0]) for c in tables.mix_child
                  if c is not None] + [0])
    return int(tab[2]), int(tab[3]), l_max, mc_max, len(tab)


def gather_row_stride(k: int) -> int:
    """Shared-memory floats of one staged weight row (one output of a cell)
    in K5/K6: K^2 made odd, so a warp's rows fall in different banks
    (``gather_row_stride`` in ``gather_common.cuh``)."""
    return (k * k) | 1


def _balanced_weight_floats(k: int, cells: int, left: int) -> int:
    """Floats of shared memory for staging the weights of a depth of
    ``cells`` (K, K, K) cells when ``left`` floats are free: the whole
    depth when it fits, else equal chunks of whole cells, else equal K_out
    tiles of one cell (``lee_chunks`` cuts them from this size), each
    weight row ``gather_row_stride(k)`` floats."""
    kk = gather_row_stride(k)
    cell = k * kk
    if cells * cell <= left:
        return cells * cell
    if cell <= left:
        per = left // cell
        n = -(-cells // per)
        return -(-cells // n) * cell
    kt_max = left // kk
    if kt_max < 1:
        return kk  # does not fit: the caller's total exceeds the limit
    n = -(-k // kt_max)
    return -(-k // n) * kk


def gather_smem_layout(tables, k: int, tile_b: int,
                       backward: bool = False) -> Tuple[int, int]:
    """(w_floats, total bytes) of one K5 block's shared memory, or with
    ``backward`` one K6 block's (the layouts in ``gather_fwd.cu`` and
    ``gather_bwd.cu``): the weight staging area, the tile's row buffer in
    the log domain (R rows of K a batch row), the stabilised copies and
    maxes of the rows that may be children (Rc), and the packed tables.
    The backward adds a cotangent buffer of R rows, two per-depth input
    cotangent areas (max cells rows each) and the mixing terms (max M C
    rows)."""
    r_all, r_child, l_max, mc_max, n_tab = _gather_sizes(tables)
    rows = r_all * k + r_child * (k + 1)
    if backward:
        rows += r_all * k + 2 * l_max * k + mc_max * k
    fixed = tile_b * rows + n_tab
    w_floats = _balanced_weight_floats(k, l_max, SMEM_LIMIT_BYTES // 4 - fixed)
    return w_floats, 4 * (w_floats + fixed)


def pick_gather_tile_b(tables, k: int, b: int, backward: bool = False) -> int:
    """The row tile of a gather launch (of K5, or with ``backward`` of K6):
    the largest tile that fits in shared memory and still gives
    ``GATHER_TARGET_BLOCKS`` blocks for a batch of ``b``, else the smallest
    that fits; the backward then grows the tile, as far as shared memory
    allows, until its per-tile partial gradients stay under
    ``GATHER_PART_LIMIT_BYTES`` (larger batches go in microbatches).  A
    block's time hardly depends on its rows (it stages every weight and
    runs one FMA chain an output), so one block an SM is the fastest
    tile at einet_pd's B = 512 in both kernels.  Raises when one row's
    buffer and one weight row do not fit."""
    fits = [tb for tb in TILE_B_CHOICES
            if gather_smem_layout(tables, k, tb, backward)[1]
            <= SMEM_LIMIT_BYTES]
    if not fits:
        raise ValueError(
            f"gather_grouped_log_einsum_exp: one row's buffer of "
            f"{tables.num_in_rows + tables.num_new_rows} rows at K={k} and "
            f"one weight row need "
            f"{gather_smem_layout(tables, k, 1, backward)[1]} B of shared "
            f"memory; the card allows {SMEM_LIMIT_BYTES} B")
    i = next((i for i, tb in enumerate(fits)
              if -(-b // tb) >= GATHER_TARGET_BLOCKS), len(fits) - 1)
    if backward:
        part = 4 * sum(len(l) * k ** 3 for l in tables.left)
        while i > 0 and -(-b // fits[i]) * part > GATHER_PART_LIMIT_BYTES:
            i -= 1
    return fits[i]


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


def gather_grouped_log_einsum_exp_cuda(tables, ws: Sequence[torch.Tensor],
                                       vs: Sequence[torch.Tensor],
                                       x: torch.Tensor) -> torch.Tensor:
    """Launch K5: ws (L_t, K, K, K) per depth, vs (M_t, C_t, K) per mixing
    depth, x (B, r_in, K), all float32 on one CUDA device.  Returns the new
    rows (B, r_new, K) float32."""
    k = _check_gather(tables, ws, vs, x, "gather_grouped_log_einsum_exp")
    b = x.shape[0]
    tile_b = pick_gather_tile_b(tables, k, b)
    w_floats, _ = gather_smem_layout(tables, k, tile_b)
    r_all, r_child, _, _, n_tab = _gather_sizes(tables)
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
            tab.data_ptr(), n_tab, x.data_ptr(), out.data_ptr(), b, k,
            tile_b, x.stride(0), w_floats, r_all, r_child, stream,
        )
    build.check(lib, err, "gather_fwd")
    return out


def gather_grouped_log_einsum_exp_bwd_cuda(tables,
                                           ws: Sequence[torch.Tensor],
                                           vs: Sequence[torch.Tensor],
                                           x: torch.Tensor,
                                           g_out: torch.Tensor):
    """Launch K6: ws, vs and x as in the forward, g_out (B, r_new, K)
    contiguous, all float32 on one CUDA device.  Returns (gws, gvs, gx) like
    ``gather_grouped_log_einsum_exp_bwd_plain``; gws and gvs are views of
    one buffer."""
    what = "gather_grouped_log_einsum_exp backward"
    k = _check_gather(tables, ws, vs, x, what)
    b = x.shape[0]
    if (tuple(g_out.shape) != (b, tables.num_new_rows, k)
            or g_out.dtype != torch.float32 or not g_out.is_contiguous()):
        raise ValueError(
            f"{what}: g_out {tuple(g_out.shape)} {g_out.dtype}, expected "
            f"contiguous ({b}, {tables.num_new_rows}, {k}) float32")
    tile_b = pick_gather_tile_b(tables, k, b, backward=True)
    tiles = -(-b // tile_b)
    w_floats, _ = gather_smem_layout(tables, k, tile_b, backward=True)
    r_all, r_child, l_max, mc_max, n_tab = _gather_sizes(tables)
    sizes = [t.numel() for t in list(ws) + list(vs)]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    total = sum(sizes)
    dev = x.device
    tab = gather_tables_tensor(tables, dev)
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    part = flat if tiles == 1 else torch.empty(
        (tiles, total), dtype=torch.float32, device=dev)
    gx = torch.empty((b, x.shape[1], k), dtype=torch.float32, device=dev)
    w_ptrs, v_ptrs = _pointers(ws), _pointers(vs)
    w_offs = (ctypes.c_longlong * len(ws))(*offs[:len(ws)])
    v_offs = (ctypes.c_longlong * max(1, len(vs)))(*offs[len(ws):])
    lib = build.load("gather_bwd", _GATHER_BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_bwd(
            ctypes.cast(w_ptrs, ctypes.c_void_p),
            ctypes.cast(v_ptrs, ctypes.c_void_p),
            ctypes.cast(w_offs, ctypes.c_void_p),
            ctypes.cast(v_offs, ctypes.c_void_p), len(ws), len(vs),
            tab.data_ptr(), n_tab, x.data_ptr(), g_out.data_ptr(),
            part.data_ptr(), flat.data_ptr(), total, gx.data_ptr(), b, k,
            tile_b, x.stride(0), w_floats, r_all, r_child, l_max, mc_max,
            stream,
        )
    build.check(lib, err, "gather_bwd")
    views = [flat[o: o + n].view(t.shape)
             for o, n, t in zip(offs, sizes, list(ws) + list(vs))]
    return views[:len(ws)], views[len(ws):], gx
