"""Log-einsum-exp for one layer pair (the paper's Eq. 4/5), forward and
backward: the CUDA kernels ``csrc/log_einsum_exp_fwd.cu`` (K1) and
``csrc/log_einsum_exp_bwd.cu`` (K2), each beside its plain PyTorch version.

Replaces ``repro/kernels/log_einsum_exp.py`` ``log_einsum_exp_pallas`` and
``log_einsum_exp_bwd_pallas``.  The
TPU kernel padded K to a multiple of 16 and K_out to 128 lanes for its
matrix unit; the CUDA kernel takes the unpadded shapes and masks the ragged
batch edge itself.  -inf and NEG_INF rows give exactly what the plain
version gives (out = -inf, and a + a' with the log swallowed, respectively).

``log_einsum_exp_plain`` is ``repro_torch.core.layers.log_einsum_exp``, and
``log_einsum_exp_bwd_plain`` the reference's custom-VJP backward (not
autodiff of the plain forward): the wrappers in ``ops`` run them for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.layers import S_FLOOR, cell_sums, stabilized_frame
from repro_torch.core.layers import log_einsum_exp as log_einsum_exp_plain
from repro_torch.kernels import build

# shared memory one block may use on the H100 (227 KB): kLeeSmemLimit
SMEM_LIMIT_BYTES = 232_448
MAX_GRID_Y = 65_535
SMS = 132  # streaming multiprocessors of the H100 SXM
TARGET_BLOCKS = 2 * SMS  # a launch aims for about two blocks an SM
# The register tiles of lee_sweep (csrc/lee_common.cuh LeeTile), as (R rows,
# KO outputs a lane, NKG k-groups of a warp): tiles 0 (8 outputs) and 2 (10
# outputs) for K_out >= 2, whichever pads K_out less; tile 1 (one output)
# for K_out = 1 and for a K too large for the others.  The backward's
# 8-output and one-output tiles have half the forward's rows: its blocks do
# more a row, and at einet_pd's K = 40 more, smaller blocks fill the card.
FWD_TILES = ((4, 2, 4), (2, 1, 1), (2, 5, 2))
BWD_TILES = ((2, 2, 4), (1, 1, 1), (2, 5, 2))
NSUBS = (8, 4, 2, 1)  # row subtiles a block, largest first
DW_CHUNK = 32  # rows a dW block stages at a time (kDwChunk)
# a dW block's rows are one long chain of loads and FMAs, so its grid aims
# at eight blocks an SM
DW_TARGET_BLOCKS = 8 * SMS
DW_THREADS = 256

_SIGNATURES = {
    "lee_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "lee_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
}

__all__ = [
    "log_einsum_exp_cuda", "log_einsum_exp_plain", "log_einsum_exp_bwd_cuda",
    "log_einsum_exp_bwd_plain", "launch_geometry", "dw_geometry",
]


def row_stride(k: int) -> int:
    """Shared floats of one staged weight row (``lee_row_stride``): K^2,
    made odd so that a warp's lanes, one output each, read distinct
    banks."""
    return (k * k) | 1


def pad(k: int) -> int:
    """Shared floats of one staged activation row (``lee_pad``): K, odd."""
    return k | 1


def tile_shape(tile) -> tuple:
    """(rows of a row subtile, outputs of a K_out tile) of a register tile
    (R, KO, NKG)."""
    r, ko, nkg = tile
    return 32 // nkg * r, nkg * ko


def smem_bytes(k: int, kt: int, tb: int) -> int:
    """Shared memory of one K1 block (the layout in ``lee_fwd_kernel``): kt
    weight rows, the tile's left and right rows, their two clamped maxes and
    the sweep's t for every (row, output, i)."""
    return 4 * (kt * row_stride(k) + 2 * tb + (2 + kt) * tb * pad(k))


def bwd_smem_bytes(k: int, kt: int, tb: int) -> int:
    """Shared memory of one K2 rows block (``lee_bwd_rows_kernel``): kt
    weight rows, the left and right rows, the sweep's t (then u) and ginv
    of the K_out tile."""
    return 4 * (kt * row_stride(k) + (2 + kt) * tb * pad(k) + tb * kt)


def _tile_order(k_out: int) -> list:
    """The tiles to try for K_out, best first: the 8- or 10-output tile
    that pads K_out less (the 8 on a tie), then the one-output tile."""
    if k_out == 1:
        return [1]
    pads = {t: -(-k_out // kt) * kt for t, kt in ((0, 8), (2, 10))}
    return sorted(pads, key=lambda t: (pads[t], t)) + [1]


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, cells: int, k: int, k_out: int,
                    backward: bool = False) -> tuple:
    """(tile, nsub, rows a block, outputs of a K_out tile) of a K1 launch
    (with ``backward`` of K2's rows kernel), whose grid is (cells, row
    tiles, K_out tiles).  The first tile of ``_tile_order`` that fits; then
    the most row subtiles a block that still leave TARGET_BLOCKS blocks and
    three blocks' shared memory an SM, else one subtile.  Raises when no
    tile fits in 227 KB (K above about 200)."""
    tiles = BWD_TILES if backward else FWD_TILES
    size = bwd_smem_bytes if backward else smem_bytes
    for t in _tile_order(k_out):
        rows, kt = tile_shape(tiles[t])
        fits = [n for n in NSUBS if size(k, kt, n * rows) <= SMEM_LIMIT_BYTES]
        if not fits:
            continue
        k_tiles = -(-k_out // kt)
        good = [n for n in fits
                if size(k, kt, n * rows) <= SMEM_LIMIT_BYTES // 3
                and cells * -(-b // (n * rows)) * k_tiles >= TARGET_BLOCKS]
        nsub = good[0] if good else fits[-1]
        return t, nsub, nsub * rows, kt
    raise ValueError(
        f"log_einsum_exp: K={k} leaves no room for one weight row of "
        f"{4 * row_stride(k)} B beside a row tile in {SMEM_LIMIT_BYTES} B of "
        "shared memory"
    )


@functools.lru_cache(maxsize=1024)
def dw_geometry(k: int, k_out: int) -> tuple:
    """(JT, ktw) of K2's dW kernel: JT columns j a thread (4, 8 or 16: the
    fewest that keep a k-quad's K ceil(K / JT) items within one block) and
    the K_out tile ktw, 4 outputs a k-quad, as many quads as fit in the
    block's threads."""
    jt = next((j for j in (4, 8, 16) if k * -(-k // j) <= DW_THREADS), 16)
    quad_items = k * -(-k // jt)
    return jt, 4 * max(1, min(-(-k_out // 4), DW_THREADS // quad_items))


@functools.lru_cache(maxsize=1024)
def dw_splits(b: int, cells: int, k: int, k_out: int) -> int:
    """Batch splits of K2's dW grid (cells, K_out tiles, splits): enough for
    DW_TARGET_BLOCKS blocks, at most one a DW_CHUNK rows.  Each split beyond
    one leaves a partial of gw's size, summed in split order."""
    blocks = cells * -(-k_out // dw_geometry(k, k_out)[1])
    return max(1, min(-(-b // DW_CHUNK), -(-DW_TARGET_BLOCKS // blocks)))


def dw_partial_bytes(b: int, cells: int, k: int, k_out: int) -> int:
    """Bytes of K2's dW partials (0 with one split: it writes gw itself)."""
    splits = dw_splits(b, cells, k, k_out)
    return 0 if splits == 1 else 4 * splits * cells * k_out * k * k


def _check_pair(w, ln_left, ln_right):
    """Validate one pair's operands for a kernel; returns (B, L, K, K_out)."""
    if w.dim() != 4 or ln_left.dim() != 3 or ln_right.dim() != 3:
        raise ValueError("log_einsum_exp: expected w (L,K_out,K,K), ln (B,L,K)")
    l_cells, k_out, k, k2 = w.shape
    b = ln_left.shape[0]
    if k2 != k or ln_left.shape != (b, l_cells, k) or ln_right.shape != ln_left.shape:
        raise ValueError(
            f"log_einsum_exp: shapes w {tuple(w.shape)}, ln_left "
            f"{tuple(ln_left.shape)}, ln_right {tuple(ln_right.shape)} disagree"
        )
    for name, t in (("w", w), ("ln_left", ln_left), ("ln_right", ln_right)):
        if t.dtype != torch.float32:
            raise TypeError(f"log_einsum_exp: {name} is {t.dtype}, not float32")
    if not w.is_contiguous():
        raise ValueError("log_einsum_exp: w must be contiguous")
    if ln_left.stride(2) != 1 or ln_right.stride(2) != 1:
        raise ValueError("log_einsum_exp: ln rows need unit stride over K")
    if b == 0 or l_cells == 0:
        raise ValueError("log_einsum_exp: empty batch or layer")
    return b, l_cells, k, k_out


def _geometry(b, l_cells, k, k_out, backward=False):
    geo = launch_geometry(b, l_cells, k, k_out, backward)
    if -(-b // geo[2]) > MAX_GRID_Y:
        raise ValueError(f"log_einsum_exp: batch {b} exceeds the grid limit")
    return geo


def log_einsum_exp_cuda(w: torch.Tensor, ln_left: torch.Tensor,
                        ln_right: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: w (L, K_out, K, K), ln_* (B, L, K), all
    float32 on one CUDA device; returns (B, L, K_out) float32."""
    b, l_cells, k, k_out = _check_pair(w, ln_left, ln_right)
    tile, nsub, _, _ = _geometry(b, l_cells, k, k_out)
    out = torch.empty((b, l_cells, k_out), dtype=torch.float32,
                      device=w.device)
    lib = build.load("log_einsum_exp_fwd", _SIGNATURES)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.lee_fwd(
            w.data_ptr(), ln_left.data_ptr(), ln_right.data_ptr(),
            out.data_ptr(), b, l_cells, k, k_out, tile, nsub,
            ln_left.stride(0), ln_left.stride(1),
            ln_right.stride(0), ln_right.stride(1), stream,
        )
    build.check(lib, err, "lee_fwd")
    return out


def log_einsum_exp_bwd_plain(w: torch.Tensor, ln_left: torch.Tensor,
                             ln_right: torch.Tensor, g: torch.Tensor):
    """The backward of ``log_einsum_exp`` as the reference's custom VJP
    computes it (``repro/kernels/log_einsum_exp.py`` ``_bwd_kernel``):
    in the forward's frame, with s recomputed by the forward's own
    contraction, ginv = g / max(s, 1e-30), and

        gw[l,k,i,j] = sum_b ginv[b,l,k] el[b,l,i] er[b,l,j]
        c[b,l,i,j]  = sum_k ginv[b,l,k] W[l,k,i,j]
        gl = el * sum_j c er,   gr = er * sum_i c el.

    Returns (gw (L, K_out, K, K), gl (B, L, K), gr (B, L, K)).  gl and gr
    are fixed sequences of elementwise multiply-adds, so a row's gradients
    do not depend on the batch; gw sums over the batch.
    """
    _, _, el, er = stabilized_frame(ln_left, ln_right)
    ginv = g / torch.clamp(cell_sums(w, el, er), min=S_FLOOR)  # (B, L, K_out)
    gw = torch.einsum("blk,bli,blj->lkij", ginv, el, er)
    k_out = w.shape[1]
    c = ginv[..., 0, None, None] * w[None, :, 0]  # (B, L, K, K)
    for k in range(1, k_out):
        c = c + ginv[..., k, None, None] * w[None, :, k]
    k = w.shape[-1]
    sl = c[..., 0] * er[..., 0, None]
    sr = c[..., 0, :] * el[..., 0, None]
    for j in range(1, k):
        sl = sl + c[..., j] * er[..., j, None]
        sr = sr + c[..., j, :] * el[..., j, None]
    return gw, el * sl, er * sr


def log_einsum_exp_bwd_cuda(w: torch.Tensor, ln_left: torch.Tensor,
                            ln_right: torch.Tensor, g: torch.Tensor):
    """Launch the CUDA backward kernel: w (L, K_out, K, K), ln_* (B, L, K)
    and g (B, L, K_out) contiguous, all float32 on one CUDA device.  Returns
    (gw, gl, gr) like ``log_einsum_exp_bwd_plain``."""
    b, l_cells, k, k_out = _check_pair(w, ln_left, ln_right)
    if g.shape != (b, l_cells, k_out) or g.dtype != torch.float32:
        raise ValueError(f"log_einsum_exp backward: g {tuple(g.shape)} "
                         f"{g.dtype}, expected ({b}, {l_cells}, {k_out}) "
                         "float32")
    if not g.is_contiguous():
        raise ValueError("log_einsum_exp backward: g must be contiguous")
    tile, nsub, _, kt = _geometry(b, l_cells, k, k_out, backward=True)
    jt, ktw = dw_geometry(k, k_out)
    splits = dw_splits(b, l_cells, k, k_out)
    k_tiles = -(-k_out // kt)
    dev = w.device
    gw = torch.empty_like(w)
    glr = torch.empty((2, b, l_cells, k), dtype=torch.float32, device=dev)
    # one scratch tensor: ginv, then (with several K_out tiles of the rows
    # kernel) gl's and gr's partials, then (with several batch splits) the
    # dW partials
    n_acc = 0 if k_tiles == 1 else 2 * k_tiles * b * l_cells * k
    n_part = 0 if splits == 1 else splits * w.numel()
    scratch = torch.empty(g.numel() + n_acc + n_part, dtype=torch.float32,
                          device=dev)
    ginv = scratch.data_ptr()
    acc = ginv + 4 * g.numel()
    gw_part = acc + 4 * n_acc if splits > 1 else gw.data_ptr()
    lib = build.load("log_einsum_exp_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lee_bwd(
            w.data_ptr(), ln_left.data_ptr(), ln_right.data_ptr(),
            g.data_ptr(), ginv, acc, gw_part, gw.data_ptr(),
            glr[0].data_ptr(), glr[1].data_ptr(), b, l_cells, k, k_out, tile,
            nsub, jt, ktw, splits, ln_left.stride(0), ln_left.stride(1),
            ln_right.stride(0), ln_right.stride(1), stream,
        )
    build.check(lib, err, "lee_bwd")
    return gw, glr[0], glr[1]
