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

import torch

from repro_torch.core.layers import S_FLOOR, cell_sums, stabilized_frame
from repro_torch.core.layers import log_einsum_exp as log_einsum_exp_plain
from repro_torch.kernels import build

# shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT_BYTES = 232_448
TILE_B = 32  # rows per block
MAX_GRID_Y = 65_535

_SIGNATURES = {
    "lee_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "lee_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
}

__all__ = [
    "log_einsum_exp_cuda", "log_einsum_exp_plain", "log_einsum_exp_bwd_cuda",
    "log_einsum_exp_bwd_plain", "k_out_tile",
]


def smem_bytes(k: int, kt: int, tile_b: int = TILE_B) -> int:
    """Shared memory of one block (the layout in ``lee_fwd_kernel``): a
    K_out tile of ``kt`` weight cells, the tile's left and right rows and
    their two clamped maxes."""
    return 4 * (kt * k * k + 2 * tile_b * k + 2 * tile_b)


def bwd_smem_bytes(k: int, kt: int, tile_b: int = TILE_B) -> int:
    """Shared memory of one backward block (the layout in
    ``lee_bwd_kernel``): a K_out tile of ``kt`` weight cells, the tile's
    left and right rows, their two gradient accumulators, and ``ginv`` for
    the K_out tile."""
    return 4 * (kt * k * k + 4 * tile_b * k + tile_b * kt)


def k_out_tile(k: int, k_out: int, tile_b: int = TILE_B,
               backward: bool = False) -> int:
    """Largest K_out tile whose weights fit beside the row tile in shared
    memory (of the forward block, or with ``backward`` of the backward
    block): all of K_out when one cell's W fits (K = 10: 4 KB), a slice of
    it otherwise (K = 40: one cell is 256 KB)."""
    if backward:
        kt = ((SMEM_LIMIT_BYTES - bwd_smem_bytes(k, 0, tile_b))
              // (4 * (k * k + tile_b)))
    else:
        kt = (SMEM_LIMIT_BYTES - smem_bytes(k, 0, tile_b)) // (4 * k * k)
    if kt < 1:
        raise ValueError(
            f"log_einsum_exp: K={k} leaves no room for one weight row of "
            f"{4 * k * k} B beside a {tile_b}-row tile in "
            f"{SMEM_LIMIT_BYTES} B of shared memory"
        )
    return min(k_out, kt)


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
    if -(-b // TILE_B) > MAX_GRID_Y:
        raise ValueError(f"log_einsum_exp: batch {b} exceeds the grid limit")
    return b, l_cells, k, k_out


def log_einsum_exp_cuda(w: torch.Tensor, ln_left: torch.Tensor,
                        ln_right: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: w (L, K_out, K, K), ln_* (B, L, K), all
    float32 on one CUDA device; returns (B, L, K_out) float32."""
    b, l_cells, k, k_out = _check_pair(w, ln_left, ln_right)
    kt = k_out_tile(k, k_out)
    out = torch.empty((b, l_cells, k_out), dtype=torch.float32,
                      device=w.device)
    lib = build.load("log_einsum_exp_fwd", _SIGNATURES)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.lee_fwd(
            w.data_ptr(), ln_left.data_ptr(), ln_right.data_ptr(),
            out.data_ptr(), b, l_cells, k, k_out, TILE_B, kt,
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
    kt = k_out_tile(k, k_out, backward=True)
    tiles = -(-b // TILE_B)
    dev = w.device
    gw = torch.empty_like(w)
    gw_part = gw if tiles == 1 else torch.empty(
        (tiles,) + tuple(w.shape), dtype=torch.float32, device=dev)
    gl = torch.empty((b, l_cells, k), dtype=torch.float32, device=dev)
    gr = torch.empty_like(gl)
    lib = build.load("log_einsum_exp_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lee_bwd(
            w.data_ptr(), ln_left.data_ptr(), ln_right.data_ptr(),
            g.data_ptr(), gw_part.data_ptr(), gw.data_ptr(), gl.data_ptr(),
            gr.data_ptr(), b, l_cells, k, k_out, TILE_B, kt,
            ln_left.stride(0), ln_left.stride(1),
            ln_right.stride(0), ln_right.stride(1), stream,
        )
    build.check(lib, err, "lee_bwd")
    return gw, gl, gr
