"""Log-einsum-exp forward for one layer pair (the paper's Eq. 4/5): the CUDA
kernel ``csrc/log_einsum_exp_fwd.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/log_einsum_exp.py`` ``log_einsum_exp_pallas``.  The
TPU kernel padded K to a multiple of 16 and K_out to 128 lanes for its
matrix unit; the CUDA kernel takes the unpadded shapes and masks the ragged
batch edge itself.  -inf and NEG_INF rows give exactly what the plain
version gives (out = -inf, and a + a' with the log swallowed, respectively).

``log_einsum_exp_plain`` is ``repro_torch.core.layers.log_einsum_exp``: the
wrapper in ``ops`` runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

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

__all__ = ["log_einsum_exp_cuda", "log_einsum_exp_plain", "k_out_tile"]


def smem_bytes(k: int, kt: int, tile_b: int = TILE_B) -> int:
    """Shared memory of one block (the layout in ``lee_fwd_kernel``): a
    K_out tile of ``kt`` weight cells, the tile's left and right rows and
    their two clamped maxes."""
    return 4 * (kt * k * k + 2 * tile_b * k + 2 * tile_b)


def k_out_tile(k: int, k_out: int, tile_b: int = TILE_B) -> int:
    """Largest K_out tile whose weights fit beside the row tile in shared
    memory: all of K_out when one cell's W fits (K = 10: 4 KB), a slice of
    it otherwise (K = 40: one cell is 256 KB)."""
    kt = (SMEM_LIMIT_BYTES - smem_bytes(k, 0, tile_b)) // (4 * k * k)
    if kt < 1:
        raise ValueError(
            f"log_einsum_exp: K={k} leaves no room for one weight row of "
            f"{4 * k * k} B beside a {tile_b}-row tile in "
            f"{SMEM_LIMIT_BYTES} B of shared memory"
        )
    return min(k_out, kt)


def log_einsum_exp_cuda(w: torch.Tensor, ln_left: torch.Tensor,
                        ln_right: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: w (L, K_out, K, K), ln_* (B, L, K), all
    float32 on one CUDA device; returns (B, L, K_out) float32."""
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
