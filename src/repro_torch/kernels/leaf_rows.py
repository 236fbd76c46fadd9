"""The leaf layer in one launch: the exponential-family log-densities of
every leaf and their sums over each leaf's scope, from the data's
statistics and the natural parameters straight to the leaf rows
(``csrc/leaf_rows.cu``), beside its plain PyTorch version.

Replaces no TPU kernel: the reference's leaf layer is XLA
(``repro/core/einet.py`` ``leaf_log_prob`` and ``_leaf_rows``).  The plain
version is the port's own composition, ``scope_sums`` of the EF tensor
``log_density`` with the marginalised entries set to 0: it builds the
(B, D, K, R) tensor, which the kernel never does.  The kernel rounds each
operation as the plain version does, so the two agree bit for bit on the
card.  Every exponential family of the port goes through it: the kernel
takes the family's sufficient statistics, log h, natural parameters and
log-normaliser, each computed by the family in plain PyTorch.

Arguments of both versions: theta (D, K, R, |T|) and a (D, K, R), t (B, D,
|T|) and log_h (B, D), marg_mask (B, D) bool or None (False: the variable
is marginalised, its term exactly 0) and gather (num_leaves, S) int64,
each leaf's (variable R + replica) rows in scope order padded with D R.
Both return the leaf rows (B, num_leaves, K) float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.exponential_family import log_density
from repro_torch.core.layers import scope_sums
from repro_torch.kernels import build

THREADS = 256  # kLeafThreads: threads of a block
SMEM_LIMIT_BYTES = 48 * 1024  # dynamic shared memory without an opt-in
SCOPE_CHUNK = 64  # scope positions a block stages at a time, at most
MAX_GRID_YZ = 65_535

_SIGNATURES = {
    "leaf_rows": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
}

__all__ = ["leaf_rows_cuda", "leaf_rows_plain", "launch_geometry",
           "pack", "scope_order"]


def leaf_stride(num_stats: int) -> int:
    """Shared floats of one staged component record above two statistics
    (``leaf_stride``): theta's |T| values and A, made odd so that a warp's
    lanes, one component each, read distinct banks."""
    return (num_stats + 1) | 1


def record_widths(num_stats: int) -> tuple:
    """Shared floats of one staged component record and of one row record
    (``leaf_param_width``, ``leaf_row_width``): 4 each, read as a float4,
    at one or two statistics; else (leaf_stride, |T| + 2)."""
    if num_stats <= 2:
        return 4, 4
    return leaf_stride(num_stats), num_stats + 2


def smem_bytes(kt: int, sc: int, num_stats: int) -> int:
    """Shared memory of one block: sc staged positions of kt component
    records, of THREADS // kt row records and of the table's two
    entries."""
    pw, xw = record_widths(num_stats)
    return 4 * sc * (kt * pw + THREADS // kt * xw + 2)


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, width: int, num_leaves: int, k: int,
                    num_stats: int) -> tuple:
    """(grid, kt, sc) of a launch: kt components of a block, THREADS // kt
    rows of one thread each, and sc scope positions staged at a time (at
    most SCOPE_CHUNK and the scope width, as many as fit in
    SMEM_LIMIT_BYTES); grid (row tiles, leaves, K tiles).  kt is all K up
    to THREADS, or, where one scope position of that does not fit (many
    statistics), the power of two whose position takes the least shared
    memory, idle lanes past K included.  Only the grid depends on the
    batch ``b``, and no choice changes a row's summation order.  Raises
    when no K tile fits one position."""
    kt = min(k, THREADS)
    if smem_bytes(kt, 1, num_stats) > SMEM_LIMIT_BYTES:
        kt = min((THREADS >> i for i in range(THREADS.bit_length())),
                 key=lambda c: smem_bytes(c, 1, num_stats))
    sc = min(width, SCOPE_CHUNK,
             SMEM_LIMIT_BYTES // smem_bytes(kt, 1, num_stats))
    if sc == 0:
        raise ValueError(
            f"leaf_rows: {num_stats} statistics leave no room for one "
            f"scope position in {SMEM_LIMIT_BYTES} B of shared memory")
    return (-(-b // (THREADS // kt)), num_leaves, -(-k // kt)), kt, sc


def scope_order(width: int, sc: int) -> list:
    """The scope positions in the order a thread adds their terms to its
    sum: the kernel's chunks of sc positions, one after another, each in
    order (its ``c0`` and ``s`` loops)."""
    return [c0 + s for c0 in range(0, width, sc)
            for s in range(min(sc, width - c0))]


def leaf_rows_plain(theta: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                    log_h: torch.Tensor, marg_mask: Optional[torch.Tensor],
                    gather: torch.Tensor) -> torch.Tensor:
    """The leaf rows through the EF tensor, the yardstick the kernel is
    held to: the family's log-densities (``log_density``), 0 where the
    mask drops a variable, summed over each scope (``scope_sums``)."""
    e = log_density(t, log_h, theta, a)
    if marg_mask is not None:
        e = torch.where(marg_mask[:, :, None, None], e, torch.zeros_like(e))
    return scope_sums(e, gather)


def _check(theta, a, t, log_h, marg_mask, gather):
    """Validate the operands; returns (B, D, K, R, |T|, num_leaves, S)."""
    if theta.dim() != 4 or t.dim() != 3 or gather.dim() != 2:
        raise ValueError("leaf_rows: expected theta (D,K,R,T), t (B,D,T), "
                         "gather (num_leaves, S)")
    d, k, r, n_t = theta.shape
    b = t.shape[0]
    if (a.shape != (d, k, r) or t.shape != (b, d, n_t)
            or log_h.shape != (b, d)
            or (marg_mask is not None and marg_mask.shape != (b, d))):
        raise ValueError(
            f"leaf_rows: shapes theta {tuple(theta.shape)}, a "
            f"{tuple(a.shape)}, t {tuple(t.shape)}, log_h "
            f"{tuple(log_h.shape)} disagree")
    for name, x in (("theta", theta), ("a", a), ("t", t), ("log_h", log_h)):
        if x.dtype != torch.float32:
            raise TypeError(f"leaf_rows: {name} is {x.dtype}, not float32")
    if marg_mask is not None and marg_mask.dtype != torch.bool:
        raise TypeError(f"leaf_rows: marg_mask is {marg_mask.dtype}, not bool")
    if gather.dtype != torch.int64 or not gather.is_contiguous():
        raise TypeError("leaf_rows: gather must be contiguous int64")
    if b == 0 or gather.numel() == 0:
        raise ValueError("leaf_rows: empty batch or leaf layer")
    if d * r >= 2 ** 31:
        raise ValueError(f"leaf_rows: {d} x {r} rows exceed int32")
    return b, d, k, r, n_t, gather.shape[0], gather.shape[1]


def pack(theta: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
         log_h: torch.Tensor, marg_mask: Optional[torch.Tensor]) -> tuple:
    """The kernel's two operands: tha (D R, K, |T| + 1), theta then A of
    each (variable, replica) row, and xs (B, D, |T| + 2), t, log h and the
    keep flag (1.0, or 0.0 where the mask drops the variable)."""
    tha = torch.cat([theta, a[..., None]], -1).permute(0, 2, 1, 3)
    tha = tha.contiguous().flatten(0, 1)
    # one stack of (B, D) planes: a cat along the last axis of widths |T|,
    # 1 and 1 writes a third slower on the card
    keep = (log_h.new_ones(()).expand_as(log_h) if marg_mask is None
            else marg_mask.to(torch.float32))
    return tha, torch.stack([*t.unbind(-1), log_h, keep], -1)


def leaf_rows_cuda(theta: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                   log_h: torch.Tensor, marg_mask: Optional[torch.Tensor],
                   gather: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns the leaf rows like
    ``leaf_rows_plain``, from the operands ``pack`` lays out."""
    b, d, k, r, n_t, n_leaves, width = _check(theta, a, t, log_h, marg_mask,
                                              gather)
    grid, kt, sc = launch_geometry(b, width, n_leaves, k, n_t)
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"leaf_rows: {n_leaves} leaves exceed the grid limit")
    tha, xs = pack(theta, a, t, log_h, marg_mask)
    out = torch.empty((b, n_leaves, k), dtype=torch.float32,
                      device=theta.device)
    lib = build.load("leaf_rows", _SIGNATURES)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.leaf_rows(tha.data_ptr(), xs.data_ptr(), gather.data_ptr(),
                            out.data_ptr(), b, n_leaves, width, d, r, k, n_t,
                            kt, sc, stream)
    build.check(lib, err, "leaf_rows")
    return out
