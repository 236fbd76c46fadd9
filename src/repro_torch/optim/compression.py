"""Gradient compression for the slow (inter-pod) all-reduce.

The port's counterpart of the reference's ``repro/optim/compression.py``.
Two codecs, both with error feedback (the residual is carried to the next
step so compression error does not bias the optimizer):

  * int8 blockwise quantization (one float32 scale a 256-value block);
  * top-k sparsification by magnitude.

:func:`compressed_psum` is the int8 all-reduce over a process group:
quantize against a shared codebook -> sum the int8 payloads as int32 ->
dequantize.  EM statistics can take the same path: they are sums over
data, like gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened and zero-padded to (n_blocks, BLOCK)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _absmax_scale(blocks: torch.Tensor) -> torch.Tensor:
    """Each block's absmax / 127 as an (n_blocks, 1) column.  The divisor
    is a tensor on the blocks' device: CUDA divides by a host scalar as a
    multiply by its reciprocal, which rounds otherwise than the CPU's (and
    the reference's) true division."""
    return torch.amax(torch.abs(blocks), dim=1, keepdim=True) / torch.full(
        (), 127.0, device=blocks.device)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 levels of ``blocks`` against ``scale`` (as floats; round
    half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-20)),
                       -127, 127)


def _unblock(blocks: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 levels (n_blocks, BLOCK), float32 scales (n_blocks,))."""
    blocks = _blocks(x)
    scale = _absmax_scale(blocks)
    return _quantize(blocks, scale).to(torch.int8), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _unblock(q.to(torch.float32) * scale[:, None], shape)


def compress_with_feedback(g: torch.Tensor, residual: Optional[torch.Tensor]):
    """Returns ((q, scale), new_residual)."""
    if residual is not None:
        g = g + residual
    q, scale = quantize_int8(g)
    return (q, scale), g - dequantize_int8(q, scale, g.shape)


def topk_sparsify(g: torch.Tensor, k: int, residual: Optional[torch.Tensor]):
    """Magnitude top-k with error feedback.  Returns ((values, indices),
    residual)."""
    if residual is not None:
        g = g + residual
    flat = g.reshape(-1)
    _, idx = torch.topk(torch.abs(flat), k)
    vals = flat[idx]
    approx = torch.zeros_like(flat)
    approx[idx] = vals
    return (vals, idx), (flat - approx).reshape(g.shape)


def densify_topk(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=True).reshape(shape)


def compressed_psum(g: torch.Tensor, group=None,
                    residual: Optional[torch.Tensor] = None):
    """int8 all-reduce of ``g`` over ``group`` (default: the whole job) with
    error feedback.  Returns (the decoded sum, this rank's new residual).

    The sum of int8 payloads decodes only against a common codebook, so a
    ``MAX`` all-reduce of the per-block scales comes first, then a ``SUM``
    all-reduce of the levels as int32 (no overflow).  The residual is this
    rank's own quantization error.  Without a process group the job is one
    rank and the sums are its own values."""
    if residual is not None:
        g = g + residual
    blocks = _blocks(g)
    scale = _absmax_scale(blocks)
    if dist.is_initialized():
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quantize(blocks, scale)
    qsum = q.to(torch.int32)
    if dist.is_initialized():
        dist.all_reduce(qsum, group=group)
    out = _unblock(qsum.to(torch.float32) * scale, g.shape)
    return out, g - _unblock(q * scale, g.shape)
