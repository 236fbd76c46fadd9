"""Counter-based per-row uniforms: Philox4x32-10 on integer tensors.

Row b of :func:`uniforms` is a function of ``seeds[b]`` alone: the key is
the seed's low and high 32-bit halves, the counter of the 4-word group g
is (g, 0, 0, 0), and word w becomes the float32 uniform
``(w >> 8) * 2**-24``.  It is plain PyTorch on int64 tensors, one
elementwise op at a time, so it runs as it is inside a captured CUDA
graph (the seeds are a device tensor; nothing is read back to the host),
and every 32 x 32-bit product is taken in 16-bit limbs, so nothing
overflows int64 and the CPU and the card give the same bits.

Philox4x32-10 is Salmon et al., "Parallel random numbers: as easy as 1, 2,
3" (SC 2011), with the Random123 constants below.  The reference draws
with threefry (``jax.random``), so draws differ from the reference's and
sampling parity with it is statistical.
"""

from __future__ import annotations

from typing import Tuple

import torch

M0 = 0xD2511F53  # multiplies counter word 0
M1 = 0xCD9E8D57  # multiplies counter word 2
W0 = 0x9E3779B9  # key bump, word 0 (golden ratio)
W1 = 0xBB67AE85  # key bump, word 1 (sqrt(3) - 1)
ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the constant ``m`` times the uint32
    values ``x`` (int64 tensor): ``m``'s two 16-bit limbs times ``x`` are
    each below 2^48, so the product's words come out of int64 exactly."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0,
    k1): uint32 values held in int64 tensors, which broadcast.  Returns
    the four output words."""
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r + 1 < ROUNDS:
            k0 = (k0 + W0) & _MASK32
            k1 = (k1 + W1) & _MASK32
    return c0, c1, c2, c3


def uniforms(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms on ``seeds``' device, each in [0, 1 -
    2^-24] on the 2^-24 grid: row b is words 0..n-1 of Philox4x32-10 under
    the key (low, high 32 bits of ``seeds[b]``) at counters (g, 0, 0, 0),
    g = 0, 1, ..., word 4g + j being output word j of group g."""
    if seeds.dtype != torch.int64 or seeds.dim() != 1:
        raise ValueError(f"seeds must be a 1-d int64 tensor, got "
                         f"{seeds.dtype} of shape {tuple(seeds.shape)}")
    groups = -(-int(n) // 4)
    k0 = (seeds & _MASK32)[:, None]
    k1 = ((seeds >> 32) & _MASK32)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=seeds.device)[None, :]
    zero = torch.zeros_like(g)
    words = torch.stack(philox4x32(g, zero, zero, zero, k0, k1), dim=-1)
    words = words.reshape(seeds.shape[0], 4 * groups)[:, : int(n)]
    return (words >> 8).to(torch.float32) * 2.0 ** -24
