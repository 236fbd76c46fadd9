"""Philox4x32-10 (Salmon et al., SC 2011; Random123's constants) on int64
tensors: a frozen copy of the counter-based uniforms that a served
request's seed keys.  Row b of :func:`uniforms` is words 0..n-1 of the
generator under the key (low, high 32 bits of seeds[b]) at counters
(g, 0, 0, 0), each word w becoming (w >> 8) * 2**-24.  Every 32 x 32-bit
product is taken in 16-bit limbs so that int64 never overflows."""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    lo = x * (m & 0xFFFF)
    hi = x * (m >> 16)
    t = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (t >> 32), t & MASK


def uniforms(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms on the 2^-24 grid in [0, 1 - 2^-24]."""
    groups = -(-int(n) // 4)
    k0 = (seeds & MASK)[:, None]
    k1 = ((seeds >> 32) & MASK)[:, None]
    c0 = torch.arange(groups, dtype=torch.int64, device=seeds.device)[None, :]
    c1 = c2 = c3 = torch.zeros_like(c0)
    for r in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
    words = torch.stack((c0, c1, c2, c3), dim=-1)
    words = words.reshape(seeds.shape[0], 4 * groups)[:, :int(n)]
    return (words >> 8).to(torch.float32) * 2.0 ** -24
