"""The naive PC implementation the paper benchmarks against (§3.2, §4.1):
the port of the reference's ``repro/core/baseline.py``.

LibSPN (Pronobis et al., 2017) and SPFlow (Molina et al., 2019) compute the
core sum-product unit entirely in the log-domain:

  1. materialize the outer *sum* of log-densities
     ``P[b,l,i,j] = logN[b,l,i] + logN'[b,l,j]``    (K^2 products, stored)
  2. broadcast-add ``log W[l,k,i,j]``                (K^3 terms, stored)
  3. ``log-sum-exp`` over (i, j)                     (K^3 exp ops)

versus EiNets' 2K exp / K log / K^3 *multiply* ops with nothing materialized.
Both compute the same function, so Table 1's log-likelihood parity holds up
to float error (``repro_torch.bench.table1``), while Fig. 3/6 measure the
time and memory gap (``repro_torch.bench.fig3``, ``fig6``).

This is the baseline, not a kernel port: the reference computes it outside
any Pallas kernel, so it stays plain PyTorch on every device, and its
E-step is autograd through ``torch.logsumexp``.
"""

from __future__ import annotations

import torch

from repro_torch.core.einet import EiNet


def log_einsum_exp_naive(w: torch.Tensor, ln_left: torch.Tensor,
                         ln_right: torch.Tensor) -> torch.Tensor:
    """Steps 1-3 above: explicit products + K^3-exp log-sum-exp.
    (L, K_out, K, K) weights, (B, L, K) children -> (B, L, K_out)."""
    prod = ln_left[:, :, :, None] + ln_right[:, :, None, :]  # (B, L, K, K)
    logw = torch.log(torch.clamp(w, min=1e-38))  # (L, K_out, K, K)
    t = logw[None] + prod[:, :, None, :, :]  # (B, L, K_out, K, K), stored
    b, l, k_out = t.shape[:3]
    return torch.logsumexp(t.reshape(b, l, k_out, -1), dim=-1)


class NaiveEiNet(EiNet):
    """EiNet structure evaluated with the naive LibSPN/SPFlow-style layers.

    The same constructor, structure, parameters, queries, sampling and
    E-step as :class:`EiNet`; only the pair computation differs.  Its plan
    is all per-layer (``grouped=False``), so no grouped kernel runs, and
    every pair is :func:`log_einsum_exp_naive`: the reference's
    ``impl="naive"``, where a fused or gather run is the chain of naive
    pairs and the mixing layers between them."""

    def __init__(self, *args, **kwargs):
        kwargs["grouped"] = False
        super().__init__(*args, **kwargs)

    def pair_log_einsum_exp(self, w, ln_left, ln_right):
        return log_einsum_exp_naive(w, ln_left, ln_right)
