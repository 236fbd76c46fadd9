"""The einsum layer and mixing layer (paper §3.2, §3.3, Appendix B): the
plain PyTorch path.

Everything probabilistic lives in the log-domain; the weight tensors live in
the *linear* domain.  Numerical stability comes from the paper's
log-einsum-exp trick (Eq. 4): subtract per-row maxes before ``exp`` so the
einsum contracts numbers in (0, 1], then add the maxes back after the ``log``.

``log_einsum_exp`` and ``grouped_log_einsum_exp`` here are the plain
versions of the port's two forward kernels (``repro_torch.kernels``): the
kernel wrappers run them for CPU tensors, and the tests and ``chip_smoke.py``
hold the kernels against them.  ``log_mix_exp`` has no kernel (the
reference runs it as an XLA op with a custom VJP), so this is its only
implementation, forward and backward.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Large-negative stand-in for log(0): keeps gradients finite where -inf
# would produce NaNs through max/exp.
NEG_INF = -1e30


def stabilized_frame(ln_left: torch.Tensor, ln_right: torch.Tensor):
    """The log-einsum-exp trick's frame (Eq. 4): the row maxes clamped at
    NEG_INF and the exp'd inputs, each in (0, 1].  Shared by the forward and
    the backward, so the backward works in the frame the forward logged."""
    a = torch.clamp(torch.amax(ln_left, dim=-1, keepdim=True), min=NEG_INF)
    ap = torch.clamp(torch.amax(ln_right, dim=-1, keepdim=True), min=NEG_INF)
    return a, ap, torch.exp(ln_left - a), torch.exp(ln_right - ap)


def cell_sums(w: torch.Tensor, el: torch.Tensor,
              er: torch.Tensor) -> torch.Tensor:
    """s[b,l,k] = sum_i el[b,l,i] (sum_j W[l,k,i,j] er[b,l,j]): (B, L, K_out).

    Written as elementwise multiply-adds in a fixed (j, then i) order rather
    than one einsum: the CPU's batched matrix products round a row
    differently depending on how many rows share the call, and a row's
    result must depend on that row alone (the serving engine pads batches).
    The transient is (B, L, K_out, K)."""
    k = w.shape[-1]
    t = w[None, ..., 0] * er[:, :, None, None, 0]
    for j in range(1, k):
        t = t + w[None, ..., j] * er[:, :, None, None, j]
    s = t[..., 0] * el[:, :, None, 0]
    for i in range(1, k):
        s = s + t[..., i] * el[:, :, None, i]
    return s


def log_einsum_exp(w: torch.Tensor, ln_left: torch.Tensor,
                   ln_right: torch.Tensor) -> torch.Tensor:
    """Eq. (5) with the log-einsum-exp trick of Eq. (4).

    Args:
      w:        (L, K_out, K, K) linear-domain weights, normalized over (i, j).
      ln_left:  (B, L, K) log-densities of the "left" product children.
      ln_right: (B, L, K) log-densities of the "right" product children.

    Returns:
      (B, L, K_out) log-densities  log S[b,l,k] = log sum_ij W[l,k,i,j]
                                                  exp(ln_left[b,l,i])
                                                  exp(ln_right[b,l,j]).

    Fully-marginalized rows, whose max is -inf, take the NEG_INF clamp.
    """
    a, ap, el, er = stabilized_frame(ln_left, ln_right)
    return a + ap + torch.log(cell_sums(w, el, er))


def grouped_log_einsum_exp(ws: Sequence[torch.Tensor],
                           x: torch.Tensor) -> torch.Tensor:
    """One fused execution segment: a run of consecutive CANONICAL einsum
    layers (left = rows [0, L), right = rows [L, 2L) of the layer below),
    applied bottom-up to ``x`` (B, 2 * L_first, K), as the chained per-depth
    op.  Returns (B, L_last, K_out_last)."""
    cur = x
    for w in ws:
        half = w.shape[0]
        cur = log_einsum_exp(w, cur[:, :half], cur[:, half: 2 * half])
    return cur


# Floor for the stabilized sum when dividing a backward cotangent: a NORMAL
# float32 (the reference's _S_FLOOR), so fully saturated rows, whose sum is
# exactly 0, give finite gradients.
S_FLOOR = 1e-30


def mix_frame(v, ln, mask):
    """The mixing layer's frame: clamped max over the children, the exp'd
    (masked) inputs and the stabilized sum, added in child order.  Shared
    by the forward, its backward and the gather-grouped backward's plain
    version, so each works in the frame the forward logged."""
    lnm = torch.where(mask[None, :, :, None] > 0, ln,
                      torch.full_like(ln, NEG_INF))
    a = torch.clamp(torch.amax(lnm, dim=2, keepdim=True), min=NEG_INF)
    e = torch.exp(lnm - a)  # (B, M, C, K)
    terms = v[None] * e
    s = terms[:, :, 0]
    for c in range(1, terms.shape[2]):
        s = s + terms[:, :, c]
    return a, e, s


class _LogMixExp(torch.autograd.Function):
    """The reference's custom VJP (``repro/core/layers.py`` ``_lme_bwd``):
    the backward recomputes the frame from (v, ln, mask) and emits

        dv[m,c,k]    = sum_b g[b,m,k] exp(ln[b,m,c,k] - a) / s
        dln[b,m,c,k] = g[b,m,k] v[m,c,k] exp(ln[b,m,c,k] - a) / s

    with padded children zeroed: on fully marginalized NEG_INF rows
    exp(ln - a) = 1 even where mask == 0."""

    @staticmethod
    def forward(ctx, v, ln, mask):
        ctx.save_for_backward(v, ln, mask)
        a, _, s = mix_frame(v, ln, mask)
        return a[:, :, 0, :] + torch.log(s)

    @staticmethod
    def backward(ctx, g):
        v, ln, mask = ctx.saved_tensors
        _, e, s = mix_frame(v, ln, mask)
        ginv = g / torch.clamp(s, min=S_FLOOR)  # (B, M, K)
        ge = ginv[:, :, None, :] * e * mask[None, :, :, None]
        return ge.sum(0), ge * v[None], None


def log_mix_exp(v: torch.Tensor, ln: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mixing layer (Appendix B): element-wise mixtures over C children.

    Args:
      v:    (M, C, K) linear-domain mixing weights, normalized over C;
            padded children carry zero weight.
      ln:   (B, M, C, K) log-densities of the C simple-sum children.
      mask: (M, C) 1.0 for real children, 0.0 for padding.

    Returns:
      (B, M, K) log-densities  log sum_c v[m,c,k] exp(ln[b,m,c,k]).

    The sum over C runs as elementwise adds in child order, so a row's
    result does not depend on how many rows share the call.  Under autograd
    it is a ``torch.autograd.Function`` with the reference's residual-
    recompute backward; it has no kernel, on the card or off it.
    """
    if torch.is_grad_enabled() and (v.requires_grad or ln.requires_grad):
        return _LogMixExp.apply(v, ln, mask)
    a, _, s = mix_frame(v, ln, mask)
    return a[:, :, 0, :] + torch.log(s)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in (0, 1): argmax(logits + gumbel)
    draws from the categorical distribution of ``logits``."""
    return -torch.log(-torch.log(u))


def normalize_einsum_weights(w: torch.Tensor,
                             floor: float = 1e-12) -> torch.Tensor:
    """Project W onto the simplex over its last two axes (sum-weight constraint)."""
    w = torch.clamp(w, min=floor)
    return w / torch.sum(w, dim=(-2, -1), keepdim=True)


def normalize_mixing_weights(v: torch.Tensor, mask: torch.Tensor,
                             floor: float = 1e-12) -> torch.Tensor:
    """Project V onto the simplex over the child axis, respecting padding."""
    v = torch.clamp(v, min=floor) * mask[:, :, None]
    return v / torch.sum(v, dim=1, keepdim=True)
