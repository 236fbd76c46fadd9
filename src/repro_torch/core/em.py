"""Expectation-Maximization via automatic differentiation (paper §3.5).

For a log-output circuit,

    dlogP/dw_{S,N} * w_{S,N}  =  (1/P) dP/dS N  =  n_{S,N}(x)      (Eq. 6)
    dlogP/dlogL               =  (1/P) dP/dL L  =  p_L(x)

so the whole E-step is one ``torch.autograd.grad`` of the batch
log-likelihood, with the sum over the data done by autodiff itself.  On the
card that backward pass runs the hand-written backward kernels
(``repro_torch.kernels``).  The M-step is a renormalisation (sums) and a
weighted moment average (EF leaves, Eq. 7).

Two training modes:
  * ``em_update``            -- full/minibatch statistics, exact M-step.
  * ``stochastic_em_update`` -- Sato (1999) online EM:
    p <- (1 - l) p + l p_mini (Eqs. 8/9).

Parameters are the ``EiNet`` module's own; the updates here return new
parameter dicts in the reference's layout (``phi``, ``einsum``, ``mixing``,
``class_prior``) and change nothing.  ``load_params`` writes one into the
module.  The reference's psum over data axes is the sharded step's
``reduce`` stage (``repro_torch.train.pipeline.make_sharded_em_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.core.einet import EiNet
from repro_torch.core.layers import (
    normalize_einsum_weights,
    normalize_mixing_weights,
)
from repro_torch.kernels import ops
from repro_torch.kernels.leaf_stats import pair_scatter


@dataclasses.dataclass(frozen=True)
class EMConfig:
    laplace_alpha: float = 1e-4  # Laplace smoothing on sum-weight statistics
    stat_floor: float = 1e-12
    step_size: float = 0.5  # lambda for stochastic EM (paper uses 0.5)


def params_of(model: EiNet) -> Dict[str, Any]:
    """The module's parameters in the reference's dict layout (detached
    views, not copies).  An ``EiNetMixture`` has the same names with a
    leading component axis, so this also gives its stacked components."""
    return {
        "phi": model.phi.detach(),
        "einsum": [w.detach() for w in model.einsum],
        "mixing": [v.detach() for v in model.mixing],
        "class_prior": model.class_prior.detach(),
    }


@torch.no_grad()
def load_params(model: EiNet, params: Dict[str, Any]) -> None:
    """Copy a parameter dict into the module's parameters (or a mixture's
    stacked components), in place."""
    model.phi.copy_(params["phi"])
    for p, new in zip(model.einsum, params["einsum"]):
        p.copy_(new)
    for p, new in zip(model.mixing, params["mixing"]):
        p.copy_(new)
    model.class_prior.copy_(params["class_prior"])


def leaf_scatter(model: EiNet, s_phi_pairs: torch.Tensor,
                 s_den_pairs: torch.Tensor):
    """Fan per-pair leaf statistics (in the model's pair order) out to
    parameter layout: (P, K, |T|) -> (D, K, R, |T|) and (P, K) -> (D, K, R),
    the plain path's scatter (``kernels.leaf_stats.pair_scatter``)."""
    r = model.leaf_spec.num_replica
    flat = model.leaf_pair_var * r + model.leaf_pair_rep  # unique per pair
    return pair_scatter(flat, s_phi_pairs, s_den_pairs, model.num_vars, r)


def variable_major_statistics(model: EiNet, x: torch.Tensor) -> torch.Tensor:
    """The batch's sufficient statistics t (B, D, |T|) laid out
    variable-major, as the leaf-statistics kernel reads them: a transposed
    view of a contiguous (D, B, |T|) tensor, so that a variable's rows are
    adjacent in memory.  The same values as ``ef.sufficient_statistics(x)``,
    which the family computes from x's transpose."""
    return model.ef.sufficient_statistics(x.t()).contiguous().transpose(0, 1)


@torch.no_grad()
def leaf_statistics(model: EiNet, t: torch.Tensor, g_leaf: torch.Tensor):
    """Leaf statistics from the leaf-row posteriors ``g_leaf`` (B,
    num_leaves, K) and the sufficient statistics ``t`` (B, D, |T|) of the
    batch: s_phi (D, K, R, |T|) = sum_x p_L(x) T(x) and s_den (D, K, R) =
    sum_x p_L(x), each leaf's sums written to every pair of its scope.  One
    ``ops.leaf_stats`` call through the leaf table: on CUDA one kernel that
    builds no per-pair copy and reads t laid out variable-major, as
    :func:`variable_major_statistics` gives it (the kernel refuses another
    layout), on the CPU the plain gather, einsum and scatter."""
    return ops.leaf_stats(g_leaf.contiguous(), t, model.leaf_gather,
                          model.leaf_spec.num_replica)


def em_statistics(model: EiNet, x: torch.Tensor) -> Dict[str, Any]:
    """E-step: expected statistics for every parameter block, via one
    ``torch.autograd.grad`` of the batch-summed log-likelihood with respect
    to the einsum weights, the mixing weights, the leaf rows and the
    log-prior.

    Returns a dict with:
      n_einsum: list of (L, k_out, K, K)    -- sum-node statistics n_{S,N}
      n_mixing: list of (M, C, k_out)       -- (0, 0, k_out) zeros without mixing
      s_phi:    (D, K, R, |T|)              -- sum_x p_L(x) T(x)
      s_den:    (D, K, R)                   -- sum_x p_L(x)
      n_class:  (num_classes,)
      ll:       scalar summed log-likelihood (for monitoring)
      count:    scalar number of rows

    Under a capture observer the backward's nodes go to the layer whose
    output gradient completed last (``plan.segment.bwd``, and after the
    leaf rows' gradient ``layer.leaf.bwd``), and the leaf statistics are a
    ``layer.leaf.bwd`` span too.
    """
    with torch.no_grad():
        # the leaf rows are an input of the differentiated pass, not a
        # function of phi: the leaf-rows op has no backward, and the plain
        # path's gather backward would accumulate with atomics on CUDA
        leaf_rows = model.leaf_rows(x, None)
    einsum_w = list(model.einsum)
    mixing_v = list(model.mixing)
    with torch.enable_grad():
        lr = leaf_rows.requires_grad_(True)
        obs.grad_boundary(lr, "layer.leaf.bwd")
        logprior = torch.log(model.class_prior.detach()).requires_grad_(True)
        root = model.forward_rows(lr)
        val = torch.logsumexp(root + logprior[None, :], dim=-1).sum()
        grads = torch.autograd.grad(
            val, einsum_w + mixing_v + [lr, logprior], allow_unused=True)
    n = len(einsum_w)
    g_einsum, g_mixing = grads[:n], grads[n: 2 * n]
    g_leaf, g_prior = grads[2 * n], grads[2 * n + 1]
    with torch.no_grad():
        with obs.span("layer.leaf.bwd"):
            s_phi, s_den = leaf_statistics(
                model, variable_major_statistics(model, x), g_leaf)
        # sum-node statistics: n = W * dlogP/dW (summed over the batch by AD)
        n_einsum = [w.detach() * g for w, g in zip(einsum_w, g_einsum)]
        n_mixing = [v.detach() * (torch.zeros_like(v) if g is None else g)
                    for v, g in zip(mixing_v, g_mixing)]
    return {
        "n_einsum": n_einsum,
        "n_mixing": n_mixing,
        "s_phi": s_phi,
        "s_den": s_den,
        # dlogP/dlog(prior_c) = sum_x posterior(c | x): expected class counts
        "n_class": g_prior,
        "ll": val.detach(),
        # a fill on the device, not a host-to-device copy: a CUDA graph
        # capture refuses the copy
        "count": torch.full((), float(x.shape[0]), device=x.device),
    }


@torch.no_grad()
def m_step(model: EiNet, stats: Dict[str, Any], cfg: EMConfig,
           mix_masks: Optional[List[torch.Tensor]] = None) -> Dict[str, Any]:
    """Exact M-step from accumulated statistics.  Each block is normalised
    along its non-leading axes only, so the M-step of a leading-axis block
    of the statistics (a rank's model shard) is that block of the full
    M-step; ``mix_masks`` then gives the same block of each pair's mixing
    mask (default: the model's whole masks).  An ``em.mstep`` span."""
    with obs.span("em.mstep"):
        alpha = cfg.laplace_alpha
        einsum_w = [normalize_einsum_weights(n + alpha, floor=cfg.stat_floor)
                    for n in stats["n_einsum"]]
        mixing_v = []
        for i, (n, spec) in enumerate(zip(stats["n_mixing"],
                                          model.pair_specs)):
            if spec.mix_global is None:
                mixing_v.append(n)
            else:
                mask = (model._table(i, "mix_mask") if mix_masks is None
                        else mix_masks[i])
                mixing_v.append(normalize_mixing_weights(
                    n + alpha * mask[:, :, None], mask, floor=cfg.stat_floor))
        den = torch.clamp(stats["s_den"], min=cfg.stat_floor)
        phi = model.ef.project_phi(stats["s_phi"] / den[..., None])
        prior = stats["n_class"] + alpha
        return {
            "phi": phi,
            "einsum": einsum_w,
            "mixing": mixing_v,
            "class_prior": prior / torch.sum(prior),
        }


def em_update(model: EiNet, x: torch.Tensor, cfg: EMConfig = EMConfig()):
    """One full EM update on a batch (monotone on that batch).  Returns
    (new params dict, mean LL as a 0-d tensor); the module is unchanged."""
    stats = em_statistics(model, x)
    return m_step(model, stats, cfg), stats["ll"] / stats["count"]


@torch.no_grad()
def blend_params(model: EiNet, params: Dict[str, Any], mini: Dict[str, Any],
                 step_size: float) -> Dict[str, Any]:
    """Sato online-EM interpolation (Eqs. 8/9):  p <- (1-l) p + l p_mini,
    with phi projected back onto its domain afterwards.  An ``em.blend``
    span."""
    lam = step_size

    def blend(old, new):
        return (1.0 - lam) * old + lam * new

    with obs.span("em.blend"):
        return {
            "phi": model.ef.project_phi(blend(params["phi"], mini["phi"])),
            "einsum": [blend(o, n) for o, n in zip(params["einsum"],
                                                   mini["einsum"])],
            "mixing": [blend(o, n) for o, n in zip(params["mixing"],
                                                   mini["mixing"])],
            "class_prior": blend(params["class_prior"], mini["class_prior"]),
        }


def stochastic_em_update(model: EiNet, x: torch.Tensor,
                         cfg: EMConfig = EMConfig()):
    """Sato-style online EM (Eqs. 8/9): blend the minibatch M-step into the
    module's parameters with step lambda.  Returns (new params dict, mean
    LL); the module is unchanged."""
    mini, ll = em_update(model, x, cfg)
    return blend_params(model, params_of(model), mini, cfg.step_size), ll


def accumulate_statistics(acc: Dict[str, Any],
                          new: Dict[str, Any]) -> Dict[str, Any]:
    """Running sum of E-step statistics across minibatches (full-batch EM on
    datasets that do not fit in one batch)."""
    out = {}
    for key, a in acc.items():
        b = new[key]
        out[key] = ([p + q for p, q in zip(a, b)] if isinstance(a, list)
                    else a + b)
    return out


def zeros_like_statistics(model: EiNet, device=None) -> Dict[str, Any]:
    """Zero statistics of ``model`` on ``device`` (default the model's; the
    "meta" device gives their shapes alone)."""
    dev = model.device if device is None else device
    d, k, r = model.phi.shape[:3]
    tdim = model.ef.num_stats
    return {
        "n_einsum": [torch.zeros(w.shape, device=dev) for w in model.einsum],
        "n_mixing": [torch.zeros(v.shape, device=dev) for v in model.mixing],
        "s_phi": torch.zeros((d, k, r, tdim), device=dev),
        "s_den": torch.zeros((d, k, r), device=dev),
        "n_class": torch.zeros(model.class_prior.shape, device=dev),
        "ll": torch.zeros((), device=dev),
        "count": torch.zeros((), device=dev),
    }
