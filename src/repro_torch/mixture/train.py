"""Multi-component EM: train the C EiNets of a mixture.

Training a mixture of EiNets is embarrassingly parallel over the component
axis: the C components differ only in parameter values, which
:class:`~repro_torch.mixture.model.EiNetMixture` stacks on a leading axis.
Two regimes:

  * **hard** (the paper's CelebA protocol): the data is pre-partitioned by
    k-means (``repro_torch.mixture.cluster``); each component runs the
    single-model EM update on ITS cluster's batch.  The reference vmaps
    that update over the stack; here it is a loop over components of the
    port's ``{stochastic_,}em_update_microbatched`` on the bound component
    (``EiNetMixture.bound``), so it is bit for bit the single-model step.
  * **soft**: full-mixture responsibility-weighted EM.  Because the
    mixture's top level routes through ``log_mix_exp`` (one mixing cell),
    the paper's EM-via-autodiff observation extends verbatim: ONE
    ``torch.autograd.grad`` of the summed mixture log-likelihood yields
    every component's statistics already weighted by its responsibilities
    r[b, c] = p(c | x_b), plus ``w * dL/dw = sum_b r[b, c]`` for the
    mixture weights.  No explicit E-step posterior pass exists anywhere.

Both reuse ``repro_torch.core.em`` and ``repro_torch.train``: the shared
M-step and blend, microbatch accumulation in order.  Updates return new
parameter dicts in the reference's layout (``{"components": {...},
"mixture_weights": (C,)}``, every component tensor with its leading C
axis) and change nothing; the step of ``make_mixture_em_step`` writes them
into the mixture in place.  The reference's compiled-program registry has
no counterpart: PyTorch runs the step eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.em import (
    EMConfig,
    accumulate_statistics,
    blend_params,
    leaf_statistics,
    load_params,
    m_step,
    params_of,
)
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.mixture.cluster import cluster_order, kmeans
from repro_torch.mixture.model import _W_FLOOR, EiNetMixture, component_slice
from repro_torch.train.pipeline import (
    em_update_microbatched,
    split_microbatches,
    stochastic_em_update_microbatched,
)

_COMPONENT_KEYS = ("n_einsum", "n_mixing", "s_phi", "s_den", "n_class")


@dataclasses.dataclass(frozen=True)
class MixtureTrainConfig:
    """One mixture EM step.

    assign: "hard" (per-cluster EM on a stacked (C, B, D) batch) or "soft"
      (responsibility-weighted full-mixture EM on a shared (B, D) batch).
    mode: "stochastic" (Sato blend, Eqs. 8/9) or "full" (exact M-step --
      monotone on the batch in soft mode).
    weight_alpha: Laplace smoothing on the mixture-weight statistics (soft
      mode; hard mode keeps the k-means cluster proportions fixed).
    num_microbatches: as in ``repro_torch.train.TrainConfig``.
    """

    em: EMConfig = EMConfig()
    assign: str = "hard"  # hard | soft
    mode: str = "stochastic"  # stochastic | full
    num_microbatches: int = 1
    weight_alpha: float = 1e-4


def mixture_params_of(mix: EiNetMixture) -> Dict[str, Any]:
    """The mixture's parameters in the reference's layout (detached views,
    not copies)."""
    return {"components": params_of(mix),
            "mixture_weights": mix.mixture_weights.detach()}


@torch.no_grad()
def load_mixture_params(mix: EiNetMixture, params: Dict[str, Any]) -> None:
    """Copy a parameter dict (the reference's layout) into the mixture's
    stacked parameters, in place."""
    load_params(mix, params["components"])
    mix.mixture_weights.copy_(params["mixture_weights"])


def _stack(per_comp: List[Dict[str, Any]]) -> Dict[str, Any]:
    """C single-model parameter dicts -> one dict with a leading C axis."""
    first = per_comp[0]
    return {
        key: ([torch.stack([p[key][i] for p in per_comp])
               for i in range(len(val))] if isinstance(val, list)
              else torch.stack([p[key] for p in per_comp]))
        for key, val in first.items()
    }


# ---------------------------------------------------------------- soft E-step
def mixture_em_statistics(mix: EiNetMixture,
                          x: torch.Tensor) -> Dict[str, Any]:
    """Responsibility-weighted E-step statistics for every component, via one
    ``torch.autograd.grad`` of the MIXTURE log-likelihood.

    Returns the single-model statistics dict with a leading component axis on
    every tensor, plus ``n_weight`` (C,) = sum_b r[b, c].  Each component's
    leaf rows are built under ``no_grad``, one component at a time (its EF
    tensor is (B, D, K, R)), as ``em.em_statistics`` builds them.
    """
    c_n = mix.num_components
    with torch.no_grad():
        leaf_rows = []
        for c in range(c_n):
            with mix.bound(c) as net:
                leaf_rows.append(net._leaf_rows(net.leaf_log_prob(x, None)))
    einsum_w = list(mix.einsum)
    mixing_v = list(mix.mixing)
    with torch.enable_grad():
        lrs = [lr.requires_grad_(True) for lr in leaf_rows]
        logprior = torch.log(mix.class_prior.detach()).requires_grad_(True)
        weights = mix.mixture_weights.detach().requires_grad_(True)
        comp_ll = []
        for c in range(c_n):
            with mix.bound(c) as net:
                root = net.forward_from_e(None, leaf_rows=lrs[c])
            comp_ll.append(torch.logsumexp(root + logprior[c][None, :], -1))
        val = mix.mix_log_likelihoods(weights,
                                      torch.stack(comp_ll, dim=1)).sum()
        grads = torch.autograd.grad(
            val, einsum_w + mixing_v + lrs + [logprior, weights],
            allow_unused=True)
    n = len(einsum_w)
    g_einsum, g_mixing = grads[:n], grads[n: 2 * n]
    g_leaf = grads[2 * n: 2 * n + c_n]
    g_prior, g_w = grads[-2], grads[-1]
    with torch.no_grad():
        # dL/dW of the routed mixture LL carries the r[b, c] factor that the
        # top-level log_mix_exp backward hands each component's cotangent
        n_einsum = [w.detach() * g for w, g in zip(einsum_w, g_einsum)]
        n_mixing = [v.detach() * (torch.zeros_like(v) if g is None else g)
                    for v, g in zip(mixing_v, g_mixing)]
        net = mix.component
        t = net.ef.sufficient_statistics(x)  # shared across components
        leaf = [leaf_statistics(net, t, g) for g in g_leaf]
    return {
        "n_einsum": n_einsum,
        "n_mixing": n_mixing,
        "s_phi": torch.stack([s for s, _ in leaf]),  # (C, D, K, R, |T|)
        "s_den": torch.stack([d for _, d in leaf]),  # (C, D, K, R)
        "n_class": g_prior,  # (C, num_classes)
        "n_weight": weights.detach() * g_w,  # (C,) = sum_b r[b, c]
        "ll": val.detach(),
        "count": torch.tensor(float(x.shape[0]), device=x.device),
    }


def zeros_like_mixture_statistics(mix: EiNetMixture) -> Dict[str, Any]:
    dev = mix.device
    c, d, k, r = mix.phi.shape[:4]
    tdim = mix.component.ef.num_stats
    return {
        "n_einsum": [torch.zeros_like(w) for w in mix.einsum],
        "n_mixing": [torch.zeros_like(v) for v in mix.mixing],
        "s_phi": torch.zeros((c, d, k, r, tdim), device=dev),
        "s_den": torch.zeros((c, d, k, r), device=dev),
        "n_class": torch.zeros_like(mix.class_prior),
        "n_weight": torch.zeros((c,), device=dev),
        "ll": torch.zeros((), device=dev),
        "count": torch.zeros((), device=dev),
    }


def microbatched_mixture_em_statistics(
    mix: EiNetMixture, x: torch.Tensor, num_microbatches: int = 1
) -> Dict[str, Any]:
    """Soft statistics summed over ``num_microbatches`` equal pieces in order
    (sums over data, so microbatching is exact to float32 rounding)."""
    if num_microbatches == 1:
        return mixture_em_statistics(mix, x)
    acc = zeros_like_mixture_statistics(mix)
    for xb in split_microbatches(x, num_microbatches):
        acc = accumulate_statistics(acc, mixture_em_statistics(mix, xb))
    return acc


@torch.no_grad()
def mixture_m_step(
    mix: EiNetMixture,
    stats: Dict[str, Any],
    cfg: EMConfig,
    weight_alpha: float = 1e-4,
) -> Dict[str, Any]:
    """Per-component exact M-step + mixture-weight renormalisation."""
    per_comp = {key: stats[key] for key in _COMPONENT_KEYS}
    comps = _stack([m_step(mix.component, component_slice(per_comp, c), cfg)
                    for c in range(mix.num_components)])
    nw = stats["n_weight"] + weight_alpha
    return {"components": comps, "mixture_weights": nw / torch.sum(nw)}


def mixture_em_update(
    mix: EiNetMixture,
    x: torch.Tensor,
    cfg: MixtureTrainConfig = MixtureTrainConfig(assign="soft", mode="full"),
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One full soft-EM update (monotone on the batch).  Returns (new params,
    mean mixture log-likelihood); the mixture is unchanged."""
    stats = microbatched_mixture_em_statistics(mix, x, cfg.num_microbatches)
    new = mixture_m_step(mix, stats, cfg.em, cfg.weight_alpha)
    return new, stats["ll"] / stats["count"]


def stochastic_mixture_em_update(
    mix: EiNetMixture,
    x: torch.Tensor,
    cfg: MixtureTrainConfig = MixtureTrainConfig(assign="soft"),
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Sato online soft EM: per-component blend + linear weight blend."""
    mini, ll = mixture_em_update(mix, x, cfg)
    return blend_mixture_params(mix, mini, cfg.em.step_size), ll


@torch.no_grad()
def blend_mixture_params(mix: EiNetMixture, mini: Dict[str, Any],
                         step_size: float) -> Dict[str, Any]:
    """Sato's blend (Eqs. 8/9) of the mixture's parameters towards
    ``mini``: each component's (``em.blend_params``) and the weights'."""
    lam = step_size
    old = mixture_params_of(mix)
    # the blend and phi's projection are elementwise, so one call over the
    # stacked components is the per-component blend
    comps = blend_params(mix.component, old["components"],
                         mini["components"], lam)
    w = (1.0 - lam) * old["mixture_weights"] + lam * mini["mixture_weights"]
    return {"components": comps, "mixture_weights": w}


# ---------------------------------------------------------------- hard E-step
def hard_mixture_em_update(
    mix: EiNetMixture,
    x_stacked: torch.Tensor,
    cfg: MixtureTrainConfig = MixtureTrainConfig(),
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Per-cluster EM: component c updates on its own batch ``x_stacked[c]``.

    A loop of the single-model update over the bound components, bit for
    bit C separate ``{stochastic_,}em_update_microbatched`` calls.  Mixture
    weights stay fixed (they are the k-means cluster proportions -- the
    stacked equal-size batches carry no size signal).  Returns (new params,
    weight-averaged per-cluster mean LL); the mixture is unchanged.
    """
    if x_stacked.dim() != 3 or x_stacked.shape[0] != mix.num_components:
        raise ValueError(
            f"hard mixture EM needs a (C={mix.num_components}, B, D) stacked "
            f"batch; got {tuple(x_stacked.shape)}"
        )
    update = (stochastic_em_update_microbatched if cfg.mode == "stochastic"
              else em_update_microbatched)
    news, lls = [], []
    for c in range(mix.num_components):
        with mix.bound(c) as net:
            new, ll = update(net, x_stacked[c], cfg.em, cfg.num_microbatches)
        news.append(new)
        lls.append(ll)
    w = mix.mixture_weights.detach()
    ll = torch.sum(w * torch.stack(lls)) / torch.clamp(torch.sum(w),
                                                        min=_W_FLOOR)
    return {"components": _stack(news), "mixture_weights": w.clone()}, ll


# ---------------------------------------------------------------------- step
def make_mixture_em_step(
    mix: EiNetMixture, cfg: MixtureTrainConfig = MixtureTrainConfig()
) -> Callable[[torch.Tensor], float]:
    """The mixture EM step ``step(x) -> mean LL`` (a float, so the step has
    finished on the device when it returns), which writes the new
    parameters into the mixture IN PLACE.  ``assign="hard"`` expects a
    stacked (C, B, D) batch (:func:`stacked_cluster_loader`);
    ``assign="soft"`` a shared (B, D) batch."""
    if cfg.assign not in ("hard", "soft"):
        raise ValueError(f"unknown assign {cfg.assign!r}; 'hard' or 'soft'")
    if cfg.mode not in ("stochastic", "full"):
        raise ValueError(f"unknown mode {cfg.mode!r}; 'stochastic' or 'full'")
    if cfg.assign == "hard":
        update = hard_mixture_em_update
    elif cfg.mode == "stochastic":
        update = stochastic_mixture_em_update
    else:
        update = mixture_em_update

    def step(x: torch.Tensor) -> float:
        new, ll = update(mix, x, cfg)
        load_mixture_params(mix, new)
        return float(ll)

    return step


# -------------------------------------------------------------------- loaders
def stacked_cluster_loader(
    data: np.ndarray,
    assignments: np.ndarray,
    num_clusters: int,
    per_component_batch: int,
    num_shards: int = 1,
    shard_id: int = 0,
    start_step: int = 0,
) -> ShardedLoader:
    """``ShardedLoader`` of stacked per-cluster batches {"x": (C, B, D)}.

    Component c's rows tile ITS cluster with the same contiguous
    block-mod-N scheme as ``repro_torch.data.datasets.array_loader`` (shards
    within a step are disjoint per cluster, steps tile each cluster).
    Empty clusters fall back to tiling the whole dataset -- their mixture
    weight is ~0, so the rows only keep shapes static.
    """
    order, offsets = cluster_order(assignments, num_clusters)
    idx = [
        order[offsets[c]: offsets[c + 1]] for c in range(num_clusters)
    ]
    idx = [i if len(i) else np.arange(len(data)) for i in idx]

    def make(step: int, shard: int, n: int) -> Dict[str, np.ndarray]:
        out = np.empty(
            (num_clusters, n) + data.shape[1:], dtype=np.float32
        )
        base = (step * num_shards + shard) * n
        for c in range(num_clusters):
            rows = idx[c][(np.arange(n) + base) % len(idx[c])]
            out[c] = data[rows]
        return {"x": out}

    return ShardedLoader(
        make, per_component_batch * num_shards, num_shards=num_shards,
        shard_id=shard_id, start_step=start_step,
    )


# full-batch Lloyd below this many rows; deterministic contiguous-block
# minibatches above it (one threshold for every §4.2 entry point)
KMEANS_MINIBATCH_THRESHOLD = 8192


def prepare_mixture_training(
    mix: EiNetMixture,
    data: np.ndarray,
    seed: int = 0,
    global_batch: int = 512,
    kmeans_iters: int = 25,
):
    """THE §4.2 hard-EM setup: k-means the data on the mixture's device
    (minibatched past :data:`KMEANS_MINIBATCH_THRESHOLD` rows), initialise
    the mixture from ``seed`` with the Laplace-smoothed cluster proportions
    as its weights (in place), and build the stacked per-cluster loader with
    per-component batch ``max(min(global_batch, N) // C, 4)``.

    Returns (loader, KMeansResult).
    """
    c = mix.num_components
    km = kmeans(
        data, c, num_iters=kmeans_iters,
        batch=None if len(data) <= KMEANS_MINIBATCH_THRESHOLD
        else KMEANS_MINIBATCH_THRESHOLD,
        seed=seed, device=mix.device,
    )
    mix.init_params(torch.Generator().manual_seed(int(seed)))
    # alpha=1.0: an empty cluster keeps (negligible) mass, so the log-domain
    # weight routing never sees an exact zero
    with torch.no_grad():
        mix.mixture_weights.copy_(torch.from_numpy(km.weights(alpha=1.0)))
    per_comp = max(min(global_batch, len(data)) // c, 4)
    loader = stacked_cluster_loader(data, km.assignments, c, per_comp)
    return loader, km


def fit_mixture(
    mix: EiNetMixture,
    batches: Iterable[Any],
    cfg: MixtureTrainConfig = MixtureTrainConfig(),
    num_steps: Optional[int] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> List[float]:
    """Run the mixture step over an iterable of batches (dicts with an "x"
    key, or arrays / tensors), updating ``mix`` in place.  Returns the
    per-step mean LLs.  Steps are timed into ``train.step.seconds`` and
    their rows (all components') counted in ``train.examples.count``, as
    ``repro_torch.train.fit`` does."""
    step = make_mixture_em_step(mix, cfg)
    lls: List[float] = []
    for i, batch in enumerate(batches):
        if num_steps is not None and i >= num_steps:
            break
        x = torch.as_tensor(batch["x"] if isinstance(batch, dict) else batch,
                            device=mix.device)
        with obs.timed("train.step", metric="train.step.seconds"):
            lls.append(step(x))
        obs.METRICS.counter("train.examples.count").inc(
            x.shape[:-1].numel())
        obs.METRICS.gauge("train.ll.last").set(lls[-1])
        if on_step is not None:
            on_step(i, lls[-1])
    return lls
