"""The EM training step: E-step statistics accumulated over microbatches,
the M-step, and for stochastic EM the Sato blend, applied to the module.

The reference compiles the whole update into one donated-buffer XLA program
and folds the microbatches with ``lax.scan``.  PyTorch runs eagerly: the
microbatch fold is a Python loop that adds the statistics in microbatch
order, and the step writes the new parameters into the module in place
(``copy_`` under ``no_grad``), which is what donation bought the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from repro_torch.core.einet import EiNet
from repro_torch.core.em import (
    EMConfig,
    accumulate_statistics,
    blend_params,
    em_statistics,
    load_params,
    m_step,
    params_of,
    zeros_like_statistics,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One EM update step.

    mode: "stochastic" (Sato online EM, the paper's minibatch training) or
      "full" (exact M-step from the whole batch).
    num_microbatches: split the batch into this many pieces; bounds
      activation memory at batch / num_microbatches rows while keeping the
      statistics exact (they are sums over data).
    """

    em: EMConfig = EMConfig()
    mode: str = "stochastic"  # "stochastic" | "full"
    num_microbatches: int = 1


def split_microbatches(x: torch.Tensor, num_microbatches: int):
    """``x`` as ``num_microbatches`` equal pieces along its first axis, in
    order; raises when the batch does not divide."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {num_microbatches} microbatches")
    return x.split(b // num_microbatches)


def microbatched_em_statistics(model: EiNet, x: torch.Tensor,
                               num_microbatches: int = 1) -> Dict[str, Any]:
    """E-step statistics for ``x``, summed over ``num_microbatches`` equal
    pieces in order (the same totals as one call, to float32 rounding)."""
    if num_microbatches == 1:
        return em_statistics(model, x)
    acc = zeros_like_statistics(model)
    for xb in split_microbatches(x, num_microbatches):
        acc = accumulate_statistics(acc, em_statistics(model, xb))
    return acc


def em_update_microbatched(model: EiNet, x: torch.Tensor,
                           cfg: EMConfig = EMConfig(),
                           num_microbatches: int = 1):
    """One full EM update (monotone on the batch), microbatch-accumulated.
    Returns (new params dict, mean LL); the module is unchanged."""
    stats = microbatched_em_statistics(model, x, num_microbatches)
    return m_step(model, stats, cfg), stats["ll"] / stats["count"]


def stochastic_em_update_microbatched(model: EiNet, x: torch.Tensor,
                                      cfg: EMConfig = EMConfig(),
                                      num_microbatches: int = 1):
    """Sato online EM (Eqs. 8/9) with microbatch-accumulated statistics.
    Returns (new params dict, mean LL); the module is unchanged."""
    stats = microbatched_em_statistics(model, x, num_microbatches)
    mini = m_step(model, stats, cfg)
    new = blend_params(model, params_of(model), mini, cfg.step_size)
    return new, stats["ll"] / stats["count"]


def make_em_step(model: EiNet,
                 cfg: TrainConfig = TrainConfig()) -> Callable[[torch.Tensor], float]:
    """The training step ``step(x) -> mean LL of x`` (a float, so the step
    has finished on the device when it returns).  It computes the
    statistics and the new parameters from the current ones, then updates
    the module's parameters IN PLACE."""
    if cfg.mode not in ("stochastic", "full"):
        raise ValueError(f"unknown mode {cfg.mode!r}; 'stochastic' or 'full'")
    update = (stochastic_em_update_microbatched if cfg.mode == "stochastic"
              else em_update_microbatched)

    def step(x: torch.Tensor) -> float:
        new, ll = update(model, x, cfg.em, cfg.num_microbatches)
        load_params(model, new)
        return float(ll)

    return step


def fit(model: EiNet, batches: Iterable[Any], cfg: TrainConfig = TrainConfig(),
        num_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """Run the step over an iterable of (B, D) tensors (or dicts with an
    "x" key), updating ``model`` in place.  Returns the per-step mean LLs."""
    step = make_em_step(model, cfg)
    lls: List[float] = []
    for i, batch in enumerate(batches):
        if num_steps is not None and i >= num_steps:
            break
        x = batch["x"] if isinstance(batch, dict) else batch
        lls.append(step(x))
        if on_step is not None:
            on_step(i, lls[-1])
    return lls
