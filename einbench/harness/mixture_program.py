"""The system under test for a mixture of EiNets: the port's §4.2 mixture
(``repro_torch.mixture``), reached through its public entry points only,
as ``harness.program`` reaches a single EiNet.  The benchmark takes from
it the mixture and its EM step; it takes no weights, tables or reference
numbers from it."""

from __future__ import annotations

import dataclasses
from typing import Dict

from harness.program import _path


def build_mixture(cfg: Dict, num_components: int, device):
    """``num_components`` of the configuration's EiNets as one mixture on
    ``device``, through ``launch.cells.build_mixture`` (the program
    initialises it from its fixed seed 0; the benchmark then loads its own
    weights)."""
    _path()
    from repro_torch.configs import EinetConfig
    from repro_torch.launch.cells import build_mixture as build

    fields = {f.name for f in dataclasses.fields(EinetConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in fields}
    return build(EinetConfig(**kw), int(num_components), device=device, seed=0)


def make_mixture_em_step(mix, em: Dict, weight_alpha: float,
                         microbatches: int):
    """``make_mixture_em_step``'s soft step: stochastic EM of the whole
    mixture on a shared batch."""
    _path()
    from repro_torch.core.em import EMConfig
    from repro_torch.mixture.train import MixtureTrainConfig
    from repro_torch.mixture.train import make_mixture_em_step as make

    cfg = MixtureTrainConfig(em=EMConfig(**em), assign="soft",
                             mode="stochastic",
                             weight_alpha=float(weight_alpha),
                             num_microbatches=int(microbatches))
    return make(mix, cfg)


def mixture_params_of(mix) -> Dict:
    """``{"components": the stacked component parameters, "mixture_weights":
    (C,)}``: views of the mixture's tensors."""
    _path()
    from repro_torch.mixture.train import mixture_params_of as of

    return of(mix)


def load_mixture_params(mix, params: Dict) -> None:
    _path()
    from repro_torch.mixture.train import load_mixture_params as load

    load(mix, params)
