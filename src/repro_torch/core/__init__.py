"""Paper core: Einsum Networks (Peharz et al., ICML 2020) in PyTorch.

The names of the reference's ``repro.core``.  The model
(``core.einet.EiNet``), the naive baseline (``core.baseline.NaiveEiNet``)
and the EM functions (``core.em``) are loaded on first access: the kernel
modules import ``core.layers``, and the model imports the kernels, so this
package cannot import the model while it is itself imported.
"""

import importlib

from repro_torch.core.exponential_family import (
    Bernoulli,
    Binomial,
    Categorical,
    Normal,
    make_exponential_family,
)
from repro_torch.core.region_graph import (
    RegionGraph,
    assign_replicas,
    poon_domingos,
    random_binary_trees,
    topological_layers,
)

_LAZY = {
    "EiNet": "einet", "QUERY_KINDS": "einet", "NaiveEiNet": "baseline",
    **{name: "em" for name in (
        "EMConfig", "accumulate_statistics", "blend_params", "em_statistics",
        "em_update", "m_step", "stochastic_em_update",
        "zeros_like_statistics")},
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = [
    *_LAZY,
    "Normal",
    "Bernoulli",
    "Binomial",
    "Categorical",
    "make_exponential_family",
    "RegionGraph",
    "random_binary_trees",
    "poon_domingos",
    "topological_layers",
    "assign_replicas",
]
