"""Paper core: Einsum Networks (Peharz et al., ICML 2020) in PyTorch.

The model itself is ``repro_torch.core.einet.EiNet``; it is not re-exported
here because the kernel modules import ``core.layers``, and the model
imports the kernels.
"""

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

__all__ = [
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
