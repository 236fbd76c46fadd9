"""Mixtures of EiNets (paper §4.2): k-means clustering, the stacked-parameter
mixture model, and multi-component EM.

The paper's flagship CelebA result is a mixture of EiNets trained over image
clusters.  Deterministic (minibatch) k-means partitions the data
(``cluster``), ``EiNetMixture`` stacks C architecturally identical
components on a leading parameter axis over one shared structure and routes
``log p`` through ``log_mix_exp`` (``model``), and the EM updates advance
every component -- hard per-cluster EM or soft responsibility-weighted EM,
both via the EM-as-autodiff trick of §3.5 (``train``).
"""

from repro_torch.mixture.cluster import KMeansResult, cluster_order, kmeans
from repro_torch.mixture.model import (
    MIXTURE_COMPONENT_KINDS,
    MIXTURE_QUERY_KINDS,
    EiNetMixture,
)
from repro_torch.mixture.train import (
    MixtureTrainConfig,
    blend_mixture_params,
    fit_mixture,
    hard_mixture_em_update,
    load_mixture_params,
    make_mixture_em_step,
    microbatched_mixture_em_statistics,
    mixture_em_statistics,
    mixture_em_update,
    mixture_m_step,
    mixture_params_of,
    prepare_mixture_training,
    stacked_cluster_loader,
    stochastic_mixture_em_update,
    zeros_like_mixture_statistics,
)

__all__ = [
    "KMeansResult",
    "cluster_order",
    "kmeans",
    "EiNetMixture",
    "MIXTURE_QUERY_KINDS",
    "MIXTURE_COMPONENT_KINDS",
    "MixtureTrainConfig",
    "blend_mixture_params",
    "fit_mixture",
    "hard_mixture_em_update",
    "load_mixture_params",
    "make_mixture_em_step",
    "microbatched_mixture_em_statistics",
    "mixture_em_statistics",
    "mixture_em_update",
    "mixture_m_step",
    "mixture_params_of",
    "prepare_mixture_training",
    "stacked_cluster_loader",
    "stochastic_mixture_em_update",
    "zeros_like_mixture_statistics",
]
