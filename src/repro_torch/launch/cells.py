"""Model construction from a registered config, shared by the launch CLIs."""

from __future__ import annotations

from repro_torch.configs import EinetConfig
from repro_torch.core import Normal, poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.core.exponential_family import make_exponential_family
from repro_torch.mixture.model import EiNetMixture


def build_einet(cfg: EinetConfig, device=None, seed: int = 0,
                grouped: bool = True) -> EiNet:
    """The config's EiNet with parameters initialised from ``seed``, on
    ``device`` (CUDA unless ``device="cpu"``); ``grouped=False`` plans every
    pair as its own layer segment."""
    if cfg.structure == "pd":
        graph = poon_domingos(
            cfg.height, cfg.width, cfg.delta, cfg.num_channels, cfg.pd_axes
        )
    else:
        graph = random_binary_trees(cfg.num_vars, cfg.depth, cfg.num_repetitions)
    if cfg.exponential_family == "normal":
        ef = Normal(min_var=cfg.min_var, max_var=cfg.max_var)
    elif cfg.exponential_family == "binomial":
        # 8-bit image data modelled as counts, the paper's MNIST treatment
        ef = make_exponential_family("binomial", n_trials=255)
    elif cfg.exponential_family == "categorical":
        ef = make_exponential_family("categorical", num_categories=256)
    else:
        raise ValueError(
            f"{cfg.name}: unsupported leaf family {cfg.exponential_family!r}"
        )
    return EiNet(graph, num_sums=cfg.num_sums, num_classes=cfg.num_classes,
                 exponential_family=ef, grouped=grouped, device=device,
                 seed=seed)


def build_mixture(cfg: EinetConfig, num_components: int, device=None,
                  seed: int = 0, grouped: bool = True) -> EiNetMixture:
    """A mixture of ``num_components`` of the config's EiNets (the §4.2
    model) over one shared structure, parameters initialised from ``seed``,
    on ``device`` (CUDA unless ``device="cpu"``)."""
    return EiNetMixture(build_einet(cfg, device=device, seed=seed,
                                    grouped=grouped),
                        num_components, seed=seed)
