"""Architecture registry: ``--arch <id>`` resolves here.

A copy of the reference's five ``EinetConfig``s (``repro/configs``), so the
port never imports the JAX package.
"""

from repro_torch.configs.base import EinetConfig

from repro_torch.configs import (
    einet_celeba,
    einet_pd,
    einet_pd_mnist,
    einet_rat,
    einet_rat_large,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        einet_celeba,
        einet_pd,
        einet_pd_mnist,
        einet_rat,
        einet_rat_large,
    )
}

# stable short ids for --arch flags / file names
ALIASES = {
    "einet_celeba": "einet-pd-celeba",
    "einet_pd": "einet-pd-svhn",
    "einet_pd_mnist": "einet-pd-mnist",
    "einet_rat": "einet-rat",
    "einet_rat_large": "einet-rat-large",
}


def get_config(name: str) -> EinetConfig:
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


__all__ = ["REGISTRY", "ALIASES", "get_config", "EinetConfig"]
