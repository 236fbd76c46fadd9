"""Config system: the paper's EiNet architectures as frozen dataclasses.

Each registered architecture is one ``EinetConfig`` in
``repro_torch/configs/<id>.py`` with exact numbers from the paper's experiments
(§4); ``repro_torch.launch.cells.build_einet`` turns a config into a live model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EinetConfig:
    """One EiNet experiment cell (``--arch einet_*``)."""

    name: str
    family: str = "einet"
    structure: str = "pd"  # pd | rat
    # pd
    height: int = 32
    width: int = 32
    num_channels: int = 3
    delta: int = 8
    pd_axes: Tuple[str, ...] = ("w",)
    # rat
    num_vars: int = 512
    depth: int = 4
    num_repetitions: int = 10
    # shared
    num_sums: int = 40
    num_classes: int = 1
    exponential_family: str = "normal"  # normal | binomial | categorical
    # normal-leaf variance clamp; the paper uses [1e-6, 1e-2] for images
    min_var: float = 1e-6
    max_var: float = 10.0
    batch_size: int = 512
