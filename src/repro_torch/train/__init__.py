"""EM training steps over the port's EiNet (``pipeline.py``)."""

from repro_torch.train.pipeline import (
    TrainConfig,
    em_update_microbatched,
    fit,
    make_em_step,
    make_sharded_em_step,
    microbatched_em_statistics,
    stochastic_em_update_microbatched,
)

__all__ = [
    "TrainConfig",
    "em_update_microbatched",
    "fit",
    "make_em_step",
    "make_sharded_em_step",
    "microbatched_em_statistics",
    "stochastic_em_update_microbatched",
]
