"""Synthetic stand-ins for the paper's datasets, numpy only: a copy of the
reference's ``repro/data/synthetic.py`` (the same seed gives the same
array), so the port trains on the reference's data.

The 20 binary density-estimation datasets (Table 1), SVHN and CelebA (§4.2)
have synthetic generators of identical shape and dtype with *structured*
distributions (latent factor models, mixtures), so EM has real correlation
structure to learn offline.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

# (name, num_vars) of the 20 binary datasets from Lowd & Davis / Van Haaren:
# used to size the Table-1 proxies identically to the paper.
TWENTY_DATASETS: Tuple[Tuple[str, int], ...] = (
    ("nltcs", 16), ("msnbc", 17), ("kdd-2k", 64), ("plants", 69),
    ("jester", 100), ("audio", 100), ("netflix", 100), ("accidents", 111),
    ("retail", 135), ("pumsb-star", 163), ("dna", 180), ("kosarek", 190),
    ("msweb", 294), ("book", 500), ("each-movie", 500), ("web-kb", 839),
    ("reuters-52", 889), ("20ng", 910), ("bbc", 1058), ("ad", 1556),
)


def binary_dataset(
    name: str, num_samples: int, seed: int = 0, num_factors: int = 8
) -> np.ndarray:
    """Correlated Bernoulli data from a random latent-factor model.

    z ~ Categorical(num_factors); x_d ~ Bernoulli(sigmoid(W[z, d])): a mixture
    with the per-dataset variable count of the real benchmark.
    """
    dims = dict(TWENTY_DATASETS)
    d = dims.get(name)
    if d is None:
        raise KeyError(f"unknown dataset {name}; one of {list(dims)}")
    # crc32, not hash(): str hashes are salted per process, and these rows
    # must be recomputable across restarts (the stateless-loader contract)
    rng = np.random.RandomState((zlib.crc32(name.encode()) + seed) % 2**31)
    w = rng.randn(num_factors, d) * 2.0
    z = rng.randint(num_factors, size=num_samples)
    p = 1.0 / (1.0 + np.exp(-w[z]))
    return (rng.rand(num_samples, d) < p).astype(np.float32)


def gaussian_mixture_images(
    num_samples: int,
    height: int = 32,
    width: int = 32,
    channels: int = 3,
    num_components: int = 10,
    seed: int = 0,
) -> np.ndarray:
    """Smooth mixture 'images' in [0, 1], (N, H*W*C): the SVHN/CelebA proxy."""
    rng = np.random.RandomState(seed)
    d = height * width * channels
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    means = []
    for _ in range(num_components):
        # random smooth pattern: mixture of 2D gaussian bumps per channel
        img = np.zeros((height, width, channels), np.float32)
        for _ in range(4):
            cy, cx = rng.rand(2) * [height, width]
            s = 2.0 + rng.rand() * 6.0
            bump = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
            img += bump[:, :, None] * rng.rand(channels)
        img = img / max(img.max(), 1e-6)
        means.append(img.reshape(-1))
    means = np.stack(means)  # (C, D)
    z = rng.randint(num_components, size=num_samples)
    x = means[z] + rng.randn(num_samples, d).astype(np.float32) * 0.08
    return np.clip(x, 0.0, 1.0)


def token_batch(
    step: int, shard: int, batch: int, seq_len: int, vocab: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Stateless synthetic LM batch: derivable from (step, shard) alone.

    This statelessness is the restart/straggler story: any host can recompute
    any step's shard without coordination.
    """
    rng = np.random.RandomState((seed * 1_000_003 + step * 65_537 + shard) % 2**31)
    # Markov-ish stream so the loss actually decreases in the examples
    base = rng.randint(0, vocab, size=(batch, seq_len + 1))
    repeat = rng.rand(batch, seq_len + 1) < 0.3
    for t in range(1, seq_len + 1):
        base[:, t] = np.where(repeat[:, t], base[:, t - 1], base[:, t])
    return {
        "tokens": base[:, :-1].astype(np.int32),
        "labels": base[:, 1:].astype(np.int32),
    }
