"""Synthetic stand-ins for the paper's image datasets, numpy only.

A copy of the reference's ``repro/data/synthetic.py``
``gaussian_mixture_images``: the same seed gives the same array, so the
port's launch CLIs train on the reference's data.
"""

from __future__ import annotations

import numpy as np


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
