"""Structured evidence masks for the Fig. 4 inpainting experiment.

A mask is a flat ``(D,)`` boolean *evidence* mask in the EiNet's variable
order (pixel-major, channels innermost -- the ``poon_domingos`` id layout
``(r * width + c) * num_channels + ch``): ``True`` marks observed pixels,
``False`` the occluded region to inpaint.  Mask *names* describe the occluded
region, matching the paper's figures (``left_half`` = left half covered).

All masks occlude whole pixels (every channel of a pixel together), which is
what "inpainting" means for RGB data; ``random_pixel`` is the paper's
doodle-mask stand-in -- an unstructured scatter of missing pixels.

A numpy copy of the reference's ``repro.eval.masks``: the same masks, bit
for bit (``random_pixel`` draws from ``np.random.RandomState(seed)``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MASK_KINDS: Tuple[str, ...] = (
    "left_half",
    "bottom_half",
    "center_square",
    "random_pixel",
)


def make_mask(
    kind: str,
    height: int,
    width: int,
    channels: int = 1,
    seed: int = 0,
    missing_fraction: float = 0.5,
) -> np.ndarray:
    """Build the flat (D,) evidence mask for one occlusion pattern.

    Args:
      kind: one of ``MASK_KINDS`` (names the OCCLUDED region).
      seed: only ``random_pixel`` uses it (deterministic scatter).
      missing_fraction: only ``random_pixel`` uses it.

    Returns: (height * width * channels,) bool; True = observed evidence.
    """
    occluded = np.zeros((height, width), bool)
    if kind == "left_half":
        occluded[:, : width // 2] = True
    elif kind == "bottom_half":
        occluded[height // 2:, :] = True
    elif kind == "center_square":
        h0, w0 = height // 4, width // 4
        occluded[h0: h0 + height // 2, w0: w0 + width // 2] = True
    elif kind == "random_pixel":
        rng = np.random.RandomState(seed)
        occluded = rng.rand(height, width) < missing_fraction
    else:
        raise KeyError(f"unknown mask kind {kind!r}; one of {MASK_KINDS}")
    evidence = ~occluded
    return np.repeat(evidence.reshape(-1), channels)
