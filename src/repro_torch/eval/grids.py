"""Artifact writers: PNG image grids + per-run metrics JSON.

Grids are plain row-major tilings: samples render as one grid, inpainting
renders one grid per mask kind with rows [original / masked / conditional
sample / MPE decode] -- the layout of the paper's Fig. 4.  The canvas is
the reference's (``repro.eval.grids``: fill 32, pad 2), but the PNG is
written by a stdlib encoder (``zlib``, ``struct``, ``binascii.crc32``), so
the port needs no imaging library: 8-bit grey or RGB, filter byte 0 on
every scanline, one IDAT chunk.  Metrics JSONs land next to the PNGs under
``artifacts/eval_torch/<run>/``.
"""

from __future__ import annotations

import binascii
import json
import os
import struct
import zlib
from typing import Any, Dict, Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(images: np.ndarray, vmax: float) -> np.ndarray:
    """(N, H, W, C) floats in [0, vmax] -> uint8, clipped."""
    return np.clip(images / vmax * 255.0, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> the bytes of one PNG file."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim == 2:
        color = 0  # greyscale
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        color = 2  # truecolour
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3) pixels, got "
                         f"{pixels.shape}")
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    # filter type 0 (none) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image_grid(
    path: str,
    images: np.ndarray,  # (N, H, W, C) float, domain [0, vmax]
    columns: int = 8,
    vmax: float = 1.0,
    pad: int = 2,
) -> str:
    """Tile images into one PNG; returns the written path."""
    n, h, w, c = images.shape
    cols = max(1, min(columns, n))
    rows = -(-n // cols)
    canvas = np.full(
        (rows * (h + pad) + pad, cols * (w + pad) + pad, c), 32, np.uint8
    )
    tiles = _to_uint8(images, vmax)
    for i in range(n):
        r, col = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        canvas[y: y + h, x: x + w] = tiles[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(canvas[..., 0] if c == 1 else canvas))
    return path


def save_inpainting_grid(
    path: str,
    originals: np.ndarray,  # (N, D) domain floats
    evidence_mask: np.ndarray,  # (D,) bool
    conditional: np.ndarray,  # (N, D)
    mpe: np.ndarray,  # (N, D)
    height: int,
    width: int,
    channels: int,
    vmax: float = 1.0,
    columns: Optional[int] = None,
) -> str:
    """Fig. 4 layout: four rows per column block -- original, masked
    (occluded pixels zeroed), conditional sample, MPE decode."""
    n = len(originals)
    masked = np.where(evidence_mask[None, :], originals, 0.0)
    stack = np.concatenate([originals, masked, conditional, mpe])
    imgs = stack.reshape(-1, height, width, channels)
    return save_image_grid(path, imgs, columns=columns or n, vmax=vmax)


def save_metrics_json(path: str, record: Dict[str, Any]) -> str:
    """Atomic JSON write (tmp + rename), sorted keys for stable diffs."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True, default=float)
    os.replace(tmp, path)
    return path


def load_eval_records(root: str = "artifacts/eval_torch"
                      ) -> Sequence[Dict[str, Any]]:
    """All per-run metrics JSONs under ``root``."""
    records = []
    if not os.path.isdir(root):
        return records
    for run in sorted(os.listdir(root)):
        p = os.path.join(root, run, "metrics.json")
        if os.path.isfile(p):
            with open(p) as f:
                records.append(json.load(f))
    return records
