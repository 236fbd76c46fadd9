"""Weights and data made from ``--seed``, on the device, in a few large
calls of a ``torch.Generator`` on that device.  The same seed gives the
same tensors; each purpose draws from a stream of its own."""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch


def stream(seed: int, purpose: str) -> int:
    """A 60-bit seed for one purpose of a run's seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).hexdigest()
    return int(h[:15], 16)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        stream(seed, purpose))


# what a configuration's rows are (its file's "data" key): standard-normal
# variables, or pixels scaled to [0, 1)
DATA = ("standard_normal", "unit_uniform")


def data_of(cfg: Dict) -> str:
    data = cfg.get("data", "standard_normal")
    if data not in DATA:
        raise ValueError(f"data {data!r} is none of {DATA}")
    return data


def params(layout, seed: int, device, data: str = "standard_normal") -> Dict:
    """Random parameters in the layout's shapes, drawn as the port's own
    initialisation draws them: leaf means N(0, 0.5^2) (for pixel rows,
    ``data`` "unit_uniform": U[0, 1)) with unit variance (phi = [mu, mu^2 +
    1]), sum weights 0.1 + 0.9 U normalised over each node's children, a
    uniform class prior."""
    g = generator(seed, "params", device)
    shapes = layout.shapes()
    sizes = [math.prod(s) for s in shapes["einsum"] + shapes["mixing"]]
    u = 0.1 + 0.9 * torch.rand(sum(sizes), generator=g, device=device)
    parts = list(torch.split(u, sizes))
    ws = []
    for s in shapes["einsum"]:
        w = parts.pop(0).view(s)
        ws.append(w / w.sum((-2, -1), keepdim=True))
    vs = []
    for s, p in zip(shapes["mixing"], layout.pairs):
        v = parts.pop(0).view(s)
        if p.mix_mask is not None:
            mask = torch.as_tensor(p.mix_mask, device=device)[:, :, None]
            v = v * mask
            v = v / v.sum(1, keepdim=True)
        vs.append(v)
    if data == "unit_uniform":
        mu = torch.rand(shapes["phi"][:3], generator=g, device=device)
    else:
        mu = 0.5 * torch.randn(shapes["phi"][:3], generator=g, device=device)
    classes = shapes["class_prior"][0]
    return {"phi": torch.stack([mu, mu * mu + 1.0], -1), "einsum": ws,
            "mixing": vs,
            "class_prior": torch.full((classes,), 1.0 / classes, device=device)}


def batches(n: int, rows: int, d: int, seed: int, device,
            data: str = "standard_normal") -> torch.Tensor:
    """(n, rows, d) rows of ``data``, every one distinct."""
    g = generator(seed, "data", device)
    if data == "unit_uniform":
        return torch.rand((n, rows, d), generator=g, device=device)
    return torch.randn((n, rows, d), generator=g, device=device)


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, purpose))
