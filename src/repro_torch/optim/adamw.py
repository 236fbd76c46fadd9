"""AdamW with optionally block-quantized (int8) moment state.

The port's counterpart of the reference's ``repro/optim/adamw.py``: the
same schedule (linear warm-up, cosine decay to ``min_lr_ratio``), global
norm clipping and decoupled weight decay.  ``state_dtype='int8'`` stores m
and v in 256-value blocks with a float32 absmax scale each (the 8-bit Adam
trick); quantization is elementwise per shard, so it composes with any
placement and needs no collective.  No EiNet path uses it: EM needs no
optimizer.

Parameters and gradients are trees of tensors (``repro_torch.tree``); the
updates return new trees and change nothing in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization.  Returns (q, scales)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n].reshape(shape)


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "float32":
        return x
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        return _quantize(x)
    raise ValueError(dtype)


def _decode(enc, shape, dtype: str) -> torch.Tensor:
    if dtype == "float32":
        return enc
    if dtype == "bfloat16":
        return enc.to(torch.float32)
    q, scale = enc
    return _dequantize(q, scale, shape)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.clamp(warm, max=1.0) * cos


def init_state(cfg: AdamWConfig, params: Any) -> Any:
    """{"step": int32 0, "moments": params' tree with {"m", "v"} a leaf}."""

    def one(_, p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return {"m": _encode(z, cfg.state_dtype),
                "v": _encode(z, cfg.state_dtype)}

    _, leaves = tree_lib.flatten(params)
    device = leaves[0].device if leaves else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "moments": tree_lib.unflatten_like(params, leaves, one)}


def global_norm(tree: Any) -> torch.Tensor:
    _, leaves = tree_lib.flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: Any) -> Tuple[Any, Any, torch.Tensor]:
    """One AdamW step.  Returns (new params, new state, gradient norm)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), stepf)

    def one(p, g, mom):
        g = g.to(torch.float32) * clip
        m = _decode(mom["m"], p.shape, cfg.state_dtype)
        v = _decode(mom["v"], p.shape, cfg.state_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        newp = pf - lr * (upd + cfg.weight_decay * pf)
        return newp.to(p.dtype), {"m": _encode(m, cfg.state_dtype),
                                  "v": _encode(v, cfg.state_dtype)}

    _, flat_p = tree_lib.flatten(params)
    flat_g = tree_lib.leaves_like(params, grads)
    flat_m = tree_lib.leaves_like(params, state["moments"])
    out = [one(p, g, m) for p, g, m in zip(flat_p, flat_g, flat_m)]
    new_params = tree_lib.unflatten_like(params, [o[0] for o in out],
                                         lambda _, new: new)
    moments = tree_lib.unflatten_like(params, [o[1] for o in out],
                                      lambda _, new: new)
    return new_params, {"step": step, "moments": moments}, gnorm
