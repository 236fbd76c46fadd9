"""Optimizers of the port: AdamW (float32 / bfloat16 / int8 moment state)
and gradient compression for the data-parallel all-reduce."""

from repro_torch.optim import adamw, compression

__all__ = ["adamw", "compression"]
