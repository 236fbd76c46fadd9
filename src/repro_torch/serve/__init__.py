"""Batched exact-inference serving for Einsum Networks: ``ServeEngine``
coalesces heterogeneous requests (likelihoods, marginals, conditionals,
sampling, MPE; a mixture's kinds too) into padded per-kind micro-batches."""

from repro_torch.serve.engine import Request, Result, ServeEngine
from repro_torch.serve.queue import RequestQueue, SlotManager
from repro_torch.serve.workload import (
    DEFAULT_MIX,
    direct_call,
    mixed_requests,
    mixture_requests,
    parity,
)

__all__ = [
    "Request",
    "Result",
    "ServeEngine",
    "RequestQueue",
    "SlotManager",
    "DEFAULT_MIX",
    "direct_call",
    "mixed_requests",
    "mixture_requests",
    "parity",
]
