"""Batched exact-inference serving for Einsum Networks: ``ServeEngine``
coalesces heterogeneous requests (likelihoods, marginals, conditionals,
sampling, MPE; a mixture's kinds too) into padded per-kind micro-batches,
each run by a captured program (``repro_torch.compile``);
``run_benchmark`` measures it against the one-request-at-a-time paths."""

from repro_torch.serve.benchmark import format_report, run_benchmark
from repro_torch.serve.engine import (
    Request,
    Result,
    ServeEngine,
    assemble_batch,
)
from repro_torch.serve.queue import RequestQueue, SlotManager
from repro_torch.serve.workload import (
    DEFAULT_MIX,
    direct_call,
    legacy_call,
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
    "assemble_batch",
    "direct_call",
    "format_report",
    "legacy_call",
    "mixed_requests",
    "mixture_requests",
    "parity",
    "run_benchmark",
]
