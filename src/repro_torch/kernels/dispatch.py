"""Device dispatch for the port's kernels.

A kernel op decides by the device of the tensors it is given, and by
nothing else:

  * CUDA tensors launch the hand-written CUDA kernel, or raise;
  * CPU tensors run the kernel's plain PyTorch version;
  * any other device raises.

No path falls back: a CUDA tensor never reaches the plain version, and a
failed build or launch raises.  A ``KernelOp`` computes one function with
no autograd of its own; ``ops`` pairs each forward op with its backward op
in a ``torch.autograd.Function``.

Each op counts its kernel launches and its plain-version calls in plain
integers, so a run can show which path it went through.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch


def _tensors(args) -> Iterator[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


class KernelOp:
    """One kernel's public entry point: dispatch plus launch counters."""

    def __init__(self, name: str, kernel: Callable, plain: Callable):
        self.name = name
        self.kernel = kernel
        self.plain = plain
        self.launches = 0  # CUDA kernel launches made through this op
        self.plain_calls = 0  # calls that ran the plain version (CPU tensors)

    def reset_counts(self) -> None:
        self.launches = 0
        self.plain_calls = 0

    def launch(self, *args):
        """Run the kernel (CUDA tensors) or the plain version (CPU tensors)
        on ``args`` and count it."""
        tensors = list(_tensors(args))
        if not tensors:
            raise TypeError(f"{self.name}: no tensor arguments")
        device = tensors[0].device
        if any(t.device != device for t in tensors):
            raise ValueError(
                f"{self.name}: tensors on several devices "
                f"{sorted({str(t.device) for t in tensors})}"
            )
        if device.type == "cuda":
            out = self.kernel(*args)
            self.launches += 1
            return out
        if device.type == "cpu":
            self.plain_calls += 1
            return self.plain(*args)
        raise ValueError(f"{self.name}: unsupported device {device}")

    __call__ = launch
