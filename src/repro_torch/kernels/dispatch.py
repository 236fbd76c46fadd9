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

:func:`launch_hook` installs an observer of launches for a block: each
launch then runs inside ``hook(op, args)``, a context manager (the step
cost counter, ``repro_torch.launch.cost``, counts a launch's work there
and keeps the ops inside it out of its count).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List

import torch

# the installed launch observers, innermost last
_HOOKS: List[Callable] = []


@contextlib.contextmanager
def launch_hook(hook: Callable):
    """Run every kernel-op launch of the block inside ``hook(op, args)``
    (a context manager factory)."""
    _HOOKS.append(hook)
    try:
        yield hook
    finally:
        _HOOKS.remove(hook)


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
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"{self.name}: unsupported device {device}")
        if not _HOOKS:
            return self._run(device, args)
        with contextlib.ExitStack() as stack:
            for hook in _HOOKS:
                stack.enter_context(hook(self, args))
            return self._run(device, args)

    def _run(self, device: torch.device, args):
        if device.type == "cuda":
            out = self.kernel(*args)
            self.launches += 1
            return out
        self.plain_calls += 1
        return self.plain(*args)

    __call__ = launch
