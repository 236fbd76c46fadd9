"""The public kernel entry points of the port, with device dispatch
(``repro_torch.kernels.dispatch``): CUDA tensors launch the hand-written
kernels, CPU tensors run their plain PyTorch versions.

  * ``log_einsum_exp(w, ln_left, ln_right)`` -- one layer pair
    (``csrc/log_einsum_exp_fwd.cu``).
  * ``grouped_log_einsum_exp(ws, x)`` -- a canonical run of depths in one
    launch (``csrc/grouped_fwd.cu``).

Both are forward-only on the card.
"""

from __future__ import annotations

from repro_torch.kernels.dispatch import KernelOp
from repro_torch.kernels.grouped import (
    grouped_log_einsum_exp_cuda,
    grouped_log_einsum_exp_plain,
)
from repro_torch.kernels.log_einsum_exp import (
    log_einsum_exp_cuda,
    log_einsum_exp_plain,
)

log_einsum_exp = KernelOp(
    "log_einsum_exp", log_einsum_exp_cuda, log_einsum_exp_plain)
grouped_log_einsum_exp = KernelOp(
    "grouped_log_einsum_exp", grouped_log_einsum_exp_cuda,
    grouped_log_einsum_exp_plain)

KERNEL_OPS = (log_einsum_exp, grouped_log_einsum_exp)


def reset_counts() -> None:
    for op in KERNEL_OPS:
        op.reset_counts()
