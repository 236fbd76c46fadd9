"""Hand-written CUDA kernels for the EiNet forward and backward passes on
Hopper (sm_90a), each beside its plain PyTorch version.

  * ``ops.log_einsum_exp`` -- the paper's core op (Eq. 4/5), one layer pair
    per launch (``log_einsum_exp.py``, ``csrc/log_einsum_exp_fwd.cu``,
    backward ``csrc/log_einsum_exp_bwd.cu``).
  * ``ops.grouped_log_einsum_exp`` -- a run of consecutive canonical pairs
    in one launch (``grouped.py``, ``csrc/grouped_fwd.cu``, backward
    ``csrc/grouped_bwd.cu``).
  * ``ops.gather_grouped_log_einsum_exp`` -- a gather run of pairs
    (Poon-Domingos, mixing included) in one launch (``grouped.py``,
    ``csrc/gather_fwd.cu``, backward ``csrc/gather_bwd.cu``).

Kernels are built with ``nvcc`` on first use (``build.py``); importing this
package builds nothing and needs no CUDA.
"""

from repro_torch.kernels import build, dispatch, grouped, log_einsum_exp, ops

__all__ = ["build", "dispatch", "grouped", "log_einsum_exp", "ops"]
