"""Static analysis for the port: the circuit/plan verifier and the
recompile (recapture) sentry.

  * :mod:`repro_torch.analysis.verify` -- prove smoothness and
    decomposability of a region graph and of the circuit built over it,
    and validate every ``CircuitPlan`` (gather-table permutations, the
    plan budget and the card's launch feasibility, the lane contract) into
    a typed :class:`~repro_torch.analysis.verify.VerifyReport`.  Wired into
    ``EiNet(verify=...)`` / ``REPRO_VERIFY`` and ``python -m
    repro_torch.launch.dryrun --verify``.
  * :mod:`repro_torch.analysis.sentry` -- count the program registry's
    captures by what it keys on, and flag dtype promotion and recapture
    storms, so "one capture per (kind, bucket)" and "one capture per step
    program" are assertable for serve, train and the mixture step.

The reference's third module, its repository lint, has no counterpart
here yet.
"""

from repro_torch.analysis.sentry import CompileSentry
from repro_torch.analysis.verify import (
    Finding,
    VerifyError,
    VerifyReport,
    verify_config,
    verify_einet,
    verify_plan,
    verify_region_graph,
)

__all__ = [
    "Finding",
    "VerifyError",
    "VerifyReport",
    "verify_config",
    "verify_einet",
    "verify_plan",
    "verify_region_graph",
    "CompileSentry",
]
