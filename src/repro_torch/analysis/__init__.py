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

  * :mod:`repro_torch.analysis.lint` -- the port's AST lint (``python -m
    repro_torch.analysis.lint``): the reference's rules in the port's
    idiom (kernels only through the ``KernelOp``s, programs only through
    the registry, timing only through ``obs``) and two of its own (no
    atomic accumulation on a row path, no CPU default).  Not imported
    here: the CLI runs it as ``__main__``.
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
