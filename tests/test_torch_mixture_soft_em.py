"""The port's soft EM of a mixture of EiNets against the benchmark's plain
reference (``einbench/reference/mixture.py``), on the CPU at tiny sizes
with seeded weights.

The program takes one gradient of the whole mixture's log-likelihood
through the top-level ``log_mix_exp`` (``repro_torch.mixture.train``); the
reference weighs each component's statistics by explicit, detached
responsibilities.  A tiny Poon-Domingos mixture (C=3) on rows about three
centres, whose responsibilities are near one-hot as the benchmark's are,
and a tiny RAT mixture (C=2) on standard-normal rows with unequal weights,
whose responsibilities are soft."""

import math
import os
import sys

import pytest
import torch

EINBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "einbench")
if EINBENCH not in sys.path:
    sys.path.insert(0, EINBENCH)

from generators import em_mixture_steps as gen  # noqa: E402
from harness import mixture_program, seeded  # noqa: E402
from reference.einet import Reference  # noqa: E402
from reference.mixture import MixtureReference  # noqa: E402
from reference.structure import layout_of  # noqa: E402

PD = {"name": "tiny-pd", "structure": "pd", "height": 4, "width": 6,
      "num_channels": 2, "delta": 2, "pd_axes": ["w"], "num_sums": 3,
      "num_classes": 1, "min_var": 1e-6, "max_var": 0.01,
      "num_components": 3, "data": "clustered_unit_uniform"}
RAT = {"name": "tiny-rat", "structure": "rat", "num_vars": 16, "depth": 2,
       "num_repetitions": 3, "num_sums": 4, "num_classes": 1,
       "min_var": 1e-6, "max_var": 10.0, "num_components": 2,
       "data": "standard_normal"}
EM = {"laplace_alpha": 1e-4, "stat_floor": 1e-12, "step_size": 0.5}
WEIGHT_ALPHA = 1e-4
ROWS, BLOCK, STEPS, SEED = 48, 16, 3, 2 ** 33 + 5

# Tolerances.  Both sides compute in float32 from the same weights and
# rows; they part only by the order of their sums (the program sums a
# batch's statistics in one backward pass, the reference in blocks of 16
# rows, and the program's log_mix_exp takes the top's max out where the
# reference's softmax does).  Over three steps that moved the mean LL by
# under 1e-6 of its size, each leaf by under 3e-5 of the reference's
# change and the weights by under 2e-7 of their size; the bounds below
# leave at least 30 times that, and a fault in the statistics (the
# responsibilities) moves a leaf by order 1 of its change.
LOSS_TOL = 1e-4      # relative gap of each step's mean mixture LL
CHANGE_TOL = 1e-3    # |p - r| over the reference's change |r - p0|, a leaf
WEIGHTS_TOL = 1e-4   # relative gap of each mixture weight


def _case(cfg):
    """(reference layout params, batches) of the case."""
    lay, c_n = layout_of(cfg), cfg["num_components"]
    if cfg["data"] == gen.DATA:
        return (gen.params(lay, c_n, SEED, "cpu"),
                gen.batches(STEPS, ROWS, lay, c_n, SEED, "cpu"))
    comps = [seeded.params(lay, seeded.stream(SEED, f"component{c}"), "cpu")
             for c in range(c_n)]
    w = torch.arange(1, c_n + 1, dtype=torch.float32)
    return ({"components": comps, "weights": w / w.sum()},
            seeded.batches(STEPS, ROWS, lay.num_vars, SEED, "cpu"))


def _program(cfg, p):
    mix = mixture_program.build_mixture(cfg, cfg["num_components"], "cpu")
    mixture_program.load_mixture_params(mix, gen.stacked(p))
    step = mixture_program.make_mixture_em_step(mix, EM, WEIGHT_ALPHA, 1)
    return mix, step


def _gaps(p0, got, want):
    """Each leaf's |got - want| over the reference's change |want - p0|
    (leaves the step does not move, the one-class prior, left out), and
    the mixture weights' largest relative gap."""
    out = []
    for a, g, w in zip(p0, got, want):
        moved = float(torch.linalg.vector_norm(w - a))
        if moved > 1e-6:
            out.append(float(torch.linalg.vector_norm(g - w)) / moved)
    return max(out), float(((got[-1] - want[-1]).abs() / want[-1]).max())


def _run(cfg, resp=None):
    """Three steps of the program and of the reference (``resp(ref, p,
    x)`` in place of its responsibilities): their losses and leaves after
    each step."""
    c_n = cfg["num_components"]
    p, x = _case(cfg)
    mix, step = _program(cfg, p)
    ref = MixtureReference(cfg, "cpu")
    p0 = gen.leaves(p)
    runs = []
    for i in range(STEPS):
        loss = step(x[i])
        p, ref_loss, _ = ref.em_step(p, x[i], EM, WEIGHT_ALPHA, BLOCK,
                                     None if resp is None else resp(ref, p, x[i]))
        got = [t.clone() for t in gen.program_leaves(
            mixture_program.mixture_params_of(mix), c_n)]
        runs.append((loss, ref_loss, got, gen.leaves(p)))
    return p0, runs


@pytest.mark.parametrize("cfg", [PD, RAT], ids=["pd-3", "rat-2"])
def test_soft_steps_match_the_plain_reference(cfg):
    p0, runs = _run(cfg)
    for loss, ref_loss, got, want in runs:
        assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
        change, weights = _gaps(p0, got, want)
        assert change <= CHANGE_TOL
        assert weights <= WEIGHTS_TOL


@pytest.mark.parametrize("cfg", [PD, RAT], ids=["pd-3", "rat-2"])
def test_uniform_responsibilities_fail_the_tolerances(cfg):
    """Each component's statistics weighted 1/C, the responsibilities
    left out: the fault must break a tolerance of the step's check."""
    c_n = cfg["num_components"]
    p0, runs = _run(cfg, resp=lambda ref, p, x: torch.full((ROWS, c_n), 1.0 / c_n))
    broken = []
    for loss, ref_loss, got, want in runs[1:]:
        change, weights = _gaps(p0, got, want)
        broken.append(abs(loss - ref_loss) > LOSS_TOL * abs(ref_loss)
                      or change > CHANGE_TOL or weights > WEIGHTS_TOL)
    change, _ = _gaps(p0, runs[0][2], runs[0][3])
    assert change > 100 * CHANGE_TOL
    assert all(broken)


def _hard(ref, p, x):
    r = ref.responsibilities(p, x, BLOCK)
    return torch.nn.functional.one_hot(r.argmax(1), r.shape[1]).to(r)


def test_hard_responsibilities_fail_the_tolerances_where_rows_route_softly():
    """The RAT case, whose rows route softly: each component's statistics
    weighted by the argmax of the responsibilities must break a tolerance
    at every step.  (The PD case's and the benchmark cell's rows route
    one-hot, so there the hard step is the soft step.)"""
    p, x = _case(RAT)
    r = MixtureReference(RAT, "cpu").responsibilities(p, x[0], BLOCK)
    assert float((r.amax(1) < 0.99).float().mean()) > 0.25
    p0, runs = _run(RAT, resp=_hard)
    for loss, ref_loss, got, want in runs:
        change, weights = _gaps(p0, got, want)
        assert (abs(loss - ref_loss) > LOSS_TOL * abs(ref_loss)
                or change > CHANGE_TOL or weights > WEIGHTS_TOL)
    change, weights = _gaps(p0, runs[0][2], runs[0][3])
    assert change > 10 * CHANGE_TOL and weights > 10 * WEIGHTS_TOL


@pytest.mark.parametrize("cfg", [PD, RAT], ids=["pd-3", "rat-2"])
def test_reference_mixture_ll_is_its_components_and_the_programs(cfg):
    p, x = _case(cfg)
    ref = MixtureReference(cfg, "cpu")
    single = Reference(cfg, "cpu")
    lls = torch.stack([single.log_likelihood(q, x[0])
                       for q in p["components"]], 1)
    want = torch.logsumexp(torch.log(p["weights"])[None] + lls, -1)
    got = ref.log_likelihood(p, x[0], BLOCK)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    r = ref.responsibilities(p, x[0], BLOCK)
    torch.testing.assert_close(r.sum(1), torch.ones(ROWS))
    # the program's mixture LL, float32 in another order of sums
    mix, _ = _program(cfg, p)
    with torch.no_grad():
        prog = mix.log_likelihood(x[0])
    scale = got.abs().clamp(min=1.0)
    assert float(((prog - got).abs() / scale).max()) <= 1e-5
    assert math.isfinite(float(got.sum()))
