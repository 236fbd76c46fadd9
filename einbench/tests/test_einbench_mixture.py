"""The soft mixture cell (train.einet_celeba_x8.soft): a run on the CPU at
a tiny size with the cell's own limits comes out correct, and as not
correct with its step broken underneath (the state left unchanged, half
of every batch left out); on the card, at the cell's own sizes, the
reference with every component's statistics weighted 1/C in place of its
responsibilities fails the cell's limits, and so does the argmax of the
responsibilities wherever the cell routes a row softly.

    python -m pytest -q -s -m card einbench/tests/test_einbench_mixture.py

writes ``einbench_out/control/<cell>.<fault>.json``."""

import json
import os

import pytest
import torch

from harness import mixture_program
from harness.core import Context, execute
from harness.spec import ROOT, Spec
from reference.mixture import MixtureReference

CELL = "train.einet_celeba_x8.soft"
TINY = {"name": "tiny-pd", "structure": "pd", "height": 4, "width": 6,
        "num_channels": 2, "delta": 2, "pd_axes": ["w"], "num_sums": 3,
        "num_classes": 1, "min_var": 1e-6, "max_var": 0.01,
        "batch_size": 24, "num_components": 3,
        "data": "clustered_unit_uniform"}
CONTROL_SEEDS = [2 ** 32 + 104729 * k for k in range(3)]


def _run():
    spec = Spec()
    tr = dict(spec.traffic(spec.cell(CELL)["traffic"]), rows=48, batches=4,
              reference_block=16, trace_from=0, trace_steps=1)
    return execute(spec, CELL, 2 ** 33 + 17, 0.3, False, device="cpu",
                   config=TINY, traffic=tr)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True
    assert set(out["checks"]) == set(Spec().limits(CELL))
    assert out["readings"]["min_component_share"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    real = mixture_program.make_mixture_em_step

    def make(mix, em, weight_alpha, microbatches):
        step = real(mix, em, weight_alpha, microbatches)

        def broken(x):
            if fault == "half_batch":
                return step(x[: x.shape[0] // 2])
            saved = [p.detach().clone() for p in mix.parameters()]
            loss = step(x)
            with torch.no_grad():
                for p, s in zip(mix.parameters(), saved):
                    p.copy_(s)
            return loss

        return broken

    monkeypatch.setattr(mixture_program, "make_mixture_em_step", make)
    out = _run()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _fault_readings(fault):
    """The cell's context, its generator and the readings of ``fault`` on
    the card over the control seeds, written to
    ``einbench_out/control/<cell>.<fault>.json``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the readings are taken at the "
                    "cell's own sizes on the card")
    spec = Spec(ROOT)
    ctx = Context(spec, CELL, CONTROL_SEEDS[0], 0.0, False, "cuda", 0.0)
    gen = spec.generator(ctx.traffic["generator"])
    faults = []
    for seed in CONTROL_SEEDS:
        faults.append({"seed": seed, "fault": fault,
                       **gen.control(ctx, seed, fault)})
        print(CELL, "fault", json.dumps(faults[-1]), flush=True)
    out = os.path.join(os.environ.get("EINBENCH_OUT",
                                      os.path.join(ROOT, "einbench_out")),
                       "control")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{CELL}.{fault}.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "faults": faults,
                   "limits": ctx.limits}, f, indent=1)
    assert ctx.limits
    return ctx, gen, faults


def _fails(r, limits):
    return any(r[k] != r[k] or r[k] > v for k, v in limits.items())


@pytest.mark.card
def test_uniform_responsibilities_fail_the_cell():
    ctx, _, faults = _fault_readings("uniform")
    assert all(_fails(r, ctx.limits) for r in faults), faults


@pytest.mark.card
def test_hard_responsibilities_fail_the_cell_where_it_routes_softly():
    """Each component's statistics weighted by the argmax of the
    responsibilities: that must fail the cell's limits on every seed
    whose first batch routes some row softly; where none does, the hard
    step is the soft step, and the readings say so."""
    ctx, gen, faults = _fault_readings("hard")
    ref = MixtureReference(ctx.config, ctx.device)
    for r in faults:
        *_, resp = gen.reference_steps(ctx, ref, r["seed"], False)
        soft = float((resp.amax(1) < gen.SOFT_BELOW).float().mean())
        print(CELL, "seed", r["seed"], "soft_row_share", soft, flush=True)
        assert soft == 0.0 or _fails(r, ctx.limits), (soft, r)
