"""The readings that set each cell's correctness limits, on the card, at
the cell's own sizes: the program's numbers over a dozen seeds (the lower
readings) and the control's over three (the upper readings).  The control
is the plain reference computed with TF32 contractions, one precision
below the configuration's float32 with TF32 off, put in the program's
place.

    python -m pytest -q -s -m card einbench/tests/test_einbench_control.py

writes ``einbench_out/control/<cell>.json`` (``EINBENCH_OUT`` moves it),
with each training leaf's gap.  Every program seed must pass the cell's
limits; every control seed and every fault must fail one: for training a
step that leaves the state unchanged and half of each batch, for serving
answers rotated by a row within each bucket."""

import json
import os

import pytest

from harness.core import Context
from harness.spec import ROOT, Spec

PROGRAM_SEEDS = [2 ** 31 + 7919 * k for k in range(int(os.environ.get("EINBENCH_SEEDS", 12)))]
CONTROL_SEEDS = [2 ** 32 + 104729 * k for k in range(3)]
SERVE_SECONDS = 4.0


def cells():
    return [w["name"] for w in Spec(ROOT).data["workloads"]]


def _passes(numbers, limits):
    return all(numbers[k] == numbers[k] and numbers[k] <= v
               for k, v in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the readings are taken at the "
                    "cell's own sizes on the card")
    spec = Spec(ROOT)
    ctx = Context(spec, cell, (PROGRAM_SEEDS + CONTROL_SEEDS)[0], SERVE_SECONDS,
                  False, "cuda", 0.0)
    gen = spec.generator(ctx.traffic["generator"])
    serving = ctx.traffic["generator"] == "open_loop"
    st = gen.setup(ctx)
    program, control = [], []
    for seed in PROGRAM_SEEDS:
        ctx.seed = seed
        gen.prime(ctx, st, seed)
        if serving:
            run = gen.window(ctx, st, seed, SERVE_SECONDS)
            program.append({"seed": seed, **gen.check(ctx, run)})
        else:
            run = {"first": st["first"], "snaps": st["snaps"], "seed": seed}
            program.append({"seed": seed, **gen.check(ctx, run, detail=True)})
        print(cell, "program", json.dumps(program[-1]), flush=True)
    faults = []
    if serving:
        gen.permute_answers(st["engine"])
        for seed in CONTROL_SEEDS:
            ctx.seed = seed
            gen.prime(ctx, st, seed)
            run = gen.window(ctx, st, seed, SERVE_SECONDS)
            faults.append({"seed": seed, "fault": "rotated_rows",
                           **gen.check(ctx, run)})
            print(cell, "fault", json.dumps(faults[-1]), flush=True)
    st.clear()
    torch.cuda.empty_cache()
    for seed in CONTROL_SEEDS:
        ctx.seed = seed
        if serving:
            numbers = gen.control(ctx, seed, SERVE_SECONDS)
        else:
            numbers = gen.control(ctx, seed, detail=True)
            for fault in ("half_batch", "unchanged"):
                faults.append({"seed": seed, "fault": fault,
                               **gen.control(ctx, seed, fault)})
                print(cell, "fault", json.dumps(faults[-1]), flush=True)
        control.append({"seed": seed, **numbers})
        print(cell, "control", json.dumps(control[-1]), flush=True)
    out = os.path.join(os.environ.get("EINBENCH_OUT",
                                      os.path.join(ROOT, "einbench_out")),
                       "control")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{cell}.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "program": program,
                   "control": control, "faults": faults, "limits": ctx.limits},
                  f, indent=1)
    assert ctx.limits, f"{cell} has no limits"
    assert all(_passes(r, ctx.limits) for r in program), program
    assert not any(_passes(r, ctx.limits) for r in faults), faults
    assert not any(_passes(r, ctx.limits) for r in control), control
