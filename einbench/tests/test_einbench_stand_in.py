"""A stand-in for the lower-precision control of a serving cell whose TF32
control cannot be told from float32.

``open_loop.control`` rounds only the contractions' operands to TF32.  In
a Poon-Domingos EiNet over 3,072 pixels the answers are dominated by the
leaf layer's sums of Gaussian log-densities, which it leaves in float32,
so its gaps read below the program's own.  The stand-in holds every
operand in TF32: the parameters and the request rows rounded to TF32's
10-bit mantissa, as a tensor core reads a float32 operand (a leaf layer
computed as the contraction <phi, T(x)> would read them so), with the
contractions in TF32 as well.  It is put in the program's place on the
requests a run would compare, and must fail one of the cell's limits.

    python -m pytest -q -s -m card einbench/tests/test_einbench_stand_in.py

writes ``einbench_out/control/<cell>.stand_in.json``.  On the CPU a tiny
einet_pd case checks that the stand-in moves the answers more than the
TF32 control does."""

import json
import os

import numpy as np
import pytest
import torch

from harness import seeded
from harness.core import Context
from harness.spec import ROOT, Spec
from reference.einet import Reference, tf32

CELLS = ["serve.einet_pd.open"]
CONTROL_SEEDS = [2 ** 32 + 104729 * k for k in range(3)]
SERVE_SECONDS = 4.0
TINY_PD = {"name": "tiny-pd", "structure": "pd", "height": 4, "width": 6,
           "num_channels": 2, "delta": 2, "pd_axes": ["w"], "num_sums": 3,
           "num_classes": 1, "min_var": 1e-6, "max_var": 0.01,
           "data": "unit_uniform"}


def rounded(tree):
    """Every float32 tensor of a parameter tree rounded to TF32."""
    if isinstance(tree, dict):
        return {k: rounded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rounded(v) for v in tree)
    return tf32(tree)


def stand_in(ctx, gen, seed: int, seconds: float):
    """The open-loop generator's control with every operand in TF32: the
    numbers ``gen.compare`` gives for it against the float32 reference,
    and those of the generator's own TF32 control on the same requests."""
    ref = Reference(ctx.config, ctx.device)
    data = seeded.data_of(ctx.config)
    params = seeded.params(ref.lay, seed, ctx.device, data)
    sch = gen.schedule(ctx.traffic, seconds, seed, ref.lay.num_vars, data)
    fake = {"schedule": sch, "values": dict.fromkeys(range(len(sch["due"])))}
    ids = gen.sample(ctx, fake, seed)
    want = {k: gen.answers(ctx, ref, params, sch, k, v, False)
            for k, v in ids.items()}
    low = dict(sch, x=tf32(torch.from_numpy(
        np.ascontiguousarray(sch["x"], dtype=np.float32))).numpy())
    out = []
    for p, s in ((rounded(params), low), (params, sch)):
        got = {k: gen.answers(ctx, ref, p, s, k, v, True)[0]
               for k, v in ids.items()}
        out.append(gen.compare(got, {k: w[0] for k, w in want.items()},
                               {k: sch["evidence"][v] for k, v in ids.items()},
                               {k: w[1] for k, w in want.items()}))
    return out


def _passes(numbers, limits):
    return all(numbers[k] == numbers[k] and numbers[k] <= v
               for k, v in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_stand_in_control_fails_the_cell(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the readings are taken at the "
                    "cell's own sizes on the card")
    spec = Spec(ROOT)
    ctx = Context(spec, cell, CONTROL_SEEDS[0], SERVE_SECONDS, False, "cuda",
                  0.0)
    gen = spec.generator(ctx.traffic["generator"])
    rows = []
    for seed in CONTROL_SEEDS:
        ctx.seed = seed
        low, tf = stand_in(ctx, gen, seed, SERVE_SECONDS)
        rows.append({"seed": seed, "stand_in": low, "tf32": tf})
        print(cell, json.dumps(rows[-1]), flush=True)
    out = os.path.join(os.environ.get("EINBENCH_OUT",
                                      os.path.join(ROOT, "einbench_out")),
                       "control")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{cell}.stand_in.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "readings": rows,
                   "limits": ctx.limits}, f, indent=1)
    assert ctx.limits
    assert not any(_passes(r["stand_in"], ctx.limits) for r in rows), rows


def test_stand_in_moves_the_answers_more_than_tf32_contractions():
    spec = Spec(ROOT)
    tr = dict(spec.traffic("open_mix8_pd"), rate_per_s=200.0,
              check_per_kind=8, reference_block=8)
    ctx = Context(spec, CELLS[0], 2 ** 33 + 3, 0.5, False, "cpu", 0.0,
                  config=TINY_PD, traffic=tr)
    gen = spec.generator(tr["generator"])
    low, tf = stand_in(ctx, gen, ctx.seed, 0.5)
    assert low["rows_compared"] == tf["rows_compared"] > 0
    assert low["ll_gap"] > 10 * max(tf["ll_gap"], 1e-9)
