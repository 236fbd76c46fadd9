"""A run with its timed path broken underneath comes out as not correct.

Each test skips the command's look for a card and drives the rest of a
run (set-up, window, release, the comparison with the reference) on the
CPU at a tiny size, with the cells' own limits, once sound and once with
one fault the cell can have planted where the program produces its
result: a step that returns the state unchanged; half of every batch left
out, the mean taken over the rest; an answer altered; answers rotated by a
row within each bucket.  The cells run on
one chip, so no exchange between chips can be left out."""

import pytest
import torch

from harness import program
from harness.core import execute
from harness.spec import Spec

TINY_RAT = {"name": "tiny", "structure": "rat", "num_vars": 16, "depth": 2,
            "num_repetitions": 3, "num_sums": 4, "num_classes": 1,
            "min_var": 1e-6, "max_var": 10.0, "batch_size": 32}
TINY_PD = {"name": "tiny-pd", "structure": "pd", "height": 4, "width": 6,
           "num_channels": 2, "delta": 2, "pd_axes": ["w"], "num_sums": 3,
           "num_classes": 1, "min_var": 1e-6, "max_var": 0.01,
           "batch_size": 24, "data": "unit_uniform"}
TRAIN = [("train.einet_rat.b2000", TINY_RAT, "em_16_full"),
         ("train.einet_pd.b512", TINY_PD, "em_64_batches")]


def train_run(cell, cfg, traffic):
    spec = Spec()
    tr = dict(spec.traffic(traffic), rows=cfg["batch_size"], batches=4,
              reference_block=8, trace_from=0, trace_steps=1)
    return execute(spec, cell, 2 ** 33 + 17, 0.3, False, device="cpu",
                   config=cfg, traffic=tr)


def serve_run(rate=80.0):
    spec = Spec()
    tr = dict(spec.traffic("open_mix8"), rate_per_s=rate, max_batch=8,
              check_per_kind=6, drain_s=10.0)
    return execute(spec, "serve.einet_rat.open", 2 ** 33 + 29, 0.5,
                   False, device="cpu", config=TINY_RAT, traffic=tr)


def _broken_step(monkeypatch, fault):
    real = program.em_step

    def em_step(model, em, microbatches):
        step = real(model, em, microbatches)

        def broken(x):
            if fault == "half_batch":
                return step(x[: x.shape[0] // 2])
            saved = [p.detach().clone() for p in model.parameters()]
            loss = step(x)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return loss

        return broken

    monkeypatch.setattr(program, "em_step", em_step)


@pytest.mark.parametrize("cell,cfg,traffic", TRAIN)
def test_sound_training_run_is_correct(cell, cfg, traffic):
    assert train_run(cell, cfg, traffic)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell,cfg,traffic", TRAIN)
def test_broken_step_is_not_correct(monkeypatch, cell, cfg, traffic, fault):
    _broken_step(monkeypatch, fault)
    out = train_run(cell, cfg, traffic)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_sound_serving_run_is_correct():
    assert serve_run()["correct"] is True


@pytest.mark.parametrize("kind", ["joint_ll", "marginal_ll",
                                  "conditional_ll", "sample",
                                  "conditional_sample", "mpe"])
def test_altered_answer_is_not_correct(monkeypatch, kind):
    real = program.engine

    def engine(model, max_batch):
        eng = real(model, max_batch)
        step = eng.step

        def altered():
            res = step()
            for r in res:
                if r.kind == kind:
                    r.value = r.value + 1e-3 * (1.0 + abs(r.value))
            return res

        eng.step = altered
        return eng

    monkeypatch.setattr(program, "engine", engine)
    out = serve_run()
    assert out["correct"] is False


def test_rotated_answers_are_not_correct(monkeypatch):
    from generators import open_loop

    real = program.engine

    def engine(model, max_batch):
        eng = real(model, max_batch)
        open_loop.permute_answers(eng)
        return eng

    monkeypatch.setattr(program, "engine", engine)
    # arrivals faster than the steps, so that buckets hold several rows
    out = serve_run(rate=1000.0)
    assert out["correct"] is False
    assert out["checks"]["ll_gap.joint_ll"]["value"] > 1e-3
