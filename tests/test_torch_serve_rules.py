"""Serving under a rule table (``ServeEngine(rules=...)``) on the CPU.

A world of 1 under ``serve_rules()`` is the engine without rules bit for
bit (the counterpart of ``tests/test_serve.py``'s
``test_engine_with_serve_rules_is_noop_on_single_device``), in this
process (no process group) and in a gloo group of one.  Two gloo ranks
(spawned by ``tests/_torch_dist_workers.py``, with timeouts on init and
join) serve a mixed stream of all six kinds with each divisible bucket
split over the data dim, and every result is the one-process engine's
bit for bit.
"""

import numpy as np
import pytest

import _torch_dist_workers as workers
from repro_torch import compile as compile_lib
from repro_torch.core.einet import QUERY_KINDS
from repro_torch.dist.sharding import serve_rules
from repro_torch.serve import ServeEngine, mixed_requests
from repro_torch.serve.benchmark import run_benchmark

N_REQ, MAX_BATCH, SEED = 40, 4, 3


@pytest.fixture(scope="module")
def state_and_plain():
    model = workers.small_einet()
    reqs = mixed_requests(model.num_vars, N_REQ, seed=SEED)
    assert {r.kind for r in reqs} == set(QUERY_KINDS)
    plain = ServeEngine(model, max_batch=MAX_BATCH).run(reqs)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return state, {i: np.asarray(r.value) for i, r in plain.items()}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        a, b = np.asarray(got[i]), want[i]
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert a.tobytes() == b.tobytes(), i


def test_world_of_one_is_the_engine_without_rules(state_and_plain):
    state, plain = state_and_plain
    model = workers.small_einet(state)
    reg = compile_lib.ProgramRegistry()
    engine = ServeEngine(model, max_batch=MAX_BATCH, rules=serve_rules(),
                         registry=reg)
    assert engine.mesh is None  # no process group: nothing to split over
    out = engine.run(mixed_requests(model.num_vars, N_REQ, seed=SEED))
    _same({i: r.value for i, r in out.items()}, plain)
    # the program keys carry the rules, as the reference's do
    rules_key = engine._rules_key()
    assert rules_key is not None
    assert all(k[-1] == rules_key for k in reg.table(model))
    assert all(engine._split(b) is None for b in engine.buckets)


def test_run_benchmark_takes_rules(state_and_plain):
    state, _ = state_and_plain
    model = workers.small_einet(state)
    reqs = mixed_requests(model.num_vars, 12, seed=SEED)
    rep = run_benchmark(model, reqs, max_batch=MAX_BATCH, reps=1,
                        registry=compile_lib.ProgramRegistry(),
                        rules=serve_rules())
    assert rep["ll_max_abs_diff"] == 0.0 and rep["sample_mismatches"] == 0


def test_gloo_world_of_one_is_the_engine_without_rules(state_and_plain,
                                                       tmp_path):
    state, plain = state_and_plain
    (out,) = workers.run_world(1, tmp_path, workers.serve_worker, state,
                               N_REQ, MAX_BATCH, SEED)
    assert out["mesh"] == (1, 1) and out["split"] == []
    _same(out["values"], plain)


def test_two_ranks_split_buckets_bit_for_bit(state_and_plain, tmp_path):
    state, plain = state_and_plain
    outs = workers.run_world(2, tmp_path, workers.serve_worker, state,
                             N_REQ, MAX_BATCH, SEED)
    for out in outs:
        assert out["mesh"] == (2, 1)
        # buckets 2 and 4 split in halves; bucket 1 does not divide and is
        # replicated
        assert out["split"] == [2, 4]
        assert out["requests"] == N_REQ
        _same(out["values"], plain)
