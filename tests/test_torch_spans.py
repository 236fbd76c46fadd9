"""The plan walk's segment spans and counter (``plan.segment``,
``plan.segment.traces``) and the obs sync hook, against the reference's
plans.

An eager forward with tracing on emits one span a plan segment, with the
reference's segment kinds and bounds; the counter counts one a segment a
walk; an installed sync hook runs once a segment on the segment's output;
and a walk recorded by a capture with a hook installed raises instead of
synchronising inside the capture.
"""

import numpy as np
import pytest
import torch

from repro.core import EiNet as RefEiNet
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.core import poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.serve.engine import assemble_batch, query_fn


def _pair(kind):
    """(reference model, port model) of one small structure: RAT (one
    fused segment), Poon-Domingos (a gather segment and a layer), RAT per
    layer."""
    if kind == "pd":
        return (RefEiNet(ref_pd(4, 8, 2, 1, ("h", "w")), num_sums=4),
                EiNet(poon_domingos(4, 8, 2, 1, ("h", "w")), num_sums=4,
                      device="cpu"))
    grouped = kind == "rat"
    return (RefEiNet(ref_rbt(32, 2, 2, seed=0), num_sums=4, grouped=grouped),
            EiNet(random_binary_trees(32, 2, 2, seed=0), num_sums=4,
                  device="cpu", grouped=grouped))


def _x(net, b=6):
    return torch.from_numpy(
        np.random.RandomState(0).randn(b, net.num_vars).astype(np.float32))


def _segment_spans(fn):
    mark = obs.num_events()
    obs.configure(trace=True)
    try:
        fn()
    finally:
        obs.configure(trace=False)
    return [(e["args"]["start"], e["args"]["stop"], e["args"]["kind"])
            for e in obs.trace_events()[mark:] if e["name"] == "plan.segment"]


@pytest.mark.parametrize("kind", ["rat", "pd"])
def test_one_span_a_segment_with_the_references_bounds(kind):
    ref, port = _pair(kind)
    want = [tuple(s[:3]) for s in ref.grouping_summary()["segments"]]
    assert want == [tuple(s[:3]) for s in port.grouping_summary()["segments"]]
    assert {k for _, _, k in want} == ({"fused"} if kind == "rat"
                                       else {"gather", "layer"})
    with torch.inference_mode():
        spans = _segment_spans(lambda: port.log_likelihood(_x(port)))
    assert spans == want
    # tracing off: no span, the same numbers
    mark = obs.num_events()
    with torch.inference_mode():
        a = port.log_likelihood(_x(port))
    assert obs.num_events() == mark
    obs.configure(trace=True)
    try:
        with torch.inference_mode():
            b = port.log_likelihood(_x(port))
    finally:
        obs.configure(trace=False)
    assert torch.equal(a, b)


def test_per_layer_plan_walks_no_segment():
    """The per-layer plan is the per-pair loop, which is no plan walk: no
    segment span, no count (as in the reference)."""
    _, port = _pair("layer")
    assert not port.grouped_active
    with torch.inference_mode():
        assert _segment_spans(lambda: port.log_likelihood(_x(port))) == []


def _traces(kind):
    return obs.METRICS.value("plan.segment.traces", kind=kind)


@pytest.mark.parametrize("kind", ["rat", "pd"])
def test_counter_counts_one_a_segment_a_walk(kind):
    _, port = _pair(kind)
    kinds = [s.kind for s in port.exec_plan]
    before = {k: _traces(k) for k in set(kinds)}
    with torch.inference_mode():
        for _ in range(3):
            port.log_likelihood(_x(port))
    for k in set(kinds):
        assert _traces(k) - before[k] == 3 * kinds.count(k)


@pytest.mark.parametrize("kind", ["rat", "pd"])
def test_sync_hook_runs_once_a_segment(kind):
    _, port = _pair(kind)
    seen = []
    obs.set_sync(lambda v: seen.append(tuple(v.shape)))
    try:
        assert obs.has_sync()
        with torch.inference_mode():
            port.log_likelihood(_x(port, b=5))
    finally:
        obs.set_sync(None)
    assert not obs.has_sync()
    assert len(seen) == len(port.exec_plan)
    assert all(s[0] == 5 for s in seen)
    assert obs.sync("v") == "v"  # no hook: a no-op


def test_sync_hook_under_a_capture_raises(monkeypatch):
    """A capture records the walk; a sync hook inside it would synchronise
    a capturing stream.  The injected capture reports the stream as
    capturing while it records, as a CUDA capture would."""
    _, port = _pair("pd")

    def capture(run, device, pool):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        try:
            out = run()
        finally:
            monkeypatch.undo()
        return (lambda: None), out

    reg = compile_lib.ProgramRegistry(capture_fn=capture)
    batch = assemble_batch(port, [], 2)
    # no hook: the capture records the walk
    reg.capture(port, ("joint_ll", 2), query_fn("joint_ll"), batch)
    obs.set_sync(lambda v: None)
    try:
        with pytest.raises(RuntimeError, match="being captured"):
            reg.capture(port, ("marginal_ll", 2), query_fn("marginal_ll"),
                        batch)
    finally:
        obs.set_sync(None)
