"""Launches by layer, counted at capture (``repro_torch.obs.capture``), the
serving engine's phase counters, and the obs clock against
torch.profiler's, on the CPU.

A CUDA graph cannot be captured here, so the registry's capture seam
(``ProgramRegistry(capture_fn=..., node_counter=...)``) records a program
by running it once under a dispatch mode that counts the aten ops it
runs; the capture observer reads that count as the graph's node count.
The card's own count (the driver's, ``kernels.graph_census``) is held
against a graph's total in ``einbench/tests/test_einbench_counters.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.core import poon_domingos, random_binary_trees
from repro_torch.core.em import (EMConfig, leaf_statistics,
                                 variable_major_statistics)
from repro_torch.core.einet import EiNet
from repro_torch.mixture import (EiNetMixture, MixtureTrainConfig,
                                 make_mixture_em_step)
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import ServeEngine, mixed_requests
from repro_torch.serve.engine import STEP_PHASES, assemble_batch, query_fn
from repro_torch.train import TrainConfig, make_em_step


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class _CountingCapture:
    """A capture seam: records ``run()`` by running it once under an op
    counter (the "graph": one node an op) and replays by running it again
    into the static output.  ``node_counter`` hands the observer the
    running count while it records, and nothing while it replays."""

    def __init__(self):
        self.mode = None
        self.totals = []

    def __call__(self, run, device, pool):
        self.mode = _Ops()
        with self.mode:
            out = run()
        self.totals.append(self.mode.n)
        self.mode = None

        def replay():
            if out is None:  # a step: it writes its own outputs
                run()
                return
            with torch.inference_mode():  # the query's output is one
                out.copy_(run())

        return replay, out

    def node_counter(self, device):
        mode = self.mode
        if mode is None:  # a replay: nothing is being recorded
            return None
        return lambda: mode.n


def _registry():
    seam = _CountingCapture()
    return compile_lib.ProgramRegistry(capture_fn=seam,
                                       node_counter=seam.node_counter), seam


def _pd():
    return EiNet(poon_domingos(4, 8, 2, 1, ("h", "w")), num_sums=4,
                 device="cpu")


def _rat():
    return EiNet(random_binary_trees(16, 2, 2, seed=0), num_sums=3,
                 device="cpu")


def _x(net, b=8, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, net.num_vars).astype(np.float32))


def _nodes(program):
    return {labels["span"]: m.value for labels, m in
            obs.METRICS.find("compile.graph.nodes", program=program)}


def _replays(program):
    return obs.METRICS.value("compile.graph.replays", program=program)


# ------------------------------------------------------------ the observer
def test_span_is_the_null_singleton_without_observer_or_tracing():
    assert obs.capture_observer() is None and not obs.enabled()
    a, b = obs.span("a"), obs.span("b", k=1)
    assert a is b and a is trace_mod._NULL_SPAN
    observer = obs.CaptureObserver("p", lambda: 0)
    obs.set_capture_observer(observer)
    try:
        assert isinstance(obs.span("a"), obs.Span)
    finally:
        obs.set_capture_observer(None)
    assert obs.span("a") is trace_mod._NULL_SPAN
    # a real span under an observer appends no trace event with tracing off
    mark = obs.num_events()
    obs.set_capture_observer(observer)
    try:
        with obs.span("a"):
            pass
    finally:
        obs.set_capture_observer(None)
    assert obs.num_events() == mark


def test_nodes_go_to_the_innermost_span_and_sum_to_the_total():
    count = [5]  # nodes already in the graph are not the program's
    observer = obs.CaptureObserver("p", lambda: count[0])
    obs.set_capture_observer(observer)
    try:
        count[0] += 1  # root
        with obs.span("outer", k=1):
            count[0] += 2
            with obs.span("inner"):
                count[0] += 3
                with obs.span("empty"):
                    pass
            count[0] += 4  # outer again, after inner closed
        count[0] += 1  # root
        with obs.span("inner"):
            count[0] += 2
    finally:
        obs.set_capture_observer(None)
    got = observer.finish()
    assert got["nodes"] == 13
    assert got["spans"] == {"root": 2, "outer": 6, "inner": 5}
    assert sum(got["spans"].values()) == got["nodes"]
    assert got["layers"] == [["root", {}, 0, 0], ["outer", {"k": 1}, 1, 2],
                             ["inner", {}, 3, 5], ["outer", {"k": 1}, 6, 9],
                             ["root", {}, 10, 10], ["inner", {}, 11, 12]]


def test_a_backward_boundary_takes_the_nodes_until_the_next_mark():
    count = [0]
    observer = obs.CaptureObserver("p", lambda: count[0])
    observer.enter("fwd", {})
    count[0] += 2
    observer.exit()
    observer.backward("fwd.bwd", {})
    count[0] += 3
    observer.backward("leaf.bwd", {})
    count[0] += 1
    observer.enter("mstep", {})  # a span ends the backward region
    count[0] += 4
    observer.exit()
    count[0] += 1
    assert observer.finish()["spans"] == {"fwd": 2, "fwd.bwd": 3,
                                          "leaf.bwd": 1, "mstep": 4,
                                          "root": 1}


def test_grad_boundary_is_a_no_op_without_an_observer():
    t = torch.zeros(3, requires_grad=True)
    obs.grad_boundary(t, "x.bwd")
    assert t._backward_hooks is None or not t._backward_hooks


# ------------------------------------------------------------ step programs
def test_step_capture_splits_leaf_from_einsum_layers_fwd_and_bwd():
    reg, seam = _registry()
    net = _pd()
    x = _x(net)
    kinds = {s.kind for s in net.exec_plan}
    assert kinds == {"gather", "layer"}
    step = make_em_step(net, TrainConfig(em=EMConfig(), health=False), reg)
    # the replay counter is the process's: other files' steps of this
    # label may have replayed before
    replays0 = _replays("em_step")
    step(x)
    step(x)
    got = obs.layer_maps()["em_step"]
    spans = got["spans"]
    assert got["nodes"] == seam.totals[-1]
    assert sum(spans.values()) == got["nodes"]
    assert _nodes("em_step") == spans
    assert set(spans) == {"root", "layer.leaf", "plan.segment",
                          "plan.segment.bwd", "layer.leaf.bwd", "em.mstep",
                          "em.blend"}
    # the leaf layer's backward: its statistics from the leaf rows'
    # gradient, and nothing of the einsum layers' backward
    g = torch.rand(x.shape[0], net.leaf_spec.num_leaves, net.K)
    ops = _Ops()
    with ops, torch.no_grad():
        leaf_statistics(net, variable_major_statistics(net, x), g)
    assert spans["layer.leaf.bwd"] == ops.n
    # in capture order: forward, then the einsum layers' backward (one
    # region a segment, last segment first), then the leaf layer's
    order = [name for name, *_ in got["layers"]]
    first = order.index("plan.segment.bwd")
    assert "plan.segment" in order[:first] and "layer.leaf" in order[:first]
    bwd = [(a["start"], a["stop"]) for name, a, *_ in got["layers"]
           if name == "plan.segment.bwd"]
    assert bwd == sorted(((s.start, s.stop) for s in net.exec_plan),
                         reverse=True)
    assert order.index("layer.leaf.bwd") > max(
        i for i, n in enumerate(order) if n == "plan.segment.bwd")
    assert order.index("em.mstep") < order.index("em.blend")
    # one capture, two replays
    assert _replays("em_step") - replays0 == 2
    assert len(seam.totals) == 1


def test_fused_rat_step_marks_each_fused_segment():
    reg, _ = _registry()
    net = _rat()
    assert {s.kind for s in net.exec_plan} == {"fused"}
    make_em_step(net, TrainConfig(em=EMConfig(), health=False), reg)(_x(net))
    spans = obs.layer_maps()["em_step"]["spans"]
    assert spans["plan.segment"] > 0 and spans["plan.segment.bwd"] > 0
    assert spans["layer.leaf"] > 0 and spans["layer.leaf.bwd"] > 0


def test_staged_step_labels_body_and_finish():
    reg, _ = _registry()
    net = _rat()
    cfg = TrainConfig(em=EMConfig(), num_microbatches=2, health=False)
    step = make_em_step(net, cfg, reg)
    b0, f0 = _replays("em_step.body"), _replays("em_step")
    for _ in range(3):
        step(_x(net))
    assert _replays("em_step.body") - b0 == 6
    assert _replays("em_step") - f0 == 3
    maps = obs.layer_maps()
    assert "layer.leaf.bwd" in maps["em_step.body"]["spans"]
    assert set(maps["em_step"]["spans"]) >= {"em.mstep", "em.blend"}


def test_soft_mixture_step_marks_the_mixture_and_its_components():
    reg, seam = _registry()
    c_n = 3
    mix = EiNetMixture(_pd(), c_n, seed=0)
    step = make_mixture_em_step(mix, MixtureTrainConfig(assign="soft"), reg)
    x = _x(mix.component)
    step(x)
    got = obs.layer_maps()["mixture_em_step"]
    spans = got["spans"]
    assert got["nodes"] == seam.totals[-1]
    assert sum(spans.values()) == got["nodes"]
    assert _nodes("mixture_em_step") == spans
    assert {"mixture.top", "mixture.top.bwd", "mixture.weights",
            "mixture.component", "layer.leaf", "plan.segment",
            "plan.segment.bwd", "layer.leaf.bwd", "em.mstep",
            "em.blend"} <= set(spans)
    assert all(spans[n] > 0 for n in ("mixture.top", "mixture.top.bwd",
                                      "mixture.weights"))
    # each component's backward starts from the mixture's top, last
    # component first, and the components' forwards are spans of their own
    layers = got["layers"]
    order = [name for name, *_ in layers]
    comps = [a["c"] for name, a, *_ in layers if name == "mixture.component"]
    assert sorted(set(comps)) == list(range(c_n))
    first_bwd = order.index("plan.segment.bwd")
    assert order[first_bwd - 1] == "mixture.top.bwd"
    tops = [i for i, n in enumerate(order) if n == "mixture.top.bwd"]
    assert len(tops) == c_n
    assert all(order[i + 1] == "plan.segment.bwd" for i in tops)


# --------------------------------------------------------- serving programs
@pytest.mark.parametrize("kind, want", [
    ("joint_ll", {"layer.leaf", "plan.segment", "root"}),
    ("conditional_ll", {"layer.leaf", "plan.segment", "root"}),
    ("sample", {"query.noise", "layer.leaf", "layer.einsum",
                "query.topdown", "root"}),
    ("mpe", {"layer.leaf", "layer.einsum", "query.topdown", "root"}),
])
def test_query_programs_map_every_node_to_a_layer(kind, want):
    reg, seam = _registry()
    net = _rat()
    prog = reg.capture(net, (kind, 4, None), query_fn(kind),
                       assemble_batch(net, [], 4))
    label = f"query.{kind}.4"
    assert prog.label == label
    got = obs.layer_maps()[label]
    assert set(got["spans"]) == want
    assert sum(got["spans"].values()) == got["nodes"] == seam.totals[-1]
    assert _nodes(label) == got["spans"]


def test_replays_count_replays_not_captures():
    reg, _ = _registry()
    net = _rat()
    batch = assemble_batch(net, mixed_requests(net.num_vars, 4, seed=1), 4)
    before = _replays("query.joint_ll.4")
    prog = reg.capture(net, ("joint_ll", 4), query_fn("joint_ll"), batch)
    assert _replays("query.joint_ll.4") == before
    for _ in range(3):
        prog(batch)
    assert _replays("query.joint_ll.4") - before == 3
    assert prog.replay_seconds() is None  # no timing events off the card


def test_a_recapture_replaces_the_counts():
    net = _rat()
    batch = assemble_batch(net, [], 2)
    for _ in range(2):
        reg, seam = _registry()
        reg.capture(net, ("mpe", 2), query_fn("mpe"), batch)
    assert sum(_nodes("query.mpe.2").values()) == seam.totals[-1]


def test_no_node_counter_observes_nothing():
    reg = compile_lib.ProgramRegistry(capture_fn=_CountingCapture(),
                                      node_counter=lambda device: None)
    net = _rat()
    before = obs.layer_maps().get("query.marginal_ll.2")
    reg.capture(net, ("marginal_ll", 2), query_fn("marginal_ll"),
                assemble_batch(net, [], 2))
    assert obs.layer_maps().get("query.marginal_ll.2") is before


def test_export_writes_layer_maps_and_the_profiler_base(tmp_path):
    import json

    reg, _ = _registry()
    net = _rat()
    reg.capture(net, ("joint_ll", 2), query_fn("joint_ll"),
                assemble_batch(net, [], 2))
    doc = json.loads(open(obs.export_trace(str(tmp_path / "t.json"))).read())
    assert doc["baseTimeNanoseconds"] == obs.BASE_NS
    assert "query.joint_ll.2" in doc["otherData"]["layer_maps"]


# ------------------------------------------------------------------- engine
def test_engine_phase_counters_and_step_count():
    net = _rat()
    eng = ServeEngine(net, max_batch=4)

    def read():
        return ([obs.METRICS.value("serve.step.seconds", phase=p)
                 for p in STEP_PHASES],
                obs.METRICS.value("serve.steps.count"),
                obs.METRICS.value("serve.replay.count"))

    phases0, steps0, replays0 = read()
    steps_before = eng.stats["steps"]
    eng.run(mixed_requests(net.num_vars, 11, seed=3))
    phases1, steps1, replays1 = read()
    spent = [b - a for a, b in zip(phases0, phases1)]
    assert steps1 - steps0 == eng.stats["steps"] - steps_before >= 3
    assert all(s > 0 for s in spent)
    assert replays1 == replays0  # eager programs: nothing replayed
    assert obs.METRICS.gauge("serve.queue.depth").max >= 1
    assert obs.summary()["serve_queue_wait_ms"] >= 0


# -------------------------------------------------------------------- clock
def test_obs_span_and_record_function_share_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    def probe():
        with record_function("probe.range"):
            with obs.span("probe.span"):
                torch.ones(4).sum()

    mark = obs.num_events()
    obs.configure(trace=True)
    try:
        probe()  # first use of both
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            probe()
    finally:
        obs.configure(trace=False)
    ranges = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "probe.range"]
    spans = [e for e in obs.trace_events()[mark:] if e["name"] == "probe.span"]
    assert len(ranges) == 1 and len(spans) == 2
    start_ns = obs.BASE_NS + spans[-1]["ts"] * 1e3
    assert abs(start_ns - ranges[0]) < 100e3
