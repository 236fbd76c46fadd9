"""The readers of the program's counters (``harness/counters.py`` and the
metrics that use it) on a registry filled by hand, and, on the card, the
capture counts they read against the graphs' own node counts.

The CPU tests put a registry of the port's own metric classes in
``sys.modules["repro_torch.obs"]``'s place, so what each reader computes is
checked against numbers written here; with the port not loaded every
reader returns None, as it does for a program that lacks the counters.

    python -m pytest einbench/tests/test_einbench_counters.py -m card

runs the card test on a machine with an NVIDIA GPU.
"""

import sys
import types

import pytest

from harness import counters
from harness.spec import ROOT, Spec
from repro_torch.obs.metrics import MetricsRegistry

TRAIN = {"kind": "train"}
SERVE = {"kind": "serve"}
READERS = ("launches_per_step.train", "launches_per_step.serve",
           "leaf_launches_per_step", "serve_host_ms_per_step",
           "serve_replay_ms", "serve_queue_wait_ms")


def _read(metric, run):
    return Spec(ROOT).reader(metric).read(run)


@pytest.fixture
def reg(monkeypatch):
    r = MetricsRegistry()
    monkeypatch.setitem(sys.modules, "repro_torch.obs",
                        types.SimpleNamespace(METRICS=r))
    return r


def _nodes(reg, program, spans, replays):
    for span, n in spans.items():
        reg.counter("compile.graph.nodes", program=program, span=span).inc(n)
    reg.counter("compile.graph.replays", program=program).inc(replays)


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_none_without_the_port(metric, monkeypatch):
    monkeypatch.delitem(sys.modules, "repro_torch.obs", raising=False)
    assert counters.registry() is None
    for run in (TRAIN, SERVE):
        assert _read(metric, run) is None


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_none_on_an_empty_registry(metric, reg):
    for run in (TRAIN, SERVE):
        assert _read(metric, run) is None


def test_launches_weigh_each_program_by_its_replays(reg):
    _nodes(reg, "em_step", {"root": 10, "layer.leaf": 60,
                            "layer.leaf.bwd": 20, "plan.segment": 10}, 7)
    _nodes(reg, "query.joint_ll.64", {"root": 3, "layer.leaf": 5}, 3)
    _nodes(reg, "query.sample.8", {"root": 4, "query.topdown": 28}, 1)
    assert _read("launches_per_step.train", TRAIN) == 100.0
    assert _read("leaf_launches_per_step", TRAIN) == 80.0
    assert _read("launches_per_step.serve", SERVE) == (8 * 3 + 32 * 1) / 4
    assert _read("leaf_launches_per_step", SERVE) is None
    # a program captured but never replayed weighs nothing
    _nodes(reg, "query.mpe.2", {"root": 1000}, 0)
    assert _read("launches_per_step.serve", SERVE) == (8 * 3 + 32 * 1) / 4


def test_serving_phases_replay_and_queue_wait(reg):
    for phase, s in (("assemble", 0.3), ("launch", 0.2), ("wait", 5.0),
                     ("finish", 0.5)):
        reg.counter("serve.step.seconds", phase=phase).inc(s)
    reg.counter("serve.steps.count").inc(500)
    reg.counter("serve.replay.device_seconds").inc(0.25)
    reg.counter("serve.replay.count").inc(500)
    for kind, waits in (("joint_ll", (0.001, 0.003)), ("mpe", (0.002,))):
        h = reg.histogram("serve.queue_wait.seconds", kind=kind)
        for w in waits:
            h.record(w)
    assert _read("serve_host_ms_per_step", SERVE) == pytest.approx(2.0)
    assert _read("serve_replay_ms", SERVE) == pytest.approx(0.5)
    assert _read("serve_queue_wait_ms", SERVE) == pytest.approx(2.0)
    for metric in ("serve_host_ms_per_step", "serve_replay_ms",
                   "serve_queue_wait_ms"):
        assert _read(metric, TRAIN) is None


def test_every_new_metric_has_its_reader_and_cells():
    spec = Spec(ROOT)
    names = {w["name"] for w in spec.data["workloads"]}
    entries = {m["name"]: m for m in spec.data["per_layer"]}
    for metric in READERS:
        m = entries[metric]
        assert m["source"] == "program_counter"
        assert set(m["workloads"]) <= names
        spec.reader(metric)


# ------------------------------------------------------------------- card
@pytest.mark.card
def test_span_counts_sum_to_each_graphs_own_node_count():
    """For einet_pd's step graph and two serving graphs of einet_rat: the
    spans' node counts sum to the graph's own count (the driver's, read at
    the end of the recording), and a capture without the observer records
    the same graph node for node (each node's type and kernel)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs are captured on the card")
    from harness import program

    program._path()
    from repro_torch import compile as compile_lib
    from repro_torch import obs
    from repro_torch.kernels import graph_census
    from repro_torch.serve.engine import assemble_batch, query_fn
    from repro_torch.train import TrainConfig, make_em_step

    spec = Spec(ROOT)
    seen = []

    def census(run, device, pool):
        def counted():
            out = run()
            stream = torch.cuda.current_stream(device).cuda_stream
            seen.append(graph_census.node_kinds(stream))
            return out
        return compile_lib.capture_cuda_graph(counted, device, pool)

    def registries():
        return (compile_lib.ProgramRegistry(capture_fn=census),
                compile_lib.ProgramRegistry(
                    capture_fn=census, node_counter=lambda device: None))

    # the step of einet_pd at the cell's batch
    cfg = spec.config("einet_pd")
    x = torch.rand(cfg["batch_size"], cfg["height"] * cfg["width"]
                   * cfg["num_channels"], device="cuda")
    graphs = []
    for reg in registries():
        model = program.build_model(cfg, "cuda")
        seen.clear()
        make_em_step(model, TrainConfig(health=False), reg)(x)
        graphs.append(list(seen))
    got = obs.layer_maps()["em_step"]
    print("einet_pd em_step", got["nodes"], got["spans"])
    assert len(graphs[0]) == 1 and got["nodes"] == len(graphs[0][0])
    assert sum(got["spans"].values()) == got["nodes"]
    assert graphs[0] == graphs[1]
    assert got["spans"]["layer.leaf"] + got["spans"]["layer.leaf.bwd"] > 0
    # two serving programs of einet_rat at max_batch 64
    cfg = spec.config("einet_rat")
    for kind in ("joint_ll", "sample"):
        graphs = []
        for reg in registries():
            model = program.build_model(cfg, "cuda")
            seen.clear()
            reg.capture(model, (kind, 64, None), query_fn(kind),
                        assemble_batch(model, [], 64))
            graphs.append(list(seen))
        got = obs.layer_maps()[f"query.{kind}.64"]
        print(f"einet_rat query.{kind}.64", got["nodes"], got["spans"])
        assert got["nodes"] == len(graphs[0][0])
        assert sum(got["spans"].values()) == got["nodes"]
        assert graphs[0] == graphs[1]
