"""The port's program registry (``repro_torch.compile``) and its counter-
based per-row noise (``repro_torch.core.philox``) on the CPU.

On the CPU a program is the eager query; the graph bookkeeping (static
buffers, copies handed back, launch counters left to the wrappers,
recapture when a tensor the model reads moves) is exercised through an
injected capture function, which records nothing and replays by rerunning
the function.  The graphs themselves run
only on the card (``chip_smoke.py``).
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.core import philox, random_binary_trees
from repro_torch.core.einet import _U_MIN, EiNet
from repro_torch.kernels import ops
from repro_torch.serve import ServeEngine, mixed_requests
from repro_torch.serve.engine import assemble_batch, query_fn

D = 8


def _net(seed=0):
    return EiNet(random_binary_trees(D, 2, 2, seed=0), num_sums=3,
                 device="cpu", seed=seed)


def _counter(name, kind):
    return obs.METRICS.value(name, kind=kind)


# ---------------------------------------------------------------- registry
def test_registry_keys_hits_and_counters():
    reg = compile_lib.ProgramRegistry()
    net = _net()
    batch = assemble_batch(net, [], 4)
    misses0 = _counter("compile.cache.misses", "eager")
    hits0 = _counter("compile.cache.hits", "eager")
    p1 = reg.capture(net, ("joint_ll", 4), query_fn("joint_ll"), batch)
    p2 = reg.capture(net, ("joint_ll", 4), query_fn("joint_ll"), batch)
    p3 = reg.capture(net, ("mpe", 4), query_fn("mpe"), batch)
    assert p1 is p2 and p1 is not p3
    assert isinstance(p1, compile_lib.EagerProgram) and p1.kind == "eager"
    assert reg.stats == {"compiles": 2, "compile_s": 0.0, "hits": 1}
    assert _counter("compile.cache.misses", "eager") - misses0 == 2
    assert _counter("compile.cache.hits", "eager") - hits0 == 1
    assert list(reg.table(net)) == [("joint_ll", 4), ("mpe", 4)]
    other = _net(1)
    reg.capture(other, ("joint_ll", 4), query_fn("joint_ll"), batch)
    assert reg.num_programs(net) == 2 and reg.num_programs() == 3
    with torch.inference_mode():
        want = net.query(batch, "joint_ll")
    assert torch.equal(p1(batch), want)
    reg.clear()
    assert reg.num_programs() == 0 and reg.stats["compiles"] == 0


def test_registry_releases_dead_anchors():
    reg = compile_lib.ProgramRegistry()
    net = _net()
    prog = reg.capture(net, ("joint_ll", 2), query_fn("joint_ll"),
                       assemble_batch(net, [], 2))
    engine = ServeEngine(net, max_batch=2, registry=reg)
    engine.warmup(kinds=["mpe"])
    assert reg.num_programs() == 3
    del net, engine
    gc.collect()
    assert reg.num_programs() == 0
    with pytest.raises(ReferenceError):
        prog(assemble_batch(_net(), [], 2))


def _fake_capture(launches=None):
    """A capture function for the CPU: ``run`` is called once to make the
    output buffer, each replay reruns it into the buffer.  ``launches``
    (op -> n) stands for the kernel launches a capture would record: the
    capture adds them to the ops' counters, as the kernels' wrappers do
    while a graph records; a replay adds nothing, as a graph's replay runs
    no wrapper."""
    calls = {"captures": 0, "replays": 0}

    def capture(run, device, pool):
        assert pool is None and device.type == "cpu"
        calls["captures"] += 1
        out = run()
        for op, n in (launches or {}).items():
            op.launches += n

        def replay():
            calls["replays"] += 1
            with torch.inference_mode():  # the query's output is one
                out.copy_(run())
        return replay, out

    return capture, calls


def test_graph_program_bookkeeping_with_injected_capture():
    capture, calls = _fake_capture({ops.log_einsum_exp: 3,
                                    ops.grouped_log_einsum_exp: 1})
    reg = compile_lib.ProgramRegistry(capture_fn=capture)
    net = _net()
    reqs = mixed_requests(D, 4, seed=1)
    ops.reset_counts()
    prog = reg.capture(net, ("conditional_sample", 4),
                       query_fn("conditional_sample"),
                       assemble_batch(net, [], 4))
    assert isinstance(prog, compile_lib.GraphProgram)
    assert calls["captures"] == 1 and reg.stats["compiles"] == 1
    # the counters hold what the wrappers counted while the graph recorded
    # and nothing else: the program neither takes it off nor adds to it
    counts = (ops.log_einsum_exp.launches,
              ops.grouped_log_einsum_exp.launches)
    assert counts == (3, 1)
    batch = assemble_batch(net, reqs, 4)
    with torch.inference_mode():
        want = net.query(batch, "conditional_sample")
    out = prog(batch)
    assert torch.equal(out, want)
    prog(batch)
    assert (ops.log_einsum_exp.launches,
            ops.grouped_log_einsum_exp.launches) == counts
    assert prog.replays == 2 and calls["replays"] == 2
    with pytest.raises(ValueError, match="captured as"):
        prog(assemble_batch(net, reqs[:2], 2))


def test_graph_program_recaptures_when_a_tensor_moves():
    capture, calls = _fake_capture()
    reg = compile_lib.ProgramRegistry(capture_fn=capture)
    net = _net()
    batch = assemble_batch(net, mixed_requests(D, 2, seed=2), 2)
    prog = reg.capture(net, ("joint_ll", 2), query_fn("joint_ll"), batch)
    first = prog(batch).clone()
    # an in-place write (training's M-step) keeps every pointer: no
    # recapture, and the replay reads the new weights
    with torch.no_grad():
        net.phi.mul_(0.5)
    with torch.inference_mode():
        want = net.query(batch, "joint_ll")
    assert torch.equal(prog(batch), want) and not torch.equal(want, first)
    assert calls["captures"] == 1 and reg.stats["compiles"] == 1
    # a replaced parameter costs exactly one recapture
    misses0 = _counter("compile.cache.misses", "graph")
    net.class_prior = nn.Parameter(net.class_prior.detach().clone())
    prog(batch)
    assert calls["captures"] == 2 and reg.stats["compiles"] == 2
    assert _counter("compile.cache.misses", "graph") - misses0 == 1
    prog(batch)
    assert calls["captures"] == 2
    # a replaced buffer (a static table) moves a pointer too
    net.pair0_left = net.pair0_left.clone()
    assert torch.equal(prog(batch), want)
    assert calls["captures"] == 3


def test_graph_program_hands_back_a_copy():
    """A program's output stays valid when the program, or another one of
    the same model, replays afterwards: the static output is copied after
    each replay (exact equality)."""
    capture, _ = _fake_capture()
    reg = compile_lib.ProgramRegistry(capture_fn=capture)
    net = _net()
    reqs = mixed_requests(D, 4, seed=4)
    a = reg.capture(net, ("joint_ll", 2), query_fn("joint_ll"),
                    assemble_batch(net, [], 2))
    b = reg.capture(net, ("mpe", 2), query_fn("mpe"),
                    assemble_batch(net, [], 2))
    b1, b2 = assemble_batch(net, reqs[:2], 2), assemble_batch(net, reqs[2:], 2)
    with torch.inference_mode():
        want1 = net.query(b1, "joint_ll")
        want2 = net.query(b2, "joint_ll")
    out1 = a(b1)
    b(b2)
    out2 = a(b2)
    assert not torch.equal(want1, want2)
    assert torch.equal(out1, want1) and torch.equal(out2, want2)


def test_read_tensors_cover_a_mixture():
    from repro_torch.mixture import EiNetMixture

    mix = EiNetMixture(_net(), 2)
    got = {t.data_ptr() for t in compile_lib.read_tensors(mix)}
    assert {p.data_ptr() for p in mix.parameters()} <= got
    assert {b.data_ptr() for b in mix.component.buffers()} <= got


def test_engine_with_injected_capture_matches_eager():
    capture, calls = _fake_capture()
    net = _net()
    reqs = mixed_requests(D, 13, seed=3)
    eager = ServeEngine(net, max_batch=4).run(reqs)
    graphed = ServeEngine(net, max_batch=4,
                          registry=compile_lib.ProgramRegistry(capture)
                          ).run(reqs)
    assert calls["captures"] > 0
    for r in reqs:
        np.testing.assert_array_equal(graphed[r.req_id].value,
                                      eager[r.req_id].value)


# ------------------------------------------------------------------- pools
class _Graph:
    """Stands for a captured graph: while it lives, the pool it was
    captured into is in use (PyTorch releases a pool once its graphs are
    gone).  A replay reruns the recorded function (into the static output
    of a serving program; a step stage returns nothing)."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        if self.out is None:
            self.run()
            return
        with torch.inference_mode():
            self.out.copy_(self.run())


class _PoolSeam:
    """A capture function that records each capture's pool and a weak
    reference to its graph; it runs ``run`` once for the static output."""

    def __init__(self):
        self.captures = []  # (pool, weakref to the graph), in order

    def __call__(self, run, device, pool):
        graph = _Graph(run, run())
        self.captures.append((pool, weakref.ref(graph)))
        return graph.replay, graph.out

    def live(self, pool):
        gc.collect()
        return [r for p, r in self.captures if p == pool and r() is not None]


@pytest.fixture
def pool_seam(monkeypatch):
    """A registry whose captures ``_PoolSeam`` records, with numbered
    tokens for pools (``new_pool`` makes none off the card)."""
    made = []

    def new_pool(device):
        made.append(("pool", len(made)))
        return made[-1]

    monkeypatch.setattr(compile_lib, "new_pool", new_pool)
    seam = _PoolSeam()
    return compile_lib.ProgramRegistry(capture_fn=seam), seam, made


def _step(reg, net, **cfg):
    from repro_torch.train import TrainConfig, make_em_step

    return make_em_step(net, TrainConfig(**cfg), registry=reg)


def _x(b, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(b, D).astype(np.float32))


@pytest.mark.parametrize("microbatches", [1, 3])
def test_step_runs_reduce_and_gather_eagerly_between_graphs(microbatches):
    """A staged step with ``reduce`` and ``gather``: the body is captured
    even at one microbatch, and a call replays the body once a microbatch,
    then runs ``reduce`` (not captured), replays ``finish``, runs
    ``gather`` -- in that order, the same order as the eager program."""
    events, captured = [], []

    def capture(run, device, pool):
        captured.append(run)
        return (lambda: (events.append("replay"), run())), None

    def start(model):
        return {"s": torch.zeros(())}

    def body(model, acc, xb):
        events.append("body")
        acc["s"].add_(xb.sum())

    def reduce(model, acc):
        events.append("reduce")

    def finish(model, acc, x):
        events.append("finish")
        return (acc["s"].clone(),)

    def gather(model):
        events.append("gather")

    step = compile_lib.StagedStep(
        finish=finish, num_microbatches=microbatches, start=start, body=body,
        result=lambda outs: float(outs[0]), reduce=reduce, gather=gather)
    assert step.staged
    net = _net()
    reg = compile_lib.ProgramRegistry(capture_fn=capture)
    prog = reg.jit(net, ("staged", microbatches), step)
    x = _x(6)
    events.clear()
    out = prog(x)
    assert len(captured) == 2  # body and finish, even at one microbatch
    call = events[events.index("reduce") - 2 * microbatches:]
    assert call == ["replay", "body"] * microbatches + [
        "reduce", "replay", "finish", "gather"]
    eager = compile_lib.ProgramRegistry().jit(net, ("staged",), step)
    events.clear()
    assert eager(x) == out == pytest.approx(float(x.sum()))
    assert events == ["body"] * microbatches + ["reduce", "finish", "gather"]


def test_step_programs_get_distinct_pools(pool_seam):
    reg, seam, _ = pool_seam
    net = _net()
    _step(reg, net)(_x(4))
    _step(reg, net)(_x(6))  # a second shape of the same program
    _step(reg, net, mode="full")(_x(4))
    _step(reg, net, num_microbatches=2)(_x(4))  # body and finish graphs
    pools = [p for p, _ in seam.captures]
    assert len(pools) == 5
    assert len(set(pools[:3])) == 3 and pools[3] == pools[4]
    assert pools[2] != pools[3]
    assert reg.pools(net) == pools[:3] + [pools[3]]


def test_step_recapture_takes_a_fresh_pool(pool_seam):
    reg, seam, _ = pool_seam
    net = _net()
    step = _step(reg, net)
    x = _x(4)
    step(x)
    first = seam.captures[0][0]
    net.class_prior = nn.Parameter(net.class_prior.detach().clone())
    step(x)
    assert len(seam.captures) == 2 and reg.stats["compiles"] == 2
    second = seam.captures[1][0]
    assert second != first
    # the old graphs went before the new capture, and their pool with them
    assert seam.live(first) == [] and len(seam.live(second)) == 1
    assert reg.pools(net) == [second]


def test_serving_programs_of_a_model_share_a_pool(pool_seam):
    reg, seam, made = pool_seam
    net, other = _net(), _net(1)
    batch = assemble_batch(net, [], 2)
    for kind in ("joint_ll", "mpe"):
        reg.capture(net, (kind, 2), query_fn(kind), batch)
    reg.capture(other, ("joint_ll", 2), query_fn("joint_ll"), batch)
    _step(reg, net)(_x(2))
    pools = [p for p, _ in seam.captures]
    assert pools[0] == pools[1] != pools[2]
    assert pools[3] not in pools[:3]
    assert reg.pools(net) == [pools[0], pools[3]]
    assert len(made) == 3


def test_a_dropped_step_program_releases_its_pool(pool_seam):
    reg, seam, _ = pool_seam
    net = _net()
    batch = assemble_batch(net, [], 2)
    reg.capture(net, ("joint_ll", 2), query_fn("joint_ll"), batch)
    step = _step(reg, net, num_microbatches=2)
    step(_x(4))
    serve_pool, step_pool = seam.captures[0][0], seam.captures[1][0]
    assert len(seam.live(step_pool)) == 2
    del step
    reg.table(net).pop(next(k for k in reg.table(net) if k[0] == "em_step"))
    assert seam.live(step_pool) == []
    assert reg.pools(net) == [serve_pool]
    assert len(seam.live(serve_pool)) == 1
    # a dead model takes its step pools along too (a fresh one: the fake
    # serving graph above holds its model, which a real graph does not)
    net = _net(1)
    step = _step(reg, net)
    step(_x(4))
    pool = seam.captures[-1][0]
    assert len(seam.live(pool)) == 1
    del step, net
    assert seam.live(pool) == []


# ------------------------------------------------------------------ philox
M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox4x32-10 in Python integers, from the published constants."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _MASK,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & _MASK]
        k = [(k[0] + W0) & _MASK, (k[1] + W1) & _MASK]
    return c


def test_philox_python_oracle_known_answers():
    # Random123's known-answer vectors for philox4x32_10
    assert _philox_py((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox_py((_MASK,) * 4, (_MASK, _MASK)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert _philox_py((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                      (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


EDGE_SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, -1,
              -(2 ** 63), 1000]


def test_philox_tensor_equals_python_oracle():
    rng = np.random.RandomState(0)
    ctrs = [(0, 0, 0, 0), (_MASK,) * 4] + [
        tuple(int(v) for v in rng.randint(0, 2 ** 32, 4, dtype=np.uint64))
        for _ in range(30)]
    keys = [(0, 0), (_MASK, _MASK)] + [
        tuple(int(v) for v in rng.randint(0, 2 ** 32, 2, dtype=np.uint64))
        for _ in range(30)]
    t = lambda i, rows: torch.tensor([r[i] for r in rows],  # noqa: E731
                                     dtype=torch.int64)
    got = philox.philox4x32(*(t(i, ctrs) for i in range(4)),
                            t(0, keys), t(1, keys))
    for j, (c, k) in enumerate(zip(ctrs, keys)):
        assert [int(w[j]) for w in got] == _philox_py(c, k)


@pytest.mark.parametrize("n", [1, 4, 7, 33])
def test_uniforms_are_philox_words_of_each_seed(n):
    """Row b, word 4g + j: output word j of the counter (g, 0, 0, 0) under
    the key (low, high 32 bits of the seed); exact (bitwise) equality."""
    seeds = torch.tensor(EDGE_SEEDS, dtype=torch.int64)
    u = philox.uniforms(seeds, n)
    assert u.shape == (len(EDGE_SEEDS), n) and u.dtype == torch.float32
    for b, s in enumerate(EDGE_SEEDS):
        key = (s & _MASK, (s >> 32) & _MASK)
        words = [w for g in range(-(-n // 4))
                 for w in _philox_py((g, 0, 0, 0), key)][:n]
        want = np.array([(w >> 8) * 2.0 ** -24 for w in words], np.float32)
        np.testing.assert_array_equal(u[b].numpy(), want)


def test_row_noise_in_range_and_per_seed():
    net = _net()
    seeds = [0, 1, 2 ** 31, 2 ** 63 - 1]
    for lead in (0, 8):
        u = net.row_noise(seeds, lead=lead)
        assert u.shape == (4, lead + net.noise_size)
        assert float(u.min()) >= _U_MIN and float(u.max()) <= 1 - _U_MIN
        assert torch.equal(u, net.row_noise(torch.tensor(seeds), lead=lead))
        assert torch.equal(u[2:3], net.row_noise(seeds[2:3], lead=lead))
        # the lead shifts the row: the model's noise follows the lead
        assert torch.equal(u[:, lead:], philox.uniforms(
            torch.tensor(seeds), lead + net.noise_size)[:, lead:].clamp(
                _U_MIN, 1 - _U_MIN))
    big = philox.uniforms(torch.arange(64, dtype=torch.int64), 4096)
    assert abs(float(big.mean()) - 0.5) < 0.01
    with pytest.raises(ValueError, match="int64"):
        philox.uniforms(torch.zeros(3, dtype=torch.int32), 4)
