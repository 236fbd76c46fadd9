"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Verifier: every registered arch verifies clean in both packages; each
corruption of ``tests/test_analysis_verify.py`` that applies to what the
port copies (region graphs, pair specs, plans) is applied to a reference
and a port structure alike, and both report the same invariant ids; the
fused run the reference's budget admits but the card's kernels cannot hold
(K=24, four depths) is caught under ``plan/vmem-budget``.

Sentry: one capture per step program through the registry's injected
capture function, the dtype-promotion finding, a moving-pointer recapture
storm named, and the serve stream's captures bounded by kinds x buckets.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from repro.analysis import verify as ref_verify
from repro.configs import REGISTRY as REF_CONFIGS
from repro.core import EiNet as RefEiNet
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro.core.einet import PairSpec as RefPairSpec
from repro.core.region_graph import RegionGraph as RefRegionGraph
from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.analysis import sentry as sentry_lib
from repro_torch.analysis import verify as port_verify
from repro_torch.analysis.sentry import CompileSentry
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet, PairSpec
from repro_torch.core.region_graph import RegionGraph
from repro_torch.kernels import grouped as grouped_kernels
from repro_torch.serve import ServeEngine, mixed_requests
from repro_torch.train import TrainConfig, make_em_step


def _ids(findings):
    return {f.invariant for f in findings}


# ------------------------------------------------------------ clean passes
def test_invariants_are_the_references():
    assert port_verify.INVARIANTS == ref_verify.INVARIANTS
    assert len(port_verify.INVARIANTS) == 20


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_registered_archs_verify_clean_in_both(arch):
    port = port_verify.verify_config(get_config(arch))
    ref = ref_verify.verify_config(REF_CONFIGS[arch])
    assert port.ok, port.format_report()
    assert ref.ok, ref.format_report()
    assert port.invariants == ref.invariants


def test_einet_verify_knob_and_env(monkeypatch):
    g = random_binary_trees(8, 2, 2, seed=0)
    net = EiNet(g, num_sums=4, device="cpu", verify="raise")
    assert net.verify_report is not None and net.verify_report.ok
    with pytest.raises(ValueError, match="verify"):
        EiNet(g, num_sums=4, device="meta", verify="bogus")
    monkeypatch.setenv("REPRO_VERIFY", "raise")
    assert EiNet(g, num_sums=4, device="meta").verify_report.ok
    monkeypatch.setenv("REPRO_VERIFY", "off")
    assert EiNet(g, num_sums=4, device="meta").verify_report is None


# ------------------------------------------------------ corruption parity
def _graph(pkg, num_vars, regions, partitions, root=0):
    cls = RefRegionGraph if pkg == "ref" else RegionGraph
    return cls(num_vars=num_vars, regions=regions, partitions=partitions,
               root=root)


GRAPH_CASES = {
    "graph/decomposability": (2, [(0, 1), (0,), (0,)], [(0, 1, 2)], 0),
    "graph/smoothness": (3, [(0, 1, 2), (0,), (1,)], [(0, 1, 2)], 0),
    "graph/nonempty-scope": (2, [(0, 1), (), (0, 1)], [(0, 1, 2)], 0),
    "graph/root-scope": (3, [(0, 1), (0,), (1,)], [(0, 1, 2)], 0),
}


@pytest.mark.parametrize("invariant", sorted(GRAPH_CASES))
def test_graph_corruptions_match(invariant):
    n, regions, partitions, root = GRAPH_CASES[invariant]
    ref = _ids(ref_verify.verify_region_graph(
        _graph("ref", n, regions, partitions, root)))
    port = _ids(port_verify.verify_region_graph(
        _graph("port", n, regions, partitions, root)))
    assert invariant in port and port == ref


def _synthetic(pkg):
    """The reference test's hand-built circuit: 4 vars, leaves rows 0-3,
    pair 0 emits einsum rows 4-6 and mixing row 7, the final pair the root
    row 8."""
    cls = RefPairSpec if pkg == "ref" else PairSpec

    def spec(**kw):
        return cls(**{"mix_child_local": None, "mix_mask": None,
                      "mix_global": None, "is_final": False, **kw})

    pair0 = spec(
        left=np.array([0, 0, 2]), right=np.array([1, 1, 3]),
        einsum_global=np.arange(4, 7), k_in=2, k_out=2,
        mix_child_local=np.array([[0, 1]]),
        mix_mask=np.array([[1.0, 1.0]], np.float32),
        mix_global=np.array([7]),
    )
    pair1 = spec(left=np.array([7]), right=np.array([6]),
                 einsum_global=np.array([8]), k_in=2, k_out=1, is_final=True)
    return SimpleNamespace(
        leaf_spec=SimpleNamespace(leaf_scopes=[(0,), (1,), (2,), (3,)]),
        pair_specs=[pair0, pair1], num_vars=4, K=2, num_classes=1)


def _set(pair, field, value):
    def corrupt(m):
        setattr(m.pair_specs[pair], field, value)
    return corrupt


def _more_vars(m):
    m.num_vars = 5


CIRCUIT_CASES = {
    "scope-overlap": ("circuit/scope-decomposability",
                      _set(0, "right", np.array([0, 1, 3]))),
    "row-range": ("circuit/row-range", _set(0, "left", np.array([0, 0, 99]))),
    "allocation": ("circuit/allocation-order",
                   _set(0, "einsum_global", np.arange(5, 8))),
    "k-chain": ("circuit/k-chain", _set(1, "k_out", 3)),
    "mix-mask": ("circuit/mix-tables",
                 _set(0, "mix_mask", np.zeros((1, 2), np.float32))),
    "mix-child": ("circuit/mix-tables",
                  _set(0, "mix_child_local", np.array([[0, 9]]))),
    "smoothness": ("circuit/scope-smoothness",
                   _set(0, "mix_child_local", np.array([[0, 2]]))),
    "root-coverage": ("circuit/root-coverage", _more_vars),
}


@pytest.mark.parametrize("case", sorted(CIRCUIT_CASES))
def test_circuit_corruptions_match(case):
    invariant, corrupt = CIRCUIT_CASES[case]
    assert ref_verify.verify_circuit(_synthetic("ref")) == []
    assert port_verify.verify_circuit(_synthetic("port")) == []
    found = {}
    for pkg, mod in (("ref", ref_verify), ("port", port_verify)):
        m = _synthetic(pkg)
        corrupt(m)
        found[pkg] = _ids(mod.verify_circuit(m))
    assert invariant in found["port"] and found["port"] == found["ref"]


def _nets(kind):
    """A reference and a port model of the same small structure: RAT (a
    fused plan) or a 6x6 Poon-Domingos grid (a gather plan)."""
    if kind == "rat":
        return (RefEiNet(ref_rbt(8, 2, 2, seed=0), num_sums=4),
                EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=4,
                      device="meta"))
    return (RefEiNet(ref_pd(6, 6, 2), num_sums=4),
            EiNet(poon_domingos(6, 6, 2), num_sums=4, device="meta"))


def _replace_segment(net, idx, **kw):
    segs = list(net.plan.segments)
    segs[idx] = dataclasses.replace(segs[idx], **kw)
    net.plan = dataclasses.replace(net.plan, segments=tuple(segs))


def _seg(net, pred):
    return next(i for i, s in enumerate(net.plan.segments) if pred(s))


def _drop_first_segment(net):
    net.plan = dataclasses.replace(net.plan, segments=net.plan.segments[1:])


def _flip_mix_flag(net):
    flags = list(net.plan.mix_flags)
    flags[0] = not flags[0]
    net.plan = dataclasses.replace(net.plan, mix_flags=tuple(flags))


def _gather_tables(edit):
    def corrupt(net):
        i = _seg(net, lambda s: s.kind == "gather")
        tb = net.plan.segments[i].tables
        _replace_segment(net, i, tables=dataclasses.replace(tb, **edit(tb)))
    return corrupt


def _far_row(tb):
    left = list(tb.left)
    left[0] = (10 ** 6,) + left[0][1:]
    return {"left": tuple(left)}


def _reversed_rows(tb):
    return {"left": (tb.left[0][::-1],) + tb.left[1:]}


def _dropped_mix(tb):
    d = next(d for d, m in enumerate(tb.mix_child) if m is not None)
    mix_child = list(tb.mix_child)
    mix_child[d] = None
    return {"mix_child": tuple(mix_child)}


def _budget_one(net):
    field = "vmem_budget" if hasattr(net.plan, "vmem_budget") \
        else "plan_budget"
    net.plan = dataclasses.replace(net.plan, **{field: 1})


def _fused(**kw):
    def corrupt(net):
        _replace_segment(net, _seg(net, lambda s: s.kind == "fused"), **kw)
    return corrupt


def _non_canonical(net):
    seg = net.plan.segments[_seg(net, lambda s: s.kind == "fused")]
    net.pair_specs[seg.start].canonical = False


def _bogus_kind(net):
    _replace_segment(net, 0, kind="bogus")


def _self_product(net):
    sp = net.pair_specs[0]
    sp.right = sp.right.copy()
    sp.right[0] = int(sp.left[0])


# name -> (structure, invariant, corruption, check): check "plan" runs
# verify_plan, "einet" the whole verify_einet
PLAN_CASES = {
    "coverage-gap": ("pd", "plan/coverage", _drop_first_segment, "plan"),
    "mix-flags": ("pd", "plan/mix-flags", _flip_mix_flag, "plan"),
    "gather-row-range": ("pd", "plan/gather-row-range",
                         _gather_tables(_far_row), "plan"),
    "gather-swapped-rows": ("pd", "plan/gather-tables",
                            _gather_tables(_reversed_rows), "plan"),
    "gather-mix-table": ("pd", "plan/mix-flags",
                         _gather_tables(_dropped_mix), "plan"),
    "budget-rat": ("rat", "plan/vmem-budget", _budget_one, "plan"),
    "budget-pd": ("pd", "plan/vmem-budget", _budget_one, "plan"),
    "fused-tiling": ("rat", "plan/fused-tiling", _fused(out_block=0),
                     "plan"),
    "fused-structure": ("rat", "plan/fused-structure", _non_canonical,
                        "plan"),
    "lanes-contract": ("rat", "plan/lanes-contract", _fused(block_b=12),
                       "plan"),
    "segment-kind": ("pd", "plan/segment-kind", _bogus_kind, "plan"),
    "scope-swap": ("pd", "circuit/scope-decomposability", _self_product,
                   "einet"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_corruptions_match(case):
    kind, invariant, corrupt, check = PLAN_CASES[case]
    ref, port = _nets(kind)
    found = {}
    for pkg, net, mod in (("ref", ref, ref_verify),
                          ("port", port, port_verify)):
        corrupt(net)
        found[pkg] = _ids(mod.verify_plan(net) if check == "plan"
                          else mod.verify_einet(net).findings)
    assert invariant in found["port"] and found["port"] == found["ref"]


def test_infeasible_fused_run_caught_on_the_card_rule():
    """At K=24 the reference's 12 MiB budget fuses the 4-depth run [0, 4),
    whose output cell's subtree does not fit the fused kernels' blocks on
    the card; the port plans [0, 3) + a layer.  The reference's plan
    carried into the port is reported under plan/vmem-budget."""
    graph = ref_rbt(512, 4, 10, seed=0)
    ref = RefEiNet(graph, num_sums=24)
    port = EiNet(random_binary_trees(512, 4, 10, seed=0), num_sums=24,
                 device="meta")
    assert port_verify.verify_einet(port).ok
    seg = ref.plan.segments[0]
    assert (seg.start, seg.stop, seg.kind) == (0, 4, "fused")
    port.plan = dataclasses.replace(port.plan, segments=(
        dataclasses.replace(port.plan.segments[0], stop=4,
                            out_block=seg.out_block, block_b=seg.block_b),))
    findings = port_verify.verify_plan(port)
    assert _ids(findings) == {"plan/vmem-budget"}
    assert any("launch geometry" in f.message for f in findings)
    assert ref_verify.verify_plan(ref) == []


def test_infeasible_gather_run_caught(monkeypatch):
    """A gather run longer than the gather kernels take is reported under
    plan/vmem-budget."""
    _, port = _nets("pd")
    tb = port.plan.segments[_seg(port, lambda s: s.kind == "gather")].tables
    assert port_verify.verify_plan(port) == []
    monkeypatch.setattr(grouped_kernels, "GATHER_MAX_DEPTHS",
                        tb.num_depths - 1)
    findings = port_verify.verify_plan(port)
    assert _ids(findings) == {"plan/vmem-budget"}
    assert any("depths exceed" in f.message for f in findings)


# ------------------------------------------------------------------ sentry
class _Seam:
    """A capture function that records nothing and executes nothing (as a
    real capture executes nothing); a replay runs the stage."""

    def __init__(self):
        self.captures = 0

    def __call__(self, run, device, pool):
        self.captures += 1
        return run, None


def _small_net(seed=0):
    return EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                 device="cpu", seed=seed)


def _x(b=16, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(b, 8).astype(np.float32))


def test_step_program_captures_once():
    seam = _Seam()
    reg = compile_lib.ProgramRegistry(capture_fn=seam)
    net = _small_net()
    with CompileSentry(registry=reg) as sentry:
        step = sentry.wrap(make_em_step(net, TrainConfig(num_microbatches=2),
                                        registry=reg), name="em_step")
        lls = [step(_x()) for _ in range(3)]
    sentry.assert_max_compiles(1, name="em_step")
    sentry.assert_no_leaks()
    assert sentry.compiles("em_step") == 1
    assert sentry.recaptures("em_step") == 0
    assert sentry.registry_compiles() == 1 and seam.captures == 2
    assert len(sentry.compile_events) == 1 == sentry.captures("em_step")
    assert all(np.isfinite(lls))


def test_captures_on_a_first_call_are_counted():
    """A program that captures twice on its first call reads 1 by
    signature (``compiles``) and 2 by ``captures``: the capture events of
    a new signature's call are kept too."""
    captured = []

    def step(v):
        if not captured:
            for i in range(2):
                obs.compile_event("graph", ("step", i), 0.0)
                captured.append(i)
        return v

    with CompileSentry() as sentry:
        f = sentry.wrap(step, name="step")
        f(torch.zeros(4))
        f(torch.zeros(4))
    assert sentry.compiles("step") == 1 and sentry.recaptures("step") == 0
    assert sentry.captures("step") == 2 == sentry.captures()
    assert "2 capture event(s)" in sentry.report()


def test_moving_pointer_recapture_storm_named():
    """A parameter replaced before every call (not written in place) moves
    a pointer the step's graphs read: every call recaptures, and the
    sentry counts and names it."""
    reg = compile_lib.ProgramRegistry(capture_fn=_Seam())
    net = _small_net()
    with CompileSentry(registry=reg) as sentry:
        step = sentry.wrap(make_em_step(net, TrainConfig(), registry=reg),
                           name="em_step")
        step(_x())
        net.class_prior = nn.Parameter(net.class_prior.detach().clone())
        step(_x())
        assert sentry.recaptures("em_step") == 1
        assert sentry.findings == []  # one replaced parameter: one recapture
        for _ in range(2):
            net.class_prior = nn.Parameter(net.class_prior.detach().clone())
            step(_x())
    assert sentry.compiles("em_step") == 4 == sentry.captures("em_step")
    assert sentry.recaptures("em_step") == 3
    assert sentry.registry_compiles() == 4
    assert [f.kind for f in sentry.findings] == ["recapture-storm"]
    assert "em_step" in str(sentry.findings[0])
    with pytest.raises(AssertionError, match="recompile sentry"):
        sentry.assert_max_compiles(1, name="em_step")
    with pytest.raises(AssertionError, match="recapture-storm"):
        sentry.assert_no_leaks()


def test_dtype_promotion_leak_detected(compile_sentry_torch):
    f = compile_sentry_torch.wrap(lambda v: v + 1, name="f")
    f(torch.zeros(4, dtype=torch.float32))
    f(torch.zeros(4, dtype=torch.float64))
    assert compile_sentry_torch.compiles("f") == 2
    kinds = [x.kind for x in compile_sentry_torch.findings]
    assert kinds == ["dtype-promotion-leak"]
    assert "torch.float32->torch.float64" in str(
        compile_sentry_torch.findings[0])


def test_shape_polymorphism_is_not_a_leak(compile_sentry_torch):
    f = compile_sentry_torch.wrap(lambda v: v, name="f")
    f(torch.zeros(4))
    f(torch.zeros(8))
    f(torch.zeros(8))
    assert compile_sentry_torch.compiles("f") == 2
    assert compile_sentry_torch.findings == []


def test_signature_keys_on_shape_dtype_device():
    sig = sentry_lib._signature(
        ({"x": torch.zeros(2, 3), "seeds": [1, 2]},), {"kind": "mpe"})
    assert sig == (  # dict keys in sorted order
        ("static", "1", None), ("static", "2", None),
        ((2, 3), "torch.float32", "cpu"),
        ("static", "'mpe'", None))


def _graph_capture(run, device, pool):
    out = run()

    def replay():
        with torch.inference_mode():
            out.copy_(run())
    return replay, out


def test_mixed_serve_stream_bounded_captures():
    """64 mixed-kind requests capture at most kinds x buckets programs; a
    second wave captures none."""
    net = _small_net()
    engine = ServeEngine(net, max_batch=8, registry=compile_lib.ProgramRegistry(
        capture_fn=_graph_capture))
    reqs = mixed_requests(net.num_vars, 64, seed=7)
    kinds = {r.kind for r in reqs}
    with CompileSentry(registry=engine.registry) as sentry:
        results = engine.run(reqs)
    assert len(results) == 64
    assert 0 < sentry.registry_compiles() <= len(kinds) * len(engine.buckets)
    assert len(sentry.compile_events) == sentry.registry_compiles()
    with CompileSentry(registry=engine.registry) as sentry2:
        engine.run(mixed_requests(net.num_vars, 64, seed=8))
    assert sentry2.registry_compiles() == 0


def test_registry_required_for_registry_compiles():
    with CompileSentry() as sentry:
        pass
    with pytest.raises(ValueError, match="registry"):
        sentry.registry_compiles()


@pytest.fixture
def compile_sentry_torch():
    with CompileSentry() as sentry:
        yield sentry
