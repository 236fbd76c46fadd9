"""The port's perf and trace gates against the reference's:
``repro_torch.obs.slo`` (budgets, history) and ``repro_torch.obs.check``
(trace and metrics schemas).

Both are copies of stdlib-only reference modules, so the tests hold them
to the same problem lists on the same documents: the reference's committed
``BENCH_*.json`` under its ``slo.json``, the breach cases of
``tests/test_slo.py``, good and corrupted traces and metrics snapshots; and
the port's own exports validate clean.
"""

import copy
import json
import os

import pytest

from repro.obs import check as ref_check
from repro.obs import slo as ref_slo
from repro_torch import obs
from repro_torch.obs import check as port_check
from repro_torch.obs import slo as port_slo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLO = {
    "tolerance": 0.10,
    "serve": {
        "max_parity_abs_diff": 1e-5,
        "min_speedup_vs_jitted": 2.0,
        "p99_ms": {"joint_ll": 10.0},
    },
    "train": {"min_speedup": 1.0, "max_step_ms": {"einet_rat": 100.0}},
    "mixture": {"min_speedup": 1.2},
    "eval": {"min_engine_vs_direct": 0.2},
}


def _serve(**over):
    r = {
        "parity_ok": True,
        "grouped_ok": True,
        "parity_max_abs_diff": 1e-7,
        "speedup_vs_jitted": 3.0,
        "latency_ms": {"joint_ll": {"p50": 1.0, "p95": 5.0, "p99": 8.0}},
    }
    r.update(over)
    return r


_TRAIN_ROW = {"arch_id": "einet_rat", "grad_parity_ok": True,
              "fused_ms_per_step": 50.0, "speedup": 2.0}
_TRAIN = {"parity_ok": True, "grouped_ok": True}

# (kind, report) pairs from tests/test_slo.py: within budget, each breach,
# smoke reports (flags only), waivers, unknown kinds
CASES = [
    ("serve", _serve()),
    ("serve", _serve(latency_ms={"joint_ll": {"p99": 10.5}})),
    ("serve", _serve(latency_ms={"joint_ll": {"p99": 11.5}})),
    ("serve", _serve(smoke=True, parity_ok=False, parity_max_abs_diff=1.0)),
    ("serve", _serve(smoke=True, latency_ms={"joint_ll": {"p99": 9999.0}},
                     speedup_vs_jitted=0.01)),
    ("serve", _serve(pd_smoke={"parity_ok": True, "grouped_ok": False,
                               "parity_max_abs_diff": 0.0})),
    ("serve", _serve(latency_ms={})),
    ("serve", _serve(speedup_vs_jitted=1.0)),
    ("train", dict(_TRAIN, results=[_TRAIN_ROW])),
    ("train", dict(_TRAIN, results=[dict(_TRAIN_ROW,
                                         fused_ms_per_step=150.0)])),
    ("train", dict(_TRAIN, results=[dict(_TRAIN_ROW, speedup=0.5)])),
    ("train", dict(_TRAIN, results=[dict(_TRAIN_ROW, speedup=0.5,
                                         speedup_waiver="tiny arch")])),
    ("train", dict(_TRAIN, grouped_ok=False, results=[
        dict(_TRAIN_ROW, grad_parity_ok=False)])),
    ("mixture", {"parity_ok": True, "results": [
        {"cell": "a", "speedup": 2.0}, {"cell": "b", "speedup": 0.9}]}),
    ("mixture", {"parity_ok": False, "smoke": True, "results": []}),
    ("eval", {"parity_ok": True, "engine_vs_direct": 0.3}),
    ("eval", {"parity_ok": True, "engine_vs_direct": 0.1}),
    ("nope", {}),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_check_report_matches_reference(case):
    kind, report = CASES[case]
    got = port_slo.check_report(kind, copy.deepcopy(report), SLO)
    assert got == ref_slo.check_report(kind, copy.deepcopy(report), SLO)


def test_breach_cases_are_caught():
    """The cases above include real breaches (the comparison is not vacuous
    on empty lists)."""
    caught = [port_slo.check_report(k, r, SLO) for k, r in CASES]
    assert sum(1 for p in caught if p) >= 9


@pytest.mark.parametrize("kind", sorted(ref_slo.BENCH_FILES))
def test_committed_reference_benches_check_alike(kind):
    """The reference's committed BENCH files under its slo.json: the same
    problem lists (none) from both packages."""
    slo = ref_slo.load_slo(os.path.join(REPO_ROOT, "slo.json"))
    with open(os.path.join(REPO_ROOT, ref_slo.BENCH_FILES[kind])) as f:
        report = json.load(f)
    assert port_slo.check_report(kind, report, slo) == \
        ref_slo.check_report(kind, report, slo) == []


def test_history_row_equal_up_to_stamp():
    for kind, path in sorted(ref_slo.BENCH_FILES.items()):
        with open(os.path.join(REPO_ROOT, path)) as f:
            report = json.load(f)
        a = port_slo.history_row(kind, report)
        b = ref_slo.history_row(kind, report)
        for row in (a, b):
            row.pop("ts")
            row.pop("commit")
        assert a == b


def test_history_roundtrip(tmp_path):
    root = str(tmp_path / "hist")
    r1 = {"parity_ok": True, "results": [
        {"arch_id": "einet_rat", "fused_ms_per_step": 50.0, "speedup": 2.0}]}
    r2 = {"parity_ok": True, "smoke": True, "results": []}
    p1 = port_slo.append_history("train", r1, root=root)
    p2 = port_slo.append_history("train", r2, root=root)
    assert p1 == p2 == os.path.join(root, "train.jsonl")
    (tmp_path / "hist" / "serve.jsonl").write_text("not json\n")
    hist = port_slo.load_history(root)
    assert sorted(hist) == ["serve", "train"] and hist["serve"] == []
    assert hist["train"][0]["cells"]["einet_rat"]["fused_ms"] == 50.0
    assert hist["train"][1]["smoke"] is True
    assert hist == ref_slo.load_history(root)


def test_port_files_and_defaults():
    assert port_slo.DEFAULT_SLO_PATH == "slo_torch.json"
    assert port_slo.HISTORY_DIR == "artifacts/bench_history_torch"
    assert port_slo.BENCH_FILES == {
        k: f"BENCH_torch_{k}.json" for k in ref_slo.BENCH_FILES}


def test_check_all_and_cli(tmp_path, capsys):
    out = port_slo.check_all(bench_dir=str(tmp_path), slo=SLO)
    assert list(out) == ["(none)"]
    (tmp_path / "slo.json").write_text(json.dumps(SLO))
    (tmp_path / "BENCH_torch_eval.json").write_text(json.dumps(
        {"parity_ok": True, "engine_vs_direct": 0.01}))
    args = ["--check", "--dir", str(tmp_path), "--slo",
            str(tmp_path / "slo.json")]
    assert port_slo.main(args) == 1
    assert "engine_vs_direct" in capsys.readouterr().out
    (tmp_path / "BENCH_torch_eval.json").write_text(json.dumps(
        {"parity_ok": True, "engine_vs_direct": 0.3}))
    assert port_slo.main(args) == 0
    assert "within budget" in capsys.readouterr().out
    (tmp_path / "BENCH_torch_eval.json").write_text("{not json")
    assert port_slo.main(args) == 1
    with pytest.raises(SystemExit):
        port_slo.main([])


def test_committed_budget_file_parses():
    slo = port_slo.load_slo(os.path.join(REPO_ROOT, "slo_torch.json"))
    assert set(slo) >= {"tolerance", "serve", "train", "mixture", "eval"}
    kinds = set(ref_slo.load_slo(os.path.join(REPO_ROOT, "slo.json"))
                ["serve"]["p99_ms"])
    assert set(slo["serve"]["p99_ms"]) == kinds
    # the card profile's archs, each with budgets of its own
    assert slo["serve"]["profile"] == slo["train"]["profile"] == "card"
    assert set(slo["serve"]["p99_ms_by_arch"]) == {"einet-rat",
                                                    "einet-pd-svhn"}
    assert all(set(b) == kinds
               for b in slo["serve"]["p99_ms_by_arch"].values())
    assert set(slo["train"]["max_step_ms"]) == {
        "einet_rat", "einet_rat_large", "einet_pd"}


def test_profile_and_per_arch_budgets():
    """The port's two optional budget keys: a report of another profile
    than the budgets' is a breach (its timings are not checked), and an
    arch listed under ``p99_ms_by_arch`` is held to its own p99s."""
    slo = copy.deepcopy(SLO)
    slo["serve"]["profile"] = slo["train"]["profile"] = "card"
    slo["serve"]["p99_ms_by_arch"] = {"fast": {"joint_ll": 2.0}}
    card = _serve(profile="card", arch="other")
    assert port_slo.check_report("serve", card, slo) == []
    assert port_slo.check_report("serve", dict(card, arch="fast"), slo) == [
        "serve: joint_ll p99 8.00 ms > budget 2.0 ms (+10% tolerance = "
        "2.20)"]
    wrong = ["serve: a 'reference'-profile report; the timing budgets are "
             "for the 'card' profile"]
    assert port_slo.check_report("serve", _serve(), slo) == wrong
    assert port_slo.check_report(
        "serve", _serve(smoke=True, profile="smoke"), slo) == []
    train = dict(_TRAIN, results=[dict(_TRAIN_ROW, speedup=0.5)])
    assert port_slo.check_report("train", train, slo) == [
        wrong[0].replace("serve", "train")]
    assert port_slo.check_report("train", dict(train, profile="card"),
                                 slo) == [
        "train[einet_rat]: speedup 0.500 < floor 0.900 (budget 1.0, -10% "
        "tolerance)"]


# ------------------------------------------------------------ obs.check
def _ev(name="serve.step", ph="X", **over):
    e = {"ph": ph, "ts": 1.0, "dur": 2.0, "name": name, "args": {}}
    e.update(over)
    return e


TRACES = [
    {"traceEvents": [_ev(), _ev("plan.segment")]},
    {"traceEvents": []},
    [],
    {"traceEvents": "nope"},
    {"traceEvents": [_ev(dur=-1.0)]},
    {"traceEvents": [_ev(dur=None)]},
    {"traceEvents": [{"name": "x"}]},
    {"traceEvents": [_ev(name="")]},
    {"traceEvents": [_ev(ts=-5)]},
    {"traceEvents": [_ev(args=[])]},
    {"traceEvents": ["not an event"]},
    {"traceEvents": [_ev(ph="i")]},
]


@pytest.mark.parametrize("case", range(len(TRACES)))
@pytest.mark.parametrize("require", [(), ("serve.",), ("train.", "plan.")])
def test_validate_events_matches_reference(case, require):
    doc = TRACES[case]
    assert port_check.validate_events(doc, require) == \
        ref_check.validate_events(doc, require)


METRICS = [
    {"serve.request.seconds{kind=mpe,bucket=4}": {"count": 3, "p50": 0.1},
     "compile.cache.misses{kind=graph}": 2},
    {},
    [],
    {"bad name": 1},
    {"serve.request": 1},
    {"serve.request.seconds": float("nan")},
    {"serve.request.seconds": {"p50": "x"}},
    {"serve.request.seconds": {}},
    {"serve.request.seconds": True},
]


@pytest.mark.parametrize("case", range(len(METRICS)))
def test_validate_metrics_matches_reference(case):
    snap = METRICS[case]
    assert port_check.validate_metrics(snap) == \
        ref_check.validate_metrics(snap)


def test_nonfinite_gauges_export_a_valid_snapshot():
    """A diverged step's gauges (NaN, inf) leave their non-finite fields
    out of the snapshot, which then validates by both checkers."""
    reg = obs.MetricsRegistry()
    reg.gauge("train.health.ll.mean").set(-3.5)
    reg.gauge("train.health.ll.mean").set(float("nan"))
    reg.gauge("train.health.stat.norm.max").set(float("inf"))
    reg.gauge("train.ll.last").set(-2.0)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap == {"train.health.ll.mean": {"max": -3.5},
                    "train.ll.last": {"value": -2.0, "max": -2.0}}
    assert port_check.validate_metrics(snap) == []
    assert ref_check.validate_metrics(snap) == []


def test_port_exports_validate_clean(tmp_path, capsys):
    """A trace and a metrics snapshot exported by the port's obs (a
    traced forward and a counter) validate clean by both checkers, and
    through the port's CLI."""
    import torch

    from repro_torch.core import random_binary_trees
    from repro_torch.core.einet import EiNet

    net = EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                device="cpu")
    obs.reset()
    obs.configure(trace=True)
    try:
        with obs.span("serve.step", kind="joint_ll"):
            with torch.inference_mode():
                net.log_likelihood(torch.zeros(4, 8))
        obs.event("compile.jit", key="k")
    finally:
        obs.configure(trace=False)
    trace = obs.export_trace(str(tmp_path / "trace.json"))
    metrics = tmp_path / "metrics.json"
    metrics.write_text(json.dumps(obs.METRICS.snapshot()))
    obs.reset()
    req = ("serve.", "plan.", "compile.")
    assert port_check.validate_trace(trace, req) == []
    assert ref_check.validate_trace(trace, req) == []
    assert port_check.validate_metrics_file(str(metrics)) == []
    assert ref_check.validate_metrics_file(str(metrics)) == []
    assert port_check.main([trace, "--require", "plan.", "--metrics",
                            str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "valid" in out and "series" in out
    assert port_check.main([str(tmp_path / "missing.json")]) == 1
