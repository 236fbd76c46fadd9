"""``repro_torch.bench.train --smoke --device cpu`` against the
reference's ``benchmarks/bench_train.py`` smoke profile (``main(smoke=True,
out="")``: no BENCH file, no history row): the same report and row keys
(plus the port's device), the same cells and grouping summaries, grad
parity within ``PARITY_TOL`` on both sides, the eager-vs-program update
parity, the segment breakdown's kinds and launches, and the port's report
within its SLO check.
"""

from dataclasses import asdict

import pytest

from benchmarks import bench_train as ref_bench
from repro_torch.bench import train as port_bench
from repro_torch.obs import slo as port_slo

from _torch_bench_common import same_grouping


@pytest.fixture(scope="module")
def reports():
    port = port_bench.main(smoke=True, out="", device="cpu")
    ref = ref_bench.main(smoke=True, out="")
    assert port and ref, "a smoke run failed its gates"
    return port, ref


def test_constants_are_the_references():
    assert port_bench.DEFAULT_CELLS == ref_bench.DEFAULT_CELLS
    assert port_bench.PARITY_TOL == ref_bench.PARITY_TOL
    assert ref_bench.SPEEDUP_WAIVERS == {}
    # the port may waive an arch of its cells, with the root cause stated
    cells = {a for a, *_ in port_bench.DEFAULT_CELLS}
    for arch, reason in port_bench.SPEEDUP_WAIVERS.items():
        assert arch in cells and isinstance(reason, str) and reason
    assert {a for a, *_ in port_bench.CARD_CELLS} == cells
    assert asdict(port_bench.SMOKE_CONFIG) == asdict(ref_bench.SMOKE_CONFIG)
    assert asdict(port_bench.PD_SMOKE_CONFIG) == asdict(
        ref_bench.PD_SMOKE_CONFIG)


def test_train_smoke_against_reference(reports):
    port, ref = reports
    assert set(port) == set(ref) | {"device", "profile"}
    assert port["backend"] == port["device"] == "cpu"
    assert port["profile"] == "smoke"
    assert port["leaf_scatter"] is None and ref["leaf_scatter"] is None
    for r in (port, ref):
        assert r["parity_ok"] and r["grouped_ok"] and r["speedup_ok"]
        assert r["smoke"]
    assert [r["arch_id"] for r in port["results"]] == \
        [r["arch_id"] for r in ref["results"]] == ["smoke", "smoke-pd"]
    for p, r in zip(port["results"], ref["results"]):
        assert set(p) == set(r)
        for k in ("arch", "num_vars", "num_sums", "num_params_m", "batch",
                  "microbatches", "steps_timed"):
            assert p[k] == r[k], k
        same_grouping(p["grouping"], r["grouping"])
        assert p["grad_parity_max_abs_diff"] <= port_bench.PARITY_TOL
        assert r["grad_parity_max_abs_diff"] <= ref_bench.PARITY_TOL
        assert p["grad_parity_ok"] and r["grad_parity_ok"]
        # the step program and the per-step path are the same ops on the
        # CPU: the same bits
        assert p["update_parity_max_abs_diff"] == 0.0
        # one eager forward: one launch a segment, the reference's kinds
        assert {k: v["launches"] for k, v in p["segment_breakdown"].items()} \
            == {k: v["launches"] for k, v in r["segment_breakdown"].items()}


def test_train_smoke_passes_the_ports_slo_check(reports):
    port, _ = reports
    slo = port_slo.load_slo(port_slo.DEFAULT_SLO_PATH)
    assert port_slo.check_report("train", port, slo) == []
