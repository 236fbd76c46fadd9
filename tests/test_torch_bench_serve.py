"""``repro_torch.bench.serve --smoke --device cpu`` against the reference's
``benchmarks/bench_serve.py`` smoke profile: the same report keys (plus
the port's parity details and device), the same grouping summaries, both
parity and grouped gates passing, LL parity within 1e-5, and the port's
report within its SLO check.

The reference's ``main(smoke=True)`` is its ``_bench_one`` on the RAT and
the PD smoke configs, combined under ``pd_smoke``; the two are run as two
tests here so that each stays short.
"""

from dataclasses import asdict

import pytest

from benchmarks import bench_serve as ref_bench
from repro_torch.bench import serve as port_bench
from repro_torch.obs import slo as port_slo

from _torch_bench_common import same_grouping

# keys the port's report adds: run_benchmark's engine-vs-direct and
# engine-vs-eager parity details, the device it ran on and the profile
PORT_EXTRA = {"device", "profile", "ll_max_abs_diff", "ll_max_rel_diff",
              "sample_mismatches", "legacy_ll_max_abs_diff",
              "legacy_ll_max_rel_diff", "legacy_sample_mismatches"}


@pytest.fixture(scope="module")
def port_report():
    report = port_bench.main(smoke=True, out="", device="cpu")
    assert report, "the port's serve smoke failed its gates"
    return report


@pytest.mark.parametrize("which", ["rat", "pd"])
def test_serve_smoke_against_reference(port_report, which):
    cfg = ref_bench.SMOKE_CONFIG if which == "rat" \
        else ref_bench.PD_SMOKE_CONFIG
    assert asdict(cfg) == asdict(port_bench.SMOKE_CONFIG if which == "rat"
                                 else port_bench.PD_SMOKE_CONFIG)
    ref = ref_bench._bench_one(cfg, 24, 0, 3, True)
    port = port_report if which == "rat" else port_report["pd_smoke"]
    assert set(port) - {"pd_smoke"} == set(ref) | PORT_EXTRA
    same_grouping(port["grouping"], ref["grouping"])
    for r in (port, ref):
        assert r["parity_ok"] and r["grouped_ok"] and r["smoke"]
        assert r["parity_max_abs_diff"] <= 1e-5
    assert port["profile"] == "smoke"
    assert port["ll_max_abs_diff"] <= 1e-5
    assert port["legacy_ll_max_rel_diff"] <= 1e-5
    assert port["sample_mismatches"] == port["legacy_sample_mismatches"] == 0
    assert port["kinds"] == ref["kinds"]
    assert port["buckets"] == ref["buckets"]
    assert port["num_requests"] == ref["num_requests"] == 24
    assert port["program_cache"] == ref["program_cache"]


def test_serve_smoke_passes_the_ports_slo_check(port_report):
    slo = port_slo.load_slo(port_slo.DEFAULT_SLO_PATH)
    assert port_slo.check_report("serve", port_report, slo) == []
    bad = dict(port_report, pd_smoke=dict(port_report["pd_smoke"],
                                          grouped_ok=False))
    assert port_slo.check_report("serve", bad, slo) == [
        "serve.pd_smoke: grouped_ok is not true"]
