"""``repro_torch.bench.mixture`` and ``repro_torch.bench.eval`` (``--smoke
--device cpu``) against the reference's ``benchmarks/bench_mixture.py``
and ``bench_eval.py`` smoke profiles (``main(smoke=True, out="")``): the
same report keys (plus the port's device), the same cells and shapes,
mixture parameter parity within 1e-6 and eval parity mismatches 0 on both
sides, and the port's reports within its SLO check.
"""

from dataclasses import asdict

import pytest

from benchmarks import bench_eval as ref_eval
from benchmarks import bench_mixture as ref_mixture
from repro_torch.bench import eval as port_eval
from repro_torch.bench import mixture as port_mixture
from repro_torch.obs import slo as port_slo


@pytest.fixture(scope="module")
def slo():
    return port_slo.load_slo(port_slo.DEFAULT_SLO_PATH)


def test_mixture_smoke_against_reference(slo):
    assert port_mixture.DEFAULT_CELLS == ref_mixture.DEFAULT_CELLS
    assert port_mixture.PARITY_TOL == ref_mixture.PARITY_TOL == 1e-6
    for name in ("COMPONENT_CONFIG", "SMOKE_CONFIG"):
        assert asdict(getattr(port_mixture, name)) == asdict(
            getattr(ref_mixture, name))
    port = port_mixture.main(smoke=True, out="", device="cpu")
    ref = ref_mixture.main(smoke=True, out="")
    assert port and ref
    assert set(port) == set(ref) | {"device"}
    assert port["parity_ok"] and ref["parity_ok"]
    assert len(port["results"]) == len(ref["results"]) == 1
    p, r = port["results"][0], ref["results"][0]
    assert set(p) == set(r)
    for k in ("cell", "component_arch", "num_components", "num_vars",
              "num_sums", "num_params_m", "per_component_batch",
              "steps_timed"):
        assert p[k] == r[k], k
    assert p["param_parity_max_abs_diff"] <= 1e-6
    assert r["param_parity_max_abs_diff"] <= 1e-6
    assert p["param_parity_ok"] and r["param_parity_ok"]
    assert port_slo.check_report("mixture", port, slo) == []


def test_eval_smoke_against_reference(slo):
    port = port_eval.main(smoke=True, out="", device="cpu")
    ref = ref_eval.main(smoke=True, out="")
    assert port and ref
    assert set(port) == set(ref) | {"device"}
    for k in ("arch", "num_vars", "num_sums", "smoke", "rows",
              "inpaint_requests"):
        assert port[k] == ref[k], k
    assert port["parity_mismatches"] == ref["parity_mismatches"] == 0
    assert port["parity_ok"] and ref["parity_ok"]
    assert port["ll_max_abs_diff_engine_vs_direct"] <= 1e-4
    assert port_slo.check_report("eval", port, slo) == []
