"""The production benches' and gates' command lines on the CPU, and the
``dryrun --verify`` health probe against the reference's.

Each ``python -m repro_torch.bench.<name> --smoke --device cpu`` exits 0,
writes its BENCH file and one history row under the working directory;
``python -m repro_torch.obs.slo --check`` passes on those files against
``slo_torch.json``; ``python -m repro_torch.launch.dryrun --verify
--device cpu`` exits 0 over the registered archs.  The probe draws its own
initial parameters, so its computation is held against the reference's
from the reference's parameters carried across (``convert``): the LL mean
within 1e-4 relative, the same leaf and segment saturation fractions, and
the same skip decision at ``PROBE_PARAM_FLOOR`` for every arch.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as REF_CONFIGS
from repro.launch import cells as ref_cells
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_einet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_clis_and_slo_check(tmp_path):
    for name in ("serve", "train", "mixture", "eval"):
        out = _run([f"repro_torch.bench.{name}", "--smoke", "--device",
                    "cpu", "--out", f"BENCH_torch_{name}.json"], tmp_path)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        assert (tmp_path / f"BENCH_torch_{name}.json").exists()
        rows = (tmp_path / "artifacts" / "bench_history_torch"
                / f"{name}.jsonl").read_text().splitlines()
        assert len(rows) == 1 and json.loads(rows[0])["smoke"] is True
    out = _run(["repro_torch.obs.slo", "--check", "--dir", str(tmp_path),
                "--slo", os.path.join(ROOT, "slo_torch.json")], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("within budget") == 4


def test_bench_cli_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _run(["repro_torch.bench.eval", "--smoke"], tmp_path)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    assert not list(tmp_path.iterdir())


def test_dryrun_verify_cli(tmp_path):
    out = _run(["repro_torch.launch.dryrun", "--verify", "--device", "cpu",
                "--health-dir", str(tmp_path / "health")], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"verification complete: {len(REGISTRY)} arch(s) clean" \
        in out.stdout
    recs = {p.stem: json.loads(p.read_text())
            for p in (tmp_path / "health").iterdir()}
    assert sorted(recs) == sorted(REGISTRY)
    assert recs["einet-rat-large"]["skipped"]
    assert all(not r["skipped"] and r["ll_nonfinite"] == 0
               for k, r in recs.items() if k != "einet-rat-large")
    out = _run(["repro_torch.launch.dryrun"], tmp_path)
    assert out.returncode != 0 and "--verify" in out.stderr


def _ref_param_count(cfg):
    model = ref_cells.build_einet(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_probe_skip_decision_matches_reference(arch):
    port_n = build_einet(get_config(arch), device="meta").num_params()
    ref_n = _ref_param_count(REF_CONFIGS[arch])
    assert port_n == ref_n
    assert (port_n > dryrun.PROBE_PARAM_FLOOR) == (arch == "einet-rat-large")


def test_probe_against_reference(tmp_path):
    """einet_rat's probe on the reference's initial parameters."""
    from repro.launch import dryrun as ref_dryrun

    assert dryrun.PROBE_PARAM_FLOOR == ref_dryrun.PROBE_PARAM_FLOOR
    assert dryrun.PROBE_BATCH == ref_dryrun.PROBE_BATCH
    cfg = REF_CONFIGS["einet-rat"]
    assert ref_dryrun.run_health_probe(["einet-rat"], str(tmp_path)) == 0
    ref = json.loads((tmp_path / "einet-rat.json").read_text())
    params = ref_cells.build_einet(cfg).init(jax.random.PRNGKey(0))
    port = build_einet(get_config("einet-rat"), device="cpu")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), port))
    got = dryrun.probe_model(port, dryrun.probe_data(port,
                                                     dryrun.PROBE_BATCH))
    assert got["probe_batch"] == ref["probe_batch"]
    assert got["ll_mean"] == pytest.approx(ref["ll_mean"], rel=1e-4)
    assert got["ll_min"] == pytest.approx(ref["ll_min"], rel=1e-4)
    assert got["ll_nonfinite"] == ref["ll_nonfinite"] == 0
    assert got["leaf_sat_frac"] == ref["leaf_sat_frac"]
    assert got["segment_sat_frac"] == ref["segment_sat_frac"]
    assert len(got["segment_sat_frac"]) == 1
