"""The port's serving engine on the CPU: queue/slot mechanics, the request
stream shared with the reference, engine-against-direct parity, bucket
padding isolation and the serve CLI."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import mixed_requests as ref_mixed_requests
from repro.serve import run_benchmark as ref_run_benchmark
from repro_torch import compile as compile_lib
from repro_torch.core import random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.serve import (
    Request,
    RequestQueue,
    ServeEngine,
    SlotManager,
    direct_call,
    format_report,
    legacy_call,
    mixed_requests,
    parity,
    run_benchmark,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_net():
    return EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                 device="cpu", seed=0)


def test_request_queue_fifo_and_pop_kind():
    q = RequestQueue()
    for i, kind in enumerate(["joint_ll", "mpe", "joint_ll", "sample", "mpe"]):
        q.submit(Request(i, kind))
    assert q.oldest_kind() == "joint_ll"
    assert q.pending_kinds() == ["joint_ll", "mpe", "sample"]
    assert [r.req_id for r in q.pop_kind("joint_ll", limit=10)] == [0, 2]
    assert q.oldest_kind() == "mpe"
    assert [r.req_id for r in q.pop_kind("mpe", limit=1)] == [1]
    assert [r.req_id for r in q.pop_kind("sample", 5)] == [3]
    assert [r.req_id for r in q.pop_kind("mpe", 5)] == [4]
    assert len(q) == 0 and q.oldest_kind() is None


def test_slot_manager_bounds_and_release():
    s = SlotManager(3)
    leases = [s.acquire() for _ in range(3)]
    assert sorted(leases) == [0, 1, 2] and s.free == 0
    assert s.acquire() is None
    s.release(leases[0])
    with pytest.raises(ValueError):
        s.release(leases[0])
    assert s.acquire() == leases[0]


def test_mixed_requests_is_the_reference_stream():
    ours, ref = mixed_requests(16, 20, seed=3), ref_mixed_requests(16, 20, seed=3)
    for a, b in zip(ours, ref):
        assert (a.req_id, a.kind, a.seed) == (b.req_id, b.kind, b.seed)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.evidence_mask, b.evidence_mask)
        np.testing.assert_array_equal(a.query_mask, b.query_mask)


def test_engine_buckets_and_validation(small_net):
    engine = ServeEngine(small_net, max_batch=16)
    assert engine.buckets == (1, 2, 4, 8, 16)
    assert engine._bucket_for(5) == 8
    with pytest.raises(ValueError, match="unknown query kind"):
        engine.submit(Request(0, "nope"))
    with pytest.raises(ValueError, match="component"):
        engine.submit(Request(0, "joint_ll", component=1))
    with pytest.raises(ValueError):
        ServeEngine(small_net, max_batch=8, buckets=(1, 4))


def test_mixed_stream_parity_with_direct_calls(small_net):
    reqs = mixed_requests(small_net.num_vars, 13, seed=2)
    results = ServeEngine(small_net, max_batch=8).run(reqs)
    assert sorted(results) == list(range(13))
    call = direct_call(small_net)
    direct = {r.req_id: call(r) for r in reqs}
    p = parity(reqs, results, direct)
    assert p["ll_max_rel_diff"] <= 1e-5
    assert p["sample_mismatches"] == 0
    for r in reqs:
        if r.kind in ("conditional_sample", "mpe"):
            np.testing.assert_array_equal(
                results[r.req_id].value[r.evidence_mask],
                r.x[r.evidence_mask])


def test_bucket_padding_never_leaks(small_net):
    """Identical streams through engines with different bucket layouts give
    the same results: filler rows and micro-batch composition do not
    perturb real rows, and a request's draw does not depend on its bucket."""
    mix = ("joint_ll", "conditional_sample", "sample", "mpe", "marginal_ll")
    reqs = mixed_requests(small_net.num_vars, 11, seed=3, mix=mix)
    out_small = ServeEngine(small_net, max_batch=2).run(reqs)
    out_large = ServeEngine(small_net, max_batch=16).run(reqs)
    alone = {r.req_id: ServeEngine(small_net, max_batch=1).run([r])[r.req_id]
             for r in reqs}
    for r in reqs:
        for other in (out_large, alone):
            a, b = out_small[r.req_id].value, other[r.req_id].value
            if r.kind.endswith("_ll"):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)


def test_engine_runs_under_inference_mode(small_net):
    reqs = mixed_requests(small_net.num_vars, 3, seed=4, mix=("joint_ll",))
    res = ServeEngine(small_net, max_batch=4).run(reqs)
    assert all(np.shape(r.value) == () for r in res.values())
    batch = {"x": torch.zeros(2, 8), "seeds": [0, 1],
             "evidence_mask": torch.zeros(2, 8, dtype=torch.bool),
             "query_mask": torch.ones(2, 8, dtype=torch.bool)}
    out = small_net.query(batch, "sample")
    assert out.shape == (2, 8) and out.is_inference()
    with pytest.raises(ValueError, match="unknown query kind"):
        small_net.query(batch, "nope")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_on_cpu():
    out = _cli("--arch", "einet_rat", "--requests", "16", "--max-batch", "8",
               "--reps", "1", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "req/s" in out.stdout and "mismatches 0" in out.stdout


def test_serve_cli_pd_on_cpu():
    out = _cli("--arch", "einet_pd", "--requests", "12", "--max-batch", "4",
               "--reps", "1", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "einet-pd-svhn" in out.stdout and "mismatches 0" in out.stdout


def test_serve_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _cli("--arch", "einet_rat", "--requests", "2")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_direct_and_legacy_calls_agree(small_net):
    """The per-request program path and the eager path give the same
    answers (LLs within 1e-6, sampling and decode identical); the direct
    path's programs are keyed ("direct", kind) in the registry."""
    reqs = mixed_requests(small_net.num_vars, 12, seed=5)
    reg = compile_lib.ProgramRegistry()
    direct, legacy = direct_call(small_net, reg), legacy_call(small_net)
    for r in reqs:
        a, b = direct(r), legacy(r)
        if r.kind.endswith("_ll"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    assert sorted(reg.table(small_net)) == sorted(
        ("direct", k) for k in {r.kind for r in reqs})


REPORT_KEYS = {
    "num_requests", "kinds", "max_batch", "buckets", "reps", "warmup_s",
    "compile_s", "direct_warmup_s", "steady_s", "engine_qps", "latency_ms",
    "program_cache", "direct_s", "direct_qps", "legacy_s", "legacy_qps",
    "speedup", "speedup_vs_jitted", "programs", "compiles",
    "scheduler_steps", "padded_rows", "queue_depth_max",
    "parity_max_abs_diff",
}


def test_run_benchmark_reports_the_reference_keys(small_net):
    """The port's report carries every key of the reference's, and the
    stream-derived ones (requests, kinds, buckets, max_batch, scheduling)
    equal the reference's on the same stream; parity is exact on the
    CPU."""
    import jax

    from repro.core import EiNet as RefEiNet
    from repro.core import random_binary_trees as ref_rbt

    reqs = mixed_requests(small_net.num_vars, 10, seed=6)
    got = run_benchmark(small_net, reqs, reps=2,
                        registry=compile_lib.ProgramRegistry())
    ref = RefEiNet(ref_rbt(8, 2, 2, seed=0), num_sums=3)
    want = ref_run_benchmark(ref, ref.init(jax.random.PRNGKey(0)),
                             ref_mixed_requests(8, 10, seed=6), reps=2)
    assert set(want) <= set(got) and REPORT_KEYS <= set(want)
    for k in ("num_requests", "kinds", "buckets", "max_batch", "reps",
              "scheduler_steps", "padded_rows", "programs", "compiles"):
        assert got[k] == want[k], k
    assert set(got["latency_ms"]) == set(want["latency_ms"])
    assert set(got["program_cache"]) == set(want["program_cache"])
    assert got["program_cache"]["registry_compiles"] == got["programs"]
    assert got["program_cache"]["hits"] == 2 * got["programs"]
    assert got["parity_max_abs_diff"] == 0.0
    assert got["sample_mismatches"] == 0 and got["ll_max_abs_diff"] == 0.0
    # against the eager path: LLs within 1e-5 relative (the CLI's gate),
    # sampling and decode identical
    assert got["legacy_sample_mismatches"] == 0
    assert got["legacy_ll_max_rel_diff"] <= 1e-5
    assert got["compile_s"] == 0.0 and got["queue_depth_max"] >= 1
    with pytest.raises(ValueError, match="at least one"):
        run_benchmark(small_net, [])


def test_format_report_lines(small_net):
    reqs = mixed_requests(small_net.num_vars, 6, seed=7)
    text = format_report(run_benchmark(small_net, reqs, reps=1))
    lines = text.splitlines()
    heads = [ln.split(":")[0].strip() for ln in lines]
    assert heads[0].startswith("batched exact-inference engine")
    for head in ("warm-up", "steady", "prog cache", "baselines", "parity",
                 "programs"):
        assert head in heads, head
    assert sum(h == "latency" for h in heads) == len({r.kind for r in reqs})
    assert "req/s" in text


def test_serve_cli_smoke_trace_and_metrics(tmp_path):
    out = _cli("--smoke", "--device", "cpu", "--trace",
               str(tmp_path / "trace.json"), "--metrics",
               str(tmp_path / "metrics.json"))
    assert out.returncode == 0, out.stderr
    assert "einet-rat-serve-smoke" in out.stdout
    assert "batched exact-inference engine: 4 requests" in out.stdout
    assert "mismatches 0" in out.stdout and "[obs] serve:" in out.stdout
    assert "parity: LL max|engine - direct|" in out.stdout
    assert "parity: LL max|engine - legacy|" in out.stdout
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"serve.step", "serve.bench.steady", "serve.bench.legacy"} <= names
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert snap["serve.queue.depth"]["max"] >= 1
    assert snap["compile.cache.misses{kind=eager}"] >= 1
