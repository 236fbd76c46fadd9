"""The harness on the CPU: files found by name, the frozen counts, the
exact tail, the seeded schedule and the modules a run loads."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from harness import core
from harness.spec import ROOT, Spec

TINY_RAT = {"name": "tiny", "structure": "rat", "num_vars": 16, "depth": 2,
            "num_repetitions": 3, "num_sums": 4, "num_classes": 1,
            "min_var": 1e-6, "max_var": 10.0, "batch_size": 32}


@pytest.fixture
def copy(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "einbench"), tmp_path / "einbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_cell_metric_and_kernel_files_are_found(copy):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    cell = {"name": "train.einet_pd.b64", "config": "einet_pd",
            "traffic": "em_4_batches", "chips": 1, "why": "a test cell"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "rows_seen", "unit": "rows", "better": "higher",
        "source": "host_clock", "layer": "Model step, training",
        "moves": "train_rows_per_s", "workloads": [cell["name"]]})
    bench["end_to_end"][0]["workloads"].append(cell["name"])
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((copy / "einbench/traffic/em_64_batches.json").read_text())
    traffic.update(rows=64, batches=4)
    (copy / "einbench/traffic/em_4_batches.json").write_text(json.dumps(traffic))
    (copy / "einbench/metrics/rows_seen.py").write_text(
        "def read(run):\n    return run['rows'] * run['steps']\n")
    (copy / "einbench/kernels/extra.json").write_text(
        json.dumps({"einsum layers": {"base": ["new_kernel"]}}))
    spec = Spec(str(copy))
    found = spec.cell(cell["name"])
    assert spec.traffic(found["traffic"])["batches"] == 4
    names = [m["name"] for m in spec.metrics_for(found, trace=True)]
    assert "rows_seen" in names and "em_step_mfu" not in names
    assert "train_rows_per_s" in [m["name"] for m in spec.metrics_for(found, False)]
    assert spec.reader("rows_seen").read({"rows": 64, "steps": 3}) == 192
    layers = spec.kernel_layers()
    assert "new_kernel" in layers["einsum layers"]["base"]
    assert "lee_fwd_kernel" in layers["einsum layers"]["base"]
    # a split metric without a file of its own reads through its stem
    assert spec.reader("idle_share.anything").read(
        {"trace": {"window_s": 2.0, "busy_s": 1.5}}) == pytest.approx(25.0)


class _T:
    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        return int(np.prod(self.shape))


@pytest.mark.parametrize("k,k_out,cells,b", [(4, 4, 3, 5), (7, 1, 2, 9),
                                             (10, 10, 16, 2)])
def test_frozen_counts_equal_the_program_rules(k, k_out, cells, b):
    from counts.einsum import launch_cost as frozen
    from repro_torch.kernels.cost import launch_cost as theirs

    w, x = _T(cells, k_out, k, k), _T(b, cells, k)
    for op, args in [
        ("log_einsum_exp", (w, x, x)),
        ("log_einsum_exp_bwd", (w, x, x, _T(b, cells, k_out))),
        ("grouped_log_einsum_exp", ([_T(2 * cells, k, k, k), w], _T(b, 4 * cells, k))),
        ("grouped_log_einsum_exp_bwd", ([_T(2 * cells, k, k, k), w],
                                        _T(b, 4 * cells, k), _T(b, cells, k_out))),
    ]:
        assert frozen(op, *args) == theirs(op, *args), op
    tables = types.SimpleNamespace(k=k, left=[np.zeros(cells), np.zeros(3)],
                                   num_new_rows=cells + 3)
    ws, vs = [w, _T(3, k_out, k, k)], [_T(2, 2, k_out)]
    gx = _T(b, 11, k)
    assert frozen("gather_grouped_log_einsum_exp", tables, ws, vs, gx) == \
        theirs("gather_grouped_log_einsum_exp", tables, ws, vs, gx)
    g = _T(b, cells + 3, k)
    assert frozen("gather_grouped_log_einsum_exp_bwd", tables, ws, vs, gx, g) == \
        theirs("gather_grouped_log_einsum_exp_bwd", tables, ws, vs, gx, g)


def test_layout_counts_sum_the_program_rule_over_pairs():
    from counts import einsum as counts
    from reference.structure import layout_of
    from repro_torch.kernels.cost import launch_cost

    lay = layout_of(TINY_RAT)
    b = 7
    want_f = sum(launch_cost("log_einsum_exp", _T(p.cells, p.k_out, 4, 4),
                             _T(b, p.cells, 4))[1] for p in lay.pairs)
    want_b = sum(launch_cost("log_einsum_exp_bwd", _T(p.cells, p.k_out, 4, 4),
                             _T(b, p.cells, 4))[1] for p in lay.pairs)
    assert counts.forward(lay, b)[1] == want_f
    assert counts.backward(lay, b)[1] == want_b
    assert counts.query_flops(lay, "conditional_ll", b) == \
        2 * counts.query_flops(lay, "joint_ll", b)


def test_p95_is_exact_over_every_request():
    reader = Spec().reader("serve_p95_ms")
    lat = list(np.linspace(0.001, 1.0, 1000))
    got = reader.read({"kind": "serve", "latency_s": lat})
    assert got == pytest.approx(float(np.percentile(lat, 95)) * 1e3, rel=1e-12)
    # one more slow request moves the tail: nothing is bucketed
    got2 = reader.read({"kind": "serve", "latency_s": lat + [5.0]})
    assert got2 > got and got2 == pytest.approx(
        float(np.percentile(lat + [5.0], 95)) * 1e3, rel=1e-12)


def test_open_loop_schedule_is_a_function_of_the_seed():
    spec = Spec()
    gen = spec.generator("open_loop")
    tr = spec.traffic("open_mix8")
    a = gen.schedule(tr, 2.0, 2 ** 33 + 1, 8)
    b = gen.schedule(tr, 2.0, 2 ** 33 + 1, 8)
    c = gen.schedule(tr, 2.0, 2 ** 33 + 2, 8)
    for key in a:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    assert not np.array_equal(a["due"], c["due"])
    assert not np.array_equal(a["x"], c["x"])
    # every seed offers the same gaps and kinds, in another order
    gaps = lambda s: np.diff(np.concatenate([[0.0], s["due"]]))
    assert np.allclose(np.sort(gaps(a)), np.sort(gaps(c)))
    assert a["kind"] == c["kind"]
    assert len(a["due"]) == round(tr["rate_per_s"] * 2.0)
    assert a["due"][-1] <= 2.0


MS = 1_000_000  # ns


def _marks(fence, t0, n):
    return [(fence, True, t0 + 10 * i, t0 + 10 * i + 5) for i in range(n)]


def test_trace_reads_only_between_the_fences():
    from harness import trace

    fence = "fence_kernel"
    work = [("k1", True, 20 * MS, 21 * MS), ("k2", True, 23 * MS, 24 * MS),
            ("einbench.train.step", False, 19 * MS, 25 * MS)]
    early = [("k0", True, 100, 150)]
    # the profiler dropped the first 40 leading markers
    lead = _marks(fence, 10 * MS, trace.FENCE)[40:]
    out = trace.reduce(early + lead + work + _marks(fence, 30 * MS, trace.FENCE),
                       fence)
    assert out["kernels"] == {"k1": 1e-3, "k2": 1e-3}
    assert out["window_s"] == pytest.approx((30 * MS - lead[-1][3]) / 1e9)
    assert out["busy_s"] == pytest.approx(2e-3)


@pytest.mark.parametrize("lead,trail,gap_ms", [(0, 64, 10), (64, 0, 10),
                                               (64, 64, 1)])
def test_trace_without_its_fences_fails(lead, trail, gap_ms):
    """A profile that lost a side's markers, or whose markers enclose no
    traced part, has no known device window: the run fails rather than
    read one from the host's clock."""
    from harness import trace

    fence = "fence_kernel"
    events = _marks(fence, 0, lead) + [
        ("k1", True, MS // 2, MS // 2 + 100),
        ("einbench.window", False, 100, gap_ms * MS)]
    events += _marks(fence, gap_ms * MS, trail)
    with pytest.raises(RuntimeError, match="fence markers"):
        trace.reduce(events, fence)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert core.forbidden_modules() == ["repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    script = f"""
import json, sys
sys.path[:0] = [{os.path.join(ROOT, 'einbench')!r}, {os.path.join(ROOT, 'src')!r}]
from harness.core import execute, forbidden_modules
from harness.spec import Spec
spec = Spec({ROOT!r})
cfg = {TINY_RAT!r}
tr = dict(spec.traffic("em_16_full"), rows=16, batches=4, reference_block=8)
out = execute(spec, "train.einet_rat.b2000", 5, 0.2, False, device="cpu",
              config=cfg, traffic=tr)
trs = dict(spec.traffic("open_mix8"), rate_per_s=50.0, max_batch=4,
           check_per_kind=2, drain_s=5.0)
out2 = execute(spec, "serve.einet_rat.open", 6, 0.3, False, device="cpu",
               config=cfg, traffic=trs)
print(json.dumps([forbidden_modules(), out["correct"], out2["correct"]]))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    loaded, ok_train, ok_serve = json.loads(res.stdout.strip().splitlines()[-1])
    assert loaded == [] and ok_train and ok_serve


def test_the_command_fails_without_the_program(copy):
    res = subprocess.run(
        [sys.executable, "einbench/run.py", "--workload", "train.einet_pd.b512",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(copy))
    assert res.returncode != 0
    assert '"correct"' not in res.stdout


@pytest.mark.parametrize("tie, wrong", [(False, 0.25), (True, 0.0)])
def test_noisy_draws_are_judged_off_ties(tie, wrong):
    """A drawn row off the reference's draw is wrong unless a choice of the
    reference's tree ties to rounding there; a tie elsewhere excuses
    nothing."""
    from generators import open_loop

    want = np.zeros((4, 3))
    got = want.copy()
    got[1, 2] = 1.0
    margin = np.array([1e-9, 1e-3 * open_loop.TIE_REL if tie else 1.0, 1.0, 1.0])
    ev = np.zeros((4, 3), dtype=bool)
    out = open_loop.compare({"sample": got, "conditional_sample": want},
                            {"sample": want, "conditional_sample": want},
                            {"sample": ev, "conditional_sample": ev},
                            {"sample": margin, "conditional_sample": np.ones(4)})
    assert out["draw_mismatch.noisy"] == 0.125
    assert out["draw_wrong.noisy"] == wrong / 2
    assert out["draw_tied.noisy"] == (0.25 if tie else 0.125)
    assert out["draw_flip_margin.noisy"] == margin[1]
