"""The capture-only dry run on the CPU: the step cost counter
(``repro_torch.launch.cost``), ``launch_cost``, ``run_cell`` through an
injected capture, the H100 roofline and the EXPERIMENTS report.  Mirrors
``tests/test_roofline.py``, which validates the reference's HLO analyzer
on programs of known cost."""

import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EiNet as RefEiNet
from repro.core import random_binary_trees as ref_rbt
from repro.launch.hlo_analysis import analyze_hlo
from repro_torch import compile as compile_lib
from repro_torch import tree as tree_lib
from repro_torch.bench import experiments, roofline
from repro_torch.configs import get_config
from repro_torch.core import random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.core.em import zeros_like_statistics
from repro_torch.launch import cells, dryrun
from repro_torch.launch import cost as cost_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NV, DEPTH, REPS, K = 32, 3, 2, 4


def test_plain_matmul_flops():
    n, m, k = 64, 128, 256
    a, b = torch.randn(n, k), torch.randn(k, m)
    cost = cost_lib.count_call(lambda: a @ b)
    assert cost.flops == 2 * n * m * k
    assert cost.bytes_written == 4 * n * m  # the product, written once
    assert cost.output_bytes == 4 * n * m


def test_views_and_allocations_write_nothing():
    x = torch.randn(8, 16)
    cost = cost_lib.count_call(lambda: (x.t(), x.view(16, 8), x[:4],
                                        torch.empty(100)))
    assert cost.flops == 0 and cost.bytes_written == 0


class _Anchor(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(d, d))


@pytest.mark.parametrize("n", [1, 3])
def test_microbatch_body_counts_once_a_microbatch(n):
    d, rows = 16, 8
    anchor = _Anchor(d)

    def body(model, acc, xb):
        acc.add_((xb @ model.w).sum(0))

    def finish(model, acc, x):
        with torch.no_grad():
            model.w.add_(1.0)  # the step writes its parameters
        return (x.sum(),) if acc is None else (acc.sum(),)

    step = compile_lib.StagedStep(
        finish=finish, num_microbatches=n,
        start=lambda model: torch.zeros(d), body=body)
    before = anchor.w.detach().clone()
    cost = cost_lib.count_staged_step(anchor, step, torch.randn(n * rows, d))
    if n == 1:  # a single-stage step: finish on the whole batch
        assert cost.flops == 0
    else:
        assert cost.flops == n * 2 * rows * d * d
    # counting advances no model
    assert torch.equal(anchor.w.detach(), before)


def _rat(seed=0):
    return EiNet(random_binary_trees(NV, DEPTH, REPS, seed=0), num_sums=K,
                 device="cpu", seed=seed)


@pytest.mark.parametrize("n", [16, 32])
def test_collective_bytes_of_a_known_packed_buffer(n):
    model = _rat()
    stats = zeros_like_statistics(model, "meta")
    s_full = 4 * sum(x.numel() for x in tree_lib.flatten(stats)[1])
    # no model dim: the packed buffer is every statistic, whole
    got = cost_lib.collective_costs(model, {"data": n, "model": 1})
    assert got["stats_buffer_bytes"] == s_full
    assert got["collectives"]["all-reduce"] == {
        "count": 1, "bytes": 2 * (n - 1) / n * s_full}
    assert got["collectives"]["all-gather"]["count"] == 0
    assert got["collective_bytes"] == 2 * (n - 1) / n * s_full
    # two data dims: one all-reduce a dim, outermost first
    two = cost_lib.collective_costs(model, {"pod": 2, "data": n // 2,
                                            "model": 1})
    m = n // 2
    assert two["collectives"]["all-reduce"]["count"] == 2
    assert math.isclose(two["collective_bytes"],
                        (1.0 + 2 * (m - 1) / m) * s_full)


def test_model_dim_shards_the_buffer_and_gathers_the_parameters():
    model = cells.build_einet(get_config("einet_rat"), device="meta")
    got = cost_lib.collective_costs(model, cells.mesh_axis_sizes("single"))
    full = cost_lib.collective_costs(model, {"data": 16, "model": 1})
    assert got["stats_buffer_bytes"] < full["stats_buffer_bytes"]
    assert got["collectives"]["all-gather"]["count"] > 0
    assert got["collective_bytes"] == pytest.approx(
        2 * 15 / 16 * got["stats_buffer_bytes"]
        + got["collectives"]["all-gather"]["bytes"])


def test_forward_contraction_flops_against_the_reference_hlo():
    """A small einet_rat forward: the counter's flops are the contraction's
    2 B L K_out K^2 over the pairs (launch_cost of the K3 launch) and the
    leaf layer's dot of the sufficient statistics with the natural
    parameters (launch_cost of the leaf-rows launch: 2 B D K R T flops,
    T = 2 statistics of a Normal).  The reference's HLO dot flops of the
    same forward at its XLA impl hold the same leaf dot, and one more
    thing: XLA contracts a pair with K_out = 1 in two dots, over i and then
    j, which adds 2 B L K for that pair (1% of this circuit's
    contraction).  So the rest agrees within 2%."""
    b = 16
    port = _rat()
    x = torch.from_numpy(np.random.RandomState(0).randn(b, NV)
                         .astype(np.float32))
    with torch.no_grad():
        cost = cost_lib.count_call(port.log_likelihood, x)
    want = sum(2 * b * s.num_partitions * s.k_out * s.k_in ** 2
               for s in port.pair_specs)
    leaf_dot = 2 * b * NV * K * REPS * 2
    assert cost.flops == want + leaf_dot
    assert set(cost.kernels) == {"grouped_log_einsum_exp", "leaf_rows"}
    assert cost.kernels["leaf_rows"]["flops"] == leaf_dot
    ref = RefEiNet(ref_rbt(NV, DEPTH, REPS, seed=0), num_sums=K)
    params = ref.init(jax.random.PRNGKey(0))
    compiled = jax.jit(ref.log_likelihood).lower(
        params, jax.ShapeDtypeStruct((b, NV), jnp.float32)).compile()
    ref_flops = analyze_hlo(compiled.as_text())["flops"]
    assert ref_flops - leaf_dot == pytest.approx(want, rel=0.02)
    assert ref_flops - leaf_dot >= want


def test_cell_counts_are_affine_in_the_rows():
    """What chip_smoke.py's cross-check relies on: at a fixed microbatch
    count a cell's flops and bytes are affine in the rows, so two reduced
    CPU counts give the full-size count exactly."""
    cfg = get_config("einet_rat")
    got = {}
    for rows in (8, 16, 40):
        c = cells.capture_einet_cell(cfg, "single", device="cpu", rows=rows,
                                     capture=False)["cost"]
        got[rows] = (c.flops, c.bytes_written)
    for i in range(2):
        slope = (got[16][i] - got[8][i]) // 8
        assert got[40][i] == got[8][i] + slope * 32


def test_cell_rows_are_a_data_ranks_share():
    rat, large = get_config("einet_rat"), get_config("einet_rat_large")
    assert cells.cell_rows(rat, "single") == rat.batch_size // 16
    assert cells.cell_rows(rat, "multi") == rat.batch_size // 32
    assert cells.cell_rows(large, "single") == 4096
    assert cells.cell_microbatches(large, 4096) == 4
    assert cells.cell_microbatches(large, 2048) == 2
    assert cells.cell_microbatches(rat, 128) == 1


def _ref_record_keys():
    """The keys of the record the reference's run_cell writes, read from
    its source (it needs 512 host devices to run)."""
    tree = ast.parse(open(os.path.join(
        ROOT, "src", "repro", "launch", "dryrun.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets) and len(node.value.keys) > 8:
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in the reference's run_cell")


class _NoCapture:
    """A capture that records nothing and executes nothing."""

    def __init__(self):
        self.captures = 0

    def __call__(self, run, device, pool):
        self.captures += 1
        return run, None


@pytest.fixture(scope="module")
def cell_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    seam = _NoCapture()
    reg = compile_lib.ProgramRegistry(capture_fn=seam)
    rec = dryrun.run_cell("einet_rat", "single", str(out), device="cpu",
                          registry=reg)
    return out, rec, seam


def test_run_cell_writes_the_reference_record(cell_record):
    out, rec, seam = cell_record
    assert "error" not in rec, rec.get("traceback")
    path = out / "einet-rat__em_step__16x16.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    want = _ref_record_keys() - {"lower_s", "compile_s"}
    assert want <= set(rec), want - set(rec)
    assert {"capture_s", "device"} <= set(rec)
    assert rec["device"] == {"type": "cpu", "card": None}
    assert rec["mesh"] == "16x16" and rec["num_devices"] == 256
    assert rec["rows_per_device"] == 128 and rec["microbatches"] == 1
    assert seam.captures == 1  # the step captured once, never replayed
    assert rec["flops_per_device"] > 0 and rec["bytes_written_per_device"] > 0
    assert set(rec["kernels"]) == {"grouped_log_einsum_exp",
                                   "grouped_log_einsum_exp_bwd", "leaf_rows",
                                   "leaf_stats"}
    assert rec["memory"]["output_bytes"] == 4  # the step's mean LL


def test_run_cell_skips_an_existing_record(cell_record, capsys):
    out, rec, _ = cell_record
    again = dryrun.run_cell("einet_rat", "single", str(out), device="cpu")
    assert again == json.loads(json.dumps(rec))
    assert "[skip-cached]" in capsys.readouterr().out


def test_failed_cell_writes_err(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(cells, "capture_einet_cell", boom)
    rec = dryrun.run_cell("einet_rat", "multi", str(tmp_path), device="cpu")
    assert "error" in rec
    assert (tmp_path / "einet-rat__em_step__2x16x16.json.err").exists()
    assert not (tmp_path / "einet-rat__em_step__2x16x16.json").exists()


def test_roofline_table_of_the_record(cell_record):
    out, rec, _ = cell_record
    rows = roofline.build_table(str(out), "16x16")
    assert len(rows) == 1
    r = rows[0]
    assert r["compute_s"] == rec["flops_per_device"] / 67e12
    assert r["memory_s"] == max(rec["bytes_written_per_device"],
                                4 * rec["param_count"]) / 3.35e12
    assert r["collective_s"] == rec["collective_bytes_per_device"] / 50e9
    assert r["dominant"] in ("compute", "memory", "collective")
    md = roofline.to_markdown(rows)
    assert md.splitlines()[0].startswith("| arch | shape | mesh |")
    assert "einet-rat | em_step | 16x16" in md
    assert roofline.build_table(str(out), "2x16x16") == []


def test_experiments_render_with_every_source_missing(tmp_path):
    text, status = experiments.render(str(tmp_path))
    # verify coverage needs no artifact; every other section is missing
    assert status.pop("Static verification coverage")
    assert not any(status.values())
    assert text.count("_not yet generated on this host") == len(status)
    assert "python -m repro_torch.launch.dryrun --all --mesh both" in text
    assert experiments.main(["--root", str(tmp_path)]) == 0
    assert (tmp_path / experiments.OUT).exists()


def test_experiments_render_the_dryrun_and_a_broken_source(cell_record,
                                                           tmp_path):
    out, _, _ = cell_record
    art = tmp_path / "artifacts"
    art.mkdir()
    os.symlink(out, art / "dryrun_torch")
    (tmp_path / "BENCH_torch_serve.json").write_text("{not json")
    text, status = experiments.render(str(tmp_path))
    assert status["Dry-run cells (single pod, 16x16)"]
    assert status["Roofline on the H100 (16x16)"]
    assert not status["Production benches"]
    assert "could not be rendered" in text
