"""The port's lint (``repro_torch.analysis.lint``): every rule catches a
seeded violation and passes its clean counterpart, the allow and only
lists hold, waivers suppress only with a reason and on their line, the
port's tree lints clean, and the CLI exits 0 or 1."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis.lint import (
    RULES,
    Violation,
    lint_source,
    load_waivers,
    run_lint,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
ROW_PATH = "src/repro_torch/serve/somefile.py"


def rules_of(violations):
    return {v.rule for v in violations}


def lint(src, path=ROW_PATH):
    return lint_source(textwrap.dedent(src), path)


# (rule, violating snippet, its clean counterpart): one of each a rule
CASES = {
    "neg-inf-literal": ("LOG_ZERO = -1e30\n", "x = -1e6\n"),
    "kernel-contract": (
        "from repro_torch.kernels.log_einsum_exp import "
        "log_einsum_exp_cuda\n",
        "from repro_torch.kernels import ops\nops.log_einsum_exp(w, l, r)\n"),
    "bare-graph": ("g = torch.cuda.CUDAGraph()\n",
                   "prog = compile_lib.REGISTRY.capture(m, k, fn, b)\n"),
    "timing-outside-obs": ("import time\nt0 = time.perf_counter()\n",
                           "import time\ntime.sleep(0.1)\n"),
    "atomic-accumulate": ("out.index_add_(0, idx, rows)\n",
                          "out = out + rows\n"),
    "cpu-default": ("def f(x, device='cpu'):\n    return x\n",
                    "def f(x, device=None):\n    return x\n"),
}


def test_every_rule_has_a_case():
    assert sorted(CASES) == sorted(RULES)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_catches_its_violation(rule):
    assert rules_of(lint(CASES[rule][0])) == {rule}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_passes_its_clean_counterpart(rule):
    assert lint(CASES[rule][1]) == []


@pytest.mark.parametrize("src", [
    "x = log_einsum_exp_plain(w, l, r)\n",
    "fn = lee.grouped_log_einsum_exp_bwd_cuda\n",
    "from repro_torch.kernels import build\n",
    "import repro_torch.kernels.build\n",
    "from repro_torch.kernels.build import build\n",
    "import ctypes\n",
    "lib = ctypes.CDLL(path)\n",
])
def test_kernel_contract_forms(src):
    assert rules_of(lint(src)) == {"kernel-contract"}
    # inside the kernels package they are the implementation itself
    assert lint(src, "src/repro_torch/kernels/ops.py") == []


def test_kernel_contract_is_not_is_cuda():
    assert lint("ok = x.is_cuda\n") == []


@pytest.mark.parametrize("src", [
    "with torch.cuda.graph(g):\n    pass\n",
    "f = torch.compile(g)\n",
    "f = torch.jit.script(g)\n",
    "from torch.cuda import CUDAGraph\n",
    "from torch import compile\n",
    "import torch.jit\n",
])
def test_bare_graph_forms(src):
    assert rules_of(lint(src)) == {"bare-graph"}
    assert lint(src, "src/repro_torch/compile.py") == []


def test_timing_allow_list():
    bad = CASES["timing-outside-obs"][0]
    assert rules_of(lint("from time import perf_counter\n")) == \
        {"timing-outside-obs"}
    assert rules_of(lint("import time\nt = time.monotonic()\n")) == \
        {"timing-outside-obs"}
    assert lint(bad, "src/repro_torch/obs/trace.py") == []
    assert lint(bad, "src/repro_torch/bench/serve.py") == []


@pytest.mark.parametrize("src", [
    "out.index_add_(0, idx, rows)\n",
    "out = torch.index_add(out, 0, idx, rows)\n",
    "out.scatter_add_(0, idx, rows)\n",
    "out.scatter_reduce_(0, idx, rows, 'sum')\n",
    "out.index_put_((idx,), vals, accumulate=True)\n",
    "out.index_put_((idx,), vals, True)\n",
])
@pytest.mark.parametrize("path", [
    "src/repro_torch/core/einet.py", "src/repro_torch/serve/engine.py",
    "src/repro_torch/mixture/train.py", "src/repro_torch/eval/metrics.py"])
def test_atomic_accumulate_on_row_paths(src, path):
    assert rules_of(lint(src, path)) == {"atomic-accumulate"}


def test_atomic_accumulate_only_on_row_paths():
    src = "out.index_put_((idx,), vals, accumulate=True)\n"
    assert lint(src, "src/repro_torch/optim/compression.py") == []
    assert lint("out.index_put_((idx,), vals, accumulate=False)\n") == []
    assert lint("out.index_put_((idx,), vals)\n") == []


@pytest.mark.parametrize("src", [
    "def f(x, *, device='cpu'):\n    return x\n",
    "def f(x, device=torch.device('cpu')):\n    return x\n",
    "DEV = 'cpu'\ndef f(x, device=DEV):\n    return x\n",
    "DEV = torch.device('cpu')\ng = lambda x, d=DEV: x\n",
    "@dataclasses.dataclass\nclass C:\n    device: str = 'cpu'\n",
])
def test_cpu_default_forms(src):
    assert rules_of(lint(src, "src/repro_torch/launch/x.py")) == \
        {"cpu-default"}


def test_cpu_default_leaves_explicit_cpu_alone():
    assert lint("y = x.to('cpu')\nif d.type == 'cpu':\n    pass\n") == []
    assert lint("DEV = 'cpu'\nbuild(device=DEV)\n") == []


def test_port_rules_include_the_reference_rules():
    carried = {"neg-inf-literal", "timing-outside-obs"}
    assert carried <= set(RULES) and carried <= set(ref_lint.RULES)
    # pallas-contract and bare-jit carried over under the port's names
    assert {"pallas-contract", "bare-jit"} <= set(ref_lint.RULES)
    assert {"kernel-contract", "bare-graph"} <= set(RULES)
    # same clock set as the reference's timing rule
    from repro_torch.analysis import lint as port_lint
    assert port_lint._TIME_ATTRS == ref_lint._TIME_ATTRS


# ----------------------------------------------------------------- waivers
def test_waiver_suppresses_with_reason(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("x = -1e30\n")
    waivers = tmp_path / "waivers.json"
    waivers.write_text(json.dumps([{
        "rule": "neg-inf-literal", "path": "bad.py",
        "reason": "test fixture"}]))
    violations, waived = run_lint([str(f)], str(waivers))
    assert violations == [] and len(waived) == 1


@pytest.mark.parametrize("entry", [
    {"rule": "bare-graph", "path": "x.py"},
    {"rule": "bare-graph", "path": "x.py", "reason": "  "},
])
def test_waiver_requires_reason(tmp_path, entry):
    waivers = tmp_path / "waivers.json"
    waivers.write_text(json.dumps([entry]))
    with pytest.raises(ValueError, match="reason"):
        load_waivers(str(waivers))


def test_waiver_line_mismatch_does_not_suppress(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("x = -1e30\n")
    waivers = tmp_path / "waivers.json"
    waivers.write_text(json.dumps([{
        "rule": "neg-inf-literal", "path": "bad.py", "line": 999,
        "reason": "wrong line"}]))
    violations, waived = run_lint([str(f)], str(waivers))
    assert len(violations) == 1 and waived == []


# ------------------------------------------------------------- tree is clean
def test_port_tree_lints_clean():
    violations, waived = run_lint([str(SRC)])
    assert violations == [], "\n".join(str(v) for v in violations)
    shipped = load_waivers()
    assert all(w["reason"].strip() for w in shipped)
    # every waiver is used: none outlives the violation it excuses
    assert len(waived) == len(shipped)


def _cli(*args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"]}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env, timeout=120)


def test_cli_exit_codes(tmp_path):
    ok = _cli()
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 violation(s)" in ok.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("g = torch.compile(f)\n")
    fail = _cli(str(bad))
    assert fail.returncode == 1
    assert "bare-graph" in fail.stdout


def test_cli_list_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    assert [line.split(":")[0] for line in out.stdout.splitlines()] == \
        list(RULES)


def test_violation_str_is_clickable():
    v = Violation("bare-graph", "repro_torch/serve/x.py", 12, "msg")
    assert str(v) == "repro_torch/serve/x.py:12: bare-graph: msg"
