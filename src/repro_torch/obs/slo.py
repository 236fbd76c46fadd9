"""SLO budgets and commit-stamped bench history for the port.

The port's copy of the reference's ``repro/obs/slo.py``: the same checks
and the same history rows, over the port's own files.

  * **Budgets** -- ``slo_torch.json`` at the repo root declares what the
    port's benchmarks are *allowed* to report: per-kind serve p99 latency,
    per-arch train step time, minimum speedups, parity bounds, plus one
    ``tolerance`` knob that widens every timing budget by its declared
    noise fraction.  ``python -m repro_torch.obs.slo --check`` validates
    every ``BENCH_torch_*.json`` against the budgets and exits non-zero on
    any breach.  Smoke-profile reports (``"smoke": true``) carry no
    meaningful wall-clock, so only their correctness flags (parity, grouped
    execution) are checked; full-profile reports get the timing budgets
    too.  The budgets are the card's: a full-profile report from a CPU run
    is not held to them meaningfully.

    Two keys the reference's ``slo.json`` does not have, both optional:
    ``"profile"`` under a bench's budgets names the profile its timing
    budgets were calibrated on (the port's benches stamp every report with
    ``"profile"``: "smoke", "reference" or "card"), and a full-profile
    report of another profile is a breach instead of being held to
    budgets that were not set for it; ``serve.p99_ms_by_arch`` gives an
    arch (the report's ``"arch"``) p99 budgets of its own in place of
    ``p99_ms``, so that a fast arch is not checked against a slow one's.

  * **History** -- every benchmark run appends one compact, commit-stamped
    row to ``artifacts/bench_history_torch/<bench>.jsonl``
    (:func:`append_history`, called by ``repro_torch.bench.{serve,train,
    mixture,eval}`` right after writing the BENCH file), so a regression
    is visible as a trend, not just a budget breach.

Stdlib only, like the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

DEFAULT_SLO_PATH = "slo_torch.json"
HISTORY_DIR = "artifacts/bench_history_torch"

# bench kind -> the BENCH file it writes (the --check discovery set)
BENCH_FILES = {
    "serve": "BENCH_torch_serve.json",
    "train": "BENCH_torch_train.json",
    "mixture": "BENCH_torch_mixture.json",
    "eval": "BENCH_torch_eval.json",
}


def load_slo(path: str = DEFAULT_SLO_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _tol(slo: Dict[str, Any]) -> float:
    return float(slo.get("tolerance", 0.0))


def _flag(report: Dict[str, Any], name: str, problems: List[str],
          where: str) -> None:
    if not report.get(name, False):
        problems.append(f"{where}: {name} is not true")


def _wrong_profile(report: Dict[str, Any], budget: Dict[str, Any],
                   where: str, problems: List[str]) -> bool:
    """True (and a problem noted) when the budgets name a profile and the
    report was run at another one."""
    want = budget.get("profile")
    got = report.get("profile", "reference")
    if want is None or got == want:
        return False
    problems.append(f"{where}: a {got!r}-profile report; the timing budgets "
                    f"are for the {want!r} profile")
    return True


# ------------------------------------------------------------ per-kind checks
def _check_serve(report: Dict[str, Any], slo: Dict[str, Any]) -> List[str]:
    budget = slo.get("serve", {})
    tol = _tol(slo)
    problems: List[str] = []
    reports = [("serve", report)]
    if isinstance(report.get("pd_smoke"), dict):
        reports.append(("serve.pd_smoke", report["pd_smoke"]))
    for where, r in reports:
        _flag(r, "parity_ok", problems, where)
        _flag(r, "grouped_ok", problems, where)
        max_parity = budget.get("max_parity_abs_diff")
        if max_parity is not None and (
                r.get("parity_max_abs_diff", 0.0) > max_parity):
            problems.append(
                f"{where}: parity_max_abs_diff "
                f"{r['parity_max_abs_diff']:.3e} > {max_parity:.0e}")
    if report.get("smoke") or _wrong_profile(report, budget, "serve",
                                             problems):
        return problems
    p99_ms = budget.get("p99_ms_by_arch", {}).get(
        report.get("arch"), budget.get("p99_ms", {}))
    for kind, p99_budget in p99_ms.items():
        lat = report.get("latency_ms", {}).get(kind)
        if lat is None:
            problems.append(f"serve: no latency for kind {kind!r}")
            continue
        limit = p99_budget * (1.0 + tol)
        if lat["p99"] > limit:
            problems.append(
                f"serve: {kind} p99 {lat['p99']:.2f} ms > budget "
                f"{p99_budget} ms (+{tol:.0%} tolerance = {limit:.2f})")
    min_sv = budget.get("min_speedup_vs_jitted")
    if min_sv is not None:
        floor = min_sv * (1.0 - tol)
        if report.get("speedup_vs_jitted", 0.0) < floor:
            problems.append(
                f"serve: speedup_vs_jitted "
                f"{report.get('speedup_vs_jitted', 0.0):.2f} < floor "
                f"{floor:.2f} (budget {min_sv}, -{tol:.0%} tolerance)")
    return problems


def _check_train(report: Dict[str, Any], slo: Dict[str, Any]) -> List[str]:
    budget = slo.get("train", {})
    tol = _tol(slo)
    problems: List[str] = []
    _flag(report, "parity_ok", problems, "train")
    _flag(report, "grouped_ok", problems, "train")
    for row in report.get("results", []):
        arch = row.get("arch_id", row.get("arch", "?"))
        if not row.get("grad_parity_ok", True):
            problems.append(f"train[{arch}]: grad_parity_ok is not true")
    if report.get("smoke") or _wrong_profile(report, budget, "train",
                                             problems):
        return problems
    max_ms = budget.get("max_step_ms", {})
    min_speedup = budget.get("min_speedup")
    for row in report.get("results", []):
        arch = row.get("arch_id", row.get("arch", "?"))
        ms_budget = max_ms.get(arch)
        if ms_budget is not None:
            limit = ms_budget * (1.0 + tol)
            if row.get("fused_ms_per_step", 0.0) > limit:
                problems.append(
                    f"train[{arch}]: fused step "
                    f"{row['fused_ms_per_step']:.2f} ms > budget "
                    f"{ms_budget} ms (+{tol:.0%} tolerance = {limit:.2f})")
        if min_speedup is not None and row.get("speedup_waiver") is None:
            floor = min_speedup * (1.0 - tol)
            if row.get("speedup", 0.0) < floor:
                problems.append(
                    f"train[{arch}]: speedup {row.get('speedup', 0.0):.3f} "
                    f"< floor {floor:.3f} (budget {min_speedup}, "
                    f"-{tol:.0%} tolerance)")
    return problems


def _check_mixture(report: Dict[str, Any], slo: Dict[str, Any]) -> List[str]:
    budget = slo.get("mixture", {})
    tol = _tol(slo)
    problems: List[str] = []
    _flag(report, "parity_ok", problems, "mixture")
    if report.get("smoke"):
        return problems
    min_speedup = budget.get("min_speedup")
    if min_speedup is not None:
        floor = min_speedup * (1.0 - tol)
        for row in report.get("results", []):
            cell = row.get("cell", "?")
            if row.get("speedup", 0.0) < floor:
                problems.append(
                    f"mixture[{cell}]: speedup "
                    f"{row.get('speedup', 0.0):.3f} < floor {floor:.3f} "
                    f"(budget {min_speedup}, -{tol:.0%} tolerance)")
    return problems


def _check_eval(report: Dict[str, Any], slo: Dict[str, Any]) -> List[str]:
    budget = slo.get("eval", {})
    tol = _tol(slo)
    problems: List[str] = []
    _flag(report, "parity_ok", problems, "eval")
    if report.get("smoke"):
        return problems
    min_ratio = budget.get("min_engine_vs_direct")
    if min_ratio is not None:
        floor = min_ratio * (1.0 - tol)
        if report.get("engine_vs_direct", 0.0) < floor:
            problems.append(
                f"eval: engine_vs_direct "
                f"{report.get('engine_vs_direct', 0.0):.3f} < floor "
                f"{floor:.3f} (budget {min_ratio}, -{tol:.0%} tolerance)")
    return problems


_CHECKS = {
    "serve": _check_serve,
    "train": _check_train,
    "mixture": _check_mixture,
    "eval": _check_eval,
}


def check_report(kind: str, report: Dict[str, Any],
                 slo: Dict[str, Any]) -> List[str]:
    """Budget breaches of one bench report (empty list = within SLO)."""
    if kind not in _CHECKS:
        return [f"unknown bench kind {kind!r}; one of {sorted(_CHECKS)}"]
    return _CHECKS[kind](report, slo)


def check_all(bench_dir: str = ".",
              slo: Optional[Dict[str, Any]] = None,
              slo_path: str = DEFAULT_SLO_PATH) -> Dict[str, List[str]]:
    """Check every ``BENCH_torch_*.json`` present in ``bench_dir``; kind ->
    its problem list.  Having NO bench file at all is itself a problem entry
    (the gate must not pass vacuously)."""
    if slo is None:
        slo = load_slo(slo_path)
    out: Dict[str, List[str]] = {}
    found = 0
    for kind, fname in BENCH_FILES.items():
        path = os.path.join(bench_dir, fname)
        if not os.path.exists(path):
            continue
        found += 1
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            out[kind] = [f"cannot load {path}: {e}"]
            continue
        out[kind] = check_report(kind, report, slo)
    if not found:
        out["(none)"] = [f"no BENCH_torch_*.json found in {bench_dir!r}"]
    return out


# ---------------------------------------------------------------- history
def git_commit(repo_dir: str = ".") -> str:
    """Short commit hash of ``repo_dir``, or "unknown" outside a checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _summarize(kind: str, report: Dict[str, Any]) -> Dict[str, Any]:
    """The compact per-run payload of one history row (trend-worthy scalars
    only -- the full report lives in the BENCH file, not the history)."""
    if kind == "serve":
        lat = report.get("latency_ms", {})
        return {
            "speedup": report.get("speedup"),
            "speedup_vs_jitted": report.get("speedup_vs_jitted"),
            "engine_qps": report.get("engine_qps"),
            "p99_ms": {k: v.get("p99") for k, v in lat.items()},
            "parity_ok": report.get("parity_ok"),
        }
    if kind == "train":
        return {
            "cells": {
                row.get("arch_id", row.get("arch", "?")): {
                    "fused_ms": row.get("fused_ms_per_step"),
                    "speedup": row.get("speedup"),
                }
                for row in report.get("results", [])
            },
            "parity_ok": report.get("parity_ok"),
        }
    if kind == "mixture":
        return {
            "cells": {
                row.get("cell", "?"): row.get("speedup")
                for row in report.get("results", [])
            },
            "parity_ok": report.get("parity_ok"),
        }
    if kind == "eval":
        return {
            "engine_vs_direct": report.get("engine_vs_direct"),
            "engine_rows_per_s": report.get("engine_rows_per_s"),
            "parity_ok": report.get("parity_ok"),
        }
    return {}


def history_row(kind: str, report: Dict[str, Any]) -> Dict[str, Any]:
    ts = report.get("timestamp") or datetime.datetime.now(
        datetime.timezone.utc).isoformat()
    return {
        "bench": kind,
        "ts": ts,
        "commit": git_commit(),
        "smoke": bool(report.get("smoke", False)),
        **_summarize(kind, report),
    }


def append_history(kind: str, report: Dict[str, Any],
                   root: str = HISTORY_DIR) -> str:
    """Append one commit-stamped row to ``<root>/<kind>.jsonl``; returns the
    file path.  Called by every bench run that writes its BENCH file (smoke
    and full), so the history is an unbroken per-commit record."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{kind}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(history_row(kind, report), sort_keys=True) + "\n")
    return path


def load_history(root: str = HISTORY_DIR) -> Dict[str, List[Dict[str, Any]]]:
    """bench kind -> its history rows, oldest first (malformed lines are
    skipped, not fatal -- history must never break a build)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    if not os.path.isdir(root):
        return out
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".jsonl"):
            continue
        rows = []
        with open(os.path.join(root, fname)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        out[fname[:-len(".jsonl")]] = rows
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.slo", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="validate BENCH_torch_*.json against the SLO budgets")
    ap.add_argument("--dir", default=".",
                    help="directory holding the BENCH_torch_*.json files")
    ap.add_argument("--slo", default=DEFAULT_SLO_PATH,
                    help="budget file (default: ./slo_torch.json)")
    ap.add_argument("--history", action="store_true",
                    help="print the bench history (rows per bench kind)")
    args = ap.parse_args(argv)
    if not args.check and not args.history:
        ap.error("nothing to do: pass --check and/or --history")
    status = 0
    if args.check:
        results = check_all(bench_dir=args.dir, slo_path=args.slo)
        for kind in sorted(results):
            problems = results[kind]
            if problems:
                status = 1
                for p in problems:
                    print(f"slo check: {kind}: {p}")
            else:
                print(f"slo check: {kind}: within budget")
    if args.history:
        for kind, rows in sorted(load_history().items()):
            print(f"{kind}: {len(rows)} rows")
            for row in rows[-5:]:
                print(f"  {json.dumps(row, sort_keys=True)}")
    return status


if __name__ == "__main__":
    sys.exit(main())
