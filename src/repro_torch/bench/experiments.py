"""Assemble ``EXPERIMENTS_torch.md`` from the port's artifacts (the
counterpart of the reference's ``benchmarks/make_experiments_md.py``).

Sources, each a section:

  * verify coverage -- ``analysis.verify`` over every registered arch (on
    the "meta" device; no artifact needed);
  * the numerical health probe -- ``artifacts/health_torch/*.json``
    (``python -m repro_torch.launch.dryrun --verify``);
  * the dry-run cells and their roofline on the H100 --
    ``artifacts/dryrun_torch`` (``python -m repro_torch.launch.dryrun --all
    --mesh both``; ``bench.roofline``);
  * the production benches -- ``BENCH_torch_{serve,train,mixture,eval}.json``
    (``python -m repro_torch.bench.<name>``);
  * the eval workbench -- ``artifacts/eval_torch/<run>/metrics.json``
    (``python -m repro_torch.launch.eval``);
  * the bench history -- ``artifacts/bench_history_torch/*.jsonl``.

A missing source renders a placeholder naming the command that makes it,
and a section that cannot be rendered says why: the report never
crashes.  The output is generated from the card's gitignored artifacts,
so ``.gitignore`` lists it.

  PYTHONPATH=src python -m repro_torch.bench.experiments [--root .] [--out ...]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.bench import roofline

OUT = "EXPERIMENTS_torch.md"
PLACEHOLDER = "_not yet generated on this host — run `{cmd}` first._"

_CMDS = {
    "verify": "PYTHONPATH=src python -m repro_torch.launch.dryrun --verify",
    "health": "PYTHONPATH=src python -m repro_torch.launch.dryrun --verify",
    "dryrun": "PYTHONPATH=src python -m repro_torch.launch.dryrun --all "
              "--mesh both",
    "benches": "PYTHONPATH=src python -m repro_torch.bench.serve --card "
               "(and bench.train --card, bench.mixture, bench.eval)",
    "eval": "PYTHONPATH=src python -m repro_torch.launch.eval --dataset "
            "synthetic --smoke",
    "history": "PYTHONPATH=src python -m repro_torch.bench.serve",
}


class Missing(Exception):
    """A section's source is not on this host."""


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def verify_summary(root: str) -> str:
    from repro_torch.analysis.verify import verify_config
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.cells import build_einet

    rows = ["| arch | pairs | plan | invariants checked | findings | status |",
            "|" + "---|" * 6]
    for name in sorted(REGISTRY):
        model = build_einet(REGISTRY[name], device="meta")
        report = verify_config(REGISTRY[name])
        s = model.grouping_summary()
        rows.append(
            f"| {report.name} | {len(model.pair_specs)} | "
            f"{s['segments']} | {len(report.invariants)} | "
            f"{len(report.findings)} | {'ok' if report.ok else 'FAILED'} |")
    return "\n".join(rows)


def health_summary(root: str) -> str:
    d = os.path.join(root, "artifacts", "health_torch")
    files = sorted(f for f in os.listdir(d) if f.endswith(".json")) \
        if os.path.isdir(d) else []
    if not files:
        raise Missing
    rows = ["| arch | device | params | probe LL mean | LL min | non-finite "
            "| leaf sat | segment sat (max) |", "|" + "---|" * 8]
    for f in files:
        rec = _load(os.path.join(d, f))
        if rec.get("skipped"):
            rows.append(f"| {rec.get('arch')} | — | "
                        f"{rec.get('num_params', 0):,} | — | — | — | — | "
                        f"skipped: {rec.get('reason', '?')} |")
            continue
        seg = rec.get("segment_sat_frac") or [0.0]
        rows.append(
            f"| {rec['arch']} | {rec.get('device', '?')} | "
            f"{rec.get('num_params', 0):,} | {rec['ll_mean']:.2f} | "
            f"{rec['ll_min']:.2f} | {rec['ll_nonfinite']} | "
            f"{rec['leaf_sat_frac']:.3f} | {max(seg):.3f} over {len(seg)} "
            f"segment(s) |")
    return "\n".join(rows)


def _dryrun_dir(root: str) -> str:
    d = os.path.join(root, roofline.DEFAULT_DIR)
    if not os.path.isdir(d) or not any(
            f.endswith(".json") for f in os.listdir(d)):
        raise Missing
    return d


def dryrun_summary(root: str, mesh: str) -> str:
    d = _dryrun_dir(root)
    rows, ok, err = [], 0, 0
    for f in sorted(os.listdir(d)):
        if not (f.endswith(".json") or f.endswith(".json.err")):
            continue
        rec = _load(os.path.join(d, f))
        if "error" in rec:
            if rec.get("mesh") in (mesh, "single" if mesh == "16x16"
                                   else "multi"):
                err += 1
                rows.append(f"| {rec['arch']} | {rec.get('shape')} | ERROR: "
                            f"{rec['error'][:60]} |" + " |" * 8)
            continue
        if rec.get("mesh") != mesh:
            continue
        ok += 1
        mem = rec["memory"]
        card = (rec.get("device") or {}).get("card") or \
            (rec.get("device") or {}).get("type", "?")
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | "
            f"{rec['rows_per_device']} ({rec['microbatches']}) | "
            f"{rec['flops_per_device']:.3e} | "
            f"{rec['bytes_written_per_device']:.3e} | "
            f"{rec['collective_bytes_per_device']:.3e} | "
            f"{mem['argument_bytes'] / 2 ** 30:.3f} | "
            f"{mem['pool_bytes'] / 2 ** 30:.3f} | {rec['capture_s']:.2f} | "
            f"{card} |")
    if not ok and not err:
        raise Missing
    hdr = ("| arch | shape | kind | rows/dev (microbatches) | FLOPs/dev | "
           "bytes/dev | coll B/dev | args GiB | pool GiB | capture s | "
           "device |\n|" + "---|" * 11)
    return (f"{ok} cells captured, {err} failed.\n\n" + hdr + "\n"
            + "\n".join(rows))


def roofline_summary(root: str, mesh: str) -> str:
    return roofline.to_markdown(roofline.build_table(_dryrun_dir(root), mesh))


def bench_summary(root: str) -> str:
    parts = []
    path = os.path.join(root, "BENCH_torch_serve.json")
    if os.path.isfile(path):
        r = _load(path)
        pc = r.get("program_cache") or {}
        parts.append(
            f"**Serving** (`BENCH_torch_serve.json`, {r.get('arch')}, "
            f"profile {r.get('profile')}, {r.get('device')}): engine "
            f"{r.get('engine_qps', 0):.1f} req/s — x"
            f"{r.get('speedup', 0):.1f} vs the eager per-request path, x"
            f"{r.get('speedup_vs_jitted', 0):.1f} vs per-request graphs; "
            f"parity {r.get('parity_max_abs_diff')}; program cache "
            f"{pc.get('hits', 0)} hits / {pc.get('misses', 0)} misses.")
        lat = r.get("latency_ms") or {}
        if lat:
            rows = ["| kind | p50 ms | p95 ms | p99 ms |", "|" + "---|" * 4]
            rows += [f"| {k} | {v.get('p50', 0):.3f} | {v.get('p95', 0):.3f}"
                     f" | {v.get('p99', 0):.3f} |"
                     for k, v in sorted(lat.items())]
            parts.append("\n".join(rows))
    path = os.path.join(root, "BENCH_torch_train.json")
    if os.path.isfile(path):
        r = _load(path)
        rows = ["| arch | batch (microbatches) | graph ms/step | eager "
                "ms/step | speedup | grad parity |", "|" + "---|" * 6]
        for c in r.get("results", []):
            rows.append(
                f"| {c['arch']} | {c['batch']} ({c['microbatches']}) | "
                f"{c['fused_ms_per_step']} | {c['per_step_ms_per_step']} | "
                f"x{c['speedup']} | {c['grad_parity_max_abs_diff']:.1e} |")
        parts.append(f"**Training** (`BENCH_torch_train.json`, profile "
                     f"{r.get('profile')}, {r.get('device')}):\n\n"
                     + "\n".join(rows))
    path = os.path.join(root, "BENCH_torch_mixture.json")
    if os.path.isfile(path):
        r = _load(path)
        rows = ["| cell | C | one program ms/step | C programs ms/step | "
                "speedup |", "|" + "---|" * 5]
        for c in r.get("results", []):
            rows.append(
                f"| {c['cell']} | {c['num_components']} | "
                f"{c['vmapped_ms_per_step']} | {c['looped_ms_per_step']} | "
                f"x{c['speedup']} |")
        parts.append(f"**Mixture training** (`BENCH_torch_mixture.json`, "
                     f"{r.get('device')}):\n\n" + "\n".join(rows))
    path = os.path.join(root, "BENCH_torch_eval.json")
    if os.path.isfile(path):
        r = _load(path)
        parts.append(
            f"**Evaluation** (`BENCH_torch_eval.json`, {r.get('arch')}, "
            f"{r.get('device')}): engine {r.get('engine_rows_per_s', 0):.0f}"
            f" rows/s vs {r.get('direct_rows_per_s', 0):.0f} for dense "
            f"chunks (x{r.get('engine_vs_direct', 0):.2f}); parity "
            f"{'ok' if r.get('parity_ok') else 'MISMATCHES'}.")
    if not parts:
        raise Missing
    return "\n\n".join(parts)


def eval_summary(root: str) -> str:
    d = os.path.join(root, "artifacts", "eval_torch")
    runs = sorted(os.listdir(d)) if os.path.isdir(d) else []
    records = [_load(os.path.join(d, run, "metrics.json")) for run in runs
               if os.path.isfile(os.path.join(d, run, "metrics.json"))]
    if not records:
        raise Missing
    parts = []
    for r in records:
        bj, bm = r.get("bpd_joint", {}), r.get("bpd_marginal", {})
        rows = ["| mask | sample MSE | MPE MSE | mean-fill MSE |",
                "|" + "---|" * 4]
        for mk, m in r.get("inpainting", {}).get("per_mask", {}).items():
            mf = m.get("mean_fill_mse")
            rows.append(
                f"| {mk} | {m.get('conditional_sample_mse', 0):.4f} | "
                f"{m.get('mpe_mse', 0):.4f} | "
                f"{'—' if mf is None else f'{mf:.4f}'} |")
        parts.append(
            f"**{r.get('run_name')}** — {r.get('dataset')} "
            f"({r.get('dataset_source')}), {r.get('num_params', 0):,} params,"
            f" {r.get('train_steps')} EM steps; test bpd "
            f"{bj.get('bpd', 0):.4f} at {bj.get('engine_rows_per_s', 0):.0f}"
            f" rows/s, marginal bpd {bm.get('bpd', 0):.4f}; parity "
            f"mismatches {r.get('parity_mismatches_total')}.\n\n"
            + "\n".join(rows))
    return "\n\n".join(parts)


def _headline(kind: str, r: dict) -> str:
    """One history row's headline figures (the reference's choice)."""
    if kind == "serve":
        return (f"{r.get('engine_qps') or 0:.0f} req/s, "
                f"x{r.get('speedup_vs_jitted') or 0:.2f} vs per-request "
                f"graphs")
    if kind == "train":
        return ", ".join(f"{a}: {(c or {}).get('fused_ms') or 0:.2f} ms"
                         for a, c in sorted((r.get("cells") or {}).items()))
    if kind == "mixture":
        return ", ".join(f"{c}: x{s or 0:.2f}"
                         for c, s in sorted((r.get("cells") or {}).items()))
    return f"engine/direct x{r.get('engine_vs_direct') or 0:.2f}"


def history_summary(root: str, last: int = 5) -> str:
    d = os.path.join(root, "artifacts", "bench_history_torch")
    files = sorted(f for f in os.listdir(d) if f.endswith(".jsonl")) \
        if os.path.isdir(d) else []
    parts = []
    for fname in files:
        rows = []
        with open(os.path.join(d, fname)) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        if not rows:
            continue
        kind = fname[: -len(".jsonl")]
        md = [f"**{kind}** ({len(rows)} run(s)):", "",
              "| commit | when (UTC) | profile | headline |", "|" + "---|" * 4]
        for r in rows[-last:]:
            md.append(f"| {r.get('commit', '?')} | "
                      f"{str(r.get('ts', '?'))[:16]} | "
                      f"{'smoke' if r.get('smoke') else 'full'} | "
                      f"{_headline(kind, r)} |")
        parts.append("\n".join(md))
    if not parts:
        raise Missing
    return "\n\n".join(parts)


def _section(name: str, fn: Callable[[], str]) -> Tuple[str, bool]:
    """(text, rendered from its source) of one section."""
    try:
        return fn(), True
    except Missing:
        return PLACEHOLDER.format(cmd=_CMDS[name]), False
    except Exception as e:  # noqa: BLE001 -- a report never crashes
        return (f"_section could not be rendered ({e!r}); run "
                f"`{_CMDS[name]}` again._"), False


def render(root: str = ".", bench_dir: Optional[str] = None
           ) -> Tuple[str, Dict[str, bool]]:
    """The report's text and, per section, whether it was rendered from
    its source.  ``bench_dir`` holds the ``BENCH_torch_*.json`` files
    (default ``root``)."""
    bench_dir = root if bench_dir is None else bench_dir
    sections: List[Tuple[str, str, Callable[[], str]]] = [
        ("Static verification coverage", "verify",
         lambda: verify_summary(root)),
        ("Numerical health probe", "health", lambda: health_summary(root)),
        ("Dry-run cells (single pod, 16x16)", "dryrun",
         lambda: dryrun_summary(root, "16x16")),
        ("Dry-run cells (two pods, 2x16x16)", "dryrun",
         lambda: dryrun_summary(root, "2x16x16")),
        ("Roofline on the H100 (16x16)", "dryrun",
         lambda: roofline_summary(root, "16x16")),
        ("Roofline on the H100 (2x16x16)", "dryrun",
         lambda: roofline_summary(root, "2x16x16")),
        ("Production benches", "benches", lambda: bench_summary(bench_dir)),
        ("Eval workbench", "eval", lambda: eval_summary(root)),
        ("Bench history", "history", lambda: history_summary(root)),
    ]
    out = ["# EXPERIMENTS (PyTorch/CUDA port)", "",
           "Generated by `python -m repro_torch.bench.experiments` from this "
           "host's artifacts; do not edit by hand.", ""]
    status: Dict[str, bool] = {}
    for title, name, fn in sections:
        text, ok = _section(name, fn)
        status[title] = ok
        out += [f"## {title}", "", text, ""]
    return "\n".join(out), status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.experiments")
    ap.add_argument("--root", default=".",
                    help="where the artifacts and BENCH_torch_*.json are")
    ap.add_argument("--bench-dir", default=None,
                    help="where the BENCH_torch_*.json are (default --root)")
    ap.add_argument("--out", default=None,
                    help=f"output file (default <root>/{OUT})")
    args = ap.parse_args(argv)
    text, status = render(args.root, args.bench_dir)
    out = args.out or os.path.join(args.root, OUT)
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({len(text)} bytes); sections from their sources: "
          + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in status.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
