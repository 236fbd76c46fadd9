"""Serving-engine throughput benchmark -> BENCH_torch_serve.json.

The port of the reference's ``benchmarks/bench_serve.py``: the batched
exact-inference engine (``repro_torch.serve``) against the direct
one-request-at-a-time path on a mixed query stream, through the port's
``serve.run_benchmark`` and ``format_report``:

  PYTHONPATH=src python -m repro_torch.bench.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.bench.serve       # einet_rat, card
  PYTHONPATH=src python -m repro_torch.bench.serve --card --arch einet_pd

Two profiles besides ``--smoke``: the reference's (64 requests, sized for
a CPU: about 11 requests a kind, one bucket each), kept so that the two
packages' reports line up, and ``--card`` (``CARD_REQUESTS`` requests at
``max_batch`` ``CARD_MAX_BATCH``, the graph-serving size), which is what
``slo_torch.json``'s serve budgets hold.

Schema: the report of ``repro_torch.serve.benchmark.run_benchmark`` plus
the reference's {"arch", "num_vars", "num_sums", "smoke", "parity_ok",
"grouped_ok", "grouping", "timestamp"} (and "pd_smoke" under ``--smoke``),
"device", the card's name or "cpu", and "profile" ("smoke", "reference"
or "card").  The model is the config's EiNet initialised from ``--seed``;
the programs go into a registry of their own, so the report's program
counts are this run's.  The gates are the reference's: LL parity engine
against direct within 1e-5, and the grouped plan active.
"""

from __future__ import annotations

import argparse
import datetime
from typing import Optional

from repro_torch import compile as compile_lib
from repro_torch.bench import device_name, write_report
from repro_torch.configs import EinetConfig, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.launch.cells import build_einet
from repro_torch.serve import format_report, mixed_requests, run_benchmark

PARITY_TOL = 1e-5

# the card profile: the graph-serving phase's stream, about 43 requests a
# kind and every bucket up to 64
CARD_REQUESTS = 256
CARD_MAX_BATCH = 64

SMOKE_CONFIG = EinetConfig(
    name="einet-rat-serve-smoke",
    structure="rat",
    # 32 vars: the smallest RAT shape whose scopes don't collide across
    # repetitions, so the whole circuit depth-groups and the smoke run
    # exercises the grouped execution path (see bench.train.SMOKE_CONFIG)
    num_vars=32,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=64,
)

PD_SMOKE_CONFIG = EinetConfig(
    name="einet-pd-serve-smoke",
    structure="pd",
    # 32 vars as a 4x8 image, delta=2 on both axes: the interior PD pairs
    # compile to one gather-grouped segment, so the smoke run serves
    # through the gather kernels (see bench.train.PD_SMOKE_CONFIG)
    height=4,
    width=8,
    num_channels=1,
    delta=2,
    pd_axes=("h", "w"),
    num_sums=4,
    batch_size=64,
)


def bench_model(model, requests, name: str, max_batch: int = 0,
                reps: int = 3, smoke: bool = False,
                registry: Optional[compile_lib.ProgramRegistry] = None,
                profile: str = "reference") -> dict:
    """``run_benchmark`` of ``requests`` on ``model`` (an EiNet, or a
    mixture, whose shared structure gives the plan) in ``registry`` (a
    fresh one by default), with the bench's fields and gates added."""
    report = run_benchmark(
        model, requests, max_batch=max_batch, reps=reps,
        registry=registry if registry is not None
        else compile_lib.ProgramRegistry())
    structure = getattr(model, "component", model)
    report.update(
        arch=name,
        num_vars=model.num_vars,
        num_sums=structure.K,
        smoke=smoke,
        profile="smoke" if smoke else profile,
        parity_ok=report["parity_max_abs_diff"] <= PARITY_TOL,
        # LL serving must run the grouped plan -- RAT through fused
        # (canonical) segments, PD through gather segments
        grouped_ok=structure.grouped_active,
        # kernel launches per forward: per-layer loop vs grouped plan
        grouping=structure.grouping_summary(),
        device=device_name(structure.device),
        timestamp=datetime.datetime.now(datetime.timezone.utc).isoformat(),
    )
    return report


def _bench_one(cfg, requests: int, max_batch: int, reps: int, smoke: bool,
               device, seed: int = 0, profile: str = "reference") -> dict:
    model = build_einet(cfg, device=device, seed=seed)
    reqs = mixed_requests(model.num_vars, requests, seed=0)
    report = bench_model(model, reqs, cfg.name, max_batch, reps, smoke,
                         profile=profile)
    print(format_report(report))
    g = report["grouping"]
    print(f"grouping  : launches {g['launches_per_layer']} -> "
          f"{g['launches_grouped']} ({g['fused_groups']} fused + "
          f"{g['gather_groups']} gather group(s) over "
          f"{g['fused_pairs']}/{g['num_pairs']} pairs)")
    if not report["parity_ok"]:
        print(f"PARITY FAILURE: {report['parity_max_abs_diff']:.2e} > "
              f"{PARITY_TOL:.0e}")
    if not report["grouped_ok"]:
        print("GROUPED-EXECUTION FAILURE: arch expected to depth-group fell "
              "back to the per-layer path")
    return report


def main(
    smoke: bool = False,
    arch: str = "einet_rat",
    requests: int = 64,
    max_batch: int = 0,
    reps: int = 3,
    out: str = "BENCH_torch_serve.json",
    device=None,
    seed: int = 0,
    card: bool = False,
) -> dict:
    """Run the bench; returns the report, or {} when a gate fails.
    ``card`` serves ``CARD_REQUESTS`` at ``max_batch`` ``CARD_MAX_BATCH``.
    ``out=""`` writes no BENCH file and appends no history row."""
    dev = resolve_device(device)
    cfg = SMOKE_CONFIG if smoke else get_config(arch)
    profile = "reference"
    if smoke:
        requests = min(requests, 24)
    elif card:
        requests, max_batch, profile = CARD_REQUESTS, CARD_MAX_BATCH, "card"
    report = _bench_one(cfg, requests, max_batch, reps, smoke, dev, seed,
                        profile)
    ok = report["parity_ok"] and report["grouped_ok"]
    if smoke:
        # the gather-topology twin: serves through the PD gather kernels
        pd_report = _bench_one(PD_SMOKE_CONFIG, requests, max_batch, reps,
                               smoke, dev, seed)
        report["pd_smoke"] = pd_report
        ok = ok and pd_report["parity_ok"] and pd_report["grouped_ok"]
    write_report("serve", report, out)
    return report if ok else {}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + short stream (CI profile)")
    ap.add_argument("--card", action="store_true",
                    help=f"the card profile: {CARD_REQUESTS} requests at "
                    f"max_batch {CARD_MAX_BATCH} (what slo_torch.json holds)")
    ap.add_argument("--arch", default="einet_rat")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's initial parameters")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_serve.json")
    args = ap.parse_args()
    result = main(smoke=args.smoke, arch=args.arch, requests=args.requests,
                  max_batch=args.max_batch, reps=args.reps, out=args.out,
                  device=args.device, seed=args.seed, card=args.card)
    raise SystemExit(0 if result else 1)
