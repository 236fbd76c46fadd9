"""Serving CLI: the batched exact-inference engine (``repro_torch.serve``).

A mixed stream of joint/marginal/conditional LL, sampling and MPE requests
is coalesced into padded per-kind micro-batches and run through the
program cache (a CUDA graph per (kind, bucket) on the card); warm-up
(capture) and steady state are reported apart, with per-kind p50/p95/p99
latency and the two one-request-at-a-time baselines
(``serve.benchmark.run_benchmark`` / ``format_report``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch einet_rat --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --trace /tmp/trace.json

Runs on CUDA unless ``--device cpu``.  Exits non-zero when the engine
disagrees with either one-request path, the per-request programs or the
eager path (which shares no program with the engine): an LL differing by
more than 1e-5 relative (|diff| / max(1, |LL|)), or any sampling/decode
output not identical.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch import serve as serve_lib
from repro_torch.configs import EinetConfig, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.launch.cells import build_einet

LL_REL_TOL = 1e-5

# the reference's CI trace-smoke profile (``repro.launch.serve``): a tiny
# RAT (32 vars, the smallest whose scopes do not collide across
# repetitions) with a short stream; kept here because the launch CLIs only
# see src/ on PYTHONPATH
SMOKE_CONFIG = EinetConfig(
    name="einet-rat-serve-smoke",
    structure="rat",
    num_vars=32,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=64,
)


def serve_einet(cfg, requests: int, max_batch: int, reps: int,
                device) -> dict:
    """Build ``cfg`` (seed 0) on ``device`` and run ``run_benchmark`` on
    ``mixed_requests(D, requests, seed=0)``; returns the report."""
    device = resolve_device(device)
    model = build_einet(cfg, device=device, seed=0)
    reqs = serve_lib.mixed_requests(model.num_vars, requests, seed=0)
    report = serve_lib.run_benchmark(model, reqs, max_batch=max_batch,
                                     reps=reps)
    report.update(arch=cfg.name, device=str(device))
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny built-in arch and short stream (the CI "
                         "trace-smoke profile); --arch not required")
    ap.add_argument("--requests", type=int, default=None,
                    help="stream length (default 64, or 4 with --smoke)")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="engine micro-batch cap (0 = min(32, requests))")
    ap.add_argument("--reps", type=int, default=3,
                    help="steady-state measurement repetitions")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="collect obs tracing spans and export a "
                         "Chrome-trace JSON to this path at exit")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the METRICS.snapshot() JSON to this path "
                         "at exit")
    args = ap.parse_args()
    if not args.smoke and args.arch is None:
        ap.error("--arch is required (or pass --smoke)")
    requests = args.requests or (4 if args.smoke else 64)
    obs.cli_begin(args.trace)
    cfg = SMOKE_CONFIG if args.smoke else get_config(args.arch)
    r = serve_einet(cfg, requests, args.max_batch, args.reps, args.device)
    where = r["device"]
    if where.startswith("cuda"):
        where += f" ({torch.cuda.get_device_name(torch.device(where))})"
    print(f"{r['arch']} on {where}")
    print(serve_lib.format_report(r))
    bad = []
    for what, pre in (("direct", ""), ("legacy", "legacy_")):
        print(f"parity: LL max|engine - {what}| "
              f"{r[pre + 'll_max_abs_diff']:.3e} (relative "
              f"{r[pre + 'll_max_rel_diff']:.3e}); sampling/decode "
              f"mismatches {r[pre + 'sample_mismatches']}")
        if r[pre + "ll_max_rel_diff"] > LL_REL_TOL or \
                r[pre + "sample_mismatches"]:
            bad.append(what)
    obs.cli_end(args.trace, args.metrics)
    if bad:
        raise SystemExit(f"engine parity violated against {', '.join(bad)}")


if __name__ == "__main__":
    main()
