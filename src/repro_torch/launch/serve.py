"""Serving CLI: a mixed stream of joint/marginal/conditional LL,
sampling and MPE requests through ``repro_torch.serve.ServeEngine``, timed
against nothing but itself and checked against direct one-request calls.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch einet_rat --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch einet_rat --device cpu

Runs on CUDA unless ``--device cpu``.  Prints the engine's throughput
(after one warm pass) and the parity with direct calls, and exits non-zero
when parity is violated: an LL differing by more than 1e-5 relative
(|diff| / max(1, |LL|)), or any sampling/decode output not identical.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import serve as serve_lib
from repro_torch.configs import get_config
from repro_torch.core.einet import resolve_device
from repro_torch.launch.cells import build_einet

LL_REL_TOL = 1e-5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_einet(cfg, requests: int, max_batch: int, reps: int, device) -> dict:
    """Build ``cfg`` (seed 0), serve ``mixed_requests(D, requests, seed=0)``
    once warm and ``reps`` times timed; returns the report."""
    device = resolve_device(device)
    model = build_einet(cfg, device=device, seed=0)
    reqs = serve_lib.mixed_requests(model.num_vars, requests, seed=0)
    engine = serve_lib.ServeEngine(model, max_batch=max_batch)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    _sync(device)
    warm_s = time.perf_counter() - t0
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = engine.run(reqs)
        _sync(device)
        steady.append(time.perf_counter() - t0)
    call = serve_lib.direct_call(model)
    direct = {r.req_id: call(r) for r in reqs}
    report = {
        "arch": cfg.name,
        "device": str(device),
        "num_requests": len(reqs),
        "max_batch": max_batch,
        "warm_s": warm_s,
        "steady_s": min(steady),
        "engine_qps": len(reqs) / min(steady),
        "scheduler_steps": engine.stats["steps"] // (reps + 1),
    }
    report.update(serve_lib.parity(reqs, results, direct))
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    r = serve_einet(get_config(args.arch), args.requests, args.max_batch,
                    max(1, args.reps), args.device)
    where = r["device"]
    if where.startswith("cuda"):
        where += f" ({torch.cuda.get_device_name(torch.device(where))})"
    print(f"{r['arch']} on {where}: {r['num_requests']} requests, "
          f"max_batch {r['max_batch']}, {r['scheduler_steps']} steps")
    print(f"warm pass {r['warm_s'] * 1e3:.1f} ms; steady "
          f"{r['steady_s'] * 1e3:.1f} ms ({r['engine_qps']:.0f} req/s)")
    print(f"parity: LL max|engine - direct| {r['ll_max_abs_diff']:.3e} "
          f"(relative {r['ll_max_rel_diff']:.3e}); sampling/decode "
          f"mismatches {r['sample_mismatches']}")
    if r["ll_max_rel_diff"] > LL_REL_TOL or r["sample_mismatches"]:
        raise SystemExit("engine/direct parity violated")


if __name__ == "__main__":
    main()
