"""Find a serving cell's knee once, by a sweep on the card: the highest
offered rate at which the answers keep up with the arrivals through the
window.

    python3 einbench/sweep.py --workload serve.einet_rat.open \
        [--seed 7] [--seconds 6] [--start 250] [--out einbench_out/sweep.json]

One set-up (the cell's model, weights and every program), then windows of
the cell's open-loop traffic at offered rates doubling from ``--start``
until one does not keep up, then four bisections between the last rate that
kept up and the first that did not.  A rate keeps up when at least
``KEEP_UP`` of its requests are answered inside the window and the most
requests due but not yet answered in the window's last quarter are at most
1.5 times those of its second quarter, plus 16: a backlog that grows
through the window doubles between the two.  Prints one line a rate and the knee; the cell's
traffic file takes 0.8 of it as a number.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

KEEP_UP = 0.98


def trial(ctx, st, gen, rate: float, seconds: float) -> dict:
    import numpy as np

    ctx.traffic = dict(ctx.traffic, rate_per_s=rate, drain_s=5.0)
    run = gen.window(ctx, st, ctx.seed, seconds)
    due = run["schedule"]["due"]
    done = np.asarray(run["latency_s"]) + due

    def backlog(t):
        return int(((due <= t) & (done > t)).sum())

    q2 = max(backlog(t) for t in np.linspace(seconds * 0.25, seconds * 0.5, 20))
    q4 = max(backlog(t) for t in np.linspace(seconds * 0.75, seconds, 20))
    share = run["completed"] / max(1, run["attempted"])
    return {"rate_per_s": rate, "offered": run["attempted"],
            "completed_in_window": run["completed"], "completed_share": share,
            "p95_ms": float(np.percentile(run["latency_s"], 95)) * 1e3,
            "backlog_q2": q2, "backlog_q4": q4,
            "keeps_up": share >= KEEP_UP and q4 <= 1.5 * q2 + 16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--start", type=float, default=25.0)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="the engine's largest bucket, in place of the "
                         "traffic file's")
    ap.add_argument("--out", default=os.path.join(ROOT, "einbench_out", "sweep.json"))
    args = ap.parse_args(argv)

    import torch

    from harness.core import Context
    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    ctx = Context(spec, args.workload, args.seed, args.seconds, False, "cuda",
                  time.perf_counter())
    if args.max_batch:
        ctx.traffic = dict(ctx.traffic, max_batch=args.max_batch)
    gen = spec.generator(ctx.traffic["generator"])
    st = gen.setup(ctx)
    gen.prime(ctx, st, args.seed)
    rows = []

    def run(rate):
        r = trial(ctx, st, gen, rate, args.seconds)
        rows.append(r)
        print(json.dumps(r), flush=True)
        return r["keeps_up"]

    good, bad, rate = None, None, args.start
    while rate <= 1e5:
        if run(rate):
            good, rate = rate, rate * 2
        else:
            bad = rate
            break
    if good is not None and bad is not None:
        for _ in range(4):
            mid = (good * bad) ** 0.5
            if run(mid):
                good = mid
            else:
                bad = mid
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "max_batch": ctx.traffic["max_batch"],
           "seconds": args.seconds, "rows": rows, "knee_per_s": good,
           "first_failing_per_s": bad}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"knee {good} req/s (first rate that did not keep up: {bad})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
