"""Throughput / latency measurement: the engine against the two
one-request-at-a-time paths, ported from the reference's
``repro/serve/benchmark.py``.

  * warm-up (the engine's first pass, which captures its programs) is
    timed apart from steady state: capture is paid once per (kind,
    bucket[, component]), never per request;
  * steady state reruns the identical stream against the warm programs;
  * latency is per request, enqueue to complete, read from the engine's
    ``serve.request.seconds`` histograms: the counts are marked before the
    timed passes and diffed after, so the percentiles cover those passes
    only;
  * two baselines, both one request at a time: ``direct_call`` through a
    bucket-1 program per kind (a CUDA graph on the card: the strong
    baseline, and the parity oracle) and ``legacy_call``, eager (the
    path a per-request server runs without programs);
  * every engine result is checked against the direct path (parity), and
    against the eager path, an oracle that shares no program with the
    engine.

Differences from the reference: the model holds its own parameters, so
there is no ``params`` argument; ``rules`` go to the engine, which splits its micro-batches over the data ranks of a job
(``ServeEngine``); ``registry`` isolates the program counts (the reference's engines always
use the process-wide registry); the report's ``program_cache``
``registry_compiles`` counts every program kind (``"graph"`` on the card,
``"eager"`` on the CPU, where the reference counts ``"aot"``); and the
report adds ``ll_max_abs_diff``, ``ll_max_rel_diff`` and
``sample_mismatches`` (``workload.parity`` over the model's value kinds,
engine against direct) and the same three against the eager path
(``legacy_ll_max_abs_diff``, ``legacy_ll_max_rel_diff``,
``legacy_sample_mismatches``), which the serve CLI gates on.  Every
timed region ends with results on the host, so the device has finished.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.dist import sharding as shlib
from repro_torch.obs import METRICS, percentile_from_counts
from repro_torch.serve.engine import LL_KINDS, Request, ServeEngine
from repro_torch.serve.workload import direct_call, legacy_call, parity


def _program_cache_counts() -> Dict[str, int]:
    """Process-wide program-cache counters (diff two snapshots to scope
    them to one benchmark): the engines' hits/misses plus the registry's
    compile count (a registry miss IS a compile)."""
    return {
        "hits": int(sum(
            m.value for _, m in METRICS.find("serve.program_cache.hits"))),
        "misses": int(sum(
            m.value for _, m in METRICS.find("serve.program_cache.misses"))),
        "registry_compiles": int(sum(
            m.value for _, m in METRICS.find("compile.cache.misses"))),
    }


def run_benchmark(
    model,
    requests: Sequence[Request],
    max_batch: int = 0,
    reps: int = 3,
    registry: Optional[compile_lib.ProgramRegistry] = None,
    rules: Optional[shlib.Rules] = None,
) -> Dict[str, Any]:
    """Serve ``requests`` through a ``ServeEngine`` over ``model``: one
    warm-up pass, ``reps`` timed passes, then each baseline once warm and
    once timed.  ``max_batch=0`` derives the micro-batch cap from the
    stream size (min(32, n)), the one defaulting rule the CLIs share."""
    n = len(requests)
    if n == 0:
        raise ValueError("run_benchmark needs at least one request")
    reps = max(1, int(reps))
    max_batch = max_batch or max(1, min(32, n))
    engine = ServeEngine(model, max_batch=max_batch, rules=rules,
                         registry=registry)
    kinds = sorted({r.kind for r in requests})
    cache0 = _program_cache_counts()

    # -- warm-up pass: captures the programs the stream needs
    with obs.timed("serve.bench.warmup") as t_warm:
        results = engine.run(requests)

    warm_steps = engine.stats["steps"]
    warm_padded = engine.stats["padded_rows"]

    # -- steady state: identical stream, warm programs; the latency marks
    # keep the warm-up's latencies (captures included) out of the
    # percentiles
    marks: Dict[str, List[int]] = {
        k: METRICS.sum_histogram("serve.request.seconds", kind=k)
        for k in kinds
    }
    with obs.timed("serve.bench.steady", reps=reps) as t_st:
        for _ in range(reps):
            results = engine.run(requests)
    t_steady = t_st.seconds / reps
    latency_ms: Dict[str, Dict[str, float]] = {}
    for k in kinds:
        after = METRICS.sum_histogram("serve.request.seconds", kind=k)
        delta = [a - b for a, b in zip(after, marks[k])]
        latency_ms[k] = {
            f"p{q}": round(percentile_from_counts(delta, q) * 1e3, 4)
            for q in (50, 95, 99)
        }
    # per-stream scheduling stats (engine.stats accumulate across passes)
    steps_per_pass = (engine.stats["steps"] - warm_steps) // reps
    padded_per_pass = (engine.stats["padded_rows"] - warm_padded) // reps
    cache1 = _program_cache_counts()

    # -- strong baseline: one bucket-1 program per kind, warmed the same way
    call = direct_call(model, engine.registry)
    with obs.timed("serve.bench.direct_warmup") as t_dw:
        direct = {r.req_id: call(r) for r in requests}
    with obs.timed("serve.bench.direct") as t_d:
        direct = {r.req_id: call(r) for r in requests}

    # -- eager baseline: one warm pass, then the timed pass
    call = legacy_call(model)
    for r in requests:
        call(r)
    with obs.timed("serve.bench.legacy") as t_l:
        legacy = {r.req_id: call(r) for r in requests}
    t_legacy = t_l.seconds

    value_kinds = getattr(model, "value_kinds", LL_KINDS)
    par = parity(requests, results, direct, value_kinds)
    legacy_par = parity(requests, results, legacy, value_kinds)
    parity_abs = max(
        float(np.max(np.abs(np.asarray(results[i].value) - direct[i])))
        for i in direct
    )
    return {
        "num_requests": n,
        "kinds": kinds,
        "max_batch": max_batch,
        "buckets": list(engine.buckets),
        "reps": reps,
        "warmup_s": t_warm.seconds,
        "compile_s": engine.stats["compile_s"],
        "direct_warmup_s": t_dw.seconds,
        "steady_s": t_steady,
        "engine_qps": n / t_steady,
        "latency_ms": latency_ms,
        "program_cache": {k: cache1[k] - cache0[k] for k in cache1},
        "direct_s": t_d.seconds,
        "direct_qps": n / t_d.seconds,
        "legacy_s": t_legacy,
        "legacy_qps": n / t_legacy,
        "speedup": t_legacy / t_steady,
        "speedup_vs_jitted": t_d.seconds / t_steady,
        "programs": engine.num_programs,
        "compiles": engine.stats["compiles"],
        "scheduler_steps": steps_per_pass,
        "padded_rows": padded_per_pass,
        # high-watermark, not last write: the queue drains before the
        # report is assembled, so the plain gauge value reads ~0 here
        "queue_depth_max": METRICS.gauge("serve.queue.depth").max,
        "parity_max_abs_diff": parity_abs,
        **par,
        **{f"legacy_{k}": v for k, v in legacy_par.items()},
    }


def format_report(r: Dict[str, Any]) -> str:
    lines = [
        f"batched exact-inference engine: {r['num_requests']} requests, "
        f"kinds={','.join(r['kinds'])}, max_batch={r['max_batch']}",
        f"warm-up   : engine {r['warmup_s']*1e3:.0f} ms "
        f"({r['programs']} programs, capture {r['compile_s']*1e3:.0f} ms); "
        f"direct path {r['direct_warmup_s']*1e3:.0f} ms",
        f"steady    : engine {r['steady_s']*1e3:.1f} ms "
        f"({r['engine_qps']:.0f} req/s)",
    ]
    for kind, lm in sorted(r.get("latency_ms", {}).items()):
        lines.append(
            f"latency   : {kind:<24s} p50 {lm['p50']:8.3f} ms   "
            f"p95 {lm['p95']:8.3f} ms   p99 {lm['p99']:8.3f} ms"
        )
    pc = r.get("program_cache")
    if pc:
        lines.append(
            f"prog cache: {pc['hits']} hits / {pc['misses']} misses "
            f"({pc['registry_compiles']} registry compiles)"
        )
    lines += [
        f"baselines : eager one-call-at-a-time "
        f"{r['legacy_s']*1e3:.1f} ms ({r['legacy_qps']:.0f} req/s) -> "
        f"{r['speedup']:.1f}x; per-request programs "
        f"{r['direct_s']*1e3:.1f} ms ({r['direct_qps']:.0f} req/s) -> "
        f"{r['speedup_vs_jitted']:.1f}x",
        f"parity    : max|engine - direct| = {r['parity_max_abs_diff']:.2e}",
        f"programs  : {r['programs']} cached / {r['compiles']} compiles "
        f"({r['scheduler_steps']} scheduler steps, "
        f"{r['padded_rows']} padded filler rows per stream)",
    ]
    return "\n".join(lines)
