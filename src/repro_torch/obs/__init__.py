"""``repro_torch.obs``: dependency-free tracing and metrics for the port.

Three parts (see the submodule docstrings):

  * :mod:`repro_torch.obs.trace`   -- nestable ``span(...)`` context
    managers, ``timed`` regions, Chrome/Perfetto ``trace_event`` export;
  * :mod:`repro_torch.obs.metrics` -- counters / gauges / log-bucket
    histograms with ``percentile(q)``, snapshot-able to plain JSON;
  * :mod:`repro_torch.obs.events`  -- the compile-event hook fed by
    ``repro_torch.compile.ProgramRegistry`` (the one source of program
    counts).

Instrumented subsystems tag spans and metrics as ``subsystem.verb.unit``:
``serve.request.seconds{kind,bucket}``, ``serve.queue_wait.seconds{kind}``,
``serve.coalesce.seconds``, ``serve.execute.seconds``,
``compile.cache.misses{kind}``, ``train.step.seconds``,
``eval.inpaint.seconds{mask}``.  The eval and serve CLIs accept ``--trace
out.json`` and print one ``[obs]`` summary line at exit
(:func:`format_summary`).

Stdlib only: every module of the port may import ``repro_torch.obs``.
The training step's health telemetry (:mod:`repro_torch.obs.health`) and
the divergence flight recorder (:mod:`repro_torch.obs.incident`) import
torch and are imported directly, not re-exported here.
"""

from repro_torch.obs.events import (
    cache_event,
    compile_event,
    on_compile,
    remove_compile_listener,
)
from repro_torch.obs.metrics import (
    METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile_from_counts,
)
from repro_torch.obs.trace import (
    Span,
    Timed,
    configure,
    dropped_events,
    enabled,
    event,
    export_trace,
    has_sync,
    now,
    num_events,
    reset,
    set_sync,
    span,
    sync,
    timed,
    trace_events,
)

__all__ = [
    "METRICS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Timed", "cache_event", "cli_begin", "cli_end",
    "compile_event", "configure", "dropped_events", "enabled", "event",
    "export_trace", "format_summary", "has_sync", "now", "num_events",
    "on_compile", "percentile_from_counts", "remove_compile_listener",
    "reset", "set_sync", "span", "summary", "sync", "timed",
    "trace_events",
]


def summary() -> dict:
    """Compact cross-subsystem rollup of the metrics registry (the data
    behind the ``[obs]`` exit line)."""
    out: dict = {}
    compiles = sum(
        m.value for _, m in METRICS.find("compile.cache.misses")
    )
    if compiles:
        out["compiles"] = int(compiles)
        out["compile_seconds"] = round(sum(
            m.value for _, m in METRICS.find("compile.programs.seconds")
        ), 3)
        hits = sum(m.value for _, m in METRICS.find("compile.cache.hits"))
        out["cache_hits"] = int(hits)
    req = METRICS.sum_histogram("serve.request.seconds")
    n_req = sum(req)
    if n_req:
        out["serve_requests"] = n_req
        out["serve_latency_ms"] = {
            f"p{q}": round(percentile_from_counts(req, q) * 1e3, 3)
            for q in (50, 95, 99)
        }
    steps = METRICS.sum_histogram("train.step.seconds")
    n_steps = sum(steps)
    if n_steps:
        out["train_steps"] = n_steps
        out["train_step_ms_p50"] = round(
            percentile_from_counts(steps, 50) * 1e3, 1)
        ex = METRICS.value("train.examples.count")
        if ex:
            out["train_examples"] = int(ex)
    if num_events():
        out["trace_events"] = num_events()
    if dropped_events():
        out["trace_dropped"] = dropped_events()
    return out


def format_summary() -> str:
    """The ``[obs]`` exit line: human-readable one-liner of :func:`summary`
    (serve and train first, then the program counts)."""
    s = summary()
    parts = []
    if "serve_requests" in s:
        lm = s["serve_latency_ms"]
        parts.append(
            f"serve: {s['serve_requests']} req, p50 {lm['p50']:.2f} ms, "
            f"p95 {lm['p95']:.2f} ms, p99 {lm['p99']:.2f} ms"
        )
    if "train_steps" in s:
        ex = f", {s['train_examples']} examples" if "train_examples" in s \
            else ""
        parts.append(
            f"train: {s['train_steps']} steps, "
            f"p50 {s['train_step_ms_p50']:.0f} ms/step{ex}"
        )
    if "compiles" in s:
        parts.append(
            f"compile: {s['compiles']} programs "
            f"({s['compile_seconds']:.2f} s, {s['cache_hits']} cache hits)"
        )
    if "trace_events" in s:
        t = f"trace: {s['trace_events']} events"
        if "trace_dropped" in s:
            t += f" ({s['trace_dropped']} dropped, buffer cap hit)"
        parts.append(t)
    return " | ".join(parts) if parts else "no activity recorded"


def cli_begin(trace_path=None) -> None:
    """Launch-CLI prologue: ``--trace out.json`` enables collection."""
    if trace_path:
        configure(trace=True)


def cli_end(trace_path=None, metrics_path=None) -> None:
    """Launch-CLI epilogue: print the ``[obs]`` line; export the trace and
    (with ``--metrics out.json``) the metrics snapshot."""
    print(f"[obs] {format_summary()}")
    if trace_path:
        path = export_trace(trace_path)
        print(f"[obs] trace: {num_events()} events -> {path}")
    if metrics_path:
        import json
        import os

        d = os.path.dirname(metrics_path)
        if d:
            os.makedirs(d, exist_ok=True)
        snap = METRICS.snapshot()
        with open(metrics_path, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"[obs] metrics: {len(snap)} series -> {metrics_path}")
