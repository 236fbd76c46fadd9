"""``repro_torch.obs``: dependency-free tracing and metrics for the port.

Four parts (see the submodule docstrings):

  * :mod:`repro_torch.obs.trace`   -- nestable ``span(...)`` context
    managers, ``timed`` regions, Chrome/Perfetto ``trace_event`` export on
    torch.profiler's clock;
  * :mod:`repro_torch.obs.metrics` -- counters / gauges / log-bucket
    histograms with ``percentile(q)``, snapshot-able to plain JSON;
  * :mod:`repro_torch.obs.events`  -- the compile-event hook fed by
    ``repro_torch.compile.ProgramRegistry`` (the one source of program
    counts);
  * :mod:`repro_torch.obs.capture` -- the capture observer: a captured
    graph's nodes put down to the spans that added them.

Spans (emitted when tracing is on; while a graph is captured they also
mark its layers, on or off): ``serve.step``, ``serve.warmup``,
``compile.graph``, ``train.step``, ``plan.segment{kind,start,stop}`` (a
plan segment: einsum layers and mixing), ``layer.einsum{pair}`` (one pair
of the per-pair walk), ``layer.leaf`` (``EiNet.leaf_rows``),
``query.noise`` (Philox row noise), ``query.topdown`` (the sampling and
MPE pass), ``em.mstep``, ``em.blend``, a mixture's
``mixture.component{c}`` (a bound component), ``mixture.top`` (its
class-prior logsumexp and top-level ``log_mix_exp``) and
``mixture.weights`` (the mixture weights' statistics, renormalisation,
blend and copy), and in a captured E-step ``plan.segment.bwd``,
``layer.einsum.bwd``, ``layer.leaf.bwd`` and ``mixture.top.bwd`` (the
backward after each layer's output gradient is complete).

Always-on metrics, ``subsystem.verb.unit{labels}``:

  * serving: ``serve.request.seconds{kind,bucket}``,
    ``serve.queue_wait.seconds{kind}`` (histograms),
    ``serve.queue.depth`` (gauge, set once a step before the pop),
    ``serve.step.seconds{phase}`` (counters: host seconds of the step's
    ``assemble``, ``launch``, ``wait`` and ``finish`` phases),
    ``serve.steps.count``, ``serve.replay.device_seconds`` and
    ``serve.replay.count`` (the replays' device time, CUDA events),
    ``serve.program_cache.{hits,misses}{kind}``;
  * programs: ``compile.cache.{hits,misses}{kind}``,
    ``compile.programs.seconds{kind}``, ``compile.graph.nodes{program,
    span}`` (a captured graph's nodes a span), ``compile.graph.replays
    {program}``, ``plan.segment.traces{kind}``;
  * training: ``train.step.seconds``, ``train.examples.count``,
    ``train.ll.last``; eval: ``eval.inpaint.seconds{mask}``.

The eval and serve CLIs accept ``--trace out.json`` and print one
``[obs]`` summary line at exit (:func:`format_summary`).

Stdlib only: every module of the port may import ``repro_torch.obs``.
The training step's health telemetry (:mod:`repro_torch.obs.health`) and
the divergence flight recorder (:mod:`repro_torch.obs.incident`) import
torch and are imported directly, not re-exported here.
"""

from repro_torch.obs.capture import (
    CaptureObserver,
    grad_boundary,
    layer_maps,
    record_capture,
)
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
    BASE_NS,
    Span,
    Timed,
    capture_observer,
    configure,
    dropped_events,
    enabled,
    event,
    export_trace,
    has_sync,
    now,
    num_events,
    reset,
    set_capture_observer,
    set_sync,
    span,
    sync,
    timed,
    trace_events,
)

__all__ = [
    "BASE_NS", "CaptureObserver", "METRICS", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "Span", "Timed", "cache_event",
    "capture_observer", "cli_begin", "cli_end", "compile_event",
    "configure", "dropped_events", "enabled", "event", "export_trace",
    "format_summary", "grad_boundary", "has_sync", "layer_maps", "now",
    "num_events", "on_compile", "percentile_from_counts", "record_capture",
    "remove_compile_listener", "reset", "set_capture_observer", "set_sync",
    "span", "summary", "sync", "timed", "trace_events",
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
        waits = [h for _, h in METRICS.find("serve.queue_wait.seconds")]
        n_wait = sum(h.count for h in waits)
        if n_wait:
            out["serve_queue_wait_ms"] = round(
                sum(h.total for h in waits) / n_wait * 1e3, 3)
        n_replay = METRICS.value("serve.replay.count")
        if n_replay:
            out["serve_replay_ms"] = round(
                METRICS.value("serve.replay.device_seconds") / n_replay
                * 1e3, 3)
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
        serve = (f"serve: {s['serve_requests']} req, p50 {lm['p50']:.2f} "
                 f"ms, p95 {lm['p95']:.2f} ms, p99 {lm['p99']:.2f} ms")
        if "serve_queue_wait_ms" in s:
            serve += f", queue wait {s['serve_queue_wait_ms']:.2f} ms"
        if "serve_replay_ms" in s:
            serve += f", replay {s['serve_replay_ms']:.3f} ms"
        parts.append(serve)
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
