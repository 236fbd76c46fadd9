"""Tracing spans: nestable context managers -> Chrome/Perfetto trace JSON.

The tracing half of ``repro_torch.obs``: ``span("serve.step", kind=...)``
wraps a region of host code and, when tracing is enabled, appends one
Chrome ``trace_event`` *complete* event (``ph: "X"`` with ``ts``/``dur`` in
microseconds) to a thread-safe in-process buffer that
``export_trace(path)`` writes as a JSON file loadable by
``chrome://tracing`` / ui.perfetto.dev.  Nesting needs no bookkeeping --
the viewer reconstructs the stack from ``ts``/``dur`` containment per
thread.

Tracing is off until ``configure(trace=True)`` (the launch CLIs' ``--trace
out.json`` flag); there is no environment switch.  The disabled path costs
almost nothing: ``span()`` returns a shared no-op singleton.

Two flavours of timed region:

  * :func:`span` -- trace-only; a no-op when tracing is off.
  * :func:`timed` -- ALWAYS measures (exposes ``.seconds`` after exit) and
    optionally records into a metrics histogram; emits the trace event only
    when tracing is on.

Both read the host clock.  CUDA work is asynchronous, so a region that
times device work must end in a synchronisation (``.cpu()``, ``.item()``,
``torch.cuda.synchronize``) inside it.

Event ``ts`` are microseconds after :data:`BASE_NS`, an instant on the
clock torch.profiler stamps its events with (``start_ns()``: Unix-epoch
nanoseconds), sampled at import beside the monotonic clock the spans read.
So ``BASE_NS + 1000 * ts`` is an event's start on the profiler's clock,
and an exported trace carries ``BASE_NS`` as its ``baseTimeNanoseconds``,
the key torch.profiler's own Chrome traces carry: shifting one file's
``ts`` by the difference of the two bases (in microseconds) puts both
files' events on one Perfetto timeline.  Durations stay on the monotonic
clock (:func:`now`).

While a CUDA graph is captured, ``repro_torch.compile`` installs a capture
observer (:func:`set_capture_observer`, :mod:`repro_torch.obs.capture`):
then :func:`span` returns a real span even with tracing off, and its enter
and exit tell the observer where each layer's graph nodes begin and end.
The spans never emit a ``torch.profiler`` range: those show on the
profiler's device timeline, where they would read as device work.

Stdlib only: every layer of the port may import ``repro_torch.obs``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# trace-time clock origin: event ts are microseconds after _T0_NS on the
# monotonic clock, which is BASE_NS on torch.profiler's (Unix-epoch) clock
_T0_NS = time.perf_counter_ns()
BASE_NS = time.time_ns()

# buffer hard cap -- a runaway instrumented loop must not eat the host;
# events past the cap are counted, not stored
_MAX_EVENTS = 1_000_000


class _TraceState:
    __slots__ = ("enabled", "sync_fn", "observer", "lock", "events",
                 "dropped")

    def __init__(self):
        self.enabled = False
        self.sync_fn: Optional[Callable[[Any], Any]] = None
        self.observer = None
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0


_STATE = _TraceState()


def configure(trace: bool) -> None:
    """Process-wide switch: ``configure(trace=True)`` starts collecting,
    ``configure(trace=False)`` stops (buffered events are kept -- call
    :func:`reset` to drop them)."""
    _STATE.enabled = bool(trace)


def enabled() -> bool:
    return _STATE.enabled


def now() -> float:
    """The obs clock (monotonic host seconds)."""
    return time.perf_counter()


def set_sync(fn: Optional[Callable[[Any], Any]]) -> None:
    """Install a synchronization callback for :func:`sync` (e.g. one that
    calls ``torch.cuda.synchronize()`` while timing an eager plan walk).
    ``None`` (the default) makes :func:`sync` a no-op, so instrumented
    library code pays nothing in production."""
    _STATE.sync_fn = fn


def has_sync() -> bool:
    """Whether a :func:`set_sync` callback is installed."""
    return _STATE.sync_fn is not None


def set_capture_observer(observer) -> None:
    """Install the observer of a CUDA-graph capture
    (:class:`repro_torch.obs.capture.CaptureObserver`), or clear it with
    ``None``; ``repro_torch.compile`` installs one around each capture of a
    program, as :func:`set_sync` installs a sync callback."""
    _STATE.observer = observer


def capture_observer():
    """The installed capture observer, or None."""
    return _STATE.observer


def sync(value: Any) -> Any:
    """Synchronize ``value`` through the installed callback (no-op by
    default).  Instrumented compute sites call this just before their span
    closes so that an eager profile charges device time to the right
    span."""
    fn = _STATE.sync_fn
    if fn is not None:
        fn(value)
    return value


def _append(event: Dict[str, Any]) -> None:
    with _STATE.lock:
        if len(_STATE.events) >= _MAX_EVENTS:
            _STATE.dropped += 1
            return
        _STATE.events.append(event)


def _complete(name: str, t0_ns: int, t1_ns: int,
              args: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "ph": "X",
        "name": name,
        "ts": (t0_ns - _T0_NS) / 1e3,  # microseconds
        "dur": (t1_ns - t0_ns) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": args,
    }


class Span:
    """One traced region; use via ``with span("name", key=val): ...``.
    It appends a trace event when tracing is on and marks the installed
    capture observer's layer boundaries when one is installed."""

    __slots__ = ("name", "args", "_t0", "_observer", "_trace")

    def __init__(self, name: str, args: Dict[str, Any], observer=None,
                 trace: bool = True):
        self.name = name
        self.args = args
        self._t0 = 0
        self._observer = observer
        self._trace = trace

    def __enter__(self) -> "Span":
        if self._observer is not None:
            self._observer.enter(self.name, self.args)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._trace:
            _append(_complete(self.name, self._t0, time.perf_counter_ns(),
                              self.args))
        if self._observer is not None:
            self._observer.exit()
        return False


class _NullSpan:
    """The disabled path: a shared singleton whose enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args: Any):
    """Nestable traced region.  Tracing off and no capture observer
    installed -> returns a no-op singleton."""
    observer = _STATE.observer
    if observer is None:
        if not _STATE.enabled:
            return _NULL_SPAN
        return Span(name, args)
    return Span(name, args, observer, _STATE.enabled)


class Timed:
    """Always-measuring timed region: ``.seconds`` is valid after exit.

    With ``metric=`` the duration is recorded into that metrics histogram
    (labels = the span args), so one ``with obs.timed(...)`` both feeds the
    trace (when enabled) and the always-on metrics registry.
    """

    __slots__ = ("name", "args", "metric", "seconds", "_t0")

    def __init__(self, name: str, metric: Optional[str] = None,
                 **args: Any):
        self.name = name
        self.args = args
        self.metric = metric
        self.seconds = 0.0
        self._t0 = 0

    def __enter__(self) -> "Timed":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) / 1e9
        if self.metric is not None:
            from repro_torch.obs.metrics import METRICS

            METRICS.histogram(self.metric, **self.args).record(self.seconds)
        if _STATE.enabled:
            _append(_complete(self.name, self._t0, t1, self.args))
        return False


def timed(name: str, metric: Optional[str] = None, **args: Any) -> Timed:
    return Timed(name, metric=metric, **args)


def event(name: str, **args: Any) -> None:
    """Instant event (``ph: "i"``) -- a point marker in the trace."""
    if not _STATE.enabled:
        return
    _append({
        "ph": "i",
        "s": "t",
        "name": name,
        "ts": (time.perf_counter_ns() - _T0_NS) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": args,
    })


def trace_events() -> List[Dict[str, Any]]:
    """A copy of the buffered events."""
    with _STATE.lock:
        return list(_STATE.events)


def num_events() -> int:
    with _STATE.lock:
        return len(_STATE.events)


def dropped_events() -> int:
    """Events discarded past the buffer cap (surfaced by the ``[obs]`` exit
    summary so a truncated trace is never silent)."""
    with _STATE.lock:
        return _STATE.dropped


def reset() -> None:
    """Drop every buffered event (tests, repeated benchmark passes)."""
    with _STATE.lock:
        _STATE.events = []
        _STATE.dropped = 0


def export_trace(path: str) -> str:
    """Write the buffer as Chrome ``trace_event`` JSON; returns ``path``.
    ``ts`` are microseconds after the document's ``baseTimeNanoseconds``
    (:data:`BASE_NS`) on torch.profiler's clock; ``otherData.layer_maps``
    holds each captured program's layer map
    (:func:`repro_torch.obs.capture.layer_maps`)."""
    from repro_torch.obs.capture import layer_maps

    with _STATE.lock:
        events = list(_STATE.events)
        dropped = _STATE.dropped
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": BASE_NS,
        "otherData": {"producer": "repro_torch.obs",
                      "dropped_events": dropped,
                      "layer_maps": layer_maps()},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
