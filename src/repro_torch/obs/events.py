"""The shared compile-event hook: one source of truth for program counts.

``repro_torch.compile.ProgramRegistry`` is the only place programs are
made (a CUDA graph captured on the card, the eager function on the CPU),
so it is the only emitter: cache hits call :func:`cache_event`, misses and
recaptures call :func:`compile_event` (which counts the miss, accumulates
the capture seconds and fans the event out to subscribers).  The ``[obs]``
exit line and ``serve.benchmark``'s program-cache figures read these
counters; nobody else increments them, so nothing double counts.

The ``kind`` label is the program's kind: ``"graph"`` (a captured CUDA
graph) or ``"eager"`` (the eager function, on the CPU), where the
reference's is ``"aot"`` or ``"jit"``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

from repro_torch.obs.metrics import METRICS

CompileListener = Callable[[Dict[str, Any]], None]

_LOCK = threading.Lock()
_LISTENERS: List[CompileListener] = []


def on_compile(listener: CompileListener) -> CompileListener:
    """Subscribe to compile events; returns ``listener`` (the unsubscribe
    token for :func:`remove_compile_listener`)."""
    with _LOCK:
        if listener not in _LISTENERS:
            _LISTENERS.append(listener)
    return listener


def remove_compile_listener(listener: CompileListener) -> None:
    with _LOCK:
        if listener in _LISTENERS:
            _LISTENERS.remove(listener)


def cache_event(kind: str, hit: bool) -> None:
    """One program-cache lookup in the registry.  Misses are counted by
    :func:`compile_event` (a miss IS a compile), so this only counts
    hits."""
    if hit:
        METRICS.counter("compile.cache.hits", kind=kind).inc()


def compile_event(kind: str, key: Any, seconds: float) -> None:
    """One compile (a cache miss, or a recapture) in the registry.
    ``seconds`` is its wall clock (0.0 for an eager program, which
    compiles nothing)."""
    METRICS.counter("compile.cache.misses", kind=kind).inc()
    METRICS.counter("compile.programs.seconds", kind=kind).inc(seconds)
    with _LOCK:
        listeners = list(_LISTENERS)
    if not listeners:
        return
    ev = {"kind": kind, "key": repr(key), "seconds": seconds}
    for fn in listeners:
        fn(ev)
