"""Launches by layer, counted while a CUDA graph is captured.

A replay runs no Python, so no span can fire inside one.  What a span can
do is say, while the graph is captured, which of its nodes each layer put
there: ``repro_torch.compile`` installs a :class:`CaptureObserver` around
each capture of a program (:func:`repro_torch.obs.set_capture_observer`),
and while it is installed every ``obs.span`` is a real span that marks the
observer at its enter and exit.  A mark reads how many nodes the capture
holds (``count``: on the card the CUDA driver's read-only count of the
capturing graph, ``repro_torch.kernels.graph_census``, which adds no node)
and puts the nodes added since the last mark down to the innermost open
span, or to ``"root"`` outside every span.

The E-step's backward runs inside ``torch.autograd.grad``, outside the
forward's spans.  :func:`grad_boundary` registers a gradient hook on a
layer's output: when the gradient of that output is complete, the nodes
added since the last mark belong to what ran before, and the nodes after
it, up to the next mark, to ``<layer>.bwd`` (the layer's backward; for the
leaf rows, the leaf layer's).

Each finished capture is published by :func:`record_capture`:

  * ``compile.graph.nodes{program, span}`` -- counters holding the newest
    capture's node count a span name (kernels, copies and sets alike);
    the spans of a program sum to its graph's node count;
  * its layer map, :func:`layer_maps`: the ordered list of ``[span, args,
    first node, last node]``, in capture order, which is the order a
    one-stream graph replays in, so a replayed kernel's position gives its
    layer (``export_trace`` writes the maps into ``otherData``).

``compile.graph.replays{program}`` (counted by ``repro_torch.compile``,
one a replay) weighs the node counts into launches a step.

Stdlib only, like the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import METRICS

ROOT = "root"

_LOCK = threading.Lock()
_MAPS: Dict[str, Dict[str, Any]] = {}


class CaptureObserver:
    """Puts the nodes one capture adds down to the spans open while they
    were added.  ``count()`` is the number of nodes the capture holds so
    far; it is read at each mark, never otherwise."""

    def __init__(self, program: str, count: Callable[[], int]):
        self.program = program
        self._count = count
        self._base = self._last = count()
        self._stack: List[Tuple[str, Dict[str, Any]]] = [(ROOT, {})]
        self._bwd: Optional[Tuple[str, Dict[str, Any]]] = None
        self.layers: List[List[Any]] = []

    def _mark(self) -> None:
        n = self._count()
        if n <= self._last:
            return
        name, args = self._bwd or self._stack[-1]
        first, last = self._last - self._base, n - 1 - self._base
        prev = self.layers[-1] if self.layers else None
        if prev is not None and prev[0] == name and prev[1] == args:
            prev[3] = last
        else:
            self.layers.append([name, dict(args), first, last])
        self._last = n

    def enter(self, name: str, args: Dict[str, Any]) -> None:
        self._mark()
        self._bwd = None
        self._stack.append((name, args))

    def exit(self) -> None:
        self._mark()
        self._bwd = None
        self._stack.pop()

    def backward(self, name: str, args: Dict[str, Any]) -> None:
        """A gradient hook fired: what follows is ``name``'s."""
        self._mark()
        self._bwd = (name, args)

    def finish(self) -> Dict[str, Any]:
        """Mark a last time; the capture's layer map: ``nodes`` (the
        total), ``spans`` (nodes a span name) and ``layers``."""
        self._mark()
        spans: Dict[str, int] = {}
        for name, _, first, last in self.layers:
            spans[name] = spans.get(name, 0) + last - first + 1
        return {"program": self.program, "nodes": self._last - self._base,
                "spans": spans, "layers": self.layers}


def grad_boundary(tensor, name: str, **args: Any) -> None:
    """Mark the start of ``name``'s backward (``<layer>.bwd``) at the
    moment ``tensor``'s gradient is complete, while a capture observer is
    installed and ``tensor`` takes a gradient; nothing otherwise."""
    observer = trace_mod.capture_observer()
    if observer is None or not getattr(tensor, "requires_grad", False):
        return

    def hook(grad):
        observer.backward(name, args)

    tensor.register_hook(hook)


def record_capture(layer_map: Dict[str, Any]) -> None:
    """Publish a finished capture: its layer map replaces the program's
    last one, and ``compile.graph.nodes{program, span}`` take its counts
    (a span the new capture lacks reads 0)."""
    program = layer_map["program"]
    with _LOCK:
        old = _MAPS.get(program, {"spans": {}})["spans"]
        _MAPS[program] = layer_map
    spans = layer_map["spans"]
    for name in set(old) | set(spans):
        c = METRICS.counter("compile.graph.nodes", program=program, span=name)
        c.inc(spans.get(name, 0) - c.value)


def layer_maps() -> Dict[str, Dict[str, Any]]:
    """Every captured program's newest layer map, by program label."""
    with _LOCK:
        return dict(_MAPS)
