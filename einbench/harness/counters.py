"""The program's always-on counters, read after a run from the process
that ran it.

:func:`registry` is ``repro_torch.obs.METRICS`` when the port is loaded in
this process, else None.  This module imports nothing of the port: it
looks the module up in ``sys.modules``.  So a reader of a counter the
program lacks (a commit older than the counter) finds nothing and returns
None.  The registry holds the process's totals: for serving, the window
and its drain (set-up only captures the programs); for training, the
three set-up steps beside the window's.
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, List, Optional, Tuple


def registry():
    """The port's metrics registry, or None when the port is not loaded."""
    mod = sys.modules.get("repro_torch.obs")
    return getattr(mod, "METRICS", None) if mod is not None else None


def find(name: str, **match) -> List[Tuple[dict, object]]:
    """(labels, metric) of each metric ``name`` whose labels hold
    ``match``; empty without the port or the metric."""
    reg = registry()
    return [] if reg is None else reg.find(name, **match)


def value(name: str, **labels) -> Optional[float]:
    """The value of the metric ``name`` with exactly ``labels``, or None."""
    for got, metric in find(name, **labels):
        if got == labels:
            return float(metric.value)
    return None


def graph_launches(programs: Callable[[str], bool],
                   spans: Optional[Iterable[str]] = None) -> Optional[float]:
    """Graph nodes launched a replay over the captured programs that
    ``programs`` accepts: the sum of each program's nodes (of ``spans``
    only, when given) times its replays (``compile.graph.nodes``,
    ``compile.graph.replays``) over the sum of the replays.  None when
    those programs were never replayed or never counted."""
    replays = {labels["program"]: float(m.value)
               for labels, m in find("compile.graph.replays")
               if programs(labels["program"])}
    total = sum(replays.values())
    keep = None if spans is None else set(spans)
    nodes = {}
    for labels, m in find("compile.graph.nodes"):
        p = labels["program"]
        if p in replays and (keep is None or labels["span"] in keep):
            nodes[p] = nodes.get(p, 0.0) + float(m.value)
    if not total or not nodes:
        return None
    return sum(nodes.get(p, 0.0) * n for p, n in replays.items()) / total
