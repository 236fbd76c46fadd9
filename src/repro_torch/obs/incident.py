"""Divergence flight recorder: self-contained incident bundles.

The port's counterpart of the reference's ``repro/obs/incident.py``.  When
:class:`repro_torch.obs.health.HealthWatcher` trips (non-finite LL,
exploding statistic norms, saturation spike), :func:`dump_incident` writes
everything needed to debug the divergence after the fact into
``<root>/<timestamp>/`` (``root`` defaults to
``artifacts/incidents_torch/``):

  * ``incident.json``        -- reason, step, the health-slot layout and
    the last health row;
  * ``metrics.json``         -- a full ``METRICS.snapshot()`` at the moment
    of the incident;
  * ``trace.json``           -- a Chrome-trace export of the buffered spans
    plus one synthesized ``train.incident`` marker (so the document is a
    valid trace even when tracing was off);
  * ``health_history.json``  -- the watcher's recent per-step health rows;
  * ``params.npz`` + ``params_tree.txt`` -- the offending step's parameters
    (the flattened tree's leaves ``leaf_<i>``, loadable with
    ``numpy.load``, and the tree's structure).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch import tree as tree_lib
from repro_torch.obs import trace as trace_mod


def _synth_marker(reason: str, step: int) -> Dict[str, Any]:
    """One instant event on the shared trace clock marking the incident."""
    return {
        "ph": "i",
        "s": "t",
        "name": "train.incident",
        "ts": (time.perf_counter_ns() - trace_mod._T0_NS) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": {"reason": reason, "step": step},
    }


def _bundle_dir(root: str) -> str:
    ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(root, ts)
    n = 0
    while os.path.exists(path):  # same-second incidents get a suffix
        n += 1
        path = os.path.join(root, f"{ts}.{n}")
    os.makedirs(path)
    return path


def dump_incident(
    root: str,
    reason: str,
    step: int,
    history: List[Dict[str, float]],
    params: Any = None,
    spec: Any = None,
) -> str:
    """Write one incident bundle; returns its directory path."""
    from repro_torch.obs.metrics import METRICS

    path = _bundle_dir(root)
    with open(os.path.join(path, "incident.json"), "w") as f:
        json.dump({
            "reason": reason,
            "step": step,
            "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "health_slots": list(spec.names) if spec is not None else [],
            "last_health": history[-1] if history else {},
        }, f, indent=1)
    with open(os.path.join(path, "metrics.json"), "w") as f:
        json.dump(METRICS.snapshot(), f, indent=1)
    events = trace_mod.trace_events()
    events.append(_synth_marker(reason, step))
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs.incident",
                "dropped_events": trace_mod.dropped_events(),
            },
        }, f)
    with open(os.path.join(path, "health_history.json"), "w") as f:
        json.dump(history, f, indent=1)
    if params is not None:
        _dump_params(path, params)
    return path


def _dump_params(path: str, params: Any) -> None:
    import numpy as np
    import torch

    _, leaves = tree_lib.flatten(params)
    np.savez(os.path.join(path, "params.npz"), **{
        f"leaf_{i}": (leaf.detach().cpu().numpy()
                      if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        for i, leaf in enumerate(leaves)})
    with open(os.path.join(path, "params_tree.txt"), "w") as f:
        f.write(tree_lib.structure(params) + "\n")
