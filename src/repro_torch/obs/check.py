"""Chrome-trace schema checker: the port's copy of ``repro.obs.check``.

Validates that an exported trace is structurally a Chrome ``trace_event``
JSON document -- loads through ``json.loads``, ``traceEvents`` is a list,
every event carries ``ph``/``ts``/``name``/``args`` (and ``dur`` for
complete events) with sane types -- and optionally that spans from required
subsystems are present (``--require serve.`` asserts at least one event
whose name starts with that prefix).

  PYTHONPATH=src python -m repro_torch.obs.check trace.json \
      --require serve. --require plan. --require compile. \
      --metrics metrics.json

Exit status 0 = valid, 1 = problems (each printed).  Stdlib only, like the
rest of ``repro_torch.obs``; it checks the port's exports (``export_trace``,
``METRICS.snapshot()``) by the reference's rules.
"""

from __future__ import annotations

import json
import math
import re
import sys
from typing import Any, Dict, List, Sequence

_REQUIRED_FIELDS = ("ph", "ts", "name", "args")

# metric names follow ``subsystem.verb.unit`` (>= 3 dotted segments) with
# optional ``{label=value,...}`` -- e.g. ``serve.request.seconds{kind=mpe,
# bucket=4}``; see repro_torch/obs/metrics.py
_METRIC_NAME_RE = re.compile(
    r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+){2,}(\{[^{}]+\})?$"
)


def validate_events(doc: Any,
                    require_prefixes: Sequence[str] = ()) -> List[str]:
    """Problems found in a parsed trace document (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a 'traceEvents' key"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    if not events:
        problems.append("trace contains no events")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        missing = [f for f in _REQUIRED_FIELDS if f not in ev]
        if missing:
            problems.append(f"event {i} ({ev.get('name')!r}) missing "
                            f"field(s) {missing}")
            continue
        if not isinstance(ev["name"], str) or not ev["name"]:
            problems.append(f"event {i}: 'name' must be a non-empty string")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(f"event {i} ({ev['name']!r}): bad ts {ev['ts']!r}")
        if not isinstance(ev["args"], dict):
            problems.append(f"event {i} ({ev['name']!r}): 'args' must be "
                            f"an object")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev['name']!r}): complete event needs a "
                    f"non-negative 'dur', got {dur!r}")
    names = [ev.get("name", "") for ev in events if isinstance(ev, dict)]
    for prefix in require_prefixes:
        if not any(isinstance(n, str) and n.startswith(prefix)
                   for n in names):
            problems.append(
                f"no span from required subsystem {prefix!r} "
                f"(have: {sorted(set(names))[:12]})")
    return problems


def validate_trace(path: str,
                   require_prefixes: Sequence[str] = ()) -> List[str]:
    """Load + validate one exported trace file."""
    try:
        with open(path) as f:
            doc: Dict[str, Any] = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    return validate_events(doc, require_prefixes)


def _finite_number(v: Any) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


def validate_metrics(snap: Any) -> List[str]:
    """Problems in a ``METRICS.snapshot()`` document (empty list = valid).

    Schema: a flat non-empty JSON object whose keys follow
    ``subsystem.verb.unit{labels}`` and whose values are finite numbers
    (counters, legacy scalar gauges) or flat objects of finite numbers
    (histogram summaries, gauge value/max pairs).
    """
    if not isinstance(snap, dict) or not snap:
        return ["metrics snapshot is not a non-empty object"]
    problems: List[str] = []
    for name, value in snap.items():
        if not isinstance(name, str) or not _METRIC_NAME_RE.match(name):
            problems.append(
                f"metric {name!r}: name does not follow "
                "subsystem.verb.unit{labels}")
        if _finite_number(value):
            continue
        if isinstance(value, dict) and value:
            for k, v in value.items():
                if not _finite_number(v):
                    problems.append(
                        f"metric {name!r}: field {k!r} is not a finite "
                        f"number ({v!r})")
            continue
        problems.append(
            f"metric {name!r}: value must be a finite number or a flat "
            f"object of finite numbers, got {value!r}")
    return problems


def validate_metrics_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    return validate_metrics(snap)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None,
                    help="exported Chrome-trace JSON file")
    ap.add_argument("--require", action="append", default=[],
                    metavar="PREFIX",
                    help="assert at least one event name starts with this "
                         "prefix (repeatable)")
    ap.add_argument("--metrics", default=None, metavar="SNAPSHOT.json",
                    help="also validate a METRICS.snapshot() JSON file "
                         "(name format subsystem.verb.unit{labels}, finite "
                         "values)")
    args = ap.parse_args(argv)
    if args.path is None and args.metrics is None:
        ap.error("nothing to check: pass a trace path and/or --metrics")
    problems: List[str] = []
    if args.path is not None:
        trace_problems = validate_trace(args.path, args.require)
        for p in trace_problems:
            print(f"trace check: {p}")
        if not trace_problems:
            with open(args.path) as f:
                n = len(json.load(f)["traceEvents"])
            print(f"trace check: {args.path} valid ({n} events)")
        problems += trace_problems
    if args.metrics is not None:
        metric_problems = validate_metrics_file(args.metrics)
        for p in metric_problems:
            print(f"metrics check: {p}")
        if not metric_problems:
            with open(args.metrics) as f:
                n = len(json.load(f))
            print(f"metrics check: {args.metrics} valid ({n} series)")
        problems += metric_problems
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
