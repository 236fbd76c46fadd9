"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root, and
the files it names or that sit beside it by name.

  * a configuration's file is ``configs[].file``;
  * a traffic mix is ``einbench/traffic/<traffic>.json``, whose
    ``generator`` names the one general generator that reads it,
    ``einbench/generators/<generator>.py``;
  * a cell's correctness limits are ``einbench/cells/<cell>.json``;
  * a metric's reader is ``einbench/metrics/<metric>.py``;
  * the kernels of a layer are the union of ``einbench/kernels/*.json``;
  * the chips' peaks are ``einbench/counts/peaks.json``.

A later change adds a cell, a configuration, a mix, a metric or a kernel's
name by adding files and entries; none of this code needs an edit.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Any, Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a fresh module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` of ``root`` and the files of its benchmark."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = os.path.join(root, "einbench")
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return _json(os.path.join(self.bench, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> Dict[str, float]:
        path = os.path.join(self.bench, "cells", f"{cell}.json")
        return _json(path).get("limits", {}) if os.path.exists(path) else {}

    def generator(self, name: str):
        return load_module(os.path.join(self.bench, "generators", f"{name}.py"),
                           f"einbench_generator_{name}")

    def reader(self, metric: str):
        """``metrics/<metric>.py``; for a metric split by the cells it
        serves ("idle_share.train"), the file of its stem where it has no
        file of its own ("idle_share.py")."""
        path = os.path.join(self.bench, "metrics", f"{metric}.py")
        if not os.path.exists(path):
            path = os.path.join(self.bench, "metrics",
                                metric.split(".")[0] + ".py")
        return load_module(path, "einbench_metric_" + metric.replace(".", "_"))

    def kernel_layers(self) -> Dict[str, Dict[str, List[str]]]:
        """Layer -> {"base": exact kernel function names, "contains":
        substrings of kernel names}, the union of every file in
        ``einbench/kernels``."""
        out: Dict[str, Dict[str, List[str]]] = {}
        for path in sorted(glob.glob(os.path.join(self.bench, "kernels", "*.json"))):
            for layer, rule in _json(path).items():
                merged = out.setdefault(layer, {"base": [], "contains": []})
                for key in merged:
                    merged[key].extend(rule.get(key, []))
        return out

    def peaks(self) -> Dict[str, Dict[str, float]]:
        return _json(os.path.join(self.bench, "counts", "peaks.json"))

    def metrics_for(self, cell: Dict, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        metrics (True): those whose ``workloads`` list it, and those with
        no such list that the cell reports (a per-layer one: where the
        cell reports the end-to-end metric it moves)."""
        e2e = [m for m in self.data["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
