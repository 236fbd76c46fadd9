"""Benchmarks of the port, on the card.

The paper's comparison: the port of the reference's
``benchmarks/bench_{table1,fig3,fig6,fig4}.py`` and ``benchmarks/run.py``.

  python -m repro_torch.bench.run [--full] [--only table1|fig3|fig6|fig4]
                                  [--device cpu]

Each of those modules has ``run(quick, device)`` and ``main(quick,
device)``; ``main`` prints the reference's CSV block and then one JSON line
with the device it ran on (the card's ``nvidia-smi`` name and power limit
on CUDA).

The production suite: the port of ``benchmarks/bench_{serve,train,
mixture,eval}.py``, with the reference's report schemas.

  python -m repro_torch.bench.<serve|train|mixture|eval> [--smoke]
                                  [--device cpu] [--out BENCH.json]

Each writes ``BENCH_torch_<name>.json``, appends a row to
``artifacts/bench_history_torch/<name>.jsonl`` (``repro_torch.obs.slo``),
and exits non-zero when its gate fails; ``python -m repro_torch.obs.slo
--check`` holds the BENCH files to ``slo_torch.json``.

Everything runs on CUDA unless the caller asks for the CPU, where a time
is a CPU time and no device memory is measured.  The helpers below are
shared by the modules.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_lib

# timed calls after the warm-up, of which the median is reported
REPS = 5


def card_line(device: torch.device) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card (None off
    the card)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[device.index or 0]


def free(device: torch.device) -> None:
    """Drop what Python no longer holds and, on the card, give the cached
    blocks back, so that each point starts from the same memory."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def median_s(fn: Callable[[], Any], device: torch.device,
             reps: int = REPS, warmup: int = 1) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after ``warmup`` calls,
    each between device synchronisations (host clock)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def report(name: str, device: torch.device, **fields) -> Dict:
    """Print the JSON line a bench ends with (the bench, the device it ran
    on, the card's name and power limit, None off the card, and
    ``fields``) and return it."""
    rec = {"bench": name, "device": device.type, "card": card_line(device),
           **fields}
    print(json.dumps(rec), flush=True)
    return rec


def device_name(device: torch.device) -> str:
    """What a report names the device by: the card's name on CUDA,
    ``"cpu"`` on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def sync(device: torch.device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clone_tree(tree):
    """A copy of a tree of tensors (a model's ``params_of`` layout, or a
    mixture's)."""
    return tree_lib.unflatten_like(tree, tree_lib.flatten(tree)[1],
                                   lambda _, t: t.clone())


def write_report(kind: str, report: Dict, out: str) -> None:
    """Write a production bench's report to ``out`` and append its history
    row (``obs.slo.append_history``, under ``artifacts/bench_history_torch``);
    ``out=""`` writes neither."""
    from repro_torch.obs import slo as slo_lib

    if not out:
        return
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {out}")
    path = slo_lib.append_history(kind, report)
    print(f"history -> {path}")
