"""Fig. 3: training time and peak memory, EiNet against the naive
implementation, sweeping the structural hyper-parameters K (densities per
sum/leaf), D (split depth) and R (replicas), one at a time with the others
at their defaults.  The port of the reference's ``benchmarks/bench_fig3.py``.

One point is one full-batch EM update (``em_update``, an "epoch") of a RAT
with Normal leaves on N rows of D_vars standard-normal variables (seed 1),
timed on two paths, each the median of ``bench.REPS`` steps after a
warm-up:

  * eager: ``core.em.em_update`` then ``load_params``, op by op;
  * graph: ``make_em_step(net, TrainConfig(mode="full"))``, on the card
    a captured CUDA graph (``repro_torch.compile``), on the CPU the same
    stages op by op.

Peak memory is ``torch.cuda.max_memory_allocated()`` over one eager step,
with ``reset_peak_memory_stats()`` just before: ``peak_temp_mb`` is that
peak less the bytes allocated before the step (the reference's column, for
which it had only the compiled program's memory analysis), ``peak_mb`` the
raw peak.  Off the card no device memory is measured (empty columns).

Where the naive net runs out of device memory, that point's row reads
``oom`` in every measured column and the sweep goes on; an EiNet that runs
out of memory fails the run.

Profiles: quick is the reference's CPU cut (512 x 128, defaults D=3, R=4,
K=8, its quick sweeps); full is the paper's data size, 2,000 x 512, at
einet_rat's D=4, R=10, K=10 (``configs/einet_rat.py``), sweeping
K in {2, 4, 8, 10, 16, 24, 32, 40}, D in {1..6}, R in {1, 5, 10, 20, 40}.

CSV: impl,param,value,train_s_per_epoch,peak_temp_mb,graph_s_per_epoch,peak_mb
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import bench
from repro_torch import compile as compile_lib
from repro_torch.core import Normal, random_binary_trees
from repro_torch.core.baseline import NaiveEiNet
from repro_torch.core.einet import EiNet, resolve_device
from repro_torch.core.em import em_update, load_params
from repro_torch.train import TrainConfig, make_em_step

PROFILES = {
    "quick": dict(n=512, dvars=128, defaults=dict(depth=3, reps=4, k=8),
                  sweeps={"K": [4, 8, 16], "D": [2, 4], "R": [2, 8]}),
    "full": dict(n=2000, dvars=512, defaults=dict(depth=4, reps=10, k=10),
                 sweeps={"K": [2, 4, 8, 10, 16, 24, 32, 40],
                         "D": [1, 2, 3, 4, 5, 6], "R": [1, 5, 10, 20, 40]}),
}
HEADER = ("impl,param,value,train_s_per_epoch,peak_temp_mb,"
          "graph_s_per_epoch,peak_mb")
OOM = "oom"
_PARAM = {"K": "k", "D": "depth", "R": "reps"}


def build(impl: str, dvars: int, depth: int, reps: int, k: int,
          device: torch.device) -> EiNet:
    """The RAT of one point (structure seed 0, parameters seed 0)."""
    g = random_binary_trees(dvars, depth, reps, seed=0)
    cls = NaiveEiNet if impl == "naive" else EiNet
    return cls(g, num_sums=k, exponential_family=Normal(), device=device,
               seed=0)


def data(n: int, dvars: int, device: torch.device) -> torch.Tensor:
    x = np.random.RandomState(1).randn(n, dvars).astype(np.float32)
    return torch.from_numpy(x).to(device)


def measure(net: EiNet, x: torch.Tensor) -> Dict[str, Optional[float]]:
    """One point's figures: the eager step's peak memory (on the card) and
    the median seconds of the eager and the graph step."""
    dev = x.device

    def eager():
        new, ll = em_update(net, x)
        load_params(net, new)
        return float(ll)

    out: Dict[str, Optional[float]] = {"peak_temp_mb": None, "peak_mb": None}
    bench.free(dev)
    if dev.type == "cuda":
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eager()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        out["peak_temp_mb"] = (peak - before) / 1e6
        out["peak_mb"] = peak / 1e6
    out["train_s"] = bench.median_s(eager, dev)
    bench.free(dev)
    step = make_em_step(net, TrainConfig(mode="full"),
                        registry=compile_lib.ProgramRegistry())
    out["graph_s"] = bench.median_s(lambda: step(x), dev)
    return out


def point(measure_fn, impl: str, n: int, dvars: int, depth: int,
          reps: int, k: int, device: torch.device) -> Dict:
    """``measure_fn(net, x)`` on a fresh net and an n-row batch; {} for a
    naive point that ran out of device memory (an EiNet one raises)."""
    try:
        return measure_fn(build(impl, dvars, depth, reps, k, device),
                          data(n, dvars, device))
    except torch.cuda.OutOfMemoryError:
        if impl != "naive":
            raise
        return {}
    finally:
        bench.free(device)


def sweep(measure_fn, quick: bool, device: torch.device,
          sweeps: Optional[Dict[str, Sequence[int]]] = None,
          n: Optional[int] = None) -> List[tuple]:
    """(impl, param, value, figures) for every point of the profile's
    sweeps (or ``sweeps``: param -> values), one parameter at a time with
    the others at the profile's defaults, on ``n`` rows (default the
    profile's)."""
    prof = PROFILES["quick" if quick else "full"]
    sweeps = prof["sweeps"] if sweeps is None else sweeps
    out = []
    for impl in ("einet", "naive"):
        for param, values in sweeps.items():
            for v in values:
                kw = dict(prof["defaults"], **{_PARAM[param]: v})
                out.append((impl, param, v, point(
                    measure_fn, impl, prof["n"] if n is None else n,
                    prof["dvars"], device=device, **kw)))
    return out


def run(quick: bool = False, device=None,
        sweeps: Optional[Dict[str, Sequence[int]]] = None) -> List[tuple]:
    """Rows (impl, param, value, train_s, peak_temp_mb, graph_s, peak_mb),
    ``OOM`` in each figure of a naive point that ran out of memory."""
    dev = resolve_device(device)
    return [(impl, param, v) + (
        (m["train_s"], m["peak_temp_mb"], m["graph_s"], m["peak_mb"]) if m
        else (OOM,) * 4)
        for impl, param, v, m in sweep(measure, quick, dev, sweeps)]


def first_oom(rows, param: str = "K") -> Optional[int]:
    """The smallest value of ``param`` at which the naive net ran out of
    memory (None if it never did)."""
    vals = [r[2] for r in rows if r[0] == "naive" and r[1] == param
            and r[3] == OOM]
    return min(vals) if vals else None


def _fmt(v, spec: str) -> str:
    if v is None:
        return ""
    return v if isinstance(v, str) else format(v, spec)


def format_row(r) -> str:
    return ",".join([str(r[0]), r[1], str(r[2]), _fmt(r[3], ".6f"),
                     _fmt(r[4], ".2f"), _fmt(r[5], ".6f"), _fmt(r[6], ".2f")])


def ratios(rows, param: str = "K") -> Optional[Dict[str, float]]:
    """naive / einet time (eager, graph) and memory at the largest value
    of ``param`` where both ran."""
    def fig(impl, v):
        return next(r for r in rows
                    if r[0] == impl and r[1] == param and r[2] == v)
    ok = [r[2] for r in rows if r[0] == "naive" and r[1] == param
          and r[3] != OOM]
    if not ok:
        return None
    v = max(ok)
    e, nv = fig("einet", v), fig("naive", v)
    out = {param: v, "time": nv[3] / e[3], "graph_time": nv[5] / e[5]}
    if e[4] is not None:
        out["memory"] = nv[4] / max(e[4], 1e-9)
    return out


def main(quick: bool = False, device=None) -> list:
    dev = resolve_device(device)
    t0 = time.time()
    rows = run(quick, dev)
    print(HEADER)
    for r in rows:
        print(format_row(r))
    rat = ratios(rows)
    if rat is not None:
        print(f"# K={rat['K']}: naive/einet time {rat['time']:.1f}x "
              f"(graph {rat['graph_time']:.1f}x)" + (
                  f", memory {rat['memory']:.1f}x" if "memory" in rat
                  else ""))
    bench.report("fig3", dev, first_oom_k=first_oom(rows), ratios=rat,
                 seconds=time.time() - t0)
    return rows


if __name__ == "__main__":
    main()
