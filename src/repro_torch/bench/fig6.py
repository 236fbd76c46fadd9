"""Fig. 6 (supplementary): inference time per sample, EiNet against the
naive implementation, sweeping K / D / R as ``fig3`` does.  The port of the
reference's ``benchmarks/bench_fig6.py``: ``log_likelihood`` of a 100-row
test batch (the paper's setup), timed on two paths, each the median of
``bench.REPS`` calls after a warm-up:

  * eager: ``net.log_likelihood`` under ``torch.inference_mode()``;
  * graph: the serving path's joint_ll program from a
    ``compile.ProgramRegistry`` (on the card a captured CUDA graph, on the
    CPU the eager query).

Profiles and the naive out-of-memory rule are ``fig3``'s (quick: the
reference's 128 variables and sweeps; full: 512 variables at einet_rat's
defaults and the paper's sweeps).

CSV: impl,param,value,inference_us_per_sample,graph_us_per_sample
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import bench
from repro_torch import compile as compile_lib
from repro_torch.bench import fig3
from repro_torch.core.einet import EiNet, resolve_device
from repro_torch.serve.engine import query_fn

NTEST = 100
HEADER = "impl,param,value,inference_us_per_sample,graph_us_per_sample"


def measure(net: EiNet, x: torch.Tensor) -> Dict[str, float]:
    """Median µs a sample of the eager call and of the graph program."""
    dev = x.device

    def eager():
        with torch.inference_mode():
            return net.log_likelihood(x)

    n = x.shape[0]
    out = {"eager_us": bench.median_s(eager, dev) / n * 1e6}
    bench.free(dev)
    batch = {"x": x}
    prog = compile_lib.ProgramRegistry().capture(
        net, ("joint_ll", n), query_fn("joint_ll"), batch)
    out["graph_us"] = bench.median_s(lambda: prog(batch), dev) / n * 1e6
    return out


def run(quick: bool = False, device=None,
        sweeps: Optional[Dict[str, Sequence[int]]] = None) -> List[tuple]:
    """Rows (impl, param, value, eager µs/sample, graph µs/sample), ``OOM``
    in both of a naive point that ran out of memory."""
    dev = resolve_device(device)
    return [(impl, param, v) + (
        (m["eager_us"], m["graph_us"]) if m else (fig3.OOM, fig3.OOM))
        for impl, param, v, m in fig3.sweep(measure, quick, dev, sweeps,
                                            n=NTEST)]


def format_row(r) -> str:
    return ",".join([str(r[0]), r[1], str(r[2])] + [
        v if isinstance(v, str) else f"{v:.2f}" for v in r[3:]])


def main(quick: bool = False, device=None) -> list:
    dev = resolve_device(device)
    t0 = time.time()
    rows = run(quick, dev)
    print(HEADER)
    for r in rows:
        print(format_row(r))
    bench.report("fig6", dev, first_oom_k=fig3.first_oom(rows),
                 seconds=time.time() - t0)
    return rows


if __name__ == "__main__":
    main()
