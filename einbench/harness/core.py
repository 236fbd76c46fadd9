"""One run of one cell: set-up and window by the traffic's generator, the
peak memory, the comparison with the reference once the program's state
is freed, the metrics by their readers, and the result line."""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List, Optional

from harness import program
from harness.spec import Spec

# top-level module names that must not be loaded by a run: JAX and the
# JAX package the port was made from (compared as whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's records."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        start = int(stat[stat.rindex(")") + 2:].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a generator needs of one run."""

    def __init__(self, spec: Spec, cell: str, seed: int, seconds: float,
                 trace: bool, device: str, clock0: float,
                 config: Optional[Dict] = None, traffic: Optional[Dict] = None):
        self.spec = spec
        self.cell = spec.cell(cell)
        self.config = config or spec.config(self.cell["config"])
        self.traffic = traffic or spec.traffic(self.cell["traffic"])
        self.limits = spec.limits(cell)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.clock0 = clock0  # the host clock at process start
        self.peak = None
        if device == "cuda":
            import torch

            self.kind = torch.cuda.get_device_name(0)
            peaks = spec.peaks()
            self.peak = peaks.get(self.kind)
        else:
            self.kind = "cpu"

    def since_start(self) -> float:
        return time.perf_counter() - self.clock0

    def note(self, what: str) -> None:
        """A set-up phase's end, with the seconds since process start, on
        standard error."""
        print(f"[einbench {self.since_start():8.2f} s] {what}", file=sys.stderr,
              flush=True)


def _device_memory(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def execute(spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", clock0: Optional[float] = None,
            config: Optional[Dict] = None, traffic: Optional[Dict] = None
            ) -> Dict:
    """Run ``cell`` once; returns the result line's object."""
    if clock0 is None:
        age = process_age_s()
        clock0 = time.perf_counter() - (age if age is not None else 0.0)
    ctx = Context(spec, cell, seed, seconds, trace, device, clock0,
                  config, traffic)
    gen = spec.generator(ctx.traffic["generator"])
    run = gen.run(ctx)
    run["peak_mem_bytes"] = _device_memory(device)
    run["peak"] = ctx.peak
    # the program's state goes before the reference runs
    run.pop("_state").clear()
    program.release()
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    numbers = gen.check(ctx, run)
    compared = {k: v for k, v in numbers.items() if k in ctx.limits}
    missing = sorted(set(ctx.limits) - set(numbers))
    if missing:
        raise RuntimeError(f"limits for numbers the generator does not give: {missing}")
    correct = bool(compared) and all(
        v == v and v <= ctx.limits[k] for k, v in compared.items())
    metrics = {}
    for m in spec.metrics_for(ctx.cell, trace):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": ctx.kind,
           "count": ctx.cell["chips"], "memory_peak_bytes": run["peak_mem_bytes"]}
    out = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": dev}
    tr = run.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr["gaps"].items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {
            "device_ops": [[_short(n), t] for n, t in ops],
            "idle_gaps": [[f"{label} ({g[0]} gaps, longest {g[2]:.6f} s)", g[1]]
                          for label, g in gaps]}
    out["readings"] = {k: v for k, v in numbers.items() if k not in ctx.limits}
    out["checks"] = {k: {"value": v, "limit": ctx.limits[k]}
                     for k, v in compared.items()}
    return out


def _short(name: str) -> str:
    """A kernel's name without "void", its anonymous namespace, PyTorch's
    namespace or its parameter list, at most 120 characters."""
    s = name
    for cut in ("void ", "(anonymous namespace)::", "at::native::"):
        s = s.replace(cut, "")
    depth = 0
    for i, ch in enumerate(s):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            s = s[:i]
            break
    return s[:120]
