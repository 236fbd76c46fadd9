"""Training CLI: EM steps on a registered RAT architecture, on the
reference's synthetic data (white noise,
``np.random.RandomState(0).randn(4096, num_vars)``), cycled in batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_rat --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_rat \\
      --steps 3 --batch 64 --device cpu

Runs on CUDA unless ``--device cpu``; on the card every step's E-step goes
through the hand-written forward and backward kernels.  Prints the
execution plan, the float32 settings, the median ms/step, the first and
last mean LL and the kernel launches per step.  Checkpoints, fault
tolerance and health telemetry are not part of this driver.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.einet import resolve_device
from repro_torch.core.em import EMConfig
from repro_torch.kernels import ops
from repro_torch.launch.cells import build_einet
from repro_torch.train import TrainConfig, make_em_step

NUM_ROWS = 4096  # the reference's synthetic RAT training set


def synthetic_rat_data(num_vars: int) -> np.ndarray:
    """The reference's synthetic RAT training data (``repro.launch.train``
    ``einet_train_data``): (4096, num_vars) standard normal, seed 0."""
    return np.random.RandomState(0).randn(NUM_ROWS, num_vars).astype(np.float32)


def batch_at(data: torch.Tensor, step: int, batch: int) -> torch.Tensor:
    """Batch ``step`` of ``batch`` rows, cycling through ``data``."""
    idx = (step * batch + torch.arange(batch, device=data.device)) % data.shape[0]
    return data[idx]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_einet(arch: str, steps: int, batch=None, microbatches: int = 1,
                mode: str = "stochastic", grouped: bool = True, device=None,
                seed: int = 0) -> dict:
    """Build ``arch`` from ``seed`` and run ``steps`` EM steps on the
    synthetic data; returns the report."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    if cfg.structure != "rat":
        raise SystemExit(f"--arch {arch}: this driver trains RAT archs only")
    batch = batch or cfg.batch_size
    model = build_einet(cfg, device=device, seed=seed, grouped=grouped)
    data = torch.from_numpy(synthetic_rat_data(model.num_vars)).to(device)
    step = make_em_step(model, TrainConfig(
        em=EMConfig(), mode=mode, num_microbatches=microbatches))
    lls, times, launches = [], [], []
    for i in range(steps):
        x = batch_at(data, i, batch)
        ops.reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        lls.append(step(x))
        _sync(device)
        times.append(time.perf_counter() - t0)
        launches.append({op.name: (op.launches, op.plain_calls)
                         for op in ops.KERNEL_OPS})
    return {
        "arch": cfg.name, "device": str(device), "batch": batch,
        "microbatches": microbatches, "mode": mode,
        "plan": model.grouping_summary()["segments"],
        "lls": lls, "step_ms": [t * 1e3 for t in times],
        "median_ms": statistics.median(times) * 1e3,
        "launches_per_step": launches[-1],
        "tf32": (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per step (default: the config's batch_size)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--em-mode", choices=("stochastic", "full"),
                    default="stochastic")
    ap.add_argument("--grouped", action=argparse.BooleanOptionalAction,
                    default=True, help="fused plan (default) or per layer")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    r = train_einet(args.arch, args.steps, args.batch, args.microbatches,
                    args.em_mode, args.grouped, args.device)
    where = r["device"]
    if where.startswith("cuda"):
        where += f" ({torch.cuda.get_device_name(torch.device(where))})"
    print(f"{r['arch']} on {where}: plan {r['plan']}, {r['mode']} EM, "
          f"batch {r['batch']} in {r['microbatches']} microbatch(es)")
    print(f"float32: matmul allow_tf32={r['tf32'][0]}, "
          f"cudnn allow_tf32={r['tf32'][1]}")
    print(f"{len(r['lls'])} steps: median {r['median_ms']:.3f} ms/step; "
          f"mean LL first {r['lls'][0]:.4f}, last {r['lls'][-1]:.4f}")
    print("kernel launches per step (plain-version calls): " + ", ".join(
        f"{k} {n} ({p})" for k, (n, p) in r["launches_per_step"].items()))


if __name__ == "__main__":
    main()
