"""Mixture-of-EiNets training benchmark -> BENCH_torch_mixture.json.

The port of the reference's ``benchmarks/bench_mixture.py``.  Training C
architecturally identical components is better executed as ONE step
program over a stacked ``(C, B, D)`` batch than as a Python loop of C
single-model step programs.  Here the one program is
``repro_torch.mixture.make_mixture_em_step`` (hard EM; on the card one
captured CUDA graph of the whole step, the C component updates inside it)
and the loop is C ``repro_torch.train.make_em_step`` programs, one per
component on an EiNet of its own holding that component's parameters (on
the card C graphs, each replayed and read back in turn; each captured
shape has a graph pool of its own).  Both compute the identical update
(per-cluster hard EM, ``repro_torch.mixture``), so per-component
parameter parity after a step is the benchmark's gate and the wall-clock
ratio is the result:

  PYTHONPATH=src python -m repro_torch.bench.mixture --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.bench.mixture      # C in {4, 16, 32}

The report keeps the reference's schema ("vmapped" names the one-program
side); "backend" is the device type and "device" the card's name.  Both
steps write their models' parameters in place, so every timing rep starts
from a saved copy (``load_params``).  Exit status is the parity gate.
"""

from __future__ import annotations

import argparse
import copy
import datetime
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.bench import clone_tree, device_name, sync, write_report
from repro_torch.configs import EinetConfig
from repro_torch.core.einet import resolve_device
from repro_torch.core.em import load_params, params_of
from repro_torch.launch.cells import build_einet
from repro_torch.mixture import (
    EiNetMixture,
    MixtureTrainConfig,
    make_mixture_em_step,
)
from repro_torch.mixture.model import component_slice
from repro_torch.mixture.train import load_mixture_params, mixture_params_of
from repro_torch.train import TrainConfig, make_em_step

# one small component in the launch-bound regime the mixture step targets:
# many components, each small enough that the loop's per-component
# program call is a real fraction of its step (the reference's cell)
COMPONENT_CONFIG = EinetConfig(
    name="einet-rat-mixture-bench",
    structure="rat",
    num_vars=32,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=32,
)

SMOKE_CONFIG = EinetConfig(
    name="einet-rat-mixture-smoke",
    structure="rat",
    num_vars=16,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=32,
)

# (cell id, num components, per-component batch, timed steps); C spans the
# paper's clusters-of-images regime (§4.2 uses on the order of tens of
# clusters)
DEFAULT_CELLS = (
    ("mixture_c4", 4, 32, 4),
    ("mixture_c16", 16, 32, 4),
    ("mixture_c32", 32, 32, 4),
)

PARITY_TOL = 1e-6


def bench_cell(cell: str, cfg: EinetConfig, num_components: int, batch: int,
               steps: int, reps: int, device=None, seed: int = 0,
               inspect: Optional[Callable] = None) -> dict:
    """One row of the report.  ``inspect(mix, nets, registry)``, if given,
    is called once both sides have run (their programs captured), before
    the models are released."""
    dev = resolve_device(device)
    reg = compile_lib.ProgramRegistry()
    base = build_einet(cfg, device=dev, seed=seed)
    mix = EiNetMixture(base, num_components, seed=seed)
    d = base.num_vars
    x = torch.from_numpy(
        np.random.RandomState(0)
        .randn(num_components, batch, d).astype(np.float32)
    ).to(dev)
    saved = clone_tree(mixture_params_of(mix))
    comp_saved = [component_slice(saved["components"], c)
                  for c in range(num_components)]
    # the loop's models: one EiNet a component, its parameters that
    # component's
    nets = []
    for c in range(num_components):
        net = copy.deepcopy(base)
        load_params(net, comp_saved[c])
        nets.append(net)

    vstep = make_mixture_em_step(mix, MixtureTrainConfig(), registry=reg)
    ssteps = [make_em_step(net, TrainConfig(), registry=reg) for net in nets]

    def reset():
        load_mixture_params(mix, saved)
        for net, p in zip(nets, comp_saved):
            load_params(net, p)

    def run_vmapped():
        for _ in range(steps):
            vstep(x)

    def run_looped():
        for _ in range(steps):
            for c in range(num_components):
                ssteps[c](x[c])

    # -- parity: one mixture step vs the loop, from identical parameters
    reset()
    vstep(x)
    for c in range(num_components):
        ssteps[c](x[c])
    parity = 0.0
    for c in range(num_components):
        for a, b in zip(tree_lib.flatten(mix.component_params(c))[1],
                        tree_lib.flatten(params_of(nets[c]))[1]):
            if a.numel():
                parity = max(parity, float((a - b).abs().max()))

    # -- timing: a warm pass of each side, then best-of-reps, each rep from
    # the saved parameters
    reset()
    run_vmapped()
    run_looped()
    best_v = best_l = float("inf")
    for _ in range(reps):
        reset()
        sync(dev)
        with obs.timed("bench.mixture.vmapped", cell=cell) as t:
            run_vmapped()
            sync(dev)
        best_v = min(best_v, t.seconds / steps)
        reset()
        sync(dev)
        with obs.timed("bench.mixture.looped", cell=cell) as t:
            run_looped()
            sync(dev)
        best_l = min(best_l, t.seconds / steps)
    if inspect is not None:
        inspect(mix, nets, reg)

    return {
        "cell": cell,
        "component_arch": cfg.name,
        "num_components": num_components,
        "num_vars": d,
        "num_sums": base.K,
        "num_params_m": round(mix.num_params() / 1e6, 3),
        "per_component_batch": batch,
        "steps_timed": steps,
        "vmapped_ms_per_step": round(best_v * 1e3, 2),
        "looped_ms_per_step": round(best_l * 1e3, 2),
        "speedup": round(best_l / best_v, 3),
        "param_parity_max_abs_diff": parity,
        "param_parity_ok": parity <= PARITY_TOL,
    }


def main(smoke: bool = False, components: int = 0, batch: int = 0,
         steps: int = 0, reps: int = 2,
         out: str = "BENCH_torch_mixture.json", device=None, seed: int = 0,
         inspect: Optional[Callable] = None) -> dict:
    """Run the bench; returns the report, or {} when the parity gate
    fails.  ``out=""`` writes no BENCH file and appends no history row."""
    dev = resolve_device(device)
    if smoke:
        cells = [("smoke", SMOKE_CONFIG, components or 4, batch or 32, 2)]
        reps = 1
    else:
        cells = [
            (cell, COMPONENT_CONFIG, components or c, batch or b, steps or s)
            for cell, c, b, s in DEFAULT_CELLS
        ]
    results = []
    for cell, cfg, c, b, s in cells:
        print(f"[bench_mixture] {cell}: C={c} batch={b}/component ...")
        r = bench_cell(cell, cfg, c, b, s, reps, dev, seed, inspect=inspect)
        print(
            f"  vmapped {r['vmapped_ms_per_step']:.2f} ms/step vs looped "
            f"{r['looped_ms_per_step']:.2f} ms/step (x{r['speedup']:.2f}); "
            f"param parity {r['param_parity_max_abs_diff']:.2e}"
        )
        results.append(r)
    parity_ok = all(r["param_parity_ok"] for r in results)
    report = {
        "results": results,
        "smoke": smoke,
        "backend": dev.type,
        "device": device_name(dev),
        "parity_ok": parity_ok,
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    if not parity_ok:
        print(f"PARAM PARITY FAILURE (> {PARITY_TOL})")
    write_report("mixture", report, out)
    return report if parity_ok else {}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny component, parity-gated only (CI profile)")
    ap.add_argument("--components", type=int, default=0,
                    help="override C for every cell")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the per-component batch")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the mixture's initial parameters")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_mixture.json")
    args = ap.parse_args()
    result = main(smoke=args.smoke, components=args.components,
                  batch=args.batch, steps=args.steps, reps=args.reps,
                  out=args.out, device=args.device, seed=args.seed)
    raise SystemExit(0 if result else 1)
