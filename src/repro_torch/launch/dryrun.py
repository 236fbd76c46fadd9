"""Dry-run gates for the port: ``--verify``.

The port's counterpart of the reference's ``repro/launch/dryrun.py``
``--verify`` path, its CI gate:

  * :func:`run_verify` -- the static circuit/plan verifier
    (``repro_torch.analysis.verify``) over each registered arch's structure
    and plan, built on the "meta" device (no parameters);
  * :func:`run_health_probe` -- one forward at the arch's initial
    parameters through the health tap sites (``repro_torch.obs.health``),
    recording the per-segment saturation and the batch LL's health to
    ``artifacts/health_torch/<arch>.json``.  It runs on the card unless
    ``--device cpu``; an arch above ``PROBE_PARAM_FLOOR`` parameters is
    skipped (its count is read on the "meta" device), as in the reference.
    A non-finite LL on in-domain data fails the gate.  Unlike the
    reference, a probe that raises is not recorded and passed over: it
    fails the run.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --verify [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --verify --arch einet_pd

The reference's other mode, lowering and compiling every arch's EM-step
cell on the production meshes (``run_cell``), has no counterpart yet: a
run without ``--verify`` says so and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis.verify import verify_config
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.launch.cells import build_einet
from repro_torch.obs import health as health_lib

# archs whose parameters exceed this many floats skip the numerical probe
# (a forward on einet_rat_large's 530M parameters is a budget of its own,
# not a smoke test)
PROBE_PARAM_FLOOR = 80_000_000
PROBE_BATCH = 8

HEALTH_DIR = "artifacts/health_torch"


def run_verify(archs) -> int:
    """Static circuit/plan verification per arch (no parameters, no
    device): the ``--verify`` gate.  Returns the number of failing
    archs."""
    failures = 0
    for arch in archs:
        report = verify_config(get_config(arch))
        print(f"[verify] {arch}: {report.summary()}", flush=True)
        for finding in report.findings:
            print(f"  - {finding}", flush=True)
        failures += 0 if report.ok else 1
    return failures


def probe_data(model, batch: int) -> np.ndarray:
    """A batch in the arch's EF data domain (lgamma/one-hot blow up on
    out-of-domain floats, which would make the probe report false
    alarms); the reference's draws."""
    rng = np.random.RandomState(0)
    name = model.ef.name
    if name == "binomial":
        hi = model.ef.n_trials
        return rng.randint(0, hi + 1, (batch, model.num_vars)).astype(
            np.float32)
    if name == "categorical":
        hi = model.ef.num_categories
        return rng.randint(0, hi, (batch, model.num_vars)).astype(np.float32)
    if name == "bernoulli":
        return rng.randint(0, 2, (batch, model.num_vars)).astype(np.float32)
    return rng.randn(batch, model.num_vars).astype(np.float32)


@torch.inference_mode()
def probe_model(model, x: np.ndarray) -> Dict[str, Any]:
    """The probe's numbers for one model at its current parameters on the
    batch ``x``: the batch LL (mean, min, non-finite count), the leaf rows'
    saturation fraction and each plan segment's (the health taps)."""
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(model.device)
    leaf_rows = model._leaf_rows(model.leaf_log_prob(xt, None))
    with health_lib.collect() as taps:
        root = model.forward_from_e(None, leaf_rows=leaf_rows)
    ll = torch.logsumexp(root + torch.log(model.class_prior)[None, :],
                         dim=-1).cpu().numpy()
    return {
        "probe_batch": int(xt.shape[0]),
        "ll_mean": float(np.mean(ll)),
        "ll_min": float(np.min(ll)),
        "ll_nonfinite": int(np.sum(~np.isfinite(ll))),
        "leaf_sat_frac": float(health_lib.saturation_fraction(leaf_rows)),
        "segment_sat_frac": [float(t) for t in taps],
    }


def run_health_probe(archs, out_dir: str = HEALTH_DIR, device=None) -> int:
    """Numerical-health probe per arch: one forward at the initial
    parameters (seed 0) through the tap sites, written to
    ``<out_dir>/<arch>.json``.  Catches init-time numerical rot (a config
    whose leaves saturate on in-domain data before training starts) that
    static verification cannot see.  Returns the number of failing
    archs."""
    dev = resolve_device(device)
    failures = 0
    os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        path = os.path.join(out_dir, arch.replace("/", "_") + ".json")
        cfg = get_config(arch)
        n_params = build_einet(cfg, device="meta").num_params()
        if n_params > PROBE_PARAM_FLOOR:
            rec = {"arch": arch, "skipped": True, "num_params": n_params,
                   "reason": f"param count {n_params} > probe floor "
                             f"{PROBE_PARAM_FLOOR}"}
            print(f"[health] {arch}: skipped ({n_params / 1e6:.0f}M "
                  "params)", flush=True)
        else:
            model = build_einet(cfg, device=dev)
            rec = {"arch": arch, "skipped": False, "num_params": n_params,
                   "device": dev.type,
                   **probe_model(model, probe_data(model, PROBE_BATCH))}
            del model
            ok = rec["ll_nonfinite"] == 0
            failures += 0 if ok else 1
            print(f"[health] {arch}: ll mean {rec['ll_mean']:.2f} "
                  f"min {rec['ll_min']:.2f}, leaf sat "
                  f"{rec['leaf_sat_frac']:.3f}, "
                  f"{len(rec['segment_sat_frac'])} segment(s)"
                  + ("" if ok else "  <-- NON-FINITE"), flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="run the static circuit/plan verifier and the "
                         "health probe over the selected archs (non-zero "
                         "exit on any failed invariant or non-finite LL)")
    ap.add_argument("--device", default=None,
                    help="the health probe's device: cuda (default) or cpu")
    ap.add_argument("--health-dir", default=HEALTH_DIR,
                    help="where the probe writes <arch>.json")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="collect obs tracing spans and export a "
                         "Chrome-trace JSON to this path at exit")
    args = ap.parse_args(argv)
    if not args.verify:
        print("dryrun: only --verify is ported; lowering and compiling the "
              "EM-step cells (the reference's run_cell) has no counterpart "
              "in the port yet", file=sys.stderr)
        return 2
    obs.cli_begin(args.trace)
    archs = (sorted(REGISTRY) if args.all or args.arch is None
             else [args.arch])
    failures = run_verify(archs)
    failures += run_health_probe(archs, args.health_dir, args.device)
    if failures:
        print(f"{failures} arch(s) failed verification", file=sys.stderr)
        return 1
    print(f"verification complete: {len(archs)} arch(s) clean")
    obs.cli_end(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
