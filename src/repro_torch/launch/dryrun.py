"""Dry run of the port: the capture-only EM-step cells, and ``--verify``.

The port's counterpart of the reference's ``repro/launch/dryrun.py``:

  * :func:`run_cell` -- one arch's EM-step cell on a production mesh
    (``single`` 16x16 or ``multi`` 2x16x16), the counterpart of the
    reference's lowering and compiling (``lower_einet_cell``).  The
    reference lowers the step for 256 or 512 devices; one card cannot
    build that mesh (``make_production_mesh`` needs the world), so the
    cell runs one data rank's share of the global batch
    (``cells.cell_rows``: ``batch_size / 16`` or ``/ 32``;
    einet_rat_large in 1,024-row microbatches) through
    ``cells.capture_einet_cell``: the step counted once by the step cost
    counter (``launch.cost``, in place of ``hlo_analysis``), the sharded
    step's collectives counted analytically, and ``make_em_step``'s
    program captured (``StepProgram.capture``: it captures and runs no
    step).  It writes ``<out>/<arch>__em_step__<mesh>.json`` with the
    reference's record keys -- the capture's seconds (``capture_s``) in
    place of ``lower_s`` / ``compile_s``, the graph pool and the card's
    peak allocation in ``memory`` in place of XLA's ``memory_analysis``,
    the XLA-only ``xla_*_raw`` and ``hlo_bytes`` None -- plus ``device``
    (``nvidia-smi``'s name and power limit).  A failed cell writes
    ``.json.err``, as the reference's does.
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

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch einet_rat \\
      --device cpu --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --verify [--device cpu]

``python -m repro_torch.bench.roofline`` reads the records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.analysis.verify import VerifyError, verify_config, verify_einet
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.launch import cells
from repro_torch.launch.cells import build_einet
from repro_torch.obs import health as health_lib

# archs whose parameters exceed this many floats skip the numerical probe
# (a forward on einet_rat_large's 530M parameters is a budget of its own,
# not a smoke test)
PROBE_PARAM_FLOOR = 80_000_000
PROBE_BATCH = 8

HEALTH_DIR = "artifacts/health_torch"
DRYRUN_DIR = "artifacts/dryrun_torch"


def cell_path(arch: str, mesh_kind: str, out_dir: str) -> str:
    tag = f"{arch}__em_step__{cells.MESHES[mesh_kind][2]}"
    return os.path.join(out_dir, tag.replace("/", "_") + ".json")


def device_record(dev: torch.device) -> Dict[str, Any]:
    """What a record names its device by: the type and, on the card,
    ``nvidia-smi``'s name and power limit."""
    from repro_torch.bench import card_line

    return {"type": dev.type, "card": card_line(dev)}


def run_cell(arch: str, mesh_kind: str, out_dir: str = DRYRUN_DIR,
             skip_existing: bool = True, device=None,
             registry=None) -> Optional[Dict[str, Any]]:
    """The EM-step cell of ``arch`` on ``mesh_kind`` ("single" or
    "multi"): verify the model, count and capture one data rank's step,
    and write its record (``.json``; ``.json.err`` when the cell fails).
    Runs on the card unless ``device="cpu"``; ``registry`` is the program
    registry the capture goes through (default ``compile.REGISTRY``).
    Returns the record."""
    cfg = get_config(arch)
    arch = cfg.name
    names, shape, mesh_tag = cells.MESHES[mesh_kind]
    path = cell_path(arch, mesh_kind, out_dir)
    tag = os.path.basename(path)[: -len(".json")]
    if skip_existing and os.path.exists(path):
        print(f"[skip-cached] {tag}")
        with open(path) as f:
            return json.load(f)
    dev = resolve_device(device)
    print(f"[capture] {tag} ...", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    try:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        model = build_einet(cfg, device=dev)
        print(f"[plan] {arch}: {model.grouping_summary()['segments']}",
              flush=True)
        report = verify_einet(model, name=arch)
        print(f"[verify] {arch}: {report.summary()}", flush=True)
        if not report.ok:
            raise VerifyError(report)
        with obs.timed("dryrun.cell", arch=arch, mesh=mesh_tag):
            cell = cells.capture_einet_cell(cfg, mesh_kind, registry=registry,
                                            model=model)
        reg = registry if registry is not None else compile_lib.REGISTRY
        pool = reg.pool_bytes(model) if dev.type == "cuda" else 0
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        cost = cell["cost"]
        rec = {
            "arch": arch,
            "shape": "em_step",
            "mesh": mesh_tag,
            "num_devices": int(np.prod(shape)),
            "kind": "train",
            # no XLA program: nothing to read raw
            "xla_flops_raw": None,
            "xla_bytes_raw": None,
            "flops_per_device": cost.flops,
            "bytes_written_per_device": cost.bytes_written,
            "collectives": cell["collectives"],
            "collective_bytes_per_device": cell["collective_bytes"],
            "memory": {
                "argument_bytes": param_bytes + cell["rows"] * model.num_vars
                * 4,
                "output_bytes": cost.output_bytes,
                "temp_bytes": pool,
                "alias_bytes": param_bytes,  # written in place
                "pool_bytes": pool,
                "peak_allocated_bytes": peak,
            },
            # an eager program (a CPU model's) captures nothing
            "capture_s": (round(cell["graphs"].capture_s, 3)
                          if cell["graphs"] is not None else 0.0),
            "param_count": model.num_params(),
            "active_param_count": None,
            "grouping": model.grouping_summary(),
            "hlo_bytes": None,
            "rows_per_device": cell["rows"],
            "microbatches": cell["microbatches"],
            "kernels": cost.kernels,
            "stats_buffer_bytes": cell["stats_buffer_bytes"],
            "device": device_record(dev),
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if os.path.exists(path + ".err"):  # an earlier run's failure
            os.remove(path + ".err")
        print(f"[ok] {tag}: {rec['flops_per_device']:.3e} flops/dev, "
              f"{rec['bytes_written_per_device']:.3e} B/dev, "
              f"{rec['collective_bytes_per_device']:.3e} coll B/dev, pool "
              f"{pool / 2 ** 30:.3f} GiB, capture {rec['capture_s']:.2f} s",
              flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 -- a failed cell is a bug; record it
        rec = {"arch": arch, "shape": "em_step", "mesh": mesh_kind,
               "error": repr(e), "traceback": traceback.format_exc()}
        with open(path + ".err", "w") as f:
            json.dump(rec, f, indent=1)
        if os.path.exists(path):  # an earlier run's record
            os.remove(path)
        print(f"[FAIL] {tag}: {e}", flush=True)
        return rec
    finally:
        # the cell's model, program and pool go before the next cell
        cell = model = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()


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


# a batch in the arch's EF data domain: the reference's probe draws
probe_data = cells.domain_data


@torch.inference_mode()
def probe_model(model, x: np.ndarray) -> Dict[str, Any]:
    """The probe's numbers for one model at its current parameters on the
    batch ``x``: the batch LL (mean, min, non-finite count), the leaf rows'
    saturation fraction and each plan segment's (the health taps)."""
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(model.device)
    leaf_rows, ll, taps = health_lib.probe_forward(model, xt)
    ll = ll.cpu().numpy()
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
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DRYRUN_DIR,
                    help="where the cells' records go")
    ap.add_argument("--force", action="store_true",
                    help="run every cell again, even one with a record")
    ap.add_argument("--verify", action="store_true",
                    help="run the static circuit/plan verifier and the "
                         "health probe over the selected archs (non-zero "
                         "exit on any failed invariant or non-finite LL); "
                         "no cell is captured")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--health-dir", default=HEALTH_DIR,
                    help="where the probe writes <arch>.json")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="collect obs tracing spans and export a "
                         "Chrome-trace JSON to this path at exit")
    args = ap.parse_args(argv)
    obs.cli_begin(args.trace)
    archs = (sorted(REGISTRY) if args.all or args.arch is None
             else [args.arch])
    if args.verify:
        failures = run_verify(archs)
        failures += run_health_probe(archs, args.health_dir, args.device)
        if failures:
            print(f"{failures} arch(s) failed verification", file=sys.stderr)
            return 1
        print(f"verification complete: {len(archs)} arch(s) clean")
        obs.cli_end(args.trace)
        return 0
    resolve_device(args.device)  # no card and no --device cpu: say so first
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            rec = run_cell(arch, mesh_kind, args.out,
                           skip_existing=not args.force, device=args.device)
            failures += int(rec is None or "error" in rec)
    if failures:
        print(f"{failures} cell(s) failed", file=sys.stderr)
        return 1
    print("dry-run complete")
    obs.cli_end(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
