"""Roofline of the dry-run cells on the H100 (the port's counterpart of
the reference's ``benchmarks/roofline.py``).

Per (arch x shape x mesh) record of ``python -m repro_torch.launch.dryrun``
(``artifacts/dryrun_torch``), three terms on one card:

  compute    = flops_per_device            / 67e12 FLOP/s
  memory     = bytes_per_device            / 3.35e12 B/s
  collective = collective_bytes_per_device / 50e9 B/s

The peaks are NVIDIA's published H100 SXM5 figures (H100 data sheet):
67 TFLOP/s fp32 outside the tensor cores (the kernels and the step's
elementwise work run in fp32 on the CUDA cores, TF32 off, the peak
``PERF.md`` and ``chip_smoke.py``'s bounds use) and 3.35 TB/s of HBM3.
The collective term takes one ConnectX-7 NDR InfiniBand NIC a card, 400
Gb/s = 50 GB/s a direction: a 256-card mesh spans 32 hosts of 8, so a ring
over the data dim crosses hosts at that rate.  Inside one host NVLink 4
gives 450 GB/s a direction (900 GB/s both ways), 9x the NIC: a collective
whose ring stays in one host (a model dim of 8 or less) would take 1/9 of
the term.

FLOPs and bytes come from the step cost counter (``launch/cost.py``): the
aten ops' output bytes plus each kernel launch's bytes moved, its flops
and the matmul flops, the microbatch body counted once a microbatch.  The
memory term is floored by the parameter bytes the step must read once
(fp32).  Collective bytes are the sharded step's, counted analytically.

Also reported per cell: the dominant term and a one-line note on what
would move it on this card.

  PYTHONPATH=src python -m repro_torch.bench.roofline [--dir ...] [--mesh ...]

writes a markdown table to stdout (``bench.experiments`` embeds it).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 67e12  # fp32 FLOP/s, CUDA cores, H100 SXM5
HBM_BW = 3.35e12  # B/s, HBM3, H100 SXM5
LINK_BW = 50e9  # B/s, one NDR 400 Gb/s NIC a card, one direction

DEFAULT_DIR = "artifacts/dryrun_torch"


def model_flops_per_device(rec: Dict) -> Optional[float]:
    """Useful-work floor, per device: None, as in the reference (an EiNet
    EM step has no tokens-x-active-params model; the counted flops are the
    circuit's own)."""
    return None


def analyze_record(rec: Dict) -> Dict:
    mf = model_flops_per_device(rec)
    flops = max(rec["flops_per_device"], mf or 0.0)
    param_bytes = (rec.get("param_count") or 0) * 4  # fp32 read floor
    mem_bytes = max(rec["bytes_written_per_device"], param_bytes)
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": mem_bytes / HBM_BW,
        "collective_s": rec["collective_bytes_per_device"] / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    out = dict(rec)
    out.update(terms)
    out["dominant"] = dominant.replace("_s", "")
    out["model_flops_per_device"] = mf
    out["useful_ratio"] = (mf / rec["flops_per_device"]
                           if mf and rec["flops_per_device"] else None)
    useful_s = (mf or flops) / PEAK_FLOPS
    out["roofline_fraction"] = useful_s / total if total > 0 else None
    return out


_NOTES = {
    "compute": "compute-bound: move the contractions onto the tensor "
               "cores (TF32/bf16 mma) or cut the backward's recompute",
    "memory": "memory-bound: fuse the leaf layer and the M-step's "
              "elementwise passes; keep the statistics in fewer buffers",
    "collective": "collective-bound: keep the statistics ring inside a "
                  "host (NVLink) or overlap the all-reduce with the body",
}


def build_table(art_dir: str = DEFAULT_DIR,
                mesh: Optional[str] = "16x16") -> List[Dict]:
    rows = []
    for f in sorted(os.listdir(art_dir)):
        if not (f.endswith(".json") or f.endswith(".json.err")):
            continue
        with open(os.path.join(art_dir, f)) as fh:
            rec = json.load(fh)
        if mesh and rec.get("mesh") not in (mesh, None) and \
                "skipped" not in rec and "error" not in rec:
            continue
        if "error" in rec:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"),
                         "skipped": "ERROR: " + rec["error"][:60]})
            continue
        if "skipped" in rec:
            rows.append(rec)
            continue
        rows.append(analyze_record(rec))
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/HLO flops | roofline frac | note |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r.get('shape', '-')} | "
                f"{r.get('mesh', '-')} | - | - | - | skipped | - | - | "
                f"{r['skipped']} |")
            continue
        ur = f"{r['useful_ratio']:.2f}" if r["useful_ratio"] else "-"
        rf = (f"{r['roofline_fraction']:.3f}" if r["roofline_fraction"]
              else "-")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | {r['dominant']} | {ur} | {rf} | "
            f"{_NOTES[r['dominant']][:60]} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.roofline")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--mesh", default="16x16",
                    help="16x16, 2x16x16, or '' for every mesh")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = build_table(args.dir, args.mesh or None)
    if args.json:
        print(json.dumps(rows, indent=1, default=str))
    else:
        print(to_markdown(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
