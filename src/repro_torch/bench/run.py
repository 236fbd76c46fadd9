"""Benchmark harness: one benchmark per paper table/figure, on the card.
The port of the reference's ``benchmarks/run.py`` without its roofline
table (cast in TPU terms).

  python -m repro_torch.bench.run [--full] [--only table1|fig3|fig6|fig4]
                                  [--device cpu]

Defaults to the quick profile; ``--full`` runs the paper-sized sweeps.
Runs on CUDA unless ``--device cpu`` is given.  Output: a CSV block and a
JSON line (device, card) per benchmark; exits non-zero when a gate fails
(Table 1's parity and EM, Fig. 4's EM and inpainting).
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.einet import resolve_device

BENCHES = ("table1", "fig3", "fig6", "fig4")
TITLES = {
    "table1": "Table 1: LL parity einsum vs naive + EM improvement",
    "fig3": "Fig 3: train time / peak memory vs K, D, R",
    "fig6": "Fig 6: inference time vs K, D, R",
    "fig4": "Fig 4: generative image model + inpainting",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", choices=BENCHES, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    quick = not args.full
    dev = resolve_device(args.device)
    t0 = time.time()
    ok = True
    for name in BENCHES:
        if args.only not in (None, name):
            continue
        print(f"\n===== {TITLES[name]} =====", flush=True)
        if name == "table1":
            from repro_torch.bench import table1

            ok &= table1.main(quick, dev)
        elif name == "fig3":
            from repro_torch.bench import fig3

            fig3.main(quick, dev)
        elif name == "fig6":
            from repro_torch.bench import fig6

            fig6.main(quick, dev)
        else:
            from repro_torch.bench import fig4

            ok &= fig4.gate(fig4.main(quick, dev))
    print(f"\n# benchmarks done in {time.time() - t0:.1f}s; all-ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
