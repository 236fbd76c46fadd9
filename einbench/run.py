"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 einbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell, its configuration, traffic, limits and metrics are read
from ``BENCHMARK.json`` and the files under ``einbench/``.  The last line
of standard output is the result as one JSON object; the numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under the result's last key, ``checks``.  Without the
cards, or with JAX or the JAX package loaded once the window has closed,
it exits non-zero and prints no result.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".einbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.core import execute, forbidden_modules, process_age_s
    from harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"einbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    age = process_age_s()
    clock0 = time.perf_counter() - age if age is not None else CLOCK0
    out = execute(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), device="cuda", clock0=clock0)
    bad = forbidden_modules()
    if bad:
        print(f"einbench: the run loaded {bad}; the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    for name, value in out["readings"].items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
