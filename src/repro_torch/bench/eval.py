"""Evaluation-throughput benchmark -> BENCH_torch_eval.json.

The port of the reference's ``benchmarks/bench_eval.py``: the
engine-streamed held-out-LL path (``repro_torch.eval.metrics``, every
batch a captured-graph replay on the card) against the engine-free dense
baseline (fixed-size chunks of an eager ``EiNet.query``) on the same test
rows, plus the inpainting harness's throughput, gated on parity (engine
results bit for bit the direct one-row calls):

  PYTHONPATH=src python -m repro_torch.bench.eval --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.bench.eval         # 16x16x3 PD net

The report keeps the reference's schema, plus "device", the card's name
or "cpu".  The model is the synthetic dataset's PD config initialised from
``--seed``; its programs go into a registry of their own.
"""

from __future__ import annotations

import argparse
import datetime

import numpy as np

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.bench import device_name, write_report
from repro_torch.core.einet import resolve_device
from repro_torch.data import datasets as ds_lib
from repro_torch.eval.inpainting import run_inpainting
from repro_torch.eval.metrics import (
    direct_log_likelihoods,
    engine_log_likelihoods,
)
from repro_torch.eval.workbench import EvalConfig, pd_config_for
from repro_torch.launch.cells import build_einet
from repro_torch.serve import ServeEngine


def main(smoke: bool = False, rows: int = 512, inpaint_rows: int = 8,
         max_batch: int = 64, out: str = "BENCH_torch_eval.json",
         device=None, seed: int = 0) -> dict:
    """Run the bench; returns the report, or {} when a parity mismatch is
    found.  ``out=""`` writes no BENCH file and appends no history row."""
    dev = resolve_device(device)
    cfg = EvalConfig(dataset="synthetic", smoke=smoke)
    if smoke:
        rows, inpaint_rows, max_batch = 96, 4, 16
    dataset = (
        ds_lib.synthetic_image_dataset(8, 8, 1, num_train=256, num_test=rows)
        if smoke else
        ds_lib.synthetic_image_dataset(16, 16, 3, num_train=256, num_test=rows)
    )
    spec = dataset.spec
    model = build_einet(pd_config_for(cfg, spec), device=dev, seed=seed)
    test_x, _ = ds_lib.to_domain(dataset.test_x, "normal")
    x = test_x[:rows]

    engine = ServeEngine(model, max_batch=max_batch,
                         registry=compile_lib.ProgramRegistry())
    res = engine_log_likelihoods(
        model, x, engine=engine, parity_rows=min(64, rows)
    )

    # dense baseline: one warm pass on the chunk shape, then measure (the
    # result is on the host when the call returns)
    direct_log_likelihoods(model, x[: max_batch * 2], chunk=max_batch)
    with obs.timed("bench.eval.direct") as t:
        ll_direct = direct_log_likelihoods(model, x, chunk=max_batch)
    direct_s = t.seconds

    inp = run_inpainting(
        model, x[:inpaint_rows], spec.height, spec.width,
        spec.channels, engine=engine, parity_rows=None,
    )

    mismatches = res.parity_mismatches + inp.metrics["parity_mismatches"]
    report = {
        "arch": f"einet-pd-{spec.name}-eval",
        "num_vars": model.num_vars,
        "num_sums": model.K,
        "smoke": smoke,
        "rows": rows,
        "engine_rows_per_s": res.rows_per_second,
        "engine_seconds": res.engine_seconds,
        "engine_warmup_s": res.warmup_seconds,
        "direct_rows_per_s": rows / max(direct_s, 1e-9),
        "direct_seconds": direct_s,
        "engine_vs_direct": (rows / max(res.engine_seconds, 1e-9))
        / (rows / max(direct_s, 1e-9)),
        "ll_max_abs_diff_engine_vs_direct": float(
            np.max(np.abs(res.ll - ll_direct))
        ),
        "inpaint_requests_per_s": inp.metrics["requests_per_s"],
        "inpaint_requests": inp.metrics["num_requests"],
        "parity_mismatches": int(mismatches),
        "parity_ok": mismatches == 0,
        "device": device_name(dev),
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    print(f"{report['arch']}: engine {report['engine_rows_per_s']:.0f} rows/s "
          f"vs dense {report['direct_rows_per_s']:.0f} rows/s "
          f"(x{report['engine_vs_direct']:.2f}); inpainting "
          f"{report['inpaint_requests_per_s']:.0f} req/s; "
          f"parity mismatches {mismatches}")
    write_report("eval", report, out)
    return report if mismatches == 0 else {}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--inpaint-rows", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's initial parameters")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_eval.json")
    args = ap.parse_args()
    result = main(smoke=args.smoke, rows=args.rows,
                  inpaint_rows=args.inpaint_rows, max_batch=args.max_batch,
                  out=args.out, device=args.device, seed=args.seed)
    raise SystemExit(0 if result else 1)
