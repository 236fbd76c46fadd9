"""Image-evaluation CLI: train (or reuse) a PD EiNet and measure it as a
generative image model -- bits-per-dim, Fig. 4 inpainting, sample grids --
with every query served through the batched engine and parity-audited
against direct ``model.query`` calls.

  # offline end-to-end smoke (tiny PD net, procedural data, CI profile)
  PYTHONPATH=src python -m repro_torch.launch.eval --dataset synthetic --smoke
  PYTHONPATH=src python -m repro_torch.launch.eval --dataset synthetic \\
      --smoke --device cpu

  # the paper's protocol (cache under artifacts/datasets/, else a download;
  # --source procedural never needs the network)
  PYTHONPATH=src python -m repro_torch.launch.eval --dataset svhn \\
      --source procedural --num-sums 40

  # §4.2 mixture of EiNets: k-means clusters + C components trained by
  # hard EM, served through the mixture_* engine kinds
  PYTHONPATH=src python -m repro_torch.launch.eval --dataset celeba \\
      --source procedural --mixture 8 --num-sums 40 --batch 512
  PYTHONPATH=src python -m repro_torch.launch.eval --dataset celeba \\
      --mixture 3 --smoke --device cpu

Runs on CUDA unless ``--device cpu``, and fails on a machine without a
card.  Artifacts (PNG grids, metrics.json) go under
``artifacts/eval_torch/<run>/``.  Exit status is the acceptance gate:
non-zero when any engine result is not bit-identical to the direct call
(``parity_mismatches_total != 0``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.core.einet import resolve_device
from repro_torch.data.datasets import DEFAULT_DATA_DIR
from repro_torch.eval.masks import MASK_KINDS
from repro_torch.eval.workbench import EVAL_DATASETS, EvalConfig, run_eval


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=EVAL_DATASETS, default="synthetic")
    ap.add_argument("--family", choices=("normal", "binomial", "categorical"),
                    default="normal", help="leaf exponential family")
    ap.add_argument("--smoke", action="store_true",
                    help="CI profile: tiny net, procedural data, few steps")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--num-sums", type=int, default=16)
    ap.add_argument("--delta", type=int, default=None,
                    help="PD cut spacing (default: per-dataset)")
    ap.add_argument("--source", choices=("auto", "download", "procedural"),
                    default="auto", help="dataset source resolution")
    ap.add_argument("--data-dir", default=DEFAULT_DATA_DIR)
    ap.add_argument("--out-dir", default="artifacts/eval_torch")
    ap.add_argument("--run-name", default=None)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--eval-rows", type=int, default=256)
    ap.add_argument("--inpaint-rows", type=int, default=8)
    ap.add_argument("--num-samples", type=int, default=16)
    ap.add_argument("--masks", nargs="+", default=list(MASK_KINDS),
                    choices=list(MASK_KINDS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixture", type=int, default=0,
                    help="train/eval a mixture of this many EiNets over "
                         "k-means image clusters (§4.2); 0 = single EiNet")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="collect obs tracing spans and export a "
                         "Chrome-trace JSON to this path at exit")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(
            "eval: torch.cuda.is_available() is False and the eval CLI runs "
            "on CUDA by default; pass --device cpu to run on the CPU") from e
    obs.cli_begin(args.trace)

    cfg = EvalConfig(
        dataset=args.dataset,
        family=args.family,
        smoke=args.smoke,
        steps=args.steps,
        batch=args.batch,
        num_sums=args.num_sums,
        delta=args.delta,
        data_dir=args.data_dir,
        source=args.source,
        out_dir=args.out_dir,
        run_name=args.run_name,
        max_batch=args.max_batch,
        eval_rows=args.eval_rows,
        inpaint_rows=args.inpaint_rows,
        num_samples=args.num_samples,
        mask_kinds=tuple(args.masks),
        seed=args.seed,
        mixture=args.mixture,
        device=str(device),
    )
    rec = run_eval(cfg)

    where = str(device)
    if device.type == "cuda":
        where += f" ({torch.cuda.get_device_name(device)})"
    bj = rec["bpd_joint"]
    mix_s = (f", mixture of {rec['mixture_components']} "
             f"(clusters {rec['cluster_sizes']})"
             if rec.get("mixture_components") else "")
    print(f"{rec['run_name']}: {rec['dataset']} ({rec['dataset_source']}), "
          f"{rec['height']}x{rec['width']}x{rec['channels']}, "
          f"{rec['num_params']:,} params, {rec['train_steps']} EM steps"
          f"{mix_s}, on {where}")
    if rec["train_ll_first"] is not None:
        print(f"train LL: {rec['train_ll_first']:9.2f} -> "
              f"{rec['train_ll_last']:9.2f}")
    print(f"test bpd (joint):    {bj['bpd']:.4f}  "
          f"({bj['num_rows']} rows, {bj['engine_rows_per_s']:.0f} rows/s "
          f"through the engine)")
    print(f"test bpd (marginal, {rec['bpd_marginal']['mask']}): "
          f"{rec['bpd_marginal']['bpd']:.4f}")
    for mk, m in rec["inpainting"]["per_mask"].items():
        base = m.get("mean_fill_mse")
        base_s = f" vs mean-fill {base:.4f}" if base is not None else ""
        print(f"inpaint {mk:14s}: sample MSE {m['conditional_sample_mse']:.4f}"
              f", mpe MSE {m['mpe_mse']:.4f}{base_s}")
    print(f"artifacts: {', '.join(sorted(rec['artifacts'].values()))}")
    print(f"engine: {rec['engine_programs']} warmed (kind, bucket) keys, "
          f"parity mismatches {rec['parity_mismatches_total']}")
    obs.cli_end(args.trace)
    if rec["parity_mismatches_total"]:
        raise SystemExit(
            f"PARITY FAILURE: {rec['parity_mismatches_total']} engine results "
            "differ from direct model.query calls"
        )
    return rec


if __name__ == "__main__":
    main()
