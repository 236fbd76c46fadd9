"""Training CLI: EM steps on a registered architecture, one EiNet or a
mixture of them (§4.2).

The data is the reference's (``repro.launch.train`` ``einet_train_data``):
``--dataset synthetic`` (the default) cycles through white noise
(``np.random.RandomState(0).randn(4096, num_vars)``) for RAT structures and
the mixture-image proxy (``gaussian_mixture_images(4096, 16, ceil(D / 48),
3, seed=0)[:, :D]``) for Poon-Domingos ones; ``--dataset
{mnist,svhn,celeba}`` trains on the image dataset's train split in the
leaf family's domain, from the npz cache under ``--data-dir``, else its
fetcher, else (offline, or CelebA without a local raw copy) the procedural
stand-in of the same shapes.

  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_rat --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_pd --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_celeba \\
      --dataset celeba --mixture 8 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_rat \\
      --steps 3 --batch 64 --device cpu

``--mixture C`` (C >= 2) trains C components: ``--mixture-assign hard``
(the default, the paper's protocol) k-means the data into C clusters and
gives each component a per-cluster batch of ``batch // C`` rows;
``soft`` runs responsibility-weighted EM on shared batches of ``batch``
rows.

Runs on CUDA unless ``--device cpu``; on the card every step's E-step goes
through the hand-written forward and backward kernels.  Prints the
execution plan, the float32 settings, the k-means cluster counts (hard
mixtures), the median ms/step, the first and last mean LL and the kernel
launches per step.  Checkpoints, fault tolerance and health telemetry are
not part of this CLI.
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
from repro_torch.data import datasets as ds_lib
from repro_torch.data import gaussian_mixture_images
from repro_torch.kernels import ops
from repro_torch.launch.cells import build_einet, build_mixture
from repro_torch.mixture import (
    MixtureTrainConfig,
    make_mixture_em_step,
    prepare_mixture_training,
)
from repro_torch.train import TrainConfig, make_em_step

NUM_ROWS = 4096  # the reference's synthetic training sets


def synthetic_rat_data(num_vars: int) -> np.ndarray:
    """The reference's synthetic RAT training data (``repro.launch.train``
    ``einet_train_data``): (4096, num_vars) standard normal, seed 0."""
    return np.random.RandomState(0).randn(NUM_ROWS, num_vars).astype(np.float32)


def synthetic_pd_data(num_vars: int) -> np.ndarray:
    """The reference's synthetic Poon-Domingos training data: 4096 mixture
    images 16 pixels high and ceil(D / 48) wide in 3 channels, seed 0, cut
    to the model's D variables."""
    return gaussian_mixture_images(NUM_ROWS, 16, -(-num_vars // 48), 3,
                                   seed=0)[:, :num_vars]


def train_data(cfg, num_vars: int, dataset: str = "synthetic",
               data_dir: str = ds_lib.DEFAULT_DATA_DIR) -> np.ndarray:
    """The training rows for ``--dataset``: the synthetic stream, or an
    image dataset's train split in the leaf family's domain (cache, then
    fetch, then the procedural stand-in when it is unavailable)."""
    if dataset == "synthetic":
        make = synthetic_pd_data if cfg.structure == "pd" else synthetic_rat_data
        return make(num_vars)
    try:
        ds = ds_lib.load_image_dataset(dataset, data_dir=data_dir)
    except ds_lib.DatasetUnavailable as e:
        print(f"[train] {e}; using the procedural fallback")
        ds = ds_lib.load_image_dataset(dataset, data_dir=data_dir,
                                       source="procedural")
    print(f"[train] dataset {dataset} ({ds.source}): "
          f"{len(ds.train_x)} train rows")
    data, _ = ds_lib.to_domain(ds.train_x, cfg.exponential_family)
    if data.shape[1] != num_vars:
        raise SystemExit(
            f"--dataset {dataset} has {data.shape[1]} dims but --arch "
            f"{cfg.name} models {num_vars}; pick the matching PD config "
            "(einet_pd_mnist for mnist, einet_pd for svhn, einet_celeba "
            "for celeba)")
    return data


def batch_at(data: torch.Tensor, step: int, batch: int) -> torch.Tensor:
    """Batch ``step`` of ``batch`` rows, cycling through ``data``."""
    idx = (step * batch + torch.arange(batch, device=data.device)) % data.shape[0]
    return data[idx]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(step, batches, steps: int, device: torch.device) -> dict:
    """``steps`` calls of ``step`` on ``batches(i)``, each timed to the end
    of its work on the device; the launches of the last one."""
    lls, times, launches = [], [], []
    for i in range(steps):
        x = batches(i)
        ops.reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        lls.append(step(x))
        _sync(device)
        times.append(time.perf_counter() - t0)
        launches.append({op.name: (op.launches, op.plain_calls)
                         for op in ops.KERNEL_OPS})
    return {"lls": lls, "step_ms": [t * 1e3 for t in times],
            "median_ms": statistics.median(times) * 1e3,
            "launches_per_step": launches[-1]}


def _float32() -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def train_einet(arch: str, steps: int, batch=None, microbatches: int = 1,
                mode: str = "stochastic", grouped: bool = True, device=None,
                seed: int = 0, dataset: str = "synthetic",
                data_dir: str = ds_lib.DEFAULT_DATA_DIR) -> dict:
    """Build ``arch`` from ``seed`` and run ``steps`` EM steps on the
    ``dataset`` rows; returns the report."""
    device = resolve_device(device)
    tf32 = _float32()
    cfg = get_config(arch)
    batch = batch or cfg.batch_size
    model = build_einet(cfg, device=device, seed=seed, grouped=grouped)
    data = torch.from_numpy(
        train_data(cfg, model.num_vars, dataset, data_dir)).to(device)
    step = make_em_step(model, TrainConfig(
        em=EMConfig(), mode=mode, num_microbatches=microbatches))
    run = _run(step, lambda i: batch_at(data, i, batch), steps, device)
    return {"arch": cfg.name, "device": str(device), "batch": batch,
            "microbatches": microbatches, "mode": mode,
            "plan": model.grouping_summary()["segments"], "tf32": tf32,
            **run}


def train_mixture(arch: str, num_components: int, steps: int, batch=None,
                  assign: str = "hard", microbatches: int = 1,
                  mode: str = "stochastic", grouped: bool = True,
                  device=None, seed: int = 0, dataset: str = "synthetic",
                  data_dir: str = ds_lib.DEFAULT_DATA_DIR) -> dict:
    """Build a mixture of ``num_components`` ``arch`` EiNets from ``seed``
    and run ``steps`` mixture EM steps on the ``dataset`` rows (hard: after
    k-means, per-cluster batches of ``batch // C`` rows; soft: shared
    batches of ``batch`` rows); returns the report."""
    device = resolve_device(device)
    tf32 = _float32()
    cfg = get_config(arch)
    batch = batch or cfg.batch_size
    mix = build_mixture(cfg, num_components, device=device, seed=seed,
                        grouped=grouped)
    data = train_data(cfg, mix.num_vars, dataset, data_dir)
    km = None
    if assign == "hard":
        loader, km = prepare_mixture_training(mix, data, seed=seed,
                                              global_batch=batch)
    else:
        loader = ds_lib.array_loader(data, batch)
    step = make_mixture_em_step(mix, MixtureTrainConfig(
        em=EMConfig(), assign=assign, mode=mode,
        num_microbatches=microbatches))
    run = _run(step, lambda i: torch.from_numpy(
        loader.batch_at(i)["x"]).to(device), steps, device)
    return {"arch": cfg.name, "device": str(device),
            "batch": loader.per_host, "microbatches": microbatches,
            "mode": mode, "assign": assign, "components": num_components,
            "plan": mix.component.grouping_summary()["segments"],
            "tf32": tf32, "kmeans": km, **run}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per step (default: the config's batch_size); "
                         "a hard mixture gives each component batch // C")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--em-mode", choices=("stochastic", "full"),
                    default="stochastic")
    ap.add_argument("--grouped", action=argparse.BooleanOptionalAction,
                    default=True, help="fused plan (default) or per layer")
    ap.add_argument("--dataset",
                    choices=("synthetic", "mnist", "svhn", "celeba"),
                    default="synthetic",
                    help="training data (real datasets cache under "
                         "--data-dir; without one the procedural stand-in)")
    ap.add_argument("--data-dir", default=ds_lib.DEFAULT_DATA_DIR)
    ap.add_argument("--mixture", type=int, default=0,
                    help="train a mixture of this many components (>= 2; "
                         "§4.2); 0 = one EiNet")
    ap.add_argument("--mixture-assign", choices=("hard", "soft"),
                    default="hard",
                    help="hard per-cluster EM on k-means clusters, or soft "
                         "responsibility-weighted EM on shared batches")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.mixture >= 2:
        r = train_mixture(args.arch, args.mixture, args.steps, args.batch,
                          args.mixture_assign, args.microbatches,
                          args.em_mode, args.grouped, args.device,
                          dataset=args.dataset, data_dir=args.data_dir)
    else:
        r = train_einet(args.arch, args.steps, args.batch, args.microbatches,
                        args.em_mode, args.grouped, args.device,
                        dataset=args.dataset, data_dir=args.data_dir)
    where = r["device"]
    if where.startswith("cuda"):
        where += f" ({torch.cuda.get_device_name(torch.device(where))})"
    what = f"{r['mode']} EM, batch {r['batch']}"
    if "components" in r:
        what = (f"mixture of {r['components']} components, {r['assign']} "
                f"{what}" + (" a component" if r["assign"] == "hard" else ""))
    print(f"{r['arch']} on {where}: plan {r['plan']}, {what} in "
          f"{r['microbatches']} microbatch(es)")
    print(f"float32: matmul allow_tf32={r['tf32'][0]}, "
          f"cudnn allow_tf32={r['tf32'][1]}")
    if r.get("kmeans") is not None:
        km = r["kmeans"]
        print(f"k-means clusters: {km.counts.tolist()} (inertia "
              f"{km.inertia:.4f})")
    print(f"{len(r['lls'])} steps: median {r['median_ms']:.3f} ms/step; "
          f"mean LL first {r['lls'][0]:.4f}, last {r['lls'][-1]:.4f}")
    print("kernel launches per step (plain-version calls): " + ", ".join(
        f"{k} {n} ({p})" for k, (n, p) in r["launches_per_step"].items()))


if __name__ == "__main__":
    main()
