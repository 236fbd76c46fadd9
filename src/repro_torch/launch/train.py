"""Training CLI: the reference's production training launcher
(``repro.launch.train``) -- EM steps on a registered architecture, one
EiNet or a mixture of them (§4.2), inside the fault-tolerant loop with
checkpoints and, with health on, the divergence flight recorder; one
EiNet also over several processes (``--dist-em``, ``--model-parallel``).

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
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_pd --steps 20 \\
      --health --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch einet_celeba \\
      --dataset celeba --mixture 8 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--mixture C`` (C >= 2) trains C components: ``--mixture-assign hard``
(the default, the paper's protocol) k-means the data into C clusters and
gives each component a per-cluster batch of ``batch // C`` rows;
``soft`` runs responsibility-weighted EM on shared batches of ``batch``
rows.

Every step is the program ``make_em_step`` / ``make_mixture_em_step``
returns: on the card captured CUDA graphs (the first step of a batch shape
captures them), on the CPU the same update op by op.  ``ft.run_training``
runs the steps: it commits a checkpoint every ``--checkpoint-every`` steps
under ``<--ckpt-dir>/<arch>/`` (default ``artifacts/ckpt_torch/``), resumes
a run from the newest one, and replays from the last one after a failed
step.  ``--smoke`` trains the reference's small RAT smoke config with
health telemetry on; ``--health`` turns it on for any arch (a single
EiNet): each step's health vector feeds the ``train.health.*`` gauges and
the flight recorder, which dumps an incident bundle under
``artifacts/incidents_torch/`` when the step diverges and then aborts or
continues (``--on-divergence``).  ``--trace`` and ``--metrics`` export the
obs spans and metrics at exit.

Under torchrun (several processes) or with ``--dist-em`` the step is the
sharded one (``make_sharded_em_step``) on a (data, ``--model-parallel``)
mesh (``launch/mesh.py``): each rank reads its disjoint rows of every
global batch of ``--batch`` rows, the E-step statistics are all-reduced
over the data dim, and at ``--model-parallel`` 2 or more each rank runs the
M-step on its model shard.  Health is off there, and ``--mixture`` is
refused, as in the reference.  Each rank writes its own checkpoint shard
(``shard_<rank>.npz``).  A CUDA job joins with NCCL, a CPU one with gloo:

  torchrun --nproc_per_node 2 -m repro_torch.launch.train --smoke \
      --dist-em --device cpu --ckpt-dir /tmp/ck_dist

Runs on CUDA unless ``--device cpu``.  Prints the execution plan, the
float32 settings, the k-means cluster counts (hard mixtures), the median
ms/step, the first and last mean LL, the kernel launches of the last step
(a graph replay launches through no wrapper, so 0 on the card after the
first step), then the reference's closing lines: ms/step with the
restarts (and ``dp_shards``, the data-parallel ranks), and the objective
first -> last.
"""

from __future__ import annotations

import argparse
import os
import statistics

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import EinetConfig, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.core.em import EMConfig, load_params, params_of
from repro_torch.data import datasets as ds_lib
from repro_torch.data import gaussian_mixture_images
from repro_torch.kernels import ops
from repro_torch.launch.cells import build_einet, build_mixture
from repro_torch.launch.mesh import (
    dp_index,
    dp_shards,
    init_distributed,
    make_mesh_for,
)
from repro_torch.dist import fault_tolerance as ft
from repro_torch.mixture import (
    MixtureTrainConfig,
    make_mixture_em_step,
    prepare_mixture_training,
)
from repro_torch.mixture.train import load_mixture_params, mixture_params_of
from repro_torch.obs import health as health_lib
from repro_torch.train import TrainConfig, make_em_step, make_sharded_em_step
from repro_torch.train.pipeline import resolve_step_health

NUM_ROWS = 4096  # the reference's synthetic training sets
DEFAULT_CKPT_DIR = "artifacts/ckpt_torch"

# --smoke: the reference's smoke profile (``repro.launch.train``
# SMOKE_CONFIG) -- a RAT shape small enough to train in seconds on the CPU
# but deep enough to fuse, with health telemetry forced on
SMOKE_CONFIG = EinetConfig(
    name="einet-rat-train-launch-smoke",
    structure="rat",
    num_vars=32,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=64,
)


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


def _snapshot(params):
    """A copy of a parameter tree (the loop's replay-from-start state)."""
    if isinstance(params, dict):
        return {k: _snapshot(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_snapshot(v) for v in params]
    return params.clone()


def _float32() -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _loop(step, batches, steps: int, device: torch.device, params_of_model,
          load, ckpt_dir: str, checkpoint_every: int,
          watcher=None, spec=None, mgr=None) -> dict:
    """``steps`` calls of ``step`` on ``batches(i)`` inside
    ``ft.run_training``: each call timed to the end of its work on the
    device, its launches counted, a checkpoint committed every
    ``checkpoint_every`` steps under ``ckpt_dir``.  ``params_of_model()``
    gives the model's parameters (views), ``load(params)`` writes a
    parameter tree into the model in place.  With a health ``watcher``
    the step returns (LL, health vector) and each vector is published and
    watched.  ``mgr`` defaults to a ``CheckpointManager`` of ``ckpt_dir``
    for this process.  Returns the report."""
    mgr = mgr or CheckpointManager(ckpt_dir)
    times, launches, lls = [], [], []
    first = {}

    def step_fn(state, x):
        ops.reset_counts()
        _sync(device)
        # the device has finished the step when the timed region closes
        with obs.timed("train.step", metric="train.step.seconds") as t:
            out = step(x)
            ll, hv = out if watcher is not None else (out, None)
            _sync(device)
        times.append(t.seconds)
        launches.append({op.name: (op.launches, op.plain_calls)
                         for op in ops.KERNEL_OPS})
        obs.METRICS.counter("train.examples.count").inc(
            x.shape[:-1].numel())
        obs.METRICS.gauge("train.ll.last").set(ll)
        if watcher is not None:
            health_lib.publish(spec, hv)
            watcher.observe(state["step"], hv, params_of_model())
        return {"last_ll": ll, "params": params_of_model(),
                "step": state["step"] + 1}

    def load_state(state):
        load(state["params"])
        first.setdefault("step", int(state["step"]))
        return {"last_ll": float(state["last_ll"]),
                "params": params_of_model(), "step": int(state["step"])}

    init = {"last_ll": 0.0, "params": _snapshot(params_of_model()),
            "step": 0}
    with obs.timed("train.run") as t_run:
        state, stats = ft.run_training(
            step_fn, init, batches, mgr, steps,
            ft.LoopConfig(checkpoint_every=checkpoint_every),
            on_step=lambda s, st: lls.append(st["last_ll"]),
            load_state=load_state)
    return {"lls": lls, "step_ms": [t * 1e3 for t in times],
            "median_ms": statistics.median(times) * 1e3 if times else 0.0,
            "launches_per_step": launches[-1] if launches else {},
            "run_s": t_run.seconds, "restarts": stats["restarts"],
            "resumed_at": first.get("step", 0), "ckpt_dir": ckpt_dir,
            "checkpoints": mgr.all_steps()}


def train_einet(arch: str, steps: int, batch=None, microbatches: int = 1,
                mode: str = "stochastic", grouped: bool = True, device=None,
                seed: int = 0, dataset: str = "synthetic",
                data_dir: str = ds_lib.DEFAULT_DATA_DIR,
                ckpt_dir: str = DEFAULT_CKPT_DIR, checkpoint_every: int = 25,
                health=None, on_divergence: str = "abort",
                cfg: EinetConfig = None, dist_em: bool = False,
                model_parallel: int = 1) -> dict:
    """Build ``arch`` (or ``cfg``) from ``seed`` and run ``steps`` EM steps
    on the ``dataset`` rows in the fault-tolerant loop; ``health`` None
    defers to the model's knob (``REPRO_HEALTH``).  Returns the report.

    Under several processes (torchrun's environment, or a process group
    the caller made) or with ``dist_em``, the step is the sharded one
    (``make_sharded_em_step``) on a (data, ``model_parallel``) mesh: each
    rank reads its disjoint rows of each global batch of ``batch`` rows
    (``array_loader`` shard ``dp_index`` of ``dp_shards``) and health is
    off, as in the reference.  A rank left out of the mesh trains nothing
    and reports ``"idle": True``."""
    owns_group = not torch.distributed.is_initialized()
    rank, world, device = init_distributed(device)
    try:
        dist = dist_em or world > 1
        tf32 = _float32()
        cfg = cfg or get_config(arch)
        batch = batch or cfg.batch_size
        mesh = make_mesh_for(world, model_parallel, device_type=device.type)
        report = {"arch": cfg.name, "device": str(device), "batch": batch,
                  "microbatches": microbatches, "mode": mode, "tf32": tf32,
                  "dist": dist, "rank": rank, "world": world,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "dp_shards": dp_shards(mesh)}
        if mesh.get_coordinate() is None:
            return {**report, "idle": True}
        model = build_einet(cfg, device=device, seed=seed, grouped=grouped)
        rows = train_data(cfg, model.num_vars, dataset, data_dir)
        tcfg = TrainConfig(em=EMConfig(), mode=mode,
                           num_microbatches=microbatches,
                           health=False if dist else health)
        health_on = resolve_step_health(model, tcfg)
        watcher = (health_lib.HealthWatcher(model, health_lib.HealthPolicy(
            on_incident=on_divergence)) if health_on else None)
        ckpt = os.path.join(ckpt_dir, cfg.name.replace("/", "_"))
        if dist:
            step = make_sharded_em_step(model, tcfg, mesh)
            loader = ds_lib.array_loader(rows, batch,
                                         num_shards=dp_shards(mesh),
                                         shard_id=dp_index(mesh))

            def batches(i):
                return torch.from_numpy(loader.batch_at(i)["x"]).to(device)

            # the mesh's ranks write the checkpoints (a rank left out of
            # the mesh writes none)
            mgr = CheckpointManager(ckpt, rank=mesh.get_rank(),
                                    world=mesh.size())
        else:
            step = make_em_step(model, tcfg)
            data = torch.from_numpy(rows).to(device)
            mgr = None

            def batches(i):
                return batch_at(data, i, batch)

        run = _loop(step, batches, steps, device, lambda: params_of(model),
                    lambda p: load_params(model, p), ckpt, checkpoint_every,
                    watcher, model.health_spec, mgr)
        return {**report, "plan": model.grouping_summary()["segments"],
                "health": health_on, "program": step.kind, "idle": False,
                "incidents": watcher.incidents if watcher else [], **run}
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def train_mixture(arch: str, num_components: int, steps: int, batch=None,
                  assign: str = "hard", microbatches: int = 1,
                  mode: str = "stochastic", grouped: bool = True,
                  device=None, seed: int = 0, dataset: str = "synthetic",
                  data_dir: str = ds_lib.DEFAULT_DATA_DIR,
                  ckpt_dir: str = DEFAULT_CKPT_DIR,
                  checkpoint_every: int = 25) -> dict:
    """Build a mixture of ``num_components`` ``arch`` EiNets from ``seed``
    and run ``steps`` mixture EM steps on the ``dataset`` rows (hard: after
    k-means, per-cluster batches of ``batch // C`` rows; soft: shared
    batches of ``batch`` rows) in the fault-tolerant loop; returns the
    report."""
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
    run = _loop(step, lambda i: torch.from_numpy(
        loader.batch_at(i)["x"]).to(device), steps, device,
        lambda: mixture_params_of(mix),
        lambda p: load_mixture_params(mix, p),
        os.path.join(ckpt_dir, f"{cfg.name}_x{num_components}_{assign}"),
        checkpoint_every)
    return {"arch": cfg.name, "device": str(device),
            "batch": loader.per_host, "microbatches": microbatches,
            "mode": mode, "assign": assign, "components": num_components,
            "plan": mix.component.grouping_summary()["segments"],
            "tf32": tf32, "kmeans": km, "health": False,
            "program": step.kind, "incidents": [], **run}


def main(argv=None) -> dict:
    """The CLI on ``argv`` (default ``sys.argv[1:]``); returns the run's
    report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="registered EiNet config (required unless --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small RAT smoke config, health "
                         "telemetry on")
    ap.add_argument("--steps", type=int, default=None,
                    help="EM steps (default 8 with --smoke, else 20)")
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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="checkpoint root; a run writes under "
                         "<ckpt-dir>/<arch>/ and resumes from the newest "
                         "committed step there")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--health", action="store_true",
                    help="force health telemetry on (default: the model "
                         "knob, REPRO_HEALTH; implied by --smoke; one EiNet "
                         "only)")
    ap.add_argument("--on-divergence", choices=("abort", "continue"),
                    default="abort",
                    help="flight-recorder policy when the health vector "
                         "trips: dump an incident bundle then abort (raise) "
                         "or keep training")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="collect obs spans and export a Chrome-trace JSON "
                         "to this path at exit")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the metrics snapshot JSON (train.health.* "
                         "gauges included) to this path at exit")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's model dim (data = world // "
                         "this); at 2 or more the sharded step runs the "
                         "M-step on each rank's model shard")
    ap.add_argument("--dist-em", action="store_true",
                    help="the sharded EM step: statistics all-reduced over "
                         "the mesh's data dim (implied by several "
                         "processes; health off)")
    args = ap.parse_args(argv)
    if args.arch is None and not args.smoke:
        ap.error("--arch is required (or pass --smoke)")
    if args.steps is None:
        args.steps = 8 if args.smoke else 20
    if args.health and args.mixture >= 2:
        ap.error("--health needs a single EiNet (no --mixture)")
    multi = (torch.distributed.is_initialized()
             or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if args.mixture >= 2 and (args.dist_em or multi):
        raise SystemExit("--mixture does not compose with --dist-em / "
                         "multi-process yet; run single-process")
    obs.cli_begin(args.trace)
    if args.mixture >= 2:
        r = train_mixture(args.arch, args.mixture, args.steps, args.batch,
                          args.mixture_assign, args.microbatches,
                          args.em_mode, args.grouped, args.device,
                          dataset=args.dataset, data_dir=args.data_dir,
                          ckpt_dir=args.ckpt_dir,
                          checkpoint_every=args.checkpoint_every)
    else:
        r = train_einet(args.arch, args.steps, args.batch, args.microbatches,
                        args.em_mode, args.grouped, args.device,
                        dataset=args.dataset, data_dir=args.data_dir,
                        ckpt_dir=args.ckpt_dir,
                        checkpoint_every=args.checkpoint_every,
                        health=True if (args.smoke or args.health) else None,
                        on_divergence=args.on_divergence,
                        cfg=SMOKE_CONFIG if args.smoke else None,
                        dist_em=args.dist_em,
                        model_parallel=args.model_parallel)
        if r["idle"]:
            print(f"rank {r['rank']} of {r['world']} is not in the mesh "
                  f"{r['mesh']}: idle")
            obs.cli_end(args.trace, args.metrics)
            return r
    where = r["device"]
    if where.startswith("cuda"):
        where += f" ({torch.cuda.get_device_name(torch.device(where))})"
    what = f"{r['mode']} EM, batch {r['batch']}"
    if "components" in r:
        what = (f"mixture of {r['components']} components, {r['assign']} "
                f"{what}" + (" a component" if r["assign"] == "hard" else ""))
    print(f"{r['arch']} on {where}: plan {r['plan']}, {what} in "
          f"{r['microbatches']} microbatch(es); {r['program']} step program"
          f", health {'on' if r['health'] else 'off'}")
    if r.get("dist"):
        print(f"[dist] rank {r['rank']} of {r['world']}, mesh {r['mesh']}, "
              f"sharded EM step; {r['batch'] // r['dp_shards']} rows a rank")
    print(f"float32: matmul allow_tf32={r['tf32'][0]}, "
          f"cudnn allow_tf32={r['tf32'][1]}")
    if r.get("kmeans") is not None:
        km = r["kmeans"]
        print(f"k-means clusters: {km.counts.tolist()} (inertia "
              f"{km.inertia:.4f})")
    print(f"[ckpt] {r['ckpt_dir']}: resumed at step {r['resumed_at']}, "
          f"committed steps {r['checkpoints']}")
    lls = r["lls"]
    if lls:
        print(f"{len(r['step_ms'])} steps: median {r['median_ms']:.3f} "
              f"ms/step; mean LL first {lls[0]:.4f}, last {lls[-1]:.4f}")
        print("kernel launches per step (plain-version calls): "
              + ", ".join(f"{k} {n} ({p})" for k, (n, p)
                          in r["launches_per_step"].items()))
    ran = max(args.steps - r["resumed_at"], 0)
    print(f"{r['arch']}: {ran} steps, {r['run_s'] / max(ran, 1) * 1e3:.0f} "
          f"ms/step, dp_shards={r.get('dp_shards', 1)}, "
          f"restarts={r['restarts']}")
    if lls:
        print(f"objective: first {np.mean(lls[:5]):.3f} -> last "
              f"{np.mean(lls[-5:]):.3f}")
    obs.cli_end(args.trace, args.metrics)
    return r


if __name__ == "__main__":
    main()
