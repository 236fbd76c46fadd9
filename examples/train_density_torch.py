"""End-to-end training driver (PyTorch/CUDA port): a multi-million-parameter
EiNet density model trained for a few hundred stochastic-EM steps with the
production stack -- the sharded data pipeline, the fault-tolerant loop,
atomic async checkpoints, restart-and-continue.

PYTHONPATH=src python examples/train_density_torch.py [--steps 200] [--kill-at 120]
PYTHONPATH=src python examples/train_density_torch.py --device cpu ...

``--kill-at`` injects a simulated node failure mid-run: the loop restores
the newest committed checkpoint (or the initial parameters before the
first one) and replays from there, and the final LL equals an
uninterrupted run's bit for bit.  The reference's
``examples/train_density.py`` with the port's API: the step is
``make_em_step``'s program, which writes the model's parameters in place,
so the loop's state holds views of them and a restored state is written
back into the model (``load_state``).  ``main(argv)`` returns the numbers
it prints.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import EiNet, Normal, random_binary_trees
from repro_torch.core.em import EMConfig, load_params, params_of
from repro_torch.core.einet import resolve_device
from repro_torch.data import datasets as ds_lib
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.data.synthetic import gaussian_mixture_images
from repro_torch.dist import fault_tolerance as ft
from repro_torch.train import TrainConfig, make_em_step


def resolve_data(args) -> np.ndarray:
    """(N, D) float32 training rows for --dataset.  An image dataset is the
    deterministic procedural stand-in unless --source asks for the cache
    (or a download)."""
    if args.dataset == "synthetic":
        return gaussian_mixture_images(args.rows, 16, 16, 3, seed=1)
    ds = ds_lib.load_image_dataset(args.dataset, source=args.source)
    print(f"dataset {args.dataset} ({ds.source}): {len(ds.train_x)} rows")
    data, _ = ds_lib.to_domain(ds.train_x, "normal")
    return data


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    return tree.clone()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--num-sums", type=int, default=16)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--rows", type=int, default=8192,
                    help="synthetic rows")
    ap.add_argument("--dataset", choices=("synthetic", "mnist", "svhn"),
                    default="synthetic")
    ap.add_argument("--source", default="procedural",
                    help="image data: procedural (offline, default), auto "
                         "(the cache, then a download)")
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (pass --device cpu)") from None

    data = resolve_data(args)
    d = data.shape[1]
    graph = random_binary_trees(d, depth=args.depth,
                                num_repetitions=args.reps, seed=0)
    net = EiNet(graph, num_sums=args.num_sums,
                exponential_family=Normal(min_var=1e-6, max_var=1e-2),
                device=dev, seed=0)
    print(f"model: {net.num_params():,} parameters, "
          f"{len(net.pair_specs)} einsum layers, on {dev.type}")

    def make_batch(step, shard, n):
        idx = (np.arange(n) + step * n + shard * 10_007) % len(data)
        return {"x": data[idx]}

    loader = ShardedLoader(make_batch, global_batch=args.batch)
    # one step program (repro_torch.train): it writes the parameters in
    # place, so the loop's states hold views of them
    step_fn_prog = make_em_step(net, TrainConfig(em=EMConfig(step_size=0.3)))
    lls = {}  # step -> LL; a replayed step overwrites its entry

    def step_fn(state, batch):
        ll = step_fn_prog(torch.from_numpy(batch["x"]).to(dev))
        lls[state["step"]] = ll
        return {"params": params_of(net), "step": state["step"] + 1}

    def load_state(state):
        # a state the loop resumes from (the initial snapshot, a restored
        # checkpoint) is written into the model in place
        load_params(net, state["params"])
        return {"params": params_of(net), "step": int(state["step"])}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="einet_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    killed = set()

    def injector(step):
        if args.kill_at is not None and step == args.kill_at \
                and step not in killed:
            killed.add(step)
            raise RuntimeError("simulated preemption")

    with obs.timed("example.train") as t:
        state, stats = ft.run_training(
            step_fn,
            {"params": _snapshot(params_of(net)), "step": 0},
            loader.batch_at, mgr, num_steps=args.steps,
            cfg=ft.LoopConfig(checkpoint_every=args.checkpoint_every),
            fail_injector=injector, load_state=load_state)
    curve = [lls[i] for i in range(args.steps)]
    print(f"trained {args.steps} steps in {t.seconds:.1f}s "
          f"({t.seconds / args.steps * 1e3:.0f} ms/step), "
          f"restarts={stats['restarts']}")
    first = float(np.mean(curve[:10]))
    last = float(np.mean(curve[-10:]))
    print(f"LL: first10 {first:8.2f} -> last10 {last:8.2f}")
    test = torch.from_numpy(data[:512]).to(dev)
    with torch.inference_mode():
        final = float(net.log_likelihood(test).mean())
    print(f"final mean test LL: {final:.2f}")
    print(f"checkpoints in {ckpt_dir}: steps {mgr.all_steps()}")
    return {"lls": curve, "first10": first, "last10": last,
            "final_test_ll": final, "restarts": stats["restarts"],
            "train_s": t.seconds, "checkpoints": mgr.all_steps(),
            "num_params": net.num_params(), "device": dev.type}


if __name__ == "__main__":
    main()
