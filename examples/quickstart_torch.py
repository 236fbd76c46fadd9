"""Quickstart (PyTorch/CUDA port): build an Einsum Network, train it with
stochastic EM, and run the tractable-inference queries the paper is about.

PYTHONPATH=src python examples/quickstart_torch.py               # on CUDA
PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The reference's ``examples/quickstart.py`` with the port's API: the step
is ``make_em_step``'s program (captured CUDA graphs on the card), which
writes the model's parameters in place, and every query goes through
``EiNet.query`` by kind.  ``main(argv)`` returns the numbers it prints.
"""

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import EiNet, Normal, random_binary_trees
from repro_torch.core.em import EMConfig
from repro_torch.core.einet import resolve_device
from repro_torch.train import TrainConfig, make_em_step


def device_of(name):
    """The example's device: CUDA unless ``--device cpu``."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (pass --device cpu)") from None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--num-vars", type=int, default=32)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    d = args.num_vars

    # 1. structure: a RAT region graph (paper §4.1)
    graph = random_binary_trees(num_vars=d, depth=3, num_repetitions=4,
                                seed=0)
    net = EiNet(graph, num_sums=8, exponential_family=Normal(), device=dev,
                seed=0)
    print(f"EiNet: {net.leaf_spec.num_leaves} leaves, "
          f"{len(net.pair_specs)} einsum layers, "
          f"{net.num_params():,} parameters, on {dev.type}")

    # 2. data: two Gaussian clusters
    rng = np.random.RandomState(0)
    centers = rng.randn(2, d) * 2
    data = torch.from_numpy(
        (centers[rng.randint(2, size=args.rows)]
         + rng.randn(args.rows, d) * 0.5).astype(np.float32)).to(dev)

    # 3. train: autodiff-EM (one autograd pass per E-step -- paper §3.5);
    # the step program updates the model in place and returns the batch LL
    step = make_em_step(net, TrainConfig(em=EMConfig(step_size=0.5)))
    epoch_lls = []
    with obs.timed("example.train") as t_train:
        for epoch in range(args.epochs):
            for i in range(0, args.rows, args.batch):
                ll = step(data[i: i + args.batch])
            epoch_lls.append(ll)
            print(f"epoch {epoch}: batch mean log-likelihood {ll:8.3f}")

    # 4. exact inference (the point of tractable models), by query kind
    x = data[:4]
    marg = torch.zeros((4, d), dtype=torch.bool, device=dev)
    marg[:, : d // 2] = True  # observe vars 0..15, marginalize the rest
    q = ~marg
    batch = {"x": x, "evidence_mask": marg, "query_mask": q,
             "seeds": torch.arange(4, device=dev)}
    out = {kind: net.query(batch, kind).cpu().numpy()
           for kind in ("joint_ll", "marginal_ll", "conditional_ll",
                        "sample", "conditional_sample", "mpe")}
    print("\nlog p(x):", np.round(out["joint_ll"], 2))
    print(f"log p(x_0..{d // 2 - 1}):", np.round(out["marginal_ll"], 2))
    print(f"log p(x_{d // 2}.. | x_0..{d // 2 - 1}):",
          np.round(out["conditional_ll"], 2))
    print("\n3 samples, first 6 dims:\n", np.round(out["sample"][:3, :6], 2))
    print(f"inpainted (vars {d // 2}.. resampled | vars 0..{d // 2 - 1} "
          "observed), first row:",
          np.round(out["conditional_sample"][0, d // 2 - 2: d // 2 + 4], 2))
    print(f"trained {args.epochs} epochs in {t_train.seconds:.2f} s")
    return {"epoch_lls": epoch_lls, "train_s": t_train.seconds,
            "device": dev.type, "x": x.cpu().numpy(),
            "evidence_mask": marg.cpu().numpy(), **out}


if __name__ == "__main__":
    main()
