"""Table 1: EiNet against the naive (LibSPN/SPFlow-style) implementation.
The port of the reference's ``benchmarks/bench_table1.py``.

The paper's Table 1 shows EiNets reproduce RAT-SPN test log-likelihoods on
the 20 binary datasets.  They are not downloadable here, so this checks
the *implementation claim* on identically-sized synthetic proxies
(``repro_torch.data.synthetic``), with the reference's Bernoulli RAT
(depth min(3, log2 D), 4 replicas, K = 8):

  1. LL parity: the einsum layers and the naive log-sum-exp layers compute
     the same circuit -- max |dLL| < 1e-3 on every dataset;
  2. EM trains: the test LL after the EM epochs (full-batch ``em_update``
     through ``make_em_step``) beats the initial model's on every dataset.

Profiles: quick is the reference's (the first 6 datasets, each cut to
``MAX_VARS`` variables, 3 EM epochs); full runs all 20 at each dataset's
own number of variables, uncut, with 10 epochs.  Both on 400 / 200 rows.

CSV: name,num_vars,ll_einsum,ll_naive,max_abs_diff,ll_after_em
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import bench
from repro_torch.core import Bernoulli, random_binary_trees
from repro_torch.core.baseline import NaiveEiNet
from repro_torch.core.einet import EiNet, resolve_device
from repro_torch.data.synthetic import TWENTY_DATASETS, binary_dataset
from repro_torch.train import TrainConfig, make_em_step

MAX_VARS = 200
N_TRAIN, N_TEST = 400, 200
HEADER = "name,num_vars,ll_einsum,ll_naive,max_abs_diff,ll_after_em"

Row = Tuple[str, int, float, float, float, float]


def dataset_row(name: str, dims: int, max_vars: Optional[int], epochs: int,
                device: torch.device,
                load: Optional[Callable[[EiNet], None]] = None) -> Row:
    """One dataset's row: both nets on the same parameters (seed 0, or what
    ``load`` writes into the EiNet), then ``epochs`` full EM updates of the
    EiNet on the training rows."""
    d = dims if max_vars is None else min(dims, max_vars)
    data = binary_dataset(name, N_TRAIN + N_TEST)[:, :d]
    train = torch.from_numpy(data[:N_TRAIN]).to(device)
    test = torch.from_numpy(data[N_TRAIN:]).to(device)
    depth = min(3, int(np.log2(d)))
    g = random_binary_trees(d, depth, 4, seed=0)
    net = EiNet(g, num_sums=8, exponential_family=Bernoulli(), device=device,
                seed=0)
    if load is not None:
        load(net)
    naive = NaiveEiNet(g, num_sums=8, exponential_family=Bernoulli(),
                       device=device, seed=0)
    naive.load_state_dict(net.state_dict())
    with torch.inference_mode():
        ll_e = net.log_likelihood(test)
        ll_n = naive.log_likelihood(test)
        diff = float(torch.max(torch.abs(ll_e - ll_n)))
    step = make_em_step(net, TrainConfig(mode="full"))
    for _ in range(epochs):
        step(train)
    with torch.inference_mode():
        ll_after = float(net.log_likelihood(test).mean())
    return (name, d, float(ll_e.mean()), float(ll_n.mean()), diff, ll_after)


def run(quick: bool = False, device=None,
        datasets: Optional[Sequence[Tuple[str, int]]] = None,
        epochs: Optional[int] = None,
        load: Optional[Callable[[EiNet], None]] = None) -> list:
    """The profile's rows; ``datasets`` and ``epochs`` override it (the
    variable cap stays the profile's)."""
    dev = resolve_device(device)
    if datasets is None:
        datasets = TWENTY_DATASETS[:6] if quick else TWENTY_DATASETS
    if epochs is None:
        epochs = 3 if quick else 10
    max_vars = MAX_VARS if quick else None
    return [dataset_row(name, dims, max_vars, epochs, dev, load)
            for name, dims in datasets]


def gate(rows) -> bool:
    """The reference's gate: parity below 1e-3 and EM beats the initial
    model on every dataset."""
    return all(r[4] < 1e-3 and r[5] > r[2] for r in rows)


def main(quick: bool = False, device=None) -> bool:
    dev = resolve_device(device)
    t0 = time.time()
    rows = run(quick, dev)
    print(HEADER)
    for r in rows:
        print(",".join(str(x) for x in r))
    ok = gate(rows)
    seconds = time.time() - t0
    print(f"# parity+improvement on all datasets: {ok}; {seconds:.1f}s")
    bench.report(
        "table1", dev, ok=ok, datasets=len(rows), seconds=seconds,
        max_abs_diff=max(r[4] for r in rows))
    return ok


if __name__ == "__main__":
    main()
