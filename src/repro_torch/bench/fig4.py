"""Fig. 4: EiNets as generative image models and tractable inpainting.
The port of the reference's ``benchmarks/bench_fig4.py``.

SVHN/CelebA are not downloadable here; a structured Gaussian-mixture image
proxy of the same kind (``repro_torch.data.synthetic``) stands in.  The
protocol follows §4.2: a PD structure with vertical splits (Delta splits),
factorized Gaussian leaves over channels, stochastic EM (lambda = 0.5,
through ``make_em_step``: captured graphs on the card), variance projected
to [1e-6, 1e-2] by the leaf family's ``project_phi``.

Outputs (``artifacts/fig4_torch/``):
  samples.npy        -- 16 unconditional samples (seeds 0-15)
  inpainted.npy      -- left-half evidence, right half sampled from p(.|e)
  originals.npy
CSV to stdout: metric,value -- the train LL trajectory and the inpainting
MSE of the argmax decode against a mean-imputation baseline (the
tractability payoff must beat it).

Sizes are the reference's: quick 12 x 12 x 3, 600 training rows, 3 epochs,
K = 8; full 24 x 24 x 3, 3,000 rows, 8 epochs, K = 16; batches of 128.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import bench
from repro_torch.core import Normal, poon_domingos
from repro_torch.core.einet import EiNet, resolve_device
from repro_torch.core.em import EMConfig
from repro_torch.data.synthetic import gaussian_mixture_images
from repro_torch.train import TrainConfig, make_em_step

SIZES = {True: dict(side=12, n_train=600, epochs=3, k=8),
         False: dict(side=24, n_train=3000, epochs=8, k=16)}
CHANNELS = 3
BATCH = 128
N_SHOW = 16
OUT_DIR = os.path.join("artifacts", "fig4_torch")


def build(side: int, k: int, device: torch.device) -> EiNet:
    g = poon_domingos(side, side, delta=max(2, side // 4),
                      num_channels=CHANNELS, axes=("w",))
    return EiNet(g, num_sums=k,
                 exponential_family=Normal(min_var=1e-6, max_var=1e-2),
                 device=device, seed=0)


def train(net: EiNet, train_x: np.ndarray, epochs: int) -> list:
    """Stochastic EM over shuffled batches of ``BATCH`` rows (epoch e's
    order from ``RandomState(e)``, the reference's); the last batch's LL of
    each epoch."""
    step = make_em_step(net, TrainConfig(em=EMConfig(step_size=0.5)))
    n = len(train_x)
    lls = []
    for ep in range(epochs):
        perm = np.random.RandomState(ep).permutation(n)
        for i in range(0, n - BATCH + 1, BATCH):
            ll = step(torch.from_numpy(train_x[perm[i: i + BATCH]])
                      .to(net.device))
        lls.append(ll)
    return lls


def left_half_mask(n: int, side: int) -> np.ndarray:
    mask = np.zeros((n, side, side, CHANNELS), bool)
    mask[:, :, : side // 2, :] = True
    return mask.reshape(n, -1)


def inpaint_mse(net: EiNet, test_x: np.ndarray, train_mean: np.ndarray,
                side: int) -> Dict[str, float]:
    """MSE over the unobserved right half of the argmax decode
    (``conditional_sample(mode="argmax")``: a draw would add the model's
    own output variance, which is not an error of the conditional) and of
    the training-mean fill."""
    mask = left_half_mask(len(test_x), side)
    with torch.inference_mode():
        recon = net.conditional_sample(
            torch.from_numpy(test_x).to(net.device),
            torch.from_numpy(mask).to(net.device), mode="argmax").cpu().numpy()
    mean_fill = np.where(mask, test_x, train_mean[None])
    m = ~mask
    return {"inpaint_mse": float(np.mean((recon - test_x)[m] ** 2)),
            "meanfill_mse": float(np.mean((mean_fill - test_x)[m] ** 2))}


def run(quick: bool = False, device=None, out_dir: str = OUT_DIR,
        load: Optional[Callable[[EiNet], None]] = None) -> Dict:
    """Train, sample, inpaint; ``load`` may write the initial parameters
    (default seed 0)."""
    dev = resolve_device(device)
    sz = SIZES[quick]
    side, n_train = sz["side"], sz["n_train"]
    data = gaussian_mixture_images(n_train + 64, side, side, CHANNELS, seed=0)
    train_x, test_x = data[:n_train], data[n_train:]
    net = build(side, sz["k"], dev)
    if load is not None:
        load(net)
    t0 = time.time()
    lls = train(net, train_x, sz["epochs"])
    train_time = time.time() - t0
    xt = test_x[:N_SHOW]
    mask = left_half_mask(N_SHOW, side)
    with torch.inference_mode():
        samples = net.sample(N_SHOW).cpu().numpy()
        inpainted = net.conditional_sample_per_key(
            range(N_SHOW), torch.from_numpy(xt).to(dev),
            torch.from_numpy(mask).to(dev)).cpu().numpy()
    mse = inpaint_mse(net, xt, train_x.mean(0), side)
    os.makedirs(out_dir, exist_ok=True)
    shape = (N_SHOW, side, side, CHANNELS)
    for name, arr in (("samples", samples), ("inpainted", inpainted),
                      ("originals", xt)):
        np.save(os.path.join(out_dir, f"{name}.npy"), arr.reshape(shape))
    return {
        "ll_first_epoch": lls[0],
        "ll_last_epoch": lls[-1],
        "train_s": train_time,
        **mse,
        "samples_finite": bool(np.isfinite(samples).all()),
    }


def gate(r: Dict) -> bool:
    """The reference's gate: EM learns and inpainting beats mean-fill."""
    return (r["ll_last_epoch"] > r["ll_first_epoch"]
            and r["inpaint_mse"] < r["meanfill_mse"])


def main(quick: bool = False, device=None) -> Dict:
    dev = resolve_device(device)
    r = run(quick, dev)
    print("metric,value")
    for k, v in r.items():
        print(f"{k},{v}")
    ok = gate(r)
    print(f"# EM learns + inpainting beats mean-fill: {ok}")
    bench.report("fig4", dev, ok=ok, **r)
    return r


if __name__ == "__main__":
    main()
