"""Fig. 4 workflow (PyTorch/CUDA port): a PD-structure EiNet as a
generative image model with tractable inpainting (argmax decoding given
arbitrary evidence masks).

PYTHONPATH=src python examples/image_inpainting_torch.py          # on CUDA
PYTHONPATH=src python examples/image_inpainting_torch.py --device cpu

The reference's ``examples/image_inpainting.py`` with the port's API: the
EM step is ``make_em_step``'s program, inpainting is the ``mpe`` query
kind (evidence kept, the rest decoded), samples the ``sample`` kind.
Writes ``artifacts/example_inpainting_torch/{originals,inpainted_<mask>,
samples}.npy`` and prints reconstruction metrics for three mask patterns:
ONE model answers all conditionals exactly, no retraining per mask (the
"multi-purpose predictor" property, paper Eq. 1).  ``main(argv)`` returns
the numbers it prints.
"""

import argparse
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import EiNet, Normal, poon_domingos
from repro_torch.core.em import EMConfig
from repro_torch.core.einet import resolve_device
from repro_torch.data import gaussian_mixture_images
from repro_torch.train import TrainConfig, make_em_step

H = W = 16
C = 3
OUT = "artifacts/example_inpainting_torch"


def masks(h: int, w: int, c: int) -> dict:
    """The observed-pixel patterns (True: observed), the reference's."""
    return {
        "left_half": np.tile((np.arange(w) < w // 2)[None, :, None],
                             (h, 1, c)),
        "top_half": np.tile((np.arange(h) < h // 2)[:, None, None],
                            (1, w, c)),
        "sparse_25pct": np.random.RandomState(0).rand(h, w, c) < 0.25,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--train-rows", type=int, default=4096)
    ap.add_argument("--test-rows", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--num-sums", type=int, default=12)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (pass --device cpu)") from None

    n_train = args.train_rows
    data = gaussian_mixture_images(n_train + args.test_rows, H, W, C, seed=0)
    train, test = data[:n_train], data[n_train:]
    graph = poon_domingos(H, W, delta=4, num_channels=C, axes=("w",))
    net = EiNet(graph, num_sums=args.num_sums,
                exponential_family=Normal(min_var=1e-6, max_var=1e-2),
                device=dev, seed=0)
    step = make_em_step(net, TrainConfig(em=EMConfig(step_size=0.5)))
    train_t = torch.from_numpy(train).to(dev)
    epoch_lls = []
    with obs.timed("example.train") as t_train:
        for epoch in range(args.epochs):
            for i in range(0, n_train, args.batch):
                ll = step(train_t[i: i + args.batch])
            epoch_lls.append(ll)
            print(f"epoch {epoch}: LL {ll:9.2f}")

    n = len(test)
    xt = torch.from_numpy(test).to(dev)
    seeds = torch.arange(n, device=dev)
    os.makedirs(args.out, exist_ok=True)
    np.save(f"{args.out}/originals.npy", test.reshape(-1, H, W, C))
    mean_img = train.mean(0)
    results = {}
    with obs.timed("example.inpaint") as t_inpaint:
        for name, m in masks(H, W, C).items():
            ev = torch.from_numpy(np.tile(m.reshape(1, -1), (n, 1))).to(dev)
            recon = net.query({"x": xt, "evidence_mask": ev,
                               "query_mask": ~ev, "seeds": seeds},
                              "mpe").cpu().numpy()
            observed = ev.cpu().numpy()
            missing = ~observed
            mse = float(np.mean((recon - test)[missing] ** 2))
            base = float(np.mean((np.tile(mean_img, (n, 1)) - test)[missing]
                                 ** 2))
            kept = bool(np.array_equal(recon[observed], test[observed]))
            print(f"{name:14s}: inpaint MSE {mse:.4f} vs mean-fill "
                  f"{base:.4f} ({'better' if mse < base else 'WORSE'}); "
                  f"observed pixels kept exactly: {kept}")
            np.save(f"{args.out}/inpainted_{name}.npy",
                    recon.reshape(-1, H, W, C))
            results[name] = {"mse": mse, "mean_fill_mse": base,
                             "observed_kept": kept}
    batch = {"x": torch.zeros((16, net.num_vars), device=dev),
             "evidence_mask": torch.zeros((16, net.num_vars),
                                          dtype=torch.bool, device=dev),
             "seeds": torch.arange(16, device=dev)}
    batch["query_mask"] = ~batch["evidence_mask"]
    samples = net.query(batch, "sample").cpu().numpy()
    np.save(f"{args.out}/samples.npy", samples.reshape(-1, H, W, C))
    print(f"wrote arrays to {args.out}/ (train {t_train.seconds:.2f} s, "
          f"inpainting {t_inpaint.seconds:.3f} s)")
    return {"epoch_lls": epoch_lls, "masks": results,
            "train_s": t_train.seconds, "inpaint_s": t_inpaint.seconds,
            "samples_finite": bool(np.isfinite(samples).all()),
            "device": dev.type, "out": args.out}


if __name__ == "__main__":
    main()
