"""End-to-end image-evaluation runs: the engine behind
``repro_torch.launch.eval``.

One :func:`run_eval` call is the paper's Fig. 4 / §4.2 protocol in
miniature:

  1. resolve the dataset (synthetic / MNIST / SVHN / CelebA; ``--smoke`` and
     offline hosts use the deterministic procedural fallback),
  2. build a PD-structure EiNet matched to the image grid and leaf family
     on ``cfg.device`` (CUDA unless the caller asks for the CPU) -- or, with
     ``mixture=C``, the §4.2 mixture of EiNets: k-means clusters the train
     split (``repro_torch.mixture.cluster``) and hard EM trains each
     component on its cluster,
  3. train by stochastic EM (``repro_torch.train.fit`` /
     ``repro_torch.mixture.fit_mixture``),
  4. stream the test split through the serving engine for bits-per-dim
     (joint + marginal), run the Fig. 4 inpainting harness and a sample
     grid -- every query through ``repro_torch.serve`` (mixture runs use the
     ``mixture_*`` kinds), parity-audited against direct query calls,
  5. write PNG grids + a metrics JSON under ``artifacts/eval_torch/<run>/``.

The returned record is flat JSON with the reference's keys
(``repro.eval.workbench``); ``parity_mismatches_total`` is the acceptance
gate (must be exactly 0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.configs import EinetConfig
from repro_torch.core.einet import resolve_device
from repro_torch.data import datasets as ds_lib
from repro_torch.eval import grids as grids_lib
from repro_torch.eval.inpainting import run_inpainting
from repro_torch.eval.masks import MASK_KINDS, make_mask
from repro_torch.eval.metrics import (
    bits_per_dim,
    engine_log_likelihoods,
    evaluate_bpd,
    parity_report,
)
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import TrainConfig, fit

EVAL_DATASETS = ("synthetic", "mnist", "svhn", "celeba")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """One evaluation run.  ``smoke`` shrinks every knob to CI size and
    forces the offline procedural dataset source."""

    dataset: str = "synthetic"
    family: str = "normal"  # leaf EF: normal | binomial | categorical
    smoke: bool = False
    steps: int = 80  # stochastic-EM training steps before eval
    batch: int = 128
    num_sums: int = 16
    delta: Optional[int] = None  # PD grid coarseness (None = per-dataset)
    data_dir: str = ds_lib.DEFAULT_DATA_DIR
    source: str = "auto"  # auto | download | procedural
    out_dir: str = "artifacts/eval_torch"
    run_name: Optional[str] = None
    max_batch: int = 32  # engine micro-batch cap
    eval_rows: int = 256  # test rows streamed for bpd
    inpaint_rows: int = 8  # images per mask kind in the Fig. 4 harness
    num_samples: int = 16
    mask_kinds: Sequence[str] = MASK_KINDS
    marginal_mask: str = "left_half"  # mask for the marginal-bpd record
    seed: int = 0
    # §4.2 mixture-of-EiNets: number of k-means-clustered components
    # (0 / 1 = a single EiNet)
    mixture: int = 0
    # "cuda" (None) or "cpu"; without a card only "cpu" runs
    device: Optional[str] = None


def resolve_dataset(cfg: EvalConfig) -> ds_lib.ImageDataset:
    if cfg.dataset == "synthetic":
        if cfg.smoke:
            return ds_lib.synthetic_image_dataset(
                8, 8, 1, num_train=512, num_test=96, seed=cfg.seed
            )
        return ds_lib.synthetic_image_dataset(16, 16, 3, seed=cfg.seed)
    source = "procedural" if cfg.smoke else cfg.source
    return ds_lib.load_image_dataset(
        cfg.dataset, data_dir=cfg.data_dir, source=source,
        size_cap=1024 if cfg.smoke else None,
    )


def pd_config_for(cfg: EvalConfig, spec: ds_lib.ImageSpec) -> EinetConfig:
    """The PD image-grid config for this dataset's geometry (28x28 MNIST,
    32x32 SVHN/CelebA, or the synthetic grid), shrunk under ``--smoke``."""
    delta = cfg.delta
    if delta is None:
        delta = {"mnist": 7, "svhn": 8, "celeba": 8}.get(
            spec.name, max(spec.height // 4, 2)
        )
    if cfg.smoke:
        delta = max(delta, spec.height // 2)
    return EinetConfig(
        name=f"einet-pd-{spec.name}-eval",
        structure="pd",
        height=spec.height,
        width=spec.width,
        num_channels=spec.channels,
        delta=delta,
        pd_axes=("w",),
        num_sums=4 if cfg.smoke else cfg.num_sums,
        exponential_family=cfg.family,
        min_var=1e-6,
        max_var=1e-2,  # the paper's image-leaf variance clamp
        batch_size=cfg.batch,
    )


def _train(model, cfg: EvalConfig, train_x: np.ndarray) -> List[float]:
    """Stochastic EM on ``array_loader`` batches of the train split (``fit``
    moves each to the model's device); returns the per-step mean LLs."""
    steps = min(cfg.steps, 25) if cfg.smoke else cfg.steps
    batch = min(cfg.batch, len(train_x))
    loader = ds_lib.array_loader(train_x, batch)
    return fit(model, loader, TrainConfig(), num_steps=steps)


def _train_mixture(mix, cfg: EvalConfig, train_x: np.ndarray
                   ) -> Tuple[List[float], Any]:
    """The §4.2 protocol: k-means the train split, seed the mixture weights
    with the cluster proportions, and run hard EM over stacked per-cluster
    batches.  Returns (lls, KMeansResult)."""
    from repro_torch.mixture import (
        MixtureTrainConfig,
        fit_mixture,
        prepare_mixture_training,
    )

    loader, km = prepare_mixture_training(
        mix, train_x, seed=cfg.seed, global_batch=cfg.batch,
        kmeans_iters=10 if cfg.smoke else 25,
    )
    steps = min(cfg.steps, 25) if cfg.smoke else cfg.steps
    lls = fit_mixture(mix, loader, MixtureTrainConfig(), num_steps=steps)
    return lls, km


def _sample_grid(
    model,
    engine: ServeEngine,
    cfg: EvalConfig,
    kind: str = "sample",
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Unconditional samples through the engine + parity record."""
    reqs = [
        Request(req_id=i, kind=kind, seed=7_000_000 + cfg.seed * 10_007 + i)
        for i in range(cfg.num_samples)
    ]
    engine.warmup(kinds=[kind])
    results = engine.run(reqs)
    samples = np.stack([results[i].value for i in range(cfg.num_samples)])
    par = parity_report(model, reqs, results, rows=None)
    return samples, par


def run_eval(cfg: EvalConfig, model=None) -> Dict[str, Any]:
    """The full workbench run; pass ``model`` (an EiNet or EiNetMixture on
    ``cfg.device``, matching the dataset geometry) to skip training and
    evaluate it as it is."""
    if cfg.dataset not in EVAL_DATASETS:
        raise KeyError(
            f"unknown eval dataset {cfg.dataset!r}; one of {EVAL_DATASETS}"
        )
    device = resolve_device(cfg.device)
    if model is not None and model.device.type != device.type:
        raise ValueError(f"model is on {model.device}, the config asks for "
                         f"{device}")
    t_start = obs.now()
    dataset = resolve_dataset(cfg)
    spec = dataset.spec
    train_x, _ = ds_lib.to_domain(dataset.train_x, cfg.family)
    test_x, offset_bits = ds_lib.to_domain(dataset.test_x, cfg.family)
    vmax = 1.0 if cfg.family == "normal" else 255.0

    lls: list = []
    km = None
    if model is None:
        from repro_torch.launch.cells import build_einet

        base = build_einet(pd_config_for(cfg, spec), device=device,
                           seed=cfg.seed)
        if int(cfg.mixture) >= 2:
            from repro_torch.mixture import EiNetMixture

            model = EiNetMixture(base, int(cfg.mixture), seed=cfg.seed)
            lls, km = _train_mixture(model, cfg, train_x)
        else:
            model = base
            lls = _train(model, cfg, train_x)
    assert model.num_vars == spec.num_dims, (
        f"model covers {model.num_vars} vars, dataset has {spec.num_dims}"
    )
    is_mixture = hasattr(model, "num_components")
    prefix = "mixture_" if is_mixture else ""

    engine = ServeEngine(model, max_batch=cfg.max_batch)

    # -- bits per dim: joint on the test split, marginal under one mask ----
    eval_x = test_x[: cfg.eval_rows]
    bpd_joint = evaluate_bpd(
        model, eval_x, offset_bits=offset_bits, engine=engine,
        parity_rows=None if cfg.smoke else 64, kind=prefix + "joint_ll",
    )
    marg_ev = make_mask(cfg.marginal_mask, spec.height, spec.width,
                        spec.channels, seed=cfg.seed)
    marg = engine_log_likelihoods(
        model, eval_x, kind=prefix + "marginal_ll",
        evidence_mask=marg_ev,
        engine=engine, parity_rows=None if cfg.smoke else 64,
    )
    n_ev = int(np.sum(marg_ev))
    bpd_marginal = bits_per_dim(float(np.mean(marg.ll)), n_ev, offset_bits)

    # -- Fig. 4 inpainting + sample grid (exhaustively parity-audited) ----
    inp = run_inpainting(
        model, test_x[: cfg.inpaint_rows], spec.height, spec.width,
        spec.channels, mask_kinds=cfg.mask_kinds,
        mean_fill=train_x.mean(axis=0), engine=engine, seed=cfg.seed,
        parity_rows=None,
        kinds=(prefix + "conditional_sample", prefix + "mpe"),
    )
    samples, sample_par = _sample_grid(model, engine, cfg,
                                       kind=prefix + "sample")

    # -- artifacts --------------------------------------------------------
    run_name = cfg.run_name or (
        f"{spec.name}_{cfg.family}"
        # from the model, not cfg.mixture: prebuilt mixtures passed in with
        # the default cfg still label their artifacts correctly
        + (f"_mix{int(model.num_components)}" if is_mixture else "")
        + ("_smoke" if cfg.smoke else "")
    )
    out = f"{cfg.out_dir}/{run_name}"
    pngs = {
        "samples": grids_lib.save_image_grid(
            f"{out}/samples.png",
            samples.reshape(-1, spec.height, spec.width, spec.channels),
            vmax=vmax,
        )
    }
    for mk in cfg.mask_kinds:
        pngs[f"inpaint_{mk}"] = grids_lib.save_inpainting_grid(
            f"{out}/inpaint_{mk}.png",
            test_x[: cfg.inpaint_rows], inp.evidence_masks[mk],
            inp.recon(mk, "conditional_sample"), inp.recon(mk, "mpe"),
            spec.height, spec.width, spec.channels, vmax=vmax,
        )

    mismatches = (
        bpd_joint["parity_mismatches"] + marg.parity_mismatches
        + inp.metrics["parity_mismatches"] + sample_par["parity_mismatches"]
    )
    record = {
        "run_name": run_name,
        "dataset": spec.name,
        "dataset_source": dataset.source,
        "family": cfg.family,
        "smoke": cfg.smoke,
        "mixture_components": (
            int(model.num_components) if is_mixture else 0
        ),
        "cluster_sizes": (
            km.counts.tolist() if km is not None else None
        ),
        "cluster_inertia": (
            float(km.inertia) if km is not None else None
        ),
        "height": spec.height,
        "width": spec.width,
        "channels": spec.channels,
        "num_dims": spec.num_dims,
        "num_params": model.num_params(),
        "train_steps": len(lls),
        "train_ll_first": float(lls[0]) if lls else None,
        "train_ll_last": float(lls[-1]) if lls else None,
        "bpd_joint": bpd_joint,
        "bpd_marginal": {
            "mask": cfg.marginal_mask,
            "evidence_dims": n_ev,
            "mean_ll": float(np.mean(marg.ll)),
            "bpd": bpd_marginal,
            "parity_mismatches": marg.parity_mismatches,
        },
        "inpainting": inp.metrics,
        "samples_parity_mismatches": sample_par["parity_mismatches"],
        "parity_mismatches_total": int(mismatches),
        "engine_programs": engine.num_programs,
        "engine_stats": dict(engine.stats),
        "artifacts": pngs,
        "wall_seconds": obs.now() - t_start,
    }
    grids_lib.save_metrics_json(f"{out}/metrics.json", record)
    return record
