"""Model construction from a registered config, shared by the launch CLIs,
and the dry run's EM-step cells (``capture_einet_cell``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import compile as compile_lib
from repro_torch.configs import EinetConfig
from repro_torch.core import Normal, poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.core.exponential_family import make_exponential_family
from repro_torch.dist import sharding as shlib
from repro_torch.mixture.model import EiNetMixture


def build_einet(cfg: EinetConfig, device=None, seed: int = 0,
                grouped: bool = True) -> EiNet:
    """The config's EiNet with parameters initialised from ``seed``, on
    ``device`` (CUDA unless ``device="cpu"``); ``grouped=False`` plans every
    pair as its own layer segment."""
    if cfg.structure == "pd":
        graph = poon_domingos(
            cfg.height, cfg.width, cfg.delta, cfg.num_channels, cfg.pd_axes
        )
    else:
        graph = random_binary_trees(cfg.num_vars, cfg.depth, cfg.num_repetitions)
    if cfg.exponential_family == "normal":
        ef = Normal(min_var=cfg.min_var, max_var=cfg.max_var)
    elif cfg.exponential_family == "binomial":
        # 8-bit image data modelled as counts, the paper's MNIST treatment
        ef = make_exponential_family("binomial", n_trials=255)
    elif cfg.exponential_family == "categorical":
        ef = make_exponential_family("categorical", num_categories=256)
    else:
        raise ValueError(
            f"{cfg.name}: unsupported leaf family {cfg.exponential_family!r}"
        )
    return EiNet(graph, num_sums=cfg.num_sums, num_classes=cfg.num_classes,
                 exponential_family=ef, grouped=grouped, device=device,
                 seed=seed)


def build_mixture(cfg: EinetConfig, num_components: int, device=None,
                  seed: int = 0, grouped: bool = True) -> EiNetMixture:
    """A mixture of ``num_components`` of the config's EiNets (the §4.2
    model) over one shared structure, parameters initialised from ``seed``,
    on ``device`` (CUDA unless ``device="cpu"``)."""
    return EiNetMixture(build_einet(cfg, device=device, seed=seed,
                                    grouped=grouped),
                        num_components, seed=seed)


# ---------------------------------------------------------------- dry run
# the production meshes of the dry run: dims, shape and file tag
MESHES = {
    "single": (("data", "model"), (16, 16), "16x16"),
    "multi": (("pod", "data", "model"), (2, 16, 16), "2x16x16"),
}
# archs whose step runs in microbatches of this many rows (as
# einet_rat_large's 65,536-row step does on the card)
MICROBATCH_ROWS = {"einet-rat-large": 1024}


def mesh_axis_sizes(mesh_kind: str) -> Dict[str, int]:
    names, shape, _ = MESHES[mesh_kind]
    return dict(zip(names, shape))


def cell_rows(cfg: EinetConfig, mesh_kind: str) -> int:
    """One data rank's rows of the config's global batch on the mesh: the
    batch's leading dim as ``dist.sharding.batch_shardings`` splits it
    (resolved from the mesh's shape with ``resolve_spec``; a batch that
    does not divide is replicated, so a rank holds all of it)."""
    sizes = mesh_axis_sizes(mesh_kind)
    rules = shlib.default_rules(mesh_kind == "multi", fsdp=False)
    d = (cfg.height * cfg.width * cfg.num_channels if cfg.structure == "pd"
         else cfg.num_vars)
    spec = shlib.resolve_spec(("batch", None), (cfg.batch_size, d), sizes,
                              rules)
    split = 1
    if spec:
        entry = spec[0]
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            split *= sizes[name]
    return cfg.batch_size // split


def cell_microbatches(cfg: EinetConfig, rows: int) -> int:
    """Microbatches of a ``rows``-row step of ``cfg`` (1 unless the arch
    runs in ``MICROBATCH_ROWS``-row pieces)."""
    mb = MICROBATCH_ROWS.get(cfg.name)
    if mb is None or rows <= mb:
        return 1
    if rows % mb:
        raise ValueError(f"{cfg.name}: {rows} rows do not split into "
                         f"{mb}-row microbatches")
    return rows // mb


def domain_data(model: EiNet, batch: int) -> np.ndarray:
    """A (batch, D) batch in the arch's leaf family's data domain (lgamma
    and one-hot blow up on out-of-domain floats): the reference's probe
    draws, seed 0."""
    rng = np.random.RandomState(0)
    name = model.ef.name
    if name == "binomial":
        hi = model.ef.n_trials
        return rng.randint(0, hi + 1, (batch, model.num_vars)).astype(
            np.float32)
    if name == "categorical":
        hi = model.ef.num_categories
        return rng.randint(0, hi, (batch, model.num_vars)).astype(np.float32)
    if name == "bernoulli":
        return rng.randint(0, 2, (batch, model.num_vars)).astype(np.float32)
    return rng.randn(batch, model.num_vars).astype(np.float32)


def capture_einet_cell(cfg: EinetConfig, mesh_kind: str, device=None,
                       registry=None, rows: Optional[int] = None,
                       microbatches: Optional[int] = None,
                       capture: bool = True, model: Optional[EiNet] = None
                       ) -> Dict[str, Any]:
    """The EM-step cell of ``cfg`` on ``mesh_kind``: the counterpart of
    the reference's ``lower_einet_cell``.

    One data rank's share of the global batch (``cell_rows``; ``rows``
    overrides it, ``microbatches`` the split) goes through
    ``make_em_step``'s stages twice: once counted, eagerly, under the step
    cost counter (``launch.cost``; the parameters restored after), and once
    captured by ``StepProgram.capture`` through ``registry`` (default
    ``compile.REGISTRY``), which captures and runs no step (``capture``
    False skips it).  The collectives of the sharded step on that mesh are
    counted analytically.  Returns the counts, the captured graphs
    (``"graphs"``, a ``compile.StepGraphs``; None without a capture, and
    for a CPU model, whose step program is eager) and the model."""
    from repro_torch.launch import cost as cost_lib
    from repro_torch.train import TrainConfig, make_em_step
    from repro_torch.train.pipeline import em_stages, resolve_step_health

    model = model if model is not None else build_einet(cfg, device=device)
    rows = cell_rows(cfg, mesh_kind) if rows is None else int(rows)
    n = (cell_microbatches(cfg, rows) if microbatches is None
         else int(microbatches))
    tcfg = TrainConfig(num_microbatches=n, health=False)
    x = torch.from_numpy(domain_data(model, rows)).to(model.device)
    counted = cost_lib.count_staged_step(
        model, em_stages(tcfg, resolve_step_health(model, tcfg)), x)
    coll = cost_lib.collective_costs(model, mesh_axis_sizes(mesh_kind))
    out = {"model": model, "rows": rows, "microbatches": n,
           "cost": counted, **coll, "graphs": None}
    if capture:
        prog = make_em_step(model, tcfg, registry)
        # a CPU model's program is eager: it has no graphs to capture
        if isinstance(prog, compile_lib.StepProgram):
            out["graphs"] = prog.capture(x)
    return out
