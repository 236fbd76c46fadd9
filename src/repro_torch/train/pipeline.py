"""The EM training step: E-step statistics accumulated over microbatches,
the M-step, and for stochastic EM the Sato blend, applied to the module.

The reference compiles the whole update into one donated-buffer XLA program
through its registry's ``jit`` and folds the microbatches with
``lax.scan``.  Here :func:`make_em_step` goes through the port's registry
(``repro_torch.compile.ProgramRegistry.jit``): on the card the step is
captured CUDA graphs -- at one microbatch one graph of the whole step; at
more, one graph of a microbatch's E-step that adds into static
accumulators, replayed once a microbatch in order, and one graph of the
M-step and blend -- and on the CPU the same stages run op by op.  The
step writes the new parameters into the module in place (``copy_``),
which is what donation bought the reference, so the graphs and any
serving programs of the model stay valid.

:func:`make_sharded_em_step` is the multi-rank form: the same stages with
the statistics all-reduced over the mesh's data dims between the E-step
graph and the M-step graph, never inside a graph.

The op-by-op updates (:func:`stochastic_em_update_microbatched`,
:func:`em_update_microbatched`, with ``em.load_params``) stay: they are
the oracle the step programs are held against.

With health telemetry on (``TrainConfig.health``, else the model's
``health`` knob), the step also builds the health vector
(``repro_torch.obs.health``) inside the same program: a probe forward
under the tap collector on the whole batch at one microbatch, on the
first microbatch otherwise, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.core.einet import EiNet
from repro_torch.core.em import (
    EMConfig,
    accumulate_statistics,
    blend_params,
    em_statistics,
    load_params,
    m_step,
    params_of,
    zeros_like_statistics,
)
from repro_torch.dist import sharding as shlib
from repro_torch.obs import health as health_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One EM update step.

    mode: "stochastic" (Sato online EM, the paper's minibatch training) or
      "full" (exact M-step from the whole batch).
    num_microbatches: split the batch into this many pieces; bounds
      activation memory at batch / num_microbatches rows while keeping the
      statistics exact (they are sums over data).
    """

    em: EMConfig = EMConfig()
    mode: str = "stochastic"  # "stochastic" | "full"
    num_microbatches: int = 1
    health: Optional[bool] = None
    """Build the health vector (``repro_torch.obs.health``) as a second
    step output.  None defers to the model's ``health`` knob (which itself
    defers to ``REPRO_HEALTH``); the resolved flag is part of the step's
    registry key, so toggling it selects another cached program."""
    axis_names: Optional[Sequence[str]] = None
    """Mesh dims the sharded step sums the statistics over
    (:func:`make_sharded_em_step`); None: every data dim of the mesh."""


def split_microbatches(x: torch.Tensor, num_microbatches: int):
    """``x`` as ``num_microbatches`` equal pieces along its first axis, in
    order; raises when the batch does not divide."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {num_microbatches} microbatches")
    return x.split(b // num_microbatches)


def microbatched_em_statistics(model: EiNet, x: torch.Tensor,
                               num_microbatches: int = 1) -> Dict[str, Any]:
    """E-step statistics for ``x``, summed over ``num_microbatches`` equal
    pieces in order (the same totals as one call, to float32 rounding)."""
    if num_microbatches == 1:
        return em_statistics(model, x)
    acc = zeros_like_statistics(model)
    for xb in split_microbatches(x, num_microbatches):
        acc = accumulate_statistics(acc, em_statistics(model, xb))
    return acc


def em_update_microbatched(model: EiNet, x: torch.Tensor,
                           cfg: EMConfig = EMConfig(),
                           num_microbatches: int = 1):
    """One full EM update (monotone on the batch), microbatch-accumulated.
    Returns (new params dict, mean LL); the module is unchanged."""
    stats = microbatched_em_statistics(model, x, num_microbatches)
    return m_step(model, stats, cfg), stats["ll"] / stats["count"]


def stochastic_em_update_microbatched(model: EiNet, x: torch.Tensor,
                                      cfg: EMConfig = EMConfig(),
                                      num_microbatches: int = 1):
    """Sato online EM (Eqs. 8/9) with microbatch-accumulated statistics.
    Returns (new params dict, mean LL); the module is unchanged."""
    stats = microbatched_em_statistics(model, x, num_microbatches)
    mini = m_step(model, stats, cfg)
    new = blend_params(model, params_of(model), mini, cfg.step_size)
    return new, stats["ll"] / stats["count"]


def _probe_slice(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """The rows the health forward runs on: the whole batch at one
    microbatch, the first microbatch otherwise."""
    return x[: x.shape[0] // max(num_microbatches, 1)]


def _new_params(model: EiNet, stats: Dict[str, Any],
                cfg: TrainConfig) -> Dict[str, Any]:
    """The M-step from ``stats`` and, for stochastic EM, its blend into the
    module's current parameters."""
    mini = m_step(model, stats, cfg.em)
    if cfg.mode == "full":
        return mini
    return blend_params(model, params_of(model), mini, cfg.em.step_size)


def em_stages(cfg: TrainConfig, health: bool) -> compile_lib.StagedStep:
    """The step of ``cfg`` as the stages its program captures.  The stage
    functions take the model as an argument and hold no reference to it,
    so a registry anchored on the model can release it."""
    n = cfg.num_microbatches

    def body(model, acc, xb):
        stats = em_statistics(model, xb)
        with torch.no_grad():
            for a, b in zip(tree_lib.flatten(acc)[1],
                            tree_lib.flatten(stats)[1]):
                a.add_(b)

    def finish(model, acc, x):
        stats = em_statistics(model, x) if acc is None else acc
        new = _new_params(model, stats, cfg)
        out = (stats["ll"] / stats["count"],)
        if health:
            # the probe runs on the parameters the E-step ran on, before
            # the new ones are written
            out += (health_lib.health_vector(model, _probe_slice(x, n),
                                             stats, new),)
        load_params(model, new)
        return out

    def result(outs):
        return (float(outs[0]), outs[1]) if health else float(outs[0])

    return compile_lib.StagedStep(finish=finish, num_microbatches=n,
                                  start=zeros_like_statistics, body=body,
                                  result=result)


def _step_key(cfg: TrainConfig, tag: str, health: bool) -> tuple:
    """Registry key of one training step: the step kind and every config
    field that changes the program."""
    return (tag, cfg.mode, cfg.num_microbatches,
            tuple(cfg.axis_names) if cfg.axis_names else None, cfg.em, health)


def resolve_step_health(model: EiNet, cfg: TrainConfig) -> bool:
    return model.health if cfg.health is None else bool(cfg.health)


def make_em_step(model: EiNet, cfg: TrainConfig = TrainConfig(),
                 registry: Optional[compile_lib.ProgramRegistry] = None):
    """The training step ``step(x) -> mean LL of x`` (a float, so the step
    has finished on the device when it returns); with health on,
    ``step(x) -> (mean LL, health vector)``.  It computes the statistics
    and the new parameters from the current ones, then writes them into
    the module's parameters IN PLACE.

    The step is the program that ``registry`` (default
    ``compile.REGISTRY``) caches under (model, step key): repeat calls with
    the same (model, cfg) return the same callable.  On a CUDA model it
    replays captured graphs (captured on the first call of each batch
    shape); on a CPU model it runs op by op."""
    if cfg.mode not in ("stochastic", "full"):
        raise ValueError(f"unknown mode {cfg.mode!r}; 'stochastic' or 'full'")
    if cfg.axis_names:
        raise ValueError("axis_names names mesh dims to sum the statistics "
                         "over; use make_sharded_em_step")
    health = resolve_step_health(model, cfg)
    reg = registry if registry is not None else compile_lib.REGISTRY
    return reg.jit(model, _step_key(cfg, "em_step", health),
                   em_stages(cfg, health))


def sharded_em_stages(model: EiNet, cfg: TrainConfig,
                      mesh) -> compile_lib.StagedStep:
    """The sharded step of ``cfg`` on ``mesh`` as the stages its program
    captures and runs.

    * ``body`` (a graph): one microbatch's E-step statistics, written (one
      microbatch) or added into the ``stats`` accumulators.
    * ``reduce`` (eager, the collective): ``reduce_like_params`` of the
      totals -- one ``all_reduce`` a data dim of this rank's block of every
      leaf -- copied into the ``shard`` accumulators.
    * ``finish`` (a graph): the M-step and blend of this rank's blocks,
      written into its blocks of the module's parameters.
    * ``gather`` (eager, the collective; only where a parameter is
      sharded): the other ranks' blocks, ``all_gather``-ed over the model
      dim into the parameters.

    At a (data, 1) mesh every block is the whole leaf, and the stages
    compute what ``em_stages`` does, op for op, around the sum."""
    n = cfg.num_microbatches
    axes = shlib.data_dims(mesh, cfg.axis_names)
    shapes = zeros_like_statistics(model, "meta")
    stat_sh = shlib.tree_shardings(mesh, shapes)
    stat_placed = tree_lib.leaves_like(shapes, stat_sh)
    param_sh = shlib.tree_shardings(mesh, params_of(model))
    param_placed = tree_lib.leaves_like(params_of(model), param_sh)
    mix_placed = param_sh["mixing"]

    def blocks(tree, placed):
        _, leaves = tree_lib.flatten(tree)
        out = [shlib.local_shard(x, p, mesh) for x, p in zip(leaves, placed)]
        return tree_lib.unflatten_like(tree, out, lambda _, new: new)

    def start(model):
        stats = zeros_like_statistics(model)
        _, leaves = tree_lib.flatten(stats)
        shard = [torch.zeros(shlib.local_shard(x, p, mesh).shape,
                             device=x.device)
                 for x, p in zip(leaves, stat_placed)]
        return {"stats": stats, "shard": tree_lib.unflatten_like(
            stats, shard, lambda _, new: new)}

    def body(model, acc, xb):
        stats = em_statistics(model, xb)
        with torch.no_grad():
            for a, b in zip(tree_lib.flatten(acc["stats"])[1],
                            tree_lib.flatten(stats)[1]):
                if n == 1:
                    a.copy_(b)
                else:
                    a.add_(b)

    def reduce(model, acc):
        red = shlib.reduce_like_params(acc["stats"], mesh, stat_sh, axes)
        with torch.no_grad():
            for a, b in zip(tree_lib.flatten(acc["shard"])[1],
                            tree_lib.flatten(red)[1]):
                a.copy_(b)

    def finish(model, acc, x):
        stats = acc["shard"]
        masks = [shlib.local_shard(model._table(i, "mix_mask"), p, mesh)
                 if spec.mix_global is not None else None
                 for i, (spec, p) in enumerate(zip(model.pair_specs,
                                                   mix_placed))]
        mini = m_step(model, stats, cfg.em, masks)
        own = blocks(params_of(model), param_placed)
        new = (mini if cfg.mode == "full" else
               blend_params(model, own, mini, cfg.em.step_size))
        with torch.no_grad():
            for p, v in zip(tree_lib.flatten(own)[1],
                            tree_lib.flatten(new)[1]):
                p.copy_(v)
        return (stats["ll"] / stats["count"],)

    def gather(model):
        with torch.no_grad():
            for p, pl in zip(tree_lib.flatten(params_of(model))[1],
                             param_placed):
                if shlib.is_sharded(pl):
                    p.copy_(shlib.gather_full(shlib.local_shard(p, pl, mesh),
                                              pl, mesh))

    sharded = any(shlib.is_sharded(p) for p in param_placed)
    return compile_lib.StagedStep(
        finish=finish, num_microbatches=n, start=start, body=body,
        result=lambda outs: float(outs[0]), reduce=reduce,
        gather=gather if sharded else None)


def mesh_key(mesh) -> tuple:
    """A mesh as a registry key: its dim names, shape and ranks."""
    return (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
            tuple(mesh.mesh.flatten().tolist()))


def make_sharded_em_step(model: EiNet, cfg: TrainConfig, mesh,
                         registry: Optional[compile_lib.ProgramRegistry] = None):
    """The multi-rank form of :func:`make_em_step`: ``step(x) -> mean LL``
    over the rows of every data-parallel rank, where ``x`` is this rank's
    rows.

    Each rank computes its microbatched E-step totals; then ONE sum over
    the data dims (``cfg.axis_names``, default every data dim of ``mesh``)
    runs on the totals, not once a microbatch, as in the reference
    (``repro.train.pipeline.make_sharded_em_step``, a ``psum`` inside
    ``shard_map``).  Each rank sums only its block of every leaf under the
    parameter placements (``repro_torch.dist.sharding``): at a model dim
    above 1 it runs the M-step and blend on its model shard and the new
    parameters are all-gathered into the module; at 1 every rank runs the
    whole M-step on identical totals, so the parameters stay replicated by
    construction.  On a CUDA model the statistics and the finish are
    captured graphs, with the collectives run eagerly between them
    (``repro_torch.compile.StepProgram``).

    Health telemetry is not supported on this path, as in the reference:
    ``cfg.health`` True raises, and the model's knob is not read."""
    if cfg.mode not in ("stochastic", "full"):
        raise ValueError(f"unknown mode {cfg.mode!r}; 'stochastic' or 'full'")
    if cfg.health:
        raise ValueError("health telemetry is not supported on the sharded "
                         "EM step; run it with health off")
    if not shlib.data_dims(mesh, cfg.axis_names):
        raise ValueError(
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} has no data "
            "dim to shard the EM batch over; use make_em_step")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    reg = registry if registry is not None else compile_lib.REGISTRY
    return reg.jit(model, _step_key(cfg, "sharded_em_step", False)
                   + (mesh_key(mesh),), sharded_em_stages(model, cfg, mesh))


def fit(model: EiNet, batches: Iterable[Any], cfg: TrainConfig = TrainConfig(),
        num_steps: Optional[int] = None,
        on_step: Optional[Callable[[int, float], None]] = None,
        health_policy: Optional[health_lib.HealthPolicy] = None,
        registry: Optional[compile_lib.ProgramRegistry] = None) -> List[float]:
    """Run the step over an iterable of (B, D) tensors or arrays (or dicts
    with an "x" key), each moved to the model's device, updating ``model``
    in place.  Returns the per-step mean LLs.
    Each step is timed into ``train.step.seconds``; ``train.examples.count``
    counts its rows and ``train.ll.last`` holds its LL.

    With health on, every step's health vector feeds the
    ``train.health.*`` gauges and a ``HealthWatcher`` (``health_policy``
    configures it): a divergence dumps an incident bundle and, under the
    default "abort" policy, raises ``DivergenceError``."""
    step = make_em_step(model, cfg, registry)
    health_on = resolve_step_health(model, cfg)
    watcher = (health_lib.HealthWatcher(model, health_policy) if health_on
               else None)
    lls: List[float] = []
    for i, batch in enumerate(batches):
        if num_steps is not None and i >= num_steps:
            break
        x = torch.as_tensor(batch["x"] if isinstance(batch, dict) else batch,
                            device=model.device)
        # the step returns a float, so it has finished on the device when
        # the timed region closes
        with obs.timed("train.step", metric="train.step.seconds"):
            out = step(x)
            ll, hv = out if health_on else (out, None)
            lls.append(ll)
        obs.METRICS.counter("train.examples.count").inc(int(x.shape[0]))
        obs.METRICS.gauge("train.ll.last").set(lls[-1])
        if watcher is not None:
            health_lib.publish(model.health_spec, hv)
            watcher.observe(i, hv, params_of(model))
        if on_step is not None:
            on_step(i, lls[-1])
    return lls
