"""A step cost counter: the work of one training step or query, counted on
the step itself.

The port's stand-in for the reference's ``launch/hlo_analysis.py``
(``analyze_hlo``), which reads a compiled XLA program's text.  A CUDA
graph has no such text, so the counter runs one eager call of the step
under a ``TorchDispatchMode`` (:class:`CostCounter`) and records

  * **bytes written** -- every aten op's output bytes (the reference's
    ``bytes_written`` traffic model: each materialised buffer is written
    once); views and allocations without a write (``empty``) write
    nothing;
  * **flops** -- ``torch.utils.flop_counter``'s formulas for the aten ops
    it knows (matmuls, convolutions, attention); elementwise ops count 0,
    as a non-dot HLO op does in the reference;
  * **kernel launches** -- each ``kernels.ops`` ``KernelOp`` call counted
    once through ``kernels.cost.launch_cost`` (its bytes moved and its
    flops), whichever device runs it, with the aten ops inside it (the
    plain version on the CPU, the output allocation on the card) not
    counted.

So a step's counts are the same on the CPU and the card.  A staged
step's microbatch body is counted once and multiplied by
``num_microbatches`` (:func:`count_staged_step`), the counterpart of the
reference's loop trip counts.

Collectives are counted analytically (:func:`collective_costs`): one card
cannot run the production mesh.  The sharded step
(``train.make_sharded_em_step``) all-reduces each rank's packed block of
the statistics (``dist.sharding.reduce_like_params``) once a data dim, and
all-gathers the parameters sharded over "model" after the M-step.  A ring
all-reduce over ``n`` ranks moves ``2 (n - 1) / n * S`` bytes a rank for a
buffer of ``S`` bytes, a ring all-gather ``(n - 1) / n`` of the gathered
tensor's bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import compile as compile_lib
from repro_torch import tree as tree_lib
from repro_torch.core.em import params_of, zeros_like_statistics
from repro_torch.dist import sharding as shlib
from repro_torch.kernels.cost import launch_cost
from repro_torch.kernels.dispatch import launch_hook
from repro_torch.launch.mesh import DATA_DIMS

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# allocations that write no byte
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "empty_permuted"}


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


@dataclasses.dataclass
class StepCost:
    """The counted work of one call: flops, bytes written, and per kernel
    op its launches, bytes and flops (included in the totals)."""

    flops: int = 0
    bytes_written: int = 0
    output_bytes: int = 0  # the call's outputs (a step's: its LL, ...)
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


class CostCounter(TorchDispatchMode):
    """Counts the aten ops and kernel-op launches run inside it into
    ``cost`` (a :class:`StepCost`), each times ``multiplier``."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.multiplier = 1
        self._inside = 0  # depth of kernel-op launches being run
        self._hook = None

    def __enter__(self):
        self._hook = launch_hook(self._launch)
        self._hook.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hook.__exit__(*exc)
            self._hook = None

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count the block ``n`` times (a body a staged step replays ``n``
        times)."""
        before, self.multiplier = self.multiplier, self.multiplier * int(n)
        try:
            yield
        finally:
            self.multiplier = before

    @contextlib.contextmanager
    def _launch(self, op, args):
        if self._inside == 0:
            n_bytes, flops = launch_cost(op.name, *args)
            m = self.multiplier
            rec = self.cost.kernels.setdefault(
                op.name, {"launches": 0, "bytes": 0, "flops": 0})
            rec["launches"] += m
            rec["bytes"] += m * n_bytes
            rec["flops"] += m * flops
            self.cost.bytes_written += m * n_bytes
            self.cost.flops += m * flops
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        packet = func._overloadpacket
        if not func.is_view and packet.__name__ not in _NO_WRITE:
            self.cost.bytes_written += self.multiplier * _tensor_bytes(out)
        formula = flop_registry.get(packet)
        if formula is not None:
            self.cost.flops += self.multiplier * int(
                formula(*args, **kwargs, out_val=out))
        return out


def count_call(fn: Callable, *args, **kwargs) -> StepCost:
    """The counted work of one eager call ``fn(*args, **kwargs)``."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    counter.cost.output_bytes = _tree_bytes(out)
    return counter.cost


def combine(*parts: Tuple[StepCost, int]) -> StepCost:
    """The sum of ``(cost, times)`` parts (the outputs are the last
    part's)."""
    out = StepCost()
    for cost, times in parts:
        out.flops += times * cost.flops
        out.bytes_written += times * cost.bytes_written
        out.output_bytes = cost.output_bytes
        for name, rec in cost.kernels.items():
            mine = out.kernels.setdefault(
                name, {"launches": 0, "bytes": 0, "flops": 0})
            for k, v in rec.items():
                mine[k] += times * v
    return out


@contextlib.contextmanager
def _restored(anchor):
    """Undo the block's writes to ``anchor``'s parameters."""
    written = [p.detach() for p in anchor.parameters()]
    saved = [p.clone() for p in written]
    try:
        yield
    finally:
        with torch.no_grad():
            for p, s in zip(written, saved):
                p.copy_(s)


def count_stages(anchor, step: compile_lib.StagedStep, xb: torch.Tensor,
                 x: Optional[torch.Tensor] = None, finish: bool = True
                 ) -> Tuple[StepCost, Optional[StepCost]]:
    """The counted work of a staged step's two graphs apart: one
    microbatch body on ``xb`` (into fresh accumulators), then ``finish``
    on the whole batch ``x`` (default ``xb``; None with ``finish``
    False).  The accumulators' creation is outside the count, as it is
    outside the program's graphs, and so are ``reduce`` and ``gather``
    (:func:`collective_costs` counts them).  The parameters the step
    writes are restored afterwards: counting advances no model."""
    with _restored(anchor):
        acc = step.start(anchor)
        with CostCounter() as counter:
            step.body(anchor, acc, xb)
        body = counter.cost
        if not finish:
            return body, None
        with CostCounter() as counter:
            out = step.finish(anchor, acc, xb if x is None else x)
        counter.cost.output_bytes = _tree_bytes(out)
    return body, counter.cost


def count_staged_step(anchor, step: compile_lib.StagedStep,
                      x: torch.Tensor) -> StepCost:
    """The counted work of one step of ``step`` on ``x`` as its program
    runs it: a staged step's microbatch body counted once and taken
    ``num_microbatches`` times, then ``finish`` once (:func:`count_stages`);
    a single-stage step's ``finish`` on the whole batch.  The parameters
    are restored afterwards."""
    if not step.staged:
        with _restored(anchor):
            return count_call(step.finish, anchor, None, x)
    body, finish = count_stages(anchor, step, x[: step.microbatch_rows(x)],
                                x)
    return combine((body, step.num_microbatches), (finish, 1))


def collective_costs(model, axis_sizes: Dict[str, int],
                     rules: Optional[shlib.Rules] = None) -> Dict[str, Any]:
    """Bytes a rank moves in one sharded EM step of ``model`` on a mesh
    of ``axis_sizes`` under ``rules`` (default: the production table for
    that mesh), in the reference's ``collectives`` form: one all-reduce of
    the packed statistic blocks a data dim (``2 (n - 1) / n`` of the
    buffer), and one all-gather a parameter leaf sharded over "model"
    (``(m - 1) / m`` of the leaf).  Returns ``{"collectives": {...},
    "collective_bytes": total, "stats_buffer_bytes": S}``."""
    if rules is None:
        rules = shlib.default_rules("pod" in axis_sizes, fsdp=False)

    def block_bytes(path, leaf) -> int:
        spec = shlib.leaf_spec(path, tuple(leaf.shape), axis_sizes, rules)
        split = 1
        for entry in spec or ():
            names = (entry,) if isinstance(entry, str) else (entry or ())
            split *= math.prod(axis_sizes[n] for n in names)
        return leaf.numel() * leaf.element_size() // split

    stats = zeros_like_statistics(model, "meta")
    s_bytes = sum(block_bytes(p, x) for p, x in zip(*shlib.tree_paths(stats)))
    coll = {c: {"count": 0, "bytes": 0.0} for c in COLLECTIVES}
    for dim in DATA_DIMS:
        n = axis_sizes.get(dim, 1)
        if n > 1:
            coll["all-reduce"]["count"] += 1
            coll["all-reduce"]["bytes"] += 2 * (n - 1) / n * s_bytes
    m = axis_sizes.get("model", 1)
    paths, leaves = shlib.tree_paths(params_of(model))
    for p, leaf in zip(paths, leaves):
        spec = shlib.leaf_spec(p, tuple(leaf.shape), axis_sizes, rules)
        if m > 1 and spec and any(
                e == "model" or (isinstance(e, tuple) and "model" in e)
                for e in spec):
            coll["all-gather"]["count"] += 1
            coll["all-gather"]["bytes"] += (
                (m - 1) / m * leaf.numel() * leaf.element_size())
    return {"collectives": coll,
            "collective_bytes": sum(c["bytes"] for c in coll.values()),
            "stats_buffer_bytes": s_bytes}


def _tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(x.numel() * x.element_size()
               for x in tree_lib.flatten(tree)[1]
               if isinstance(x, torch.Tensor))
