"""Circuit execution planning: compile a pair-spec list into a typed plan.

``EiNet._build`` turns a region graph into a bottom-up list of
(product-layer, sum-layer) ``PairSpec``s; this module decides how that list
executes.  The output is a :class:`CircuitPlan`, a sequence of
:class:`ExecSegment`s of three kinds:

  * ``"fused"``  -- a run of consecutive CANONICAL pairs (left = rows
    [0, L), right = [L, 2L) of the layer below, sizes halving exactly: the
    RAT layout ``EiNet._canonicalize`` produces).  Runs as ONE grouped
    kernel launch (``repro_torch.kernels.grouped``).
  * ``"gather"`` -- a run of consecutive NON-FINAL pairs of arbitrary
    topology (Poon-Domingos cross-depth gathers, interior mixing layers
    included), carrying per-depth permutation tables (:class:`GatherTables`).
    Runs as ONE gather-grouped kernel launch
    (``repro_torch.kernels.grouped``), mixing inside the kernel.
  * ``"layer"``  -- a single pair on the per-layer path, with the reason it
    could not join a group recorded in ``CircuitPlan.fallback_reasons``.

Planning is pure host-side numpy/python over static structure.  The cost
model (``fused_cost_bytes`` / ``gather_cost_bytes``) and the 12 MiB default
budget are the JAX reference's, kept unchanged so that both packages plan
every circuit segment for segment; ``out_block`` and ``block_b`` are that
model's tile sizes and are recorded, not used as CUDA launch geometry (each
CUDA kernel sizes its own tiles against the card's shared memory).  One
check is the port's own: a canonical run joins a fused segment only where
the fused kernels have a launch geometry for it (:func:`kernels_hold`), on
every device, so the CPU plans what the card runs.

The budget resolves in priority order: the ``plan_budget=`` ctor knob, the
``REPRO_TORCH_PLAN_BUDGET`` env var (bytes), then :data:`PLAN_BUDGET_BYTES`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels import grouped as grouped_kernels

# working-set budget of the reference cost model for one fused program (the
# reference's 12 MiB VMEM slice, kept so plans match the reference)
PLAN_BUDGET_BYTES = 12 * 2 ** 20
_GROUP_BLOCK_B = (128, 64, 32)  # planner's batch-tile candidates, best first

PLAN_BUDGET_ENV = "REPRO_TORCH_PLAN_BUDGET"


def resolve_plan_budget(ctor_value: Optional[int] = None) -> int:
    """Effective plan budget in bytes: ctor knob > env var > default."""
    if ctor_value is not None:
        return int(ctor_value)
    env = os.environ.get(PLAN_BUDGET_ENV, "").strip()
    if env:
        return int(env)
    return PLAN_BUDGET_BYTES


@dataclasses.dataclass(frozen=True)
class GatherTables:
    """Static per-depth permutation tables for one gather-grouped segment.

    Built once on host from the segment's ``PairSpec``s; everything here is
    hashable nested int tuples.

    Row ids are GLOBAL buffer rows: ``EiNet._build`` allocates rows
    sequentially (leaves first, then each pair's einsum rows followed by its
    mixing rows), so the kernel's local row list -- input rows [0, r_in)
    followed by each depth's new rows in emission order -- coincides with
    the global numbering with no translation.
    """

    num_in_rows: int  # rows below the segment (= specs[start].einsum_global[0])
    k: int  # K of every depth (interior pairs: k_in == k_out == K)
    left: Tuple[Tuple[int, ...], ...]  # per depth: global rows of left children
    right: Tuple[Tuple[int, ...], ...]
    # per depth: (M, C) LOCAL indices into that depth's einsum outputs and the
    # matching 0/1 mask -- exactly PairSpec.mix_child_local / mix_mask, so the
    # in-kernel mixing replicates log_mix_exp bit-for-bit.  None = no mixing.
    mix_child: Tuple[Optional[Tuple[Tuple[int, ...], ...]], ...]
    mix_mask: Tuple[Optional[Tuple[Tuple[int, ...], ...]], ...]

    @property
    def num_depths(self) -> int:
        return len(self.left)

    @property
    def num_mix_depths(self) -> int:
        return sum(1 for m in self.mix_child if m is not None)

    @property
    def num_new_rows(self) -> int:
        return sum(
            len(l) + (len(m) if m is not None else 0)
            for l, m in zip(self.left, self.mix_child)
        )


@dataclasses.dataclass(frozen=True)
class ExecSegment:
    """One entry of the kernel schedule ``plan_circuit`` emits.

    ``kind == "fused"``: pairs [start, stop) as one canonical grouped kernel
    tiled over ``out_block`` final-depth cells x ``block_b`` batch rows.
    ``kind == "gather"``: pairs [start, stop) as one gather-grouped kernel
    (``tables`` carries the permutation tables, ``block_b`` the batch tile).
    ``kind == "layer"``: a single pair on the per-layer path.
    """

    start: int
    stop: int  # exclusive
    kind: str  # "layer" | "fused" | "gather"
    out_block: int = 0
    block_b: int = 0
    tables: Optional[GatherTables] = None

    @property
    def fused(self) -> bool:
        """Grouped execution of any flavour (not the per-layer path)."""
        return self.kind != "layer"


@dataclasses.dataclass(frozen=True)
class CircuitPlan:
    """The compiled execution schedule for one circuit's pair list."""

    segments: Tuple[ExecSegment, ...]
    num_pairs: int
    mix_flags: Tuple[bool, ...]  # per pair: has a mixing layer
    fallback_reasons: Tuple[Tuple[int, str], ...]  # (pair idx, reason)
    plan_budget: int

    @property
    def grouped_active(self) -> bool:
        return any(seg.fused for seg in self.segments)

    def launches(self) -> Tuple[int, int]:
        """(per-layer launches, planned launches) for one forward pass.

        Per-layer: one einsum launch per pair plus one mixing launch per
        mixing pair.  Planned: a gather segment is ONE launch (mixing runs
        in-kernel); a fused segment is one launch plus the terminating
        pair's mixing (canonical runs keep mixing outside the kernel); a
        layer segment counts like the per-layer path.
        """
        per_layer = self.num_pairs + sum(self.mix_flags)
        planned = 0
        for seg in self.segments:
            if seg.kind == "gather":
                planned += 1
            elif seg.kind == "fused":
                planned += 1 + (1 if self.mix_flags[seg.stop - 1] else 0)
            else:
                planned += 1 + (1 if self.mix_flags[seg.start] else 0)
        return per_layer, planned

    def summary(self) -> Dict[str, Any]:
        """Kernel-launch accounting (benchmarks record this as the
        ``grouping`` field next to wall-clock)."""
        per_layer, planned = self.launches()
        return {
            "num_pairs": self.num_pairs,
            "launches_per_layer": per_layer,
            "launches_grouped": planned,
            "fused_groups": sum(
                1 for s in self.segments if s.kind == "fused"
            ),
            "gather_groups": sum(
                1 for s in self.segments if s.kind == "gather"
            ),
            "fused_pairs": sum(
                s.stop - s.start for s in self.segments if s.fused
            ),
            "segments": [
                [s.start, s.stop, s.kind, s.out_block, s.block_b]
                for s in self.segments
            ],
            "fallbacks": [[p, r] for p, r in self.fallback_reasons],
            "plan_budget": self.plan_budget,
        }


# ------------------------------------------------------------- cost models
def fused_cost_bytes(specs: Sequence, i: int, j: int, s: int, bb: int) -> int:
    """Estimated working set of ONE backward-pass program for the
    canonical run [i, j) at out_block ``s``, batch tile ``bb`` (padded
    shapes).  The backward dominates: weights + dW blocks + every depth's
    recomputed activations + the K^2 product/contraction scratch."""
    g = j - i
    k = specs[i].k_in
    k_p = -(-k // 16) * 16
    ko_fp = -(-specs[j - 1].k_out // 128) * 128
    f = 4  # float32
    w_bytes = 0
    for d in range(g):
        m = 2 ** (g - 1 - d)
        ko = k_p if d < g - 1 else ko_fp
        w_bytes += m * s * ko * k_p * k_p * f
    act = bb * s * k_p * f * sum(2 ** (g - d) for d in range(g + 1))
    scratch = bb * k_p * k_p * f * 4
    io = bb * s * ko_fp * f * 2
    return 2 * w_bytes + act + scratch + io


def gather_cost_bytes(specs: Sequence, i: int, j: int, bb: int) -> int:
    """Estimated working set of ONE backward-pass program for the
    gather run [i, j) at batch tile ``bb`` (padded shapes).  The gather
    kernel holds the WHOLE segment per program (no cell tiling -- rows are
    irregular), so the budget bounds run length instead of out_block:
    weights + dW + the full row buffer (forward rows AND cotangents) + the
    K^2 product scratch."""
    k = specs[i].k_in
    k_p = -(-k // 16) * 16
    f = 4
    w_bytes = sum(
        specs[t].num_partitions * k_p * k_p * k_p * f for t in range(i, j)
    )
    v_bytes = sum(
        specs[t].num_mixed * specs[t].mix_child_local.shape[1] * k_p * f
        for t in range(i, j)
        if specs[t].mix_global is not None
    )
    r_in = int(specs[i].einsum_global[0])
    r_new = sum(
        specs[t].num_partitions + specs[t].num_mixed for t in range(i, j)
    )
    rows = bb * (r_in + r_new) * k_p * f
    scratch = bb * k_p * k_p * f * 4
    io = bb * (r_in + 2 * r_new) * k_p * f
    return 2 * (w_bytes + v_bytes) + 2 * rows + scratch + io


# ------------------------------------------------------------ run pickers
def kernels_hold(specs: Sequence, i: int, j: int) -> bool:
    """Whether the fused kernels (K3 forward, K4 backward) have a launch
    geometry for the canonical run [i, j): each sizes its row tile against
    the card's 227 KB of shared memory, and one output cell's subtree must
    fit one row tile (the reference's 12 MiB budget admits runs that do
    not, e.g. four depths at K=24).  Neither geometry depends on the
    batch for this."""
    k_outs = tuple(specs[t].k_out for t in range(i, j))
    args = (j - i, specs[i].k_in, k_outs, 1, specs[j - 1].num_partitions)
    try:
        grouped_kernels.fwd_geometry(*args)
        grouped_kernels.bwd_geometry(*args)
    except ValueError:
        return False
    return True


def pick_tiling(
    specs: Sequence, i: int, j: int, plan_budget: int
) -> Optional[Tuple[int, int]]:
    """(out_block, block_b) fitting the canonical run [i, j) in the plan
    budget, or None when the run cannot be fused (structure or budget)."""
    if any(not specs[t].canonical for t in range(i, j)):
        return None
    # a mixing pair may only TERMINATE a run: its mixture outputs join the
    # einsum outputs outside the kernel
    if any(specs[t].mix_global is not None for t in range(i, j - 1)):
        return None
    l_out = specs[j - 1].num_partitions
    for d, t in enumerate(range(i, j)):
        if specs[t].num_partitions != l_out * 2 ** (j - i - 1 - d):
            return None  # not an exact canonical halving chain
        if t < j - 1 and specs[t].k_out != specs[t + 1].k_in:
            return None
    if not kernels_hold(specs, i, j):
        return None
    for bb in _GROUP_BLOCK_B:
        for s in range(l_out, 0, -1):
            if l_out % s:
                continue
            if fused_cost_bytes(specs, i, j, s, bb) <= plan_budget:
                return s, bb
    return None


def pick_gather_batch(
    specs: Sequence, i: int, j: int, plan_budget: int
) -> Optional[int]:
    """Largest batch tile fitting the gather run [i, j) in the plan budget,
    or None.  Structure constraints: every pair non-final (the root layer
    changes K_out and is cheap -- it stays per-layer) with a uniform K;
    arbitrary gathers and interior mixing are fine (that is the point)."""
    if any(specs[t].is_final for t in range(i, j)):
        return None
    k = specs[i].k_in
    if any(
        specs[t].k_in != k or specs[t].k_out != k for t in range(i, j)
    ):
        return None
    for bb in _GROUP_BLOCK_B:
        if gather_cost_bytes(specs, i, j, bb) <= plan_budget:
            return bb
    return None


def build_gather_tables(specs: Sequence, start: int, stop: int) -> GatherTables:
    """Freeze the per-depth permutation tables for pairs [start, stop)."""
    left: List[Tuple[int, ...]] = []
    right: List[Tuple[int, ...]] = []
    mix_child: List[Optional[Tuple[Tuple[int, ...], ...]]] = []
    mix_mask: List[Optional[Tuple[Tuple[int, ...], ...]]] = []
    r_in = int(specs[start].einsum_global[0])
    for t in range(start, stop):
        sp = specs[t]
        assert not sp.is_final, "gather segments cover non-final pairs only"
        left.append(tuple(int(v) for v in sp.left))
        right.append(tuple(int(v) for v in sp.right))
        if sp.mix_global is not None:
            mix_child.append(
                tuple(
                    tuple(int(c) for c in row) for row in sp.mix_child_local
                )
            )
            mix_mask.append(
                tuple(tuple(int(m) for m in row) for row in sp.mix_mask)
            )
        else:
            mix_child.append(None)
            mix_mask.append(None)
    return GatherTables(
        num_in_rows=r_in,
        k=int(specs[start].k_in),
        left=tuple(left),
        right=tuple(right),
        mix_child=tuple(mix_child),
        mix_mask=tuple(mix_mask),
    )


# ---------------------------------------------------------------- planner
def _why_not_canonical(specs: Sequence, i: int, plan_budget: int) -> str:
    n = len(specs)
    if i + 2 > n:
        return "run shorter than 2 pairs"
    if not specs[i].canonical or not specs[i + 1].canonical:
        return "non-canonical pair in every candidate run"
    if specs[i].mix_global is not None:
        return "interior mixing terminates runs"
    if not kernels_hold(specs, i, i + 2):
        return "the fused kernels cannot hold the 2-depth run"
    return "2-depth working set exceeds the plan budget"


def _why_not_gather(specs: Sequence, i: int, plan_budget: int) -> str:
    n = len(specs)
    if specs[i].is_final:
        return "final (root) pair runs per-layer"
    if i + 2 > n or specs[i + 1].is_final:
        return "no 2-pair run available before the root"
    if pick_gather_batch(specs, i, i + 2, plan_budget) is None:
        return "2-pair gather working set exceeds the plan budget"
    return "unfusable run"


def plan_circuit(
    specs: Sequence,
    grouped: bool = True,
    plan_budget: Optional[int] = None,
) -> CircuitPlan:
    """Compile the pair list into the execution plan.

    All-canonical structures (RAT: ``needs_buffer`` is False) get exactly
    the canonical greedy plan of the original ``EiNet._plan_groups`` --
    maximal fused runs, split on the plan budget -- preserving those plans
    (and their benchmarks) bit-for-bit.  Structures with ANY non-canonical
    pair run in row-buffer mode, where fused (slice-tiled) segments are
    forbidden -- they skip materializing interior rows, which would leave
    holes in the global-row-indexed buffer -- and maximal gather runs take
    their place.  Pairs joining no run become layer segments with the
    reason recorded.
    """
    budget = resolve_plan_budget(plan_budget)
    n = len(specs)
    mix_flags = tuple(sp.mix_global is not None for sp in specs)

    def _finish(segments, reasons):
        return CircuitPlan(
            segments=tuple(segments),
            num_pairs=n,
            mix_flags=mix_flags,
            fallback_reasons=tuple(reasons),
            plan_budget=budget,
        )

    if not grouped or n < 2:
        reason = "grouped execution disabled" if not grouped else (
            "circuit has fewer than 2 pairs"
        )
        return _finish(
            [ExecSegment(i, i + 1, "layer") for i in range(n)],
            [(i, reason) for i in range(n)],
        )

    needs_buffer = any(not sp.canonical for sp in specs)
    segments: List[ExecSegment] = []
    reasons: List[Tuple[int, str]] = []
    i = 0
    if not needs_buffer:
        while i < n:
            best = None
            j = i + 2
            while j <= n:
                tiling = pick_tiling(specs, i, j, budget)
                if tiling is None:
                    break
                best = (j, tiling)
                j += 1
            if best is not None:
                j, (s, bb) = best
                segments.append(
                    ExecSegment(i, j, "fused", out_block=s, block_b=bb)
                )
                i = j
            else:
                segments.append(ExecSegment(i, i + 1, "layer"))
                reasons.append((i, _why_not_canonical(specs, i, budget)))
                i += 1
        return _finish(segments, reasons)

    while i < n:
        best = None
        j = i + 2
        while j <= n:
            bb = pick_gather_batch(specs, i, j, budget)
            if bb is None:
                break
            best = (j, bb)
            j += 1
        if best is not None:
            j, bb = best
            segments.append(
                ExecSegment(
                    i, j, "gather", block_b=bb,
                    tables=build_gather_tables(specs, i, j),
                )
            )
            i = j
        else:
            segments.append(ExecSegment(i, i + 1, "layer"))
            reasons.append((i, _why_not_gather(specs, i, budget)))
            i += 1
    return _finish(segments, reasons)
