"""Circuit / plan verifier: statically prove the invariants everything rests on.

The port's copy of the reference's ``repro/analysis/verify.py``: the same
checks, the same invariant ids, over the port's own ``core.plan``.  Three
layers of checks, each pure host-side python/numpy over static structure
(no tensors, no device -- the same domain as ``core.plan``):

  * **Region graph** (:func:`verify_region_graph`): smoothness and
    decomposability in the paper's Definition 1 sense -- every partition's
    child scopes are nonempty, disjoint, and cover the parent scope; the
    root region covers all variables.
  * **Compiled circuit** (:func:`verify_circuit`): the same two properties
    re-proved over the *built* artifact (``EiNet.pair_specs`` + the leaf
    layer) instead of the graph it came from, by recomputing every buffer
    row's scope bottom-up: gather rows must reference already-allocated
    rows, einsum children must have disjoint scopes, mixing children must
    share one scope (smoothness at the tensorized level), allocation must
    be contiguous in build order, the K chain must match the model, and the
    root row must cover every variable.  A graph that validates can still
    compile into a corrupt circuit (a canonicalization bug, a permuted
    gather row); this layer catches that independently.
  * **Execution plan** (:func:`verify_plan`): every ``CircuitPlan`` the
    planner emits -- segments partition the pair list exactly; mix masks
    cover exactly the mixing layers; fused segments are genuine canonical
    halving chains with in-budget VMEM working sets and valid tilings;
    gather segments carry ``GatherTables`` whose rows are in-range
    permutations consistent with the pair specs' child scopes; every
    planned launch shape satisfies the ``pad_to_lanes`` lane contract.

The plan's tile fields (``out_block``, ``block_b``) and its budget are the
reference cost model's, which the port's plan copies, so
``plan/lanes-contract`` and ``plan/vmem-budget`` check them as the
reference does.  ``plan/vmem-budget`` also holds the card's own
feasibility rule, this card's counterpart of the VMEM budget: a fused run
only where the fused kernels (K3 forward, K4 backward) have a launch
geometry for it (``core.plan.kernels_hold``), and a gather run only where
the gather kernels (K5, K6) have one (``kernels.grouped``
``gather_fwd_geometry`` / ``gather_bwd_geometry``, at most
``GATHER_MAX_DEPTHS`` depths).

``verify_einet`` runs all three and returns a typed :class:`VerifyReport`.
Wired into ``EiNet(verify=...)`` / the ``REPRO_VERIFY`` env var and
``python -m repro_torch.launch.dryrun --verify``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import plan as plan_lib
from repro_torch.kernels import grouped as grouped_kernels

# Every invariant the verifier can check, by id.  ``VerifyReport`` reports
# this set as its coverage; tests pin that each id has a negative test.
INVARIANTS = (
    # region graph (Definition 1)
    "graph/nonempty-scope",
    "graph/decomposability",
    "graph/smoothness",
    "graph/root-scope",
    # built circuit (pair specs + leaf layer)
    "circuit/row-range",
    "circuit/scope-decomposability",
    "circuit/scope-smoothness",
    "circuit/allocation-order",
    "circuit/k-chain",
    "circuit/mix-tables",
    "circuit/root-coverage",
    # execution plan (CircuitPlan)
    "plan/coverage",
    "plan/mix-flags",
    "plan/segment-kind",
    "plan/fused-structure",
    "plan/fused-tiling",
    "plan/gather-tables",
    "plan/gather-row-range",
    "plan/vmem-budget",
    "plan/lanes-contract",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant."""

    invariant: str  # id from INVARIANTS
    where: str  # location, e.g. "pair 3" / "segment gather[0,2) depth 1"
    message: str

    def __str__(self) -> str:
        return f"{self.invariant} @ {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Typed verification outcome for one model / config."""

    name: str
    invariants: Tuple[str, ...]  # the ids that were checked
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        """One startup log line (``[verify]`` in launch/dryrun.py)."""
        if self.ok:
            return (
                f"ok ({len(self.invariants)} invariants over "
                f"graph+circuit+plan)"
            )
        head = "; ".join(str(f) for f in self.findings[:3])
        more = len(self.findings) - 3
        return (
            f"FAILED {len(self.findings)} invariant(s): {head}"
            + (f"; +{more} more" if more > 0 else "")
        )

    def format_report(self) -> str:
        lines = [f"verify {self.name}: {self.summary()}"]
        lines += [f"  - {f}" for f in self.findings]
        return "\n".join(lines)


class VerifyError(RuntimeError):
    """Raised by ``EiNet(verify='raise')`` when verification fails."""

    def __init__(self, report: VerifyReport):
        super().__init__(report.format_report())
        self.report = report


# ------------------------------------------------------------ region graph
def verify_region_graph(graph) -> List[Finding]:
    """Definition 1, structurally: smooth + decomposable region graph."""
    out: List[Finding] = []
    num_vars = graph.num_vars
    all_vars = frozenset(range(num_vars))
    for rid, scope in enumerate(graph.regions):
        s = set(scope)
        if not s:
            out.append(Finding(
                "graph/nonempty-scope", f"region {rid}", "empty scope"))
        if not s <= all_vars:
            out.append(Finding(
                "graph/nonempty-scope", f"region {rid}",
                f"scope {sorted(s - all_vars)} outside [0, {num_vars})"))
    for pid, (parent, left, right) in enumerate(graph.partitions):
        sl = set(graph.regions[left])
        sr = set(graph.regions[right])
        sp = set(graph.regions[parent])
        if not sl or not sr:
            out.append(Finding(
                "graph/nonempty-scope", f"partition {pid}",
                "empty child scope"))
        if sl & sr:
            out.append(Finding(
                "graph/decomposability", f"partition {pid}",
                f"child scopes overlap on {sorted(sl & sr)[:8]}"))
        if sl | sr != sp:
            out.append(Finding(
                "graph/smoothness", f"partition {pid}",
                f"children cover {len(sl | sr)} vars, parent scope has "
                f"{len(sp)}"))
    if set(graph.regions[graph.root]) != all_vars:
        out.append(Finding(
            "graph/root-scope", f"region {graph.root}",
            f"root scope has {len(graph.regions[graph.root])} of "
            f"{num_vars} variables"))
    return out


# ---------------------------------------------------------- built circuit
def verify_circuit(model) -> List[Finding]:
    """Re-prove smoothness/decomposability over the BUILT circuit by
    recomputing every buffer row's scope bottom-up from the leaf layer."""
    out: List[Finding] = []
    ls = model.leaf_spec
    all_vars = frozenset(range(model.num_vars))
    row_scopes: List[frozenset] = [frozenset(s) for s in ls.leaf_scopes]
    root_scope: Optional[frozenset] = None
    for t, spec in enumerate(model.pair_specs):
        where = f"pair {t}"
        avail = len(row_scopes)
        if int(spec.einsum_global[0]) != avail or not np.array_equal(
            spec.einsum_global,
            np.arange(avail, avail + spec.num_partitions),
        ):
            out.append(Finding(
                "circuit/allocation-order", where,
                f"einsum rows {spec.einsum_global[:3].tolist()}... do not "
                f"continue the build allocation at row {avail}"))
        if spec.k_in != model.K:
            out.append(Finding(
                "circuit/k-chain", where,
                f"k_in {spec.k_in} != model K {model.K}"))
        want_k_out = model.num_classes if spec.is_final else model.K
        if spec.k_out != want_k_out:
            out.append(Finding(
                "circuit/k-chain", where,
                f"k_out {spec.k_out} != {want_k_out} "
                f"({'final' if spec.is_final else 'interior'} pair)"))
        pair_scopes: List[frozenset] = []
        for i in range(spec.num_partitions):
            li, ri = int(spec.left[i]), int(spec.right[i])
            if not (0 <= li < avail and 0 <= ri < avail):
                out.append(Finding(
                    "circuit/row-range", f"{where} partition {i}",
                    f"child rows ({li}, {ri}) outside the {avail} rows "
                    f"allocated below"))
                pair_scopes.append(frozenset())
                continue
            sl, sr = row_scopes[li], row_scopes[ri]
            if sl & sr:
                out.append(Finding(
                    "circuit/scope-decomposability", f"{where} partition {i}",
                    f"child rows {li} and {ri} share scope vars "
                    f"{sorted(sl & sr)[:8]}"))
            pair_scopes.append(sl | sr)
        row_scopes.extend(pair_scopes)
        if spec.mix_global is not None:
            mix_avail = len(row_scopes)
            if int(spec.mix_global[0]) != mix_avail or not np.array_equal(
                spec.mix_global,
                np.arange(mix_avail, mix_avail + spec.num_mixed),
            ):
                out.append(Finding(
                    "circuit/allocation-order", where,
                    "mixing rows do not continue the build allocation"))
            for m in range(spec.num_mixed):
                mask = np.asarray(spec.mix_mask[m])
                kids = np.asarray(spec.mix_child_local[m])
                if not np.all((mask == 0) | (mask == 1)) or mask.sum() < 1:
                    out.append(Finding(
                        "circuit/mix-tables", f"{where} mix row {m}",
                        f"mask must be 0/1 with >= 1 child, got "
                        f"{mask.tolist()}"))
                active = [int(k) for k, mk in zip(kids, mask) if mk > 0]
                if any(not 0 <= k < spec.num_partitions for k in active):
                    out.append(Finding(
                        "circuit/mix-tables", f"{where} mix row {m}",
                        f"child indices {active} outside "
                        f"[0, {spec.num_partitions})"))
                    row_scopes.append(frozenset())
                    continue
                kid_scopes = {pair_scopes[k] for k in active}
                if len(kid_scopes) > 1:
                    out.append(Finding(
                        "circuit/scope-smoothness", f"{where} mix row {m}",
                        "mixing children have differing scopes (sum node "
                        "over non-identical scopes is not smooth)"))
                row_scopes.append(next(iter(kid_scopes)) if kid_scopes
                                  else frozenset())
        if spec.is_final:
            if t != len(model.pair_specs) - 1:
                out.append(Finding(
                    "circuit/k-chain", where,
                    "is_final set on a non-terminal pair"))
            root_scope = (
                row_scopes[int(spec.mix_global[0])]
                if spec.mix_global is not None and spec.num_mixed
                else (pair_scopes[0] if pair_scopes else frozenset())
            )
    if root_scope is None or root_scope != all_vars:
        got = 0 if root_scope is None else len(root_scope)
        out.append(Finding(
            "circuit/root-coverage", "root row",
            f"root scope covers {got} of {model.num_vars} variables"))
    return out


# -------------------------------------------------------------------- plan
def _rows_available(specs: Sequence, t: int) -> int:
    """Rows allocated strictly below pair ``t`` (the build order)."""
    return int(specs[t].einsum_global[0])


def _check_fused_segment(specs, seg, budget, out: List[Finding]) -> None:
    where = f"segment fused[{seg.start},{seg.stop})"
    g = seg.stop - seg.start
    run = [specs[t] for t in range(seg.start, seg.stop)]
    if any(not sp.canonical for sp in run):
        out.append(Finding(
            "plan/fused-structure", where,
            "fused segment contains a non-canonical pair"))
        return
    if any(sp.mix_global is not None for sp in run[:-1]):
        out.append(Finding(
            "plan/fused-structure", where,
            "interior pair has a mixing layer (mixing may only terminate "
            "a fused run)"))
    l_out = run[-1].num_partitions
    for d, sp in enumerate(run):
        if sp.num_partitions != l_out * 2 ** (g - 1 - d):
            out.append(Finding(
                "plan/fused-structure", f"{where} depth {d}",
                f"{sp.num_partitions} partitions breaks the exact halving "
                f"chain to {l_out}"))
        if d < g - 1 and sp.k_out != run[d + 1].k_in:
            out.append(Finding(
                "plan/fused-structure", f"{where} depth {d}",
                f"k_out {sp.k_out} != next depth k_in {run[d + 1].k_in}"))
    if seg.out_block < 1 or l_out % max(seg.out_block, 1):
        out.append(Finding(
            "plan/fused-tiling", where,
            f"out_block {seg.out_block} does not tile L_out {l_out}"))
        return
    _check_lanes(seg, run[0].k_in, out, where)
    cost = plan_lib.fused_cost_bytes(
        specs, seg.start, seg.stop, seg.out_block, seg.block_b)
    if cost > budget:
        out.append(Finding(
            "plan/vmem-budget", where,
            f"working set {cost} B exceeds the effective budget {budget} B"))
    if not plan_lib.kernels_hold(specs, seg.start, seg.stop):
        out.append(Finding(
            "plan/vmem-budget", where,
            "the fused kernels (K3, K4) have no launch geometry for the "
            "run: one output cell's subtree does not fit the card's shared "
            "memory"))


def _check_gather_segment(specs, seg, budget, out: List[Finding]) -> None:
    where = f"segment gather[{seg.start},{seg.stop})"
    run = [specs[t] for t in range(seg.start, seg.stop)]
    if any(sp.is_final for sp in run):
        out.append(Finding(
            "plan/segment-kind", where,
            "gather segment covers the final (root) pair"))
    k = run[0].k_in
    if any(sp.k_in != k or sp.k_out != k for sp in run):
        out.append(Finding(
            "plan/gather-tables", where,
            f"non-uniform K across the run (expected k_in == k_out == {k})"))
    tb = seg.tables
    if tb is None:
        out.append(Finding(
            "plan/gather-tables", where, "gather segment carries no tables"))
        return
    if tb.num_depths != len(run):
        out.append(Finding(
            "plan/gather-tables", where,
            f"tables cover {tb.num_depths} depths, segment spans "
            f"{len(run)}"))
        return
    if tb.num_in_rows != _rows_available(specs, seg.start):
        out.append(Finding(
            "plan/gather-tables", where,
            f"tables.num_in_rows {tb.num_in_rows} != rows below the "
            f"segment {_rows_available(specs, seg.start)}"))
    if tb.k != k:
        out.append(Finding(
            "plan/gather-tables", where,
            f"tables.k {tb.k} != run K {k}"))
    avail = tb.num_in_rows
    for d, sp in enumerate(run):
        dw = f"{where} depth {d}"
        left = tuple(int(v) for v in sp.left)
        right = tuple(int(v) for v in sp.right)
        if tb.left[d] != left or tb.right[d] != right:
            out.append(Finding(
                "plan/gather-tables", dw,
                "frozen left/right rows disagree with the pair spec's "
                "child rows (table is not the spec's permutation)"))
        for side, rows in (("left", tb.left[d]), ("right", tb.right[d])):
            bad = [r for r in rows if not 0 <= int(r) < avail]
            if bad:
                out.append(Finding(
                    "plan/gather-row-range", dw,
                    f"{side} rows {bad[:4]} outside the {avail} buffer "
                    f"rows available at this depth"))
        avail += sp.num_partitions
        has_mix = sp.mix_global is not None
        if (tb.mix_child[d] is not None) != has_mix:
            out.append(Finding(
                "plan/mix-flags", dw,
                "tables' mixing entry does not match the pair's mixing "
                "layer (mix tables must cover exactly the mixing depths)"))
        elif has_mix:
            want_child = tuple(
                tuple(int(c) for c in row) for row in sp.mix_child_local)
            want_mask = tuple(
                tuple(int(m) for m in row) for row in sp.mix_mask)
            if tb.mix_child[d] != want_child or tb.mix_mask[d] != want_mask:
                out.append(Finding(
                    "plan/gather-tables", dw,
                    "frozen mixing tables disagree with the pair spec"))
            for m, mask_row in enumerate(tb.mix_mask[d] or ()):
                if sum(mask_row) < 1 or any(v not in (0, 1)
                                            for v in mask_row):
                    out.append(Finding(
                        "plan/mix-flags", f"{dw} mix row {m}",
                        f"mask row {mask_row} is not 0/1 with >= 1 child"))
            avail += sp.num_mixed
    _check_lanes(seg, k, out, where)
    cost = plan_lib.gather_cost_bytes(specs, seg.start, seg.stop, seg.block_b)
    if cost > budget:
        out.append(Finding(
            "plan/vmem-budget", where,
            f"working set {cost} B exceeds the effective budget {budget} B"))
    why = _gather_infeasible(tb, k)
    if why:
        out.append(Finding("plan/vmem-budget", where, why))


def _gather_infeasible(tables, k: int) -> str:
    """Why the gather kernels (K5 forward, K6 backward) cannot launch the
    run on the card ("" when they can): more depths than they take, or a
    depth whose pair has no K1/K2 geometry.  Neither depends on the batch
    for this, so one row stands for any."""
    if tables.num_depths > grouped_kernels.GATHER_MAX_DEPTHS:
        return (f"{tables.num_depths} depths exceed the gather kernels' "
                f"{grouped_kernels.GATHER_MAX_DEPTHS}")
    try:
        grouped_kernels.gather_fwd_geometry(tables, k, 1)
        grouped_kernels.gather_bwd_geometry(tables, k, 1)
    except ValueError as e:
        return f"the gather kernels (K5, K6) have no launch geometry: {e}"
    return ""


def _check_lanes(seg, k: int, out: List[Finding], where: str) -> None:
    """The ``pad_to_lanes`` launch contract: the batch tile must be a
    positive multiple of 8 sublanes (the planner only emits the candidates
    in ``_GROUP_BLOCK_B``), and the padded K lane (K rounded to 16) must
    make the flattened K^2 product axis a whole number of 128 lanes."""
    if seg.block_b < 1 or seg.block_b % 8:
        out.append(Finding(
            "plan/lanes-contract", where,
            f"batch tile {seg.block_b} is not a positive multiple of 8"))
    if seg.block_b not in plan_lib._GROUP_BLOCK_B:
        out.append(Finding(
            "plan/lanes-contract", where,
            f"batch tile {seg.block_b} is not a planner candidate "
            f"{plan_lib._GROUP_BLOCK_B}"))
    k_p = -(-k // 16) * 16
    if (k_p * k_p) % 128:
        out.append(Finding(
            "plan/lanes-contract", where,
            f"padded K {k_p} leaves the K^2 axis off the 128 lane"))


def verify_plan(model) -> List[Finding]:
    """Validate ``model.plan`` (a ``core.plan.CircuitPlan``) against
    ``model.pair_specs``."""
    out: List[Finding] = []
    specs = model.pair_specs
    plan: plan_lib.CircuitPlan = model.plan
    n = len(specs)
    if plan.num_pairs != n:
        out.append(Finding(
            "plan/coverage", "plan",
            f"plan.num_pairs {plan.num_pairs} != {n} built pairs"))
    pos = 0
    for seg in plan.segments:
        if seg.start != pos or seg.stop <= seg.start:
            out.append(Finding(
                "plan/coverage", f"segment {seg.kind}[{seg.start},{seg.stop})",
                f"segments must tile the pair list in order; expected "
                f"start {pos}"))
            pos = max(pos, seg.stop)
            continue
        pos = seg.stop
    if pos != n:
        out.append(Finding(
            "plan/coverage", "plan",
            f"segments cover [0, {pos}) of {n} pairs"))
    want_flags = tuple(sp.mix_global is not None for sp in specs)
    if plan.mix_flags != want_flags:
        out.append(Finding(
            "plan/mix-flags", "plan",
            "plan.mix_flags does not mark exactly the mixing layers"))
    needs_buffer = any(not sp.canonical for sp in specs)
    budget = plan.plan_budget
    if budget < 1:
        out.append(Finding(
            "plan/vmem-budget", "plan",
            f"effective plan budget {budget} B is not positive"))
    for seg in plan.segments:
        if seg.stop > n or seg.start >= n:
            continue  # already reported by plan/coverage
        if seg.kind == "fused":
            if needs_buffer:
                out.append(Finding(
                    "plan/segment-kind",
                    f"segment fused[{seg.start},{seg.stop})",
                    "fused (slice-tiled) segments are forbidden in "
                    "row-buffer mode: they skip materializing interior "
                    "rows and would leave holes in the buffer"))
            _check_fused_segment(specs, seg, budget, out)
        elif seg.kind == "gather":
            _check_gather_segment(specs, seg, budget, out)
        elif seg.kind == "layer":
            if seg.stop - seg.start != 1:
                out.append(Finding(
                    "plan/segment-kind",
                    f"segment layer[{seg.start},{seg.stop})",
                    "layer segments cover exactly one pair"))
        else:
            out.append(Finding(
                "plan/segment-kind",
                f"segment {seg.kind}[{seg.start},{seg.stop})",
                f"unknown segment kind {seg.kind!r}"))
    return out


# ----------------------------------------------------------------- reports
def verify_einet(model, name: Optional[str] = None) -> VerifyReport:
    """Run every check over a built ``EiNet`` (or ``EiNetMixture.component``)
    and return the typed report."""
    findings = (
        verify_region_graph(model.graph)
        + verify_circuit(model)
        + verify_plan(model)
    )
    return VerifyReport(
        name=name or f"einet[{model.num_vars} vars, K={model.K}]",
        invariants=INVARIANTS,
        findings=tuple(findings),
    )


def verify_config(cfg: Any, grouped: bool = True) -> VerifyReport:
    """Build the registered arch's structure and plan
    (``launch.cells.build_einet`` on the "meta" device: no parameters are
    allocated) and verify it -- the ``dryrun --verify`` path."""
    from repro_torch.launch.cells import build_einet

    model = build_einet(cfg, device="meta", grouped=grouped)
    return verify_einet(model, name=cfg.name)
