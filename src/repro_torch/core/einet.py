"""Einsum Networks: layered, vectorized probabilistic circuits (paper §3).

An ``EiNet`` compiles a region graph into a bottom-up list of (einsum-layer,
mixing-layer) pairs with static integer tables (built once, on host, in
numpy), plans how the pairs execute (``core.plan``), and holds the learnable
state as ``nn.Parameter``s: ``phi`` (leaf EF parameters), ``einsum`` and
``mixing`` (one entry per pair) and ``class_prior``.  The forward pass is

    leaf EF tensor -> sum into leaf rows -> per plan segment: one grouped
    log-einsum-exp launch (fused runs) or one per-layer launch, then the
    pair's mixing -> root log-densities.

On a CUDA device the log-einsum-exp ops (per pair, canonical run, gather
run) launch hand-written kernels (``repro_torch.kernels``), forward and,
under autograd, backward; on the CPU they run their plain PyTorch versions.
So the bottom-up pass serves under ``torch.inference_mode()`` and trains by
autodiff EM (``repro_torch.core.em``) on the card, for every plan.

Also implemented: exact marginalization (evidence masks), ancestral and
conditional sampling (the induced-tree top-down pass used for inpainting),
and MPE-style argmax decoding.  Sampling noise is explicit: each row's
whole noise vector, of a fixed length per model, is counter-based Philox
uniforms keyed by that row's seed (``core.philox``), so a row's draw
depends only on (seed, x, evidence), the CPU and the card draw the same
bits, and a captured CUDA graph takes the seeds as a device tensor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.core import philox
from repro_torch.core import plan as plan_lib
from repro_torch.core import region_graph as rg_lib
from repro_torch.core.exponential_family import ExponentialFamily, Normal
from repro_torch.core.layers import (
    NEG_INF,
    gumbel,
    log_mix_exp,
    normalize_einsum_weights,
    normalize_mixing_weights,
)
from repro_torch.kernels import ops
from repro_torch.obs import health as health_lib

# query kinds understood by EiNet.query / the serving engine
QUERY_KINDS = (
    "joint_ll",
    "marginal_ll",
    "conditional_ll",
    "sample",
    "conditional_sample",
    "mpe",
)

# sampling uniforms are kept inside [2^-24, 1 - 2^-24] (the 2^-24 grid
# without 0), so Gumbel and inverse-CDF transforms stay finite
_U_MIN = 2.0 ** -24


def seed_tensor(seeds, device) -> torch.Tensor:
    """Per-row seeds as the (B,) int64 tensor on ``device`` that the
    sampling paths take: a tensor is moved (and cast), a sequence of ints
    converted."""
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64)
    return torch.tensor([int(s) for s in seeds], dtype=torch.int64,
                        device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA without a card raises; nothing moves to the
    CPU on its own.  ("meta" builds a model's structure and plan without
    allocating its parameters.)"""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "EiNet runs on CUDA by default, but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def _sync_segment(out: torch.Tensor) -> None:
    """``obs.sync`` on a plan segment's output.  A sync hook (a device
    synchronise) inside a CUDA-graph capture would invalidate the capture,
    so a walk being captured with a hook installed raises instead."""
    if (obs.has_sync() and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "an obs.set_sync hook is installed while a CUDA graph is being "
            "captured: synchronising inside a capture invalidates it; "
            "clear the hook (obs.set_sync(None)) before capturing")
    obs.sync(out)


@dataclasses.dataclass
class PairSpec:
    """Static gather tables for one (product-layer, sum-layer) pair."""

    left: np.ndarray  # (L,) global buffer rows of left children
    right: np.ndarray  # (L,) global buffer rows of right children
    einsum_global: np.ndarray  # (L,) global row id of each simple-sum output
    k_in: int
    k_out: int
    # mixing (None when every sum in this layer has a single child)
    mix_child_local: Optional[np.ndarray]  # (M, C) local partition idx, 0-padded
    mix_mask: Optional[np.ndarray]  # (M, C) 1/0
    mix_global: Optional[np.ndarray]  # (M,) global row ids
    is_final: bool
    # canonical layout: the pair's children are exactly the previous
    # layer's outputs, reordered at build time so left = rows [0, L) and
    # right = rows [L, 2L) -- the gather becomes a static slice
    canonical: bool = False

    @property
    def num_partitions(self) -> int:
        return len(self.left)

    @property
    def num_mixed(self) -> int:
        return 0 if self.mix_global is None else len(self.mix_global)


@dataclasses.dataclass
class LeafSpec:
    pair_var: np.ndarray  # (P,) variable ids, concatenated leaf scopes
    pair_rep: np.ndarray  # (P,) replica id of the owning leaf
    pair_leaf: np.ndarray  # (P,) owning leaf row (= segment id)
    num_leaves: int
    num_replica: int
    leaf_scopes: List[Tuple[int, ...]]
    leaf_replica: np.ndarray  # (num_leaves,)


class EiNet(nn.Module):
    """A compiled Einsum Network over a region graph.

    Static structure lives on the instance; the learnable state is the
    module's parameters, initialised from ``seed`` (or loaded with
    ``load_state_dict``, e.g. from ``repro_torch.convert.params_from_jax``).
    """

    query_kinds = QUERY_KINDS

    def __init__(
        self,
        graph: rg_lib.RegionGraph,
        num_sums: int = 10,
        num_classes: int = 1,
        exponential_family: Optional[ExponentialFamily] = None,
        grouped: bool = True,
        plan_budget: Optional[int] = None,
        device=None,
        seed: int = 0,
        health: Optional[bool] = None,
        verify: Optional[str] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.graph = graph
        self.K = int(num_sums)
        self.num_classes = int(num_classes)
        self.ef = exponential_family or Normal()
        self.num_vars = graph.num_vars
        self.grouped = bool(grouped)
        self._build()
        self.plan = plan_lib.plan_circuit(
            self.pair_specs, grouped=self.grouped, plan_budget=plan_budget)
        self.exec_plan = self.plan.segments
        # numerical-health telemetry (repro_torch.obs.health): the ctor knob
        # wins, else the REPRO_HEALTH environment variable; the spec is fixed
        # by the execution plan
        self.health = health_lib.resolve_health(health)
        self.health_spec = health_lib.spec_for(self)
        self._register_tables()
        self._noise_layout()

        ls = self.leaf_spec
        self.phi = nn.Parameter(torch.empty(
            self.num_vars, self.K, ls.num_replica, self.ef.num_stats,
            device=device))
        self.einsum = nn.ParameterList([
            nn.Parameter(torch.empty(
                sp.num_partitions, sp.k_out, sp.k_in, sp.k_in, device=device))
            for sp in self.pair_specs
        ])
        self.mixing = nn.ParameterList([
            nn.Parameter(torch.empty(
                (sp.num_mixed, sp.mix_child_local.shape[1], sp.k_out)
                if sp.mix_global is not None else (0, 0, sp.k_out),
                device=device))
            for sp in self.pair_specs
        ])
        self.class_prior = nn.Parameter(
            torch.empty(self.num_classes, device=device))
        self.to(device)  # the static tables
        if device.type != "meta":
            self.init_params(torch.Generator().manual_seed(int(seed)))
        # static verification (repro_torch.analysis.verify): the ctor knob
        # wins, else the REPRO_VERIFY environment variable ("off" |
        # "report" | "raise")
        self.verify_report = None
        mode = verify if verify is not None else os.environ.get(
            "REPRO_VERIFY", "off").strip().lower()
        if mode in ("off", "", "0"):
            return
        if mode not in ("report", "raise"):
            raise ValueError(
                f"verify={mode!r}; expected 'off', 'report' or 'raise'")
        from repro_torch.analysis.verify import VerifyError, verify_einet

        self.verify_report = verify_einet(self)
        if not self.verify_report.ok:
            if mode == "raise":
                raise VerifyError(self.verify_report)
            print(self.verify_report.format_report())

    # ------------------------------------------------------------------ build
    def _build(self) -> None:
        graph = self.graph
        leaves, pairs = rg_lib.topological_layers(graph)
        leaf_scopes = [graph.regions[i] for i in leaves]
        leaf_replica, num_replica = rg_lib.assign_replicas(leaf_scopes)

        pair_var = np.concatenate(
            [np.asarray(s, dtype=np.int32) for s in leaf_scopes]
        )
        pair_rep = np.concatenate(
            [
                np.full(len(s), leaf_replica[i], dtype=np.int32)
                for i, s in enumerate(leaf_scopes)
            ]
        )
        pair_leaf = np.concatenate(
            [np.full(len(s), i, dtype=np.int32) for i, s in enumerate(leaf_scopes)]
        )
        self.leaf_spec = LeafSpec(
            pair_var=pair_var,
            pair_rep=pair_rep,
            pair_leaf=pair_leaf,
            num_leaves=len(leaves),
            num_replica=int(num_replica),
            leaf_scopes=leaf_scopes,
            leaf_replica=leaf_replica,
        )

        region_row: Dict[int, int] = {r: i for i, r in enumerate(leaves)}
        next_row = len(leaves)
        self.pair_specs: List[PairSpec] = []
        for t, (l_p, l_s) in enumerate(pairs):
            is_final = t == len(pairs) - 1
            if is_final and l_s != [graph.root]:
                raise ValueError("final sum layer must be the root")
            k_out = self.num_classes if is_final else self.K
            part_local = {p: i for i, p in enumerate(l_p)}
            left = np.array(
                [region_row[graph.partitions[p][1]] for p in l_p], dtype=np.int32
            )
            right = np.array(
                [region_row[graph.partitions[p][2]] for p in l_p], dtype=np.int32
            )
            einsum_global = np.arange(next_row, next_row + len(l_p), dtype=np.int32)
            next_row += len(l_p)

            mixed_regions = [s for s in l_s if len(graph.region_children[s]) > 1]
            mix_child_local = mix_mask = mix_global = None
            if mixed_regions:
                c_max = max(len(graph.region_children[s]) for s in mixed_regions)
                mix_child_local = np.zeros((len(mixed_regions), c_max), np.int32)
                mix_mask = np.zeros((len(mixed_regions), c_max), np.float32)
                for m, s in enumerate(mixed_regions):
                    kids = [part_local[p] for p in graph.region_children[s]]
                    mix_child_local[m, : len(kids)] = kids
                    mix_mask[m, : len(kids)] = 1.0
                mix_global = np.arange(
                    next_row, next_row + len(mixed_regions), dtype=np.int32
                )
                next_row += len(mixed_regions)
                for m, s in enumerate(mixed_regions):
                    region_row[s] = int(mix_global[m])
            for s in l_s:
                if len(graph.region_children[s]) == 1:
                    p = graph.region_children[s][0]
                    region_row[s] = int(einsum_global[part_local[p]])

            self.pair_specs.append(
                PairSpec(
                    left=left,
                    right=right,
                    einsum_global=einsum_global,
                    k_in=self.K,
                    k_out=k_out,
                    mix_child_local=mix_child_local,
                    mix_mask=mix_mask,
                    mix_global=mix_global,
                    is_final=is_final,
                )
            )
        self.total_rows = next_row  # includes final-layer rows (never buffered)
        self.root_row = region_row[graph.root]
        final = self.pair_specs[-1]
        self.buffer_rows = final.einsum_global[0]
        self._canonicalize()
        self.needs_buffer = any(not p.canonical for p in self.pair_specs)

    def _canonicalize(self) -> None:
        """Reorder each layer so children are contiguous: whenever a pair's
        children are exactly the previous layer's outputs, each consumed
        once (every pair of the RAT structure), its gather becomes two
        static slices; other pairs keep the general gather path."""
        specs = self.pair_specs
        for i in range(len(specs) - 1, -1, -1):
            cur = specs[i]
            child = np.concatenate([cur.left, cur.right])
            if i == 0:
                n = self.leaf_spec.num_leaves
                if len(child) != n or sorted(child.tolist()) != list(range(n)):
                    continue
                # reorder the leaf layer itself
                order = child.tolist()
                ls = self.leaf_spec
                scopes = [ls.leaf_scopes[j] for j in order]
                replica = ls.leaf_replica[order]
                ls.leaf_scopes = scopes
                ls.leaf_replica = replica
                ls.pair_var = np.concatenate(
                    [np.asarray(s, np.int32) for s in scopes])
                ls.pair_rep = np.concatenate([
                    np.full(len(s), replica[j], np.int32)
                    for j, s in enumerate(scopes)])
                ls.pair_leaf = np.concatenate([
                    np.full(len(s), j, np.int32)
                    for j, s in enumerate(scopes)])
                half = len(cur.left)
                cur.left = np.arange(half, dtype=np.int32)
                cur.right = np.arange(half, 2 * half, dtype=np.int32)
                cur.canonical = True
                continue
            prev = specs[i - 1]
            if prev.mix_global is not None:
                continue
            base = int(prev.einsum_global[0])
            rows = prev.einsum_global.tolist()
            if sorted(child.tolist()) != rows:
                continue
            order = [int(r) - base for r in child]  # new local -> old local
            prev.left = prev.left[order]
            prev.right = prev.right[order]
            half = len(cur.left)
            cur.left = prev.einsum_global[:half]
            cur.right = prev.einsum_global[half:]
            cur.canonical = True

    def _register_tables(self) -> None:
        """The static tables as non-persistent buffers, so they follow the
        module to its device."""
        ls = self.leaf_spec
        d_r = self.num_vars * ls.num_replica
        # leaf row j sums the EF rows of its scope; scopes are padded to one
        # length with a pointer to an all-zero row, so the sum is a fixed
        # sequence of elementwise adds
        width = max(len(s) for s in ls.leaf_scopes)
        gather = np.full((ls.num_leaves, width), d_r, np.int64)
        used = np.zeros(ls.num_leaves, np.int64)
        for v, r, j in zip(ls.pair_var, ls.pair_rep, ls.pair_leaf):
            gather[j, used[j]] = int(v) * ls.num_replica + int(r)
            used[j] += 1
        tables = {
            "leaf_gather": gather,
            "leaf_pair_var": ls.pair_var,
            "leaf_pair_rep": ls.pair_rep,
            "leaf_pair_leaf": ls.pair_leaf,
        }
        for i, sp in enumerate(self.pair_specs):
            tables[f"pair{i}_left"] = sp.left
            tables[f"pair{i}_right"] = sp.right
            tables[f"pair{i}_einsum_global"] = sp.einsum_global
            if sp.mix_global is not None:
                tables[f"pair{i}_mix_child"] = sp.mix_child_local
                tables[f"pair{i}_mix_mask"] = sp.mix_mask
                tables[f"pair{i}_mix_global"] = sp.mix_global
        for name, arr in tables.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if t.dtype != torch.float32:
                t = t.to(torch.int64)
            self.register_buffer(name, t, persistent=False)

    def _table(self, i: int, name: str) -> torch.Tensor:
        return getattr(self, f"pair{i}_{name}")

    def _noise_layout(self) -> None:
        """Offsets of each categorical choice's Gumbel noise, and of the leaf
        draws' uniforms, in a row's noise vector (``noise_size`` floats)."""
        off = 0
        self._noise: Dict[Any, Tuple[int, Tuple[int, ...]]] = {}

        def take(key, shape):
            nonlocal off
            self._noise[key] = (off, shape)
            off += int(np.prod(shape))

        take("root", (self.num_classes,))
        for i in reversed(range(len(self.pair_specs))):
            sp = self.pair_specs[i]
            if sp.mix_global is not None:
                take(("mix", i), (sp.num_mixed, sp.mix_child_local.shape[1]))
            take(("einsum", i), (sp.num_partitions, self.K * self.K))
        take("leaves", (len(self.leaf_spec.pair_var), self.ef.noise_per_draw))
        self.noise_size = off

    # ------------------------------------------------------------------- plan
    @property
    def grouped_active(self) -> bool:
        """True when the forward hot path runs fused segments."""
        return self.plan.grouped_active

    def grouping_summary(self) -> Dict[str, Any]:
        return self.plan.summary()

    @property
    def device(self) -> torch.device:
        return self.class_prior.device

    # ------------------------------------------------------------- parameters
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random initialisation (the reference's ``init`` distribution),
        drawn on the CPU from ``generator`` so a seed gives the same
        parameters on every device."""
        dev = self.device
        ls = self.leaf_spec
        self.phi.copy_(self.ef.init_phi(
            generator, (self.num_vars, self.K, ls.num_replica)).to(dev))
        for i, sp in enumerate(self.pair_specs):
            w = 0.1 + 0.9 * torch.rand(
                (sp.num_partitions, sp.k_out, sp.k_in, sp.k_in),
                generator=generator)
            self.einsum[i].copy_(normalize_einsum_weights(w).to(dev))
            if sp.mix_global is not None:
                v = 0.1 + 0.9 * torch.rand(
                    (sp.num_mixed, sp.mix_child_local.shape[1], sp.k_out),
                    generator=generator)
                mask = torch.from_numpy(sp.mix_mask)
                self.mixing[i].copy_(normalize_mixing_weights(v, mask).to(dev))
        self.class_prior.fill_(1.0 / self.num_classes)

    @torch.no_grad()
    def project_params(self) -> None:
        """Re-normalize all weights and clamp EF parameters to valid domains,
        in place."""
        self.phi.copy_(self.ef.project_phi(self.phi))
        for i, sp in enumerate(self.pair_specs):
            self.einsum[i].copy_(normalize_einsum_weights(self.einsum[i]))
            if sp.mix_global is not None:
                self.mixing[i].copy_(normalize_mixing_weights(
                    self.mixing[i], self._table(i, "mix_mask")))
        prior = torch.clamp(self.class_prior, min=1e-12)
        self.class_prior.copy_(prior / torch.sum(prior))

    # ---------------------------------------------------------------- forward
    def leaf_log_prob(self, x: torch.Tensor,
                      marg_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """EF tensor E (B, D, K, R), with marginalized variables set to log 1 = 0."""
        e = self.ef.log_prob(x, self.phi)
        if marg_mask is not None:
            e = torch.where(marg_mask[:, :, None, None], e, torch.zeros_like(e))
        return e

    def _leaf_rows(self, e: torch.Tensor) -> torch.Tensor:
        """Factorize E into leaf-region rows: (B, num_leaves, K).

        The reference's ``segment_sum`` becomes a gather of each leaf's
        scope rows plus elementwise adds in scope order, not ``index_add_``:
        on CUDA ``index_add_`` accumulates with atomics in no fixed order,
        and a row's leaf sums must not depend on its neighbours."""
        b, d, k, r = e.shape
        e_flat = e.permute(1, 3, 0, 2).reshape(d * r, b, k)
        e_flat = torch.cat([e_flat, e_flat.new_zeros(1, b, k)])
        g = e_flat[self.leaf_gather]  # (num_leaves, S, B, K)
        summed = g[:, 0]
        for s in range(1, g.shape[1]):
            summed = summed + g[:, s]
        return summed.permute(1, 0, 2).contiguous()

    def forward_from_e(
        self,
        e: Optional[torch.Tensor],
        return_cache: bool = False,
        leaf_rows: Optional[torch.Tensor] = None,
    ):
        """Bottom-up pass from the leaf EF tensor (or precomputed leaf rows).
        Returns (B, num_classes) root log-densities (and the per-pair cache
        when ``return_cache``).

        With grouped segments in the plan and no cache requested, the pass
        walks the plan: each fused or gather segment is one grouped
        log-einsum-exp launch.  The sampling path (``return_cache``) needs
        every depth's activations, so it runs per layer, one launch per
        pair.
        """
        if leaf_rows is None:
            leaf_rows = self._leaf_rows(e)
        if self.grouped_active and not return_cache:
            if self.needs_buffer:
                return self._forward_planned_buffer(leaf_rows)
            return self._forward_planned(leaf_rows)
        buffer = leaf_rows
        build_buffer = self.needs_buffer or return_cache
        cache: Dict[str, Any] = {"S": []}
        prev_out = leaf_rows
        root_out = None
        for i, spec in enumerate(self.pair_specs):
            if spec.canonical:
                half = spec.num_partitions
                n_l = prev_out[:, :half, :]
                n_r = prev_out[:, half: 2 * half, :]
            else:
                n_l = buffer[:, self._table(i, "left"), :]
                n_r = buffer[:, self._table(i, "right"), :]
            s = self.pair_log_einsum_exp(self.einsum[i], n_l, n_r)
            health_lib.tap_segment(s)
            new_rows = [s]
            mix_out = None
            if spec.mix_global is not None:
                ln = s[:, self._table(i, "mix_child"), :]  # (B, M, C, k_out)
                mix_out = log_mix_exp(self.mixing[i], ln,
                                      self._table(i, "mix_mask"))
                new_rows.append(mix_out)
            if return_cache:
                cache["S"].append(s)
            if spec.is_final:
                root_out = mix_out if spec.mix_global is not None else s[:, 0, :]
            else:
                prev_out = s if mix_out is None else torch.cat([s, mix_out], 1)
                if build_buffer:
                    buffer = torch.cat([buffer] + new_rows, dim=1)
        if root_out.dim() == 3:  # root was a mixing row: (B, 1, num_classes)
            root_out = root_out[:, 0, :]
        if return_cache:
            cache["buffer"] = buffer
            return root_out, cache
        return root_out

    def pair_log_einsum_exp(self, w: torch.Tensor, ln_left: torch.Tensor,
                            ln_right: torch.Tensor) -> torch.Tensor:
        """One pair's einsum layer, (B, L, K) x 2 -> (B, L, K_out): the
        kernel op (K1, under autograd K2).  The naive baseline
        (``core.baseline.NaiveEiNet``) overrides it."""
        return ops.log_einsum_exp(w, ln_left, ln_right)

    def _forward_planned(self, leaf_rows: torch.Tensor) -> torch.Tensor:
        """The depth-grouped bottom-up pass over an all-canonical plan:
        "fused" segments are one grouped launch, "layer" segments the
        per-layer op on the previous layer's two static slices.

        Each segment counts one ``plan.segment.traces`` (kind label) and is
        one ``plan.segment`` span (kind, start, stop), as in the reference.
        The walk runs once an eager call and once a CUDA-graph capture, so
        the counter counts walks and a replay adds nothing; the span is
        host time unless an ``obs.set_sync`` hook makes each segment wait
        for its output (:func:`_sync_segment`)."""
        prev_out = leaf_rows
        root_out = None
        for seg in self.exec_plan:
            last = self.pair_specs[seg.stop - 1]
            obs.METRICS.counter("plan.segment.traces", kind=seg.kind).inc()
            with obs.span("plan.segment", kind=seg.kind, start=seg.start,
                          stop=seg.stop):
                if seg.fused:
                    ws = [self.einsum[t] for t in range(seg.start, seg.stop)]
                    s = ops.grouped_log_einsum_exp(ws, prev_out)
                else:
                    half = last.num_partitions
                    s = self.pair_log_einsum_exp(
                        self.einsum[seg.start],
                        prev_out[:, :half, :],
                        prev_out[:, half: 2 * half, :],
                    )
                health_lib.tap_segment(s)
                mix_out = None
                if last.mix_global is not None:
                    i = seg.stop - 1
                    ln = s[:, self._table(i, "mix_child"), :]
                    mix_out = log_mix_exp(self.mixing[i], ln,
                                          self._table(i, "mix_mask"))
                _sync_segment(s if mix_out is None else mix_out)
            if last.is_final:
                root_out = mix_out if last.mix_global is not None else s[:, 0, :]
            else:
                prev_out = s if mix_out is None else torch.cat([s, mix_out], 1)
        if root_out.dim() == 3:
            root_out = root_out[:, 0, :]
        return root_out

    def _forward_planned_buffer(self, leaf_rows: torch.Tensor) -> torch.Tensor:
        """The plan walk for gather-topology (Poon-Domingos) structures,
        over the global row buffer: leaves first, then each pair's einsum
        rows followed by its mixing rows, the allocation order of
        ``_build``.  A "gather" segment is one gather-grouped launch (mixing
        inside the kernel) whose new rows append in global order; a "layer"
        segment is the per-pair op on the buffer's gathered children, then
        its mixing.  The planner emits no "fused" segment here: it would
        skip interior rows and leave holes in the buffer.  Segments are
        counted and spanned as in :meth:`_forward_planned`."""
        buffer = leaf_rows
        root_out = None
        for seg in self.exec_plan:
            obs.METRICS.counter("plan.segment.traces", kind=seg.kind).inc()
            if seg.kind == "gather":
                with obs.span("plan.segment", kind=seg.kind,
                              start=seg.start, stop=seg.stop):
                    span = range(seg.start, seg.stop)
                    ws = [self.einsum[t] for t in span]
                    vs = [self.mixing[t] for t in span
                          if self.pair_specs[t].mix_global is not None]
                    new = ops.gather_grouped_log_einsum_exp(seg.tables, ws,
                                                            vs, buffer)
                    health_lib.tap_segment(new)
                    buffer = torch.cat([buffer, new], dim=1)
                    _sync_segment(buffer)
                continue
            with obs.span("plan.segment", kind=seg.kind, start=seg.start,
                          stop=seg.stop):
                i = seg.start
                spec = self.pair_specs[i]
                s = self.pair_log_einsum_exp(
                    self.einsum[i], buffer[:, self._table(i, "left"), :],
                    buffer[:, self._table(i, "right"), :])
                health_lib.tap_segment(s)
                mix_out = None
                if spec.mix_global is not None:
                    ln = s[:, self._table(i, "mix_child"), :]
                    mix_out = log_mix_exp(self.mixing[i], ln,
                                          self._table(i, "mix_mask"))
                _sync_segment(s if mix_out is None else mix_out)
            if spec.is_final:
                root_out = mix_out if spec.mix_global is not None else s[:, 0, :]
            else:
                new = s if mix_out is None else torch.cat([s, mix_out], 1)
                buffer = torch.cat([buffer, new], dim=1)
        if root_out.dim() == 3:
            root_out = root_out[:, 0, :]
        return root_out

    def forward(
        self,
        x: torch.Tensor,
        marg_mask: Optional[torch.Tensor] = None,
        return_cache: bool = False,
    ):
        e = self.leaf_log_prob(x, marg_mask)
        return self.forward_from_e(e, return_cache=return_cache)

    def log_likelihood(
        self, x: torch.Tensor, marg_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """log P(x) = logsumexp_c [log prior_c + log P(x | c)], shape (B,)."""
        root = self.forward(x, marg_mask)
        return torch.logsumexp(
            root + torch.log(self.class_prior)[None, :], dim=-1)

    def conditional_log_likelihood(
        self,
        x: torch.Tensor,
        query_mask: torch.Tensor,
        evidence_mask: torch.Tensor,
    ) -> torch.Tensor:
        """log p(x_q | x_e) = log p(x_q, x_e) - log p(x_e)  (Eq. 1, exact)."""
        joint = self.log_likelihood(x, query_mask | evidence_mask)
        ev = self.log_likelihood(x, evidence_mask)
        return joint - ev

    # --------------------------------------------------------------- sampling
    def row_noise(self, seeds, lead: int = 0) -> torch.Tensor:
        """(B, lead + noise_size) uniforms in [_U_MIN, 1 - _U_MIN]: row b
        is Philox4x32-10 keyed by ``seeds[b]`` (``core.philox.uniforms``),
        so it depends on that seed alone and is the same on every device.
        ``seeds`` is a (B,) int64 tensor or a sequence of ints.  ``lead``
        floats come first, for a choice made before this model's pass (a
        mixture's component)."""
        seeds = seed_tensor(seeds, self.device)
        u = philox.uniforms(seeds, int(lead) + self.noise_size)
        return torch.clamp(u, _U_MIN, 1.0 - _U_MIN)

    def _noise_slice(self, noise: torch.Tensor, key) -> torch.Tensor:
        off, shape = self._noise[key]
        size = int(np.prod(shape))
        return noise[:, off: off + size].reshape((noise.shape[0],) + shape)

    def _choose(self, logits: torch.Tensor, noise: Optional[torch.Tensor],
                key) -> torch.Tensor:
        """argmax decoding, or a categorical draw by the Gumbel-max trick."""
        if noise is None:
            return torch.argmax(logits, dim=-1)
        g = self._noise_slice(noise, key).reshape(logits.shape)
        return torch.argmax(logits + gumbel(g), dim=-1)

    def sample(self, num_samples: int, seeds: Optional[Sequence[int]] = None,
               mode: str = "sample") -> torch.Tensor:
        """Unconditional ancestral sampling: (num_samples, D).  Row b draws
        with ``seeds[b]`` (default: b)."""
        seeds = seed_tensor(range(num_samples) if seeds is None else seeds,
                            self.device)
        if len(seeds) != num_samples:
            raise ValueError(f"{len(seeds)} seeds for {num_samples} samples")
        x = torch.zeros((num_samples, self.num_vars), device=self.device)
        marg = torch.zeros((num_samples, self.num_vars), dtype=torch.bool,
                           device=self.device)
        return self.conditional_sample_per_key(seeds, x, marg, mode=mode)

    def conditional_sample_per_key(
        self,
        seeds,
        x: torch.Tensor,
        evidence_mask: torch.Tensor,
        mode: str = "sample",
    ) -> torch.Tensor:
        """Row-independent conditional sampling: one seed per batch row (a
        (B,) int64 tensor or a sequence of ints).  Every row's draw is a
        function of its own (seed, x, evidence), so results do not depend
        on how requests are coalesced into batches."""
        seeds = seed_tensor(seeds, x.device)
        if len(seeds) != x.shape[0]:
            raise ValueError(f"{len(seeds)} seeds for {x.shape[0]} rows")
        noise = self.row_noise(seeds) if mode == "sample" else None
        return self.conditional_sample(x, evidence_mask, noise, mode=mode)

    def conditional_sample(
        self,
        x: torch.Tensor,
        evidence_mask: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        mode: str = "sample",
    ) -> torch.Tensor:
        """Sample X_m ~ p(. | x_e): the inpainting operation.

        Bottom-up pass with the evidence complement marginalized out, then a
        top-down induced-tree pass where every categorical choice is
        re-weighted by the children's (evidence-conditioned)
        log-likelihoods.  ``mode='sample'`` consumes ``noise`` (B,
        noise_size) uniforms in (0, 1) -- Gumbel noise for every choice and
        the leaf draws' uniforms; ``mode='argmax'`` is the greedy MPE-style
        decode and uses no noise.
        """
        if mode not in ("sample", "argmax"):
            raise ValueError(f"mode {mode!r}; expected 'sample' or 'argmax'")
        if mode == "sample":
            if noise is None or noise.shape != (x.shape[0], self.noise_size):
                raise ValueError(
                    f"mode='sample' needs noise of shape "
                    f"({x.shape[0]}, {self.noise_size})")
        else:
            noise = None
        dev = x.device
        b = x.shape[0]
        root, cache = self.forward(x, evidence_mask, return_cache=True)
        buffer = cache["buffer"]
        dummy = self.total_rows
        comp = torch.full((b, self.total_rows + 1), -1, dtype=torch.int64,
                          device=dev)
        # root class choice
        logits = root + torch.log(self.class_prior)[None, :]
        comp[:, self.root_row] = self._choose(logits, noise, "root")
        rows_b = torch.arange(b, device=dev)[:, None]

        for i in reversed(range(len(self.pair_specs))):
            spec = self.pair_specs[i]
            s_cache = cache["S"][i]  # (B, L, k_out)
            einsum_global = self._table(i, "einsum_global")
            # -- mixing rows first: they activate einsum rows
            if spec.mix_global is not None:
                mix_child = self._table(i, "mix_child")  # (M, C)
                m, c = mix_child.shape
                k = comp[:, self._table(i, "mix_global")]  # (B, M)
                active = k >= 0
                kk = torch.clamp(k, min=0)
                logv = torch.log(torch.clamp(self.mixing[i], min=1e-38))
                sel = kk[:, :, None, None].expand(b, m, c, 1)
                lv = logv[None].expand(b, -1, -1, -1).gather(3, sel)[..., 0]
                child_ll = s_cache[:, mix_child, :]  # (B, M, C, k_out)
                cll = child_ll.gather(3, sel)[..., 0]  # (B, M, C)
                logits = torch.where(
                    self._table(i, "mix_mask")[None] > 0, lv + cll,
                    torch.full_like(lv, NEG_INF))
                cidx = self._choose(logits, noise, ("mix", i))  # (B, M)
                child_local = mix_child[None].expand(b, -1, -1).gather(
                    2, cidx[:, :, None])[..., 0]  # (B, M)
                child_global = einsum_global[child_local]
                rows = torch.where(active, child_global,
                                   torch.full_like(child_global, dummy))
                comp[rows_b, rows] = kk
            # -- einsum rows: choose (i, j) and activate the two children
            k = comp[:, einsum_global]  # (B, L)
            active = k >= 0
            kk = torch.clamp(k, min=0)
            w = self.einsum[i]  # (L, k_out, K, K)
            n_cells = spec.num_partitions
            wk = w[torch.arange(n_cells, device=dev)[None], kk]  # (B, L, K, K)
            n_l = buffer[:, self._table(i, "left"), :]  # (B, L, K)
            n_r = buffer[:, self._table(i, "right"), :]
            logits = (
                torch.log(torch.clamp(wk, min=1e-38))
                + n_l[:, :, :, None]
                + n_r[:, :, None, :]
            ).reshape(b, n_cells, -1)
            flat = self._choose(logits, noise, ("einsum", i))
            ii = flat // self.K
            jj = flat % self.K
            left = self._table(i, "left")[None].expand(b, -1)
            right = self._table(i, "right")[None].expand(b, -1)
            comp[rows_b, torch.where(active, left, torch.full_like(left, dummy))] = ii
            comp[rows_b, torch.where(active, right, torch.full_like(right, dummy))] = jj

        # -- leaves: draw every variable of every active leaf
        ls = self.leaf_spec
        pair_var = self.leaf_pair_var
        k_p = comp[:, : ls.num_leaves][:, self.leaf_pair_leaf]  # (B, P)
        act_p = k_p >= 0
        kk = torch.clamp(k_p, min=0)
        phi = self.phi[pair_var, :, self.leaf_pair_rep]  # (P, K, T)
        t_dim = phi.shape[-1]
        phi_sel = phi[None].expand(b, -1, -1, -1).gather(
            2, kk[:, :, None, None].expand(-1, -1, 1, t_dim))[:, :, 0, :]
        if mode == "argmax":
            draws = self.ef.mode(phi_sel)  # deterministic MPE-style decode
        else:
            draws = self.ef.sample(phi_sel, self._noise_slice(noise, "leaves"))
        cols = torch.where(act_p, pair_var[None].expand(b, -1),
                           torch.full_like(k_p, self.num_vars))
        out = torch.zeros((b, self.num_vars + 1), dtype=x.dtype, device=dev)
        out[rows_b, cols] = draws.to(x.dtype)
        return torch.where(evidence_mask, x, out[:, : self.num_vars])

    # ----------------------------------------------------------------- query
    @torch.inference_mode()
    def query(self, batch: Dict[str, Any], kind: str) -> torch.Tensor:
        """Uniform exact-inference entry point (the serving-engine surface),
        run under ``torch.inference_mode()``.

        ``batch`` carries "x" (B, D) float32, "evidence_mask" /
        "query_mask" (B, D) bool and "seeds" (B,) int64 tensors on the
        model's device (a sequence of ints is also taken for "seeds"); each
        kind ignores the fields it does not need.

        Kinds: "joint_ll" -> (B,) log p(x); "marginal_ll" -> (B,) log p(x_e);
        "conditional_ll" -> (B,) log p(x_q | x_e); "sample" -> (B, D)
        unconditional draws; "conditional_sample" -> (B, D) draws of the
        evidence complement; "mpe" -> (B, D) greedy argmax decode.
        """
        x = batch["x"]
        if kind == "joint_ll":
            return self.log_likelihood(x)
        if kind == "marginal_ll":
            return self.log_likelihood(x, batch["evidence_mask"])
        if kind == "conditional_ll":
            return self.conditional_log_likelihood(
                x, batch["query_mask"], batch["evidence_mask"])
        seeds = batch["seeds"]
        if kind == "sample":
            return self.conditional_sample_per_key(
                seeds, torch.zeros_like(x),
                torch.zeros_like(batch["evidence_mask"]))
        if kind == "conditional_sample":
            return self.conditional_sample_per_key(
                seeds, x, batch["evidence_mask"])
        if kind == "mpe":
            return self.conditional_sample_per_key(
                seeds, x, batch["evidence_mask"], mode="argmax")
        raise ValueError(f"unknown query kind {kind!r}; one of {QUERY_KINDS}")
