"""Batched exact-inference engine for Einsum Networks.

Heterogeneous requests (joint LL, marginal LL, conditional LL,
conditional/unconditional sampling, MPE decode) enter one FIFO, are
coalesced into micro-batches per (kind, component), padded up to a
power-of-two *batch bucket*, and executed through a program cache keyed
by ``(kind, bucket[, component])`` (``repro_torch.compile``): on the card
each program is a CUDA graph of the whole ``model.query`` call, captured
once on static input buffers and replayed a batch, so the number of graphs
is bounded by kinds x buckets (x components) whatever the traffic, and a
steady-state batch pays no host-side launch cost; on the CPU a program is
the eager ``model.query`` call.

  * Bucket padding uses filler rows (zeros, empty masks, seed 0) that are
    sliced off before results are returned.  LL kinds are row-independent;
    sampling kinds draw each row's noise from that row's own seed
    (counter-based, ``EiNet.row_noise``), so a request's result is a
    function of its own (seed, x, evidence) and never of its micro-batch
    neighbours or of the bucket size.
  * Per-request determinism: a request with ``seed`` samples exactly as a
    direct ``model.conditional_sample_per_key([seed], ...)`` call.
  * Programs live in a shared registry anchored to the model (default
    ``compile.REGISTRY``); the engine keeps its own view of the keys it
    serves, so ``num_programs`` and ``stats`` are per engine.  ``warmup``
    captures programs ahead of a timed drain.

The engine records the reference's serve metrics (``repro_torch.obs``):
queue depth, per-request queue wait and end-to-end latency, coalesce and
execute times, program-cache hits and misses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch.core.einet import QUERY_KINDS
from repro_torch.obs import METRICS
from repro_torch.serve.queue import RequestQueue, SlotManager

LL_KINDS = ("joint_ll", "marginal_ll", "conditional_ll")
SAMPLE_KINDS = ("sample", "conditional_sample", "mpe")


@dataclasses.dataclass
class Request:
    """One exact-inference query.  ``x``/masks are per-variable vectors (D,);
    kinds that do not need a field may leave it None (zero-filled).

    ``component`` pins a mixture request to one mixture component (required
    by the model's ``component_kinds``, rejected for every other kind); it
    is part of the coalescing group.
    """

    req_id: int
    kind: str
    x: Optional[np.ndarray] = None
    evidence_mask: Optional[np.ndarray] = None
    query_mask: Optional[np.ndarray] = None
    seed: int = 0
    component: Optional[int] = None


@dataclasses.dataclass
class Result:
    req_id: int
    kind: str
    value: np.ndarray  # () log-likelihood, or (D,) sample / decode


def assemble_batch(model, reqs: Sequence[Request],
                   bucket: int) -> Dict[str, torch.Tensor]:
    """The ``model.query`` batch of ``bucket`` rows for ``reqs``, on the
    model's device: each request's fields in its row (zeros for a missing
    ``x``, empty masks for missing ones; "seeds" a (bucket,) int64 tensor),
    filler rows (zeros, empty masks, seed 0) after them."""
    d = model.num_vars
    x = np.zeros((bucket, d), np.float32)
    ev = np.zeros((bucket, d), bool)
    qm = np.zeros((bucket, d), bool)
    seeds = np.zeros(bucket, np.int64)
    for i, r in enumerate(reqs):
        if r.x is not None:
            x[i] = r.x
        if r.evidence_mask is not None:
            ev[i] = r.evidence_mask
        if r.query_mask is not None:
            qm[i] = r.query_mask
        seeds[i] = int(r.seed)
    dev = model.device
    return {
        "x": torch.from_numpy(x).to(dev),
        "evidence_mask": torch.from_numpy(ev).to(dev),
        "query_mask": torch.from_numpy(qm).to(dev),
        "seeds": torch.from_numpy(seeds).to(dev),
    }


def run_query(model, batch: Dict[str, torch.Tensor], kind: str,
              component: Optional[int] = None) -> torch.Tensor:
    """``model.query`` of one kind (pinned to ``component`` where given):
    the function a program records (``query_fn``)."""
    if component is None:
        return model.query(batch, kind)
    return model.query(batch, kind, component=int(component))


def query_fn(kind: str, component: Optional[int] = None
             ) -> compile_lib.QueryFn:
    """``run_query`` for one kind (and component), taking the model as its
    first argument, as ``ProgramRegistry.capture`` wants."""
    return functools.partial(run_query, kind=kind, component=component)


class ServeEngine:
    """Batched exact-inference serving engine over one EiNet, or one
    ``EiNetMixture`` (its ``query_kinds`` and ``component_kinds``)."""

    def __init__(
        self,
        model,
        max_batch: int = 64,
        buckets: Optional[Sequence[int]] = None,
        registry: Optional[compile_lib.ProgramRegistry] = None,
    ):
        self.model = model
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[-1] != max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} must equal max_batch {max_batch}"
            )
        self.query_kinds: Tuple[str, ...] = tuple(
            getattr(model, "query_kinds", QUERY_KINDS)
        )
        self.component_kinds: Tuple[str, ...] = tuple(
            getattr(model, "component_kinds", ())
        )
        self.queue = RequestQueue(key_fn=lambda r: (r.kind, r.component))
        self.slots = SlotManager(max_batch)
        # programs live in the shared registry (anchored to the model);
        # this dict is the engine's own view of the keys it serves, so
        # num_programs / stats stay per engine under a shared registry
        self.registry = (registry if registry is not None
                         else compile_lib.REGISTRY)
        self._programs: Dict[tuple, compile_lib.Program] = {}
        self.stats = {
            "compiles": 0,  # programs materialized into THIS engine's view
            "compile_s": 0.0,  # capture seconds paid by this engine
            "registry_hits": 0,  # programs another user already captured
            "steps": 0,
            "requests": 0,
            "padded_rows": 0,
        }
        # req_id -> enqueue clock, for the queue-wait and end-to-end
        # latency metrics (popped in _execute)
        self._submit_t: Dict[int, float] = {}

    # ----------------------------------------------------------- submission
    def submit(self, request: Request) -> None:
        self._enqueue(request)
        METRICS.gauge("serve.queue.depth").set(len(self.queue))

    def submit_many(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self._enqueue(r)
        METRICS.gauge("serve.queue.depth").set(len(self.queue))

    def _enqueue(self, request: Request) -> None:
        if request.kind not in self.query_kinds:
            raise ValueError(
                f"unknown query kind {request.kind!r}; one of "
                f"{self.query_kinds}"
            )
        if request.kind in self.component_kinds:
            c = request.component
            num = getattr(self.model, "num_components", 0)
            if c is None or not 0 <= int(c) < num:
                raise ValueError(
                    f"kind {request.kind!r} needs component in [0, {num}); "
                    f"got {c!r}"
                )
        elif request.component is not None:
            raise ValueError(
                f"kind {request.kind!r} does not take a component "
                f"(got {request.component!r})"
            )
        self.queue.submit(request)
        self._submit_t[request.req_id] = obs.now()

    # ------------------------------------------------------- program cache
    @property
    def num_programs(self) -> int:
        """Distinct (kind, bucket[, component]) programs this engine has
        taken from the registry."""
        return len(self._programs)

    @staticmethod
    def _key(kind: str, bucket: int, component: Optional[int]) -> tuple:
        return (kind, bucket) if component is None else (kind, bucket,
                                                        int(component))

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _program(self, kind: str, bucket: int,
                 component: Optional[int] = None) -> compile_lib.Program:
        key = self._key(kind, bucket, component)
        prog = self._programs.get(key)
        if prog is not None:
            # engine-local fast path; misses fall through to the shared
            # registry, which does its own (compile.cache.*) accounting
            METRICS.counter("serve.program_cache.hits", kind=kind).inc()
            return prog
        METRICS.counter("serve.program_cache.misses", kind=kind).inc()
        before = (self.registry.stats["compiles"],
                  self.registry.stats["compile_s"])
        prog = self.registry.capture(
            self.model, key, query_fn(kind, component),
            assemble_batch(self.model, [], bucket))
        if self.registry.stats["compiles"] > before[0]:
            self.stats["compile_s"] += (
                self.registry.stats["compile_s"] - before[1])
        else:
            self.stats["registry_hits"] += 1
        self.stats["compiles"] += 1
        self._programs[key] = prog
        return prog

    def warmup(
        self,
        kinds: Optional[Sequence[str]] = None,
        buckets: Optional[Sequence[int]] = None,
        components: Optional[Sequence[int]] = None,
    ) -> float:
        """Capture the programs of a kind/bucket cross product (on the card:
        one warm-up run and one capture each); returns the seconds it took,
        the cost a deployment pays once, reported apart from steady-state
        latency.  Component-pinned kinds get one program per component (all
        of them by default; pass ``components`` to narrow)."""
        with obs.timed("serve.warmup") as t:
            for kind in kinds or self.query_kinds:
                if kind in self.component_kinds:
                    comps: Sequence[Optional[int]] = (
                        components if components is not None
                        else range(getattr(self.model, "num_components", 0))
                    )
                else:
                    comps = (None,)
                for c in comps:
                    for bucket in buckets or self.buckets:
                        self._program(kind, bucket, c)
        return t.seconds

    # ------------------------------------------------------------ execution
    def _execute(self, kind: str, component: Optional[int],
                 reqs: List[Request]) -> List[Result]:
        bucket = self._bucket_for(len(reqs))
        t_pop = obs.now()
        wait_hist = METRICS.histogram("serve.queue_wait.seconds", kind=kind)
        for r in reqs:
            t_sub = self._submit_t.get(r.req_id)
            if t_sub is not None:
                wait_hist.record(t_pop - t_sub)
        with obs.timed("serve.coalesce", metric="serve.coalesce.seconds",
                       kind=kind, bucket=bucket):
            batch = assemble_batch(self.model, reqs, bucket)
        # the copy to the host waits for the device, so the execute time
        # covers the work
        with obs.timed("serve.execute", metric="serve.execute.seconds",
                       kind=kind, bucket=bucket):
            prog = self._program(kind, bucket, component)
            out = prog(batch).cpu().numpy()
        out = out[: len(reqs)]
        self.stats["padded_rows"] += bucket - len(reqs)
        self.stats["requests"] += len(reqs)
        t_done = obs.now()
        req_hist = METRICS.histogram(
            "serve.request.seconds", kind=kind, bucket=bucket
        )
        results = []
        for i, r in enumerate(reqs):
            t_sub = self._submit_t.pop(r.req_id, None)
            if t_sub is not None:
                req_hist.record(t_done - t_sub)
            results.append(Result(r.req_id, kind, out[i]))
        return results

    def step(self) -> List[Result]:
        """One scheduling step: serve the oldest pending request's coalescing
        group -- (kind, component) -- riding along every queued request of
        that group that fits the free slots.  Returns the retired results
        (empty when idle/saturated)."""
        group = self.queue.oldest_kind()
        if group is None:
            return []
        kind, component = group
        limit = min(self.slots.free, self.buckets[-1])
        if limit == 0:
            return []
        reqs = self.queue.pop_kind(group, limit)
        METRICS.gauge("serve.queue.depth").set(len(self.queue))
        leases = [self.slots.acquire() for _ in reqs]
        try:
            with obs.span("serve.step", kind=kind, n=len(reqs)):
                results = self._execute(kind, component, reqs)
        finally:
            for s in leases:
                if s is not None:
                    self.slots.release(s)
        self.stats["steps"] += 1
        return results

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[int, Result]:
        """Drain the queue (plus ``requests``, if given): step until empty.
        Returns {req_id: Result}."""
        if requests is not None:
            self.submit_many(requests)
        out: Dict[int, Result] = {}
        while len(self.queue):
            for res in self.step():
                out[res.req_id] = res
        return out
