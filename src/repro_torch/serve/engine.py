"""Batched exact-inference engine for Einsum Networks.

Heterogeneous requests (joint LL, marginal LL, conditional LL,
conditional/unconditional sampling, MPE decode) enter one FIFO, are
coalesced into micro-batches per (kind, component), padded up to a
power-of-two *batch bucket*, and executed by one eager ``model.query`` call
under ``torch.inference_mode()``.

  * Bucket padding uses filler rows (zeros, empty masks, seed 0) that are
    sliced off before results are returned.  LL kinds are row-independent;
    sampling kinds draw each row's noise from that row's own seed
    (``EiNet.conditional_sample_per_key``), so a request's result is a
    function of its own (seed, x, evidence) and never of its micro-batch
    neighbours or of the bucket size.
  * Per-request determinism: a request with ``seed`` samples exactly as a
    direct ``model.conditional_sample_per_key([seed], ...)`` call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.einet import QUERY_KINDS
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


class ServeEngine:
    """Batched exact-inference serving engine over one EiNet, or one
    ``EiNetMixture`` (its ``query_kinds`` and ``component_kinds``)."""

    def __init__(
        self,
        model,
        max_batch: int = 64,
        buckets: Optional[Sequence[int]] = None,
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
        self.stats = {"steps": 0, "requests": 0, "padded_rows": 0}

    # ----------------------------------------------------------- submission
    def submit(self, request: Request) -> None:
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

    def submit_many(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.submit(r)

    # ------------------------------------------------------------ execution
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _assemble(self, reqs: List[Request], bucket: int) -> Dict[str, Any]:
        d = self.model.num_vars
        x = np.zeros((bucket, d), np.float32)
        ev = np.zeros((bucket, d), bool)
        qm = np.zeros((bucket, d), bool)
        seeds = [0] * bucket
        for i, r in enumerate(reqs):
            if r.x is not None:
                x[i] = r.x
            if r.evidence_mask is not None:
                ev[i] = r.evidence_mask
            if r.query_mask is not None:
                qm[i] = r.query_mask
            seeds[i] = int(r.seed)
        dev = self.model.device
        return {
            "x": torch.from_numpy(x).to(dev),
            "evidence_mask": torch.from_numpy(ev).to(dev),
            "query_mask": torch.from_numpy(qm).to(dev),
            "seeds": seeds,
        }

    def _execute(self, kind: str, component: Optional[int],
                 reqs: List[Request]) -> List[Result]:
        bucket = self._bucket_for(len(reqs))
        batch = self._assemble(reqs, bucket)
        with torch.inference_mode():
            if component is None:
                out = self.model.query(batch, kind)
            else:
                out = self.model.query(batch, kind, component=int(component))
        out = out.cpu().numpy()[: len(reqs)]
        self.stats["padded_rows"] += bucket - len(reqs)
        self.stats["requests"] += len(reqs)
        return [Result(r.req_id, kind, out[i]) for i, r in enumerate(reqs)]

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
        leases = [self.slots.acquire() for _ in reqs]
        try:
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
