"""Synthetic mixed-kind request streams, the direct (one request at a time)
call path, and the engine-against-direct parity check.

``mixed_requests`` draws the same numpy stream as the reference's
(``repro/serve/workload.py``), so both packages can serve identical traffic;
``mixture_requests`` is its counterpart over a mixture's kinds.
``direct_call`` answers one request with a batch of one, without the
engine's queue, bucketing or coalescing: the parity oracle for the engine.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.einet import QUERY_KINDS
from repro_torch.serve.engine import LL_KINDS, Request, Result

# default traffic mix: LL-heavy with a steady sampling/decode component
DEFAULT_MIX = (
    "joint_ll",
    "marginal_ll",
    "conditional_ll",
    "conditional_sample",
    "joint_ll",
    "sample",
    "marginal_ll",
    "mpe",
)


def mixed_requests(
    num_vars: int,
    n: int,
    seed: int = 0,
    mix: Sequence[str] = DEFAULT_MIX,
) -> list:
    """Deterministic stream of ``n`` heterogeneous requests over ``mix``."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        x = rng.randn(num_vars).astype(np.float32)
        ev = rng.rand(num_vars) < 0.5
        reqs.append(
            Request(
                req_id=i,
                kind=mix[i % len(mix)],
                x=x,
                evidence_mask=ev,
                query_mask=~ev,
                seed=1000 + i,
            )
        )
    return reqs


def mixture_requests(mix, n: int, seed: int = 0) -> list:
    """Deterministic stream of ``n`` requests cycling over all of the
    mixture ``mix``'s ``query_kinds``; the k-th request of one of its
    ``component_kinds`` asks for component ``k % mix.num_components``, so
    each such kind cycles through every component."""
    kinds, pinned = tuple(mix.query_kinds), tuple(mix.component_kinds)
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        cycle, slot = divmod(i, len(kinds))
        kind = kinds[slot]
        x = rng.randn(mix.num_vars).astype(np.float32)
        ev = rng.rand(mix.num_vars) < 0.5
        reqs.append(
            Request(
                req_id=i,
                kind=kind,
                x=x,
                evidence_mask=ev,
                query_mask=~ev,
                seed=1000 + i,
                component=(cycle % mix.num_components
                           if kind in pinned else None),
            )
        )
    return reqs


def direct_call(model) -> Callable[[Request], np.ndarray]:
    """One request at a time (batch of one, no coalescing), through an
    EiNet's own methods, or for a kind the EiNet does not have (a
    mixture's) through the model's ``query`` on a one-row batch; sampling
    kinds use the request's seed as the engine does, so outputs are
    directly comparable."""
    dev = model.device

    def call(req: Request) -> np.ndarray:
        x = torch.from_numpy(np.asarray(req.x, np.float32)[None]).to(dev)
        ev = torch.from_numpy(np.asarray(req.evidence_mask, bool)[None]).to(dev)
        with torch.inference_mode():
            if req.kind not in QUERY_KINDS:
                qm = torch.from_numpy(
                    np.asarray(req.query_mask, bool)[None]).to(dev)
                batch = {"x": x, "evidence_mask": ev, "query_mask": qm,
                         "seeds": [req.seed]}
                out = model.query(batch, req.kind, req.component)
            elif req.kind == "joint_ll":
                out = model.log_likelihood(x)
            elif req.kind == "marginal_ll":
                out = model.log_likelihood(x, ev)
            elif req.kind == "conditional_ll":
                qm = torch.from_numpy(
                    np.asarray(req.query_mask, bool)[None]).to(dev)
                out = model.conditional_log_likelihood(x, qm, ev)
            elif req.kind == "sample":
                out = model.conditional_sample_per_key(
                    [req.seed], torch.zeros_like(x), torch.zeros_like(ev))
            elif req.kind == "conditional_sample":
                out = model.conditional_sample_per_key([req.seed], x, ev)
            elif req.kind == "mpe":
                out = model.conditional_sample_per_key(
                    [req.seed], x, ev, mode="argmax")
            else:
                raise ValueError(f"unknown kind {req.kind!r}")
        return out.cpu().numpy()[0]

    return call


def parity(requests: Sequence[Request], results: Dict[int, Result],
           direct: Dict[int, np.ndarray],
           value_kinds: Sequence[str] = LL_KINDS) -> Dict[str, float]:
    """Engine against direct calls over the ``value_kinds``, whose answers
    are numbers (an EiNet's LL kinds by default; a mixture passes its
    ``value_kinds``, responsibility rows included): the largest |difference|
    ("ll_max_abs_diff") and the largest |difference| / max(1, |direct|)
    ("ll_max_rel_diff"); and the number of other (sampling/decode) requests
    whose output is not identical ("sample_mismatches")."""
    ll_abs = ll_rel = 0.0
    mismatches = 0
    for r in requests:
        got, ref = np.asarray(results[r.req_id].value), direct[r.req_id]
        if r.kind in value_kinds:
            if got.shape != ref.shape:
                raise ValueError(f"request {r.req_id} ({r.kind}): engine "
                                 f"shape {got.shape}, direct {ref.shape}")
            diff = float(np.max(np.abs(got - ref)))
            ll_abs = max(ll_abs, diff)
            ll_rel = max(ll_rel, diff / max(1.0, float(np.max(np.abs(ref)))))
        elif not np.array_equal(got, ref):
            mismatches += 1
    return {"ll_max_abs_diff": ll_abs, "ll_max_rel_diff": ll_rel,
            "sample_mismatches": mismatches}
