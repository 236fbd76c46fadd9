"""Held-out likelihood / bits-per-dim evaluation through the serving engine.

The test split is streamed through ``repro_torch.serve.ServeEngine`` as
ordinary ``joint_ll`` / ``marginal_ll`` requests -- evaluation is not a
separate batched code path, it is *traffic*: the same coalescing and bucket
padding that serve production queries also serve the evaluation, so the
numbers measure the deployed path.

Parity is counted against direct per-request ``model.query`` calls on a
one-row batch: a *mismatch* is any request whose engine result is not
bit-identical to the direct result.  Row-independent LL math (fixed
summation orders in the leaf rows and the kernels) and per-row seeds make
bit-identity the engine's contract, so the harness keeps "exactly 0
mismatches" as its acceptance gate, on the CPU and on the card.

The port's models own their parameters, so no function here takes a
parameter dict; eager calls need no program cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import assemble_batch, run_query

LN2 = float(np.log(2.0))

LL_STREAM_KINDS = ("joint_ll", "marginal_ll",
                   "mixture_joint_ll", "mixture_marginal_ll")


def bits_per_dim(mean_ll: float, num_dims: int, offset_bits: float = 0.0) -> float:
    """nats of model log-likelihood -> bits-per-dim of the original data.

    ``offset_bits`` is the per-dim change-of-variables term from the domain
    transform (``repro_torch.data.datasets.to_domain``): log2(256) for
    uint8 data modelled as x/255 on [0, 1] by continuous leaves, 0 for
    discrete leaves.
    """
    return -float(mean_ll) / (num_dims * LN2) + float(offset_bits)


@dataclasses.dataclass
class EngineLLResult:
    """Per-row log-likelihoods + parity/throughput accounting."""

    ll: np.ndarray  # (N,) float32
    kind: str
    engine_seconds: float  # steady-state drain time (after the warm-up)
    warmup_seconds: float  # one-time costs paid by the warm-up
    parity_rows: int  # rows checked against direct model.query calls
    parity_mismatches: int  # rows NOT bit-identical to the direct call
    parity_max_abs_diff: float

    @property
    def rows_per_second(self) -> float:
        return len(self.ll) / max(self.engine_seconds, 1e-9)


def direct_query(model, req: Request) -> np.ndarray:
    """Direct (engine-free) result for one request: an eager
    ``model.query`` on a one-row batch built as the engine builds its
    batches, so any difference is the batching's (and, on the card, the
    engine's CUDA graphs') and the gate can be bitwise.
    (``serve.legacy_call`` goes through the EiNet's own methods instead;
    ``serve.direct_call`` replays a bucket-1 graph.)  A mixture's
    component-pinned kinds pass the request's component."""
    out = run_query(model, assemble_batch(model, [req], 1), req.kind,
                    req.component)
    return out.cpu().numpy()[0]


def parity_report(
    model,
    requests,
    results: Dict[int, Any],
    rows: Optional[int] = None,
) -> Dict[str, Any]:
    """Count engine-vs-direct mismatches (bitwise) over ``rows`` requests."""
    checked = mismatches = 0
    max_diff = 0.0
    for req in requests:
        if rows is not None and checked >= rows:
            break
        ref = direct_query(model, req)
        got = np.asarray(results[req.req_id].value)
        checked += 1
        if not np.array_equal(got, ref):
            mismatches += 1
            max_diff = max(max_diff, float(np.max(np.abs(got - ref))))
    return {
        "parity_rows": checked,
        "parity_mismatches": mismatches,
        "parity_max_abs_diff": max_diff,
    }


def engine_log_likelihoods(
    model,
    x: np.ndarray,
    kind: str = "joint_ll",
    evidence_mask: Optional[np.ndarray] = None,
    engine: Optional[ServeEngine] = None,
    max_batch: int = 64,
    parity_rows: Optional[int] = 64,
) -> EngineLLResult:
    """Stream ``x`` (N, D) through the engine as LL requests, in order.

    ``evidence_mask`` (broadcastable to (N, D)) switches ``marginal_ll`` on a
    shared or per-row mask.  ``parity_rows=None`` checks every row;
    ``0`` skips the parity pass (pure-throughput benchmarking).
    """
    if kind not in LL_STREAM_KINDS:
        raise ValueError(f"LL streaming supports joint/marginal, got {kind!r}")
    n = len(x)
    if engine is None:
        engine = ServeEngine(model, max_batch=min(max_batch, max(n, 1)))
    ev = None
    if evidence_mask is not None:
        ev = np.broadcast_to(np.asarray(evidence_mask, bool), x.shape)
    reqs = [
        Request(
            req_id=i,
            kind=kind,
            x=np.asarray(x[i], np.float32),
            evidence_mask=None if ev is None else ev[i],
        )
        for i in range(n)
    ]
    warmup = engine.warmup(kinds=[kind])
    # each engine step ends in a copy to the host, so the drain is
    # synchronised when the timed region closes
    with obs.timed("eval.ll_stream", kind=kind) as t:
        results = engine.run(reqs)
    engine_s = t.seconds
    ll = np.array([float(results[i].value) for i in range(n)], np.float32)
    par = {"parity_rows": 0, "parity_mismatches": 0, "parity_max_abs_diff": 0.0}
    if parity_rows is None or parity_rows > 0:
        par = parity_report(model, reqs, results, rows=parity_rows)
    return EngineLLResult(
        ll=ll, kind=kind, engine_seconds=engine_s, warmup_seconds=warmup, **par
    )


def direct_log_likelihoods(
    model,
    x: np.ndarray,
    kind: str = "joint_ll",
    evidence_mask: Optional[np.ndarray] = None,
    chunk: int = 256,
) -> np.ndarray:
    """The engine-free dense baseline: fixed-size chunks of ``model.query``
    (zero-padded tail), for throughput comparison."""
    n, d = x.shape
    chunk = min(chunk, n)
    ev = np.zeros((n, d), bool) if evidence_mask is None else \
        np.broadcast_to(np.asarray(evidence_mask, bool), x.shape)
    out = np.empty(n, np.float32)
    dev = model.device
    fmask = torch.zeros((chunk, d), dtype=torch.bool, device=dev)
    for i in range(0, n, chunk):
        xs = np.zeros((chunk, d), np.float32)
        es = np.zeros((chunk, d), bool)
        m = min(chunk, n - i)
        xs[:m] = x[i: i + m]
        es[:m] = ev[i: i + m]
        batch = {"x": torch.from_numpy(xs).to(dev),
                 "evidence_mask": torch.from_numpy(es).to(dev),
                 "query_mask": fmask, "seeds": [0] * chunk}
        out[i: i + m] = model.query(batch, kind).cpu().numpy()[:m]
    return out


def evaluate_bpd(
    model,
    x: np.ndarray,
    offset_bits: float = 0.0,
    engine: Optional[ServeEngine] = None,
    max_batch: int = 64,
    parity_rows: Optional[int] = 64,
    kind: str = "joint_ll",
) -> Dict[str, Any]:
    """Test-split bits-per-dim through the engine; returns a flat JSON-able
    record.  ``kind="mixture_joint_ll"`` evaluates a mixture model through
    the identical traffic path."""
    res = engine_log_likelihoods(
        model, x, kind=kind, engine=engine, max_batch=max_batch,
        parity_rows=parity_rows,
    )
    mean_ll = float(np.mean(res.ll))
    return {
        "num_rows": int(len(x)),
        "num_dims": int(x.shape[1]),
        "mean_ll": mean_ll,
        "bpd": bits_per_dim(mean_ll, x.shape[1], offset_bits),
        "bpd_offset_bits": float(offset_bits),
        "engine_rows_per_s": res.rows_per_second,
        "engine_seconds": res.engine_seconds,
        "warmup_seconds": res.warmup_seconds,
        "parity_rows": res.parity_rows,
        "parity_mismatches": res.parity_mismatches,
        "parity_max_abs_diff": res.parity_max_abs_diff,
    }
