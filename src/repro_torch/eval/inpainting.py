"""The Fig. 4 inpainting harness, served through the batched engine.

For each test image and each structured mask the harness issues TWO requests
-- a ``conditional_sample`` (posterior draw of the occluded region, the
paper's Fig. 4 middle rows) and an ``mpe`` decode (greedy argmax
reconstruction) -- each with its own per-request PRNG seed, through the same
``ServeEngine`` that serves production traffic.  Engine results are parity-
checked (bit-identical) against direct ``model.query`` calls, and scored as
occluded-region MSE against the original image, with the train-mean fill as
the baseline any generative claim must beat.

The port draws each request's noise from Philox under its seed
(``EiNet.row_noise``) where the reference uses threefry, so conditional
samples differ from the reference's; MPE decodes, masks and the mean-fill
baseline do not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.eval.masks import MASK_KINDS, make_mask
from repro_torch.eval.metrics import parity_report
from repro_torch.serve import Request, ServeEngine

INPAINT_KINDS = ("conditional_sample", "mpe")
MIXTURE_INPAINT_KINDS = ("mixture_conditional_sample", "mixture_mpe")


def _short(kind: str) -> str:
    """Canonical metric/recon key: mixture kinds score under the same names
    as the single-EiNet kinds ("conditional_sample", "mpe"), so downstream
    consumers (launch printing, EXPERIMENTS.md) read one schema."""
    return kind[len("mixture_"):] if kind.startswith("mixture_") else kind


@dataclasses.dataclass
class InpaintingReport:
    """Everything one Fig. 4 run produced.

    ``reconstructions[mask_kind][query_kind]`` is the (N, D) float array of
    inpainted images (evidence rows pass through untouched, per the
    ``conditional_sample`` contract).
    """

    mask_kinds: Sequence[str]
    evidence_masks: Dict[str, np.ndarray]  # (D,) bool per mask kind
    reconstructions: Dict[str, Dict[str, np.ndarray]]
    metrics: Dict[str, Any]  # flat JSON-able record

    def recon(self, mask_kind: str, query_kind: str = "mpe") -> np.ndarray:
        return self.reconstructions[mask_kind][query_kind]


def run_inpainting(
    model,
    images: np.ndarray,  # (N, D) in the leaf-EF domain
    height: int,
    width: int,
    channels: int,
    mask_kinds: Sequence[str] = MASK_KINDS,
    mean_fill: Optional[np.ndarray] = None,  # (D,) train mean for the baseline
    engine: Optional[ServeEngine] = None,
    max_batch: int = 32,
    seed: int = 0,
    parity_rows: Optional[int] = None,
    kinds: Sequence[str] = INPAINT_KINDS,
) -> InpaintingReport:
    """Run every (image, mask, kind) cell through the engine; score + verify.

    ``parity_rows=None`` verifies EVERY request against the direct call --
    the Fig. 4 harness is also the engine's correctness audit, so default to
    exhaustive.  ``kinds`` selects the query pair (``MIXTURE_INPAINT_KINDS``
    drives a mixture model; reconstructions and metrics keep the canonical
    short names either way).  Returns an :class:`InpaintingReport`.
    """
    n, d = images.shape
    assert d == height * width * channels, (d, height, width, channels)
    if engine is None:
        engine = ServeEngine(model, max_batch=min(max_batch, max(n, 1)))
    engine.warmup(kinds=kinds)

    evidence = {k: make_mask(k, height, width, channels, seed=seed)
                for k in mask_kinds}
    # requests run one engine drain per mask (for per-mask timing), but ids
    # and seeds are allocated in the same global order as ever -- engine
    # results are a pure function of each request's own (seed, x, evidence)
    # (the micro-batch invariant), so the reconstructions are unchanged
    requests: List[Request] = []
    index: Dict[int, tuple] = {}
    results: Dict[int, Any] = {}
    mask_seconds: Dict[str, float] = {}
    rid = 0
    for mk in mask_kinds:
        ev = evidence[mk]
        mask_requests: List[Request] = []
        for qk in kinds:
            for i in range(n):
                mask_requests.append(Request(
                    req_id=rid, kind=qk, x=np.asarray(images[i], np.float32),
                    evidence_mask=ev,
                    seed=seed * 1_000_003 + rid,
                ))
                index[rid] = (mk, _short(qk), i)
                rid += 1
        # each engine step ends in a copy to the host: the drain is
        # synchronised when the timed region closes
        with obs.timed("eval.inpaint", metric="eval.inpaint.seconds",
                       mask=mk) as t:
            results.update(engine.run(mask_requests))
        mask_seconds[mk] = t.seconds
        requests.extend(mask_requests)
    engine_s = sum(mask_seconds.values())

    short_kinds = [_short(qk) for qk in kinds]
    recon: Dict[str, Dict[str, np.ndarray]] = {
        mk: {qk: np.empty((n, d), np.float32) for qk in short_kinds}
        for mk in mask_kinds
    }
    for r_id, (mk, qk, i) in index.items():
        recon[mk][qk][i] = results[r_id].value

    par = parity_report(model, requests, results, rows=parity_rows)

    per_mask: Dict[str, Any] = {}
    for mk in mask_kinds:
        missing = ~evidence[mk]
        row: Dict[str, float] = {
            "missing_fraction": float(np.mean(missing)),
        }
        row["engine_seconds"] = mask_seconds[mk]
        for qk in short_kinds:
            err = recon[mk][qk][:, missing] - images[:, missing]
            row[f"{qk}_mse"] = float(np.mean(err ** 2))
        if mean_fill is not None:
            base = np.broadcast_to(mean_fill, images.shape)[:, missing] \
                - images[:, missing]
            row["mean_fill_mse"] = float(np.mean(base ** 2))
        per_mask[mk] = row

    metrics = {
        "num_images": int(n),
        "num_requests": len(requests),
        "engine_seconds": engine_s,
        "requests_per_s": len(requests) / max(engine_s, 1e-9),
        "per_mask": per_mask,
        **par,
    }
    return InpaintingReport(
        mask_kinds=tuple(mask_kinds),
        evidence_masks=evidence,
        reconstructions=recon,
        metrics=metrics,
    )
