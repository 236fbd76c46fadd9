"""Serving traffic: open-loop arrivals of exact-inference queries through
the port's ``ServeEngine.submit`` and ``ServeEngine.step``.

The schedule is a function of the seed alone.  A run of ``seconds`` at
``rate_per_s`` has n = rate x seconds requests; their gaps are the n
midpoint quantiles of the exponential distribution (a Poisson stream's
gaps), the same set for every seed, in an order drawn from the seed.
Request i has kind ``kinds[i mod len(kinds)]``, a standard-normal row, an
evidence mask keeping each variable with probability ``evidence_share``
(the query mask is its complement) and a sampling seed, all from the run's
seed.

One thread: it submits every request that is due, serves the engine's
oldest group when the queue holds one, and otherwise waits for the next
arrival.  A request's latency runs from when it was due to when its answer
is on the host.  After the window the queue is drained (at most
``drain_s``) so that every request due in the window is answered or
counted as failed.  Traffic file keys:

  rate_per_s, kinds, evidence_share, max_batch, drain_s
  trace_from_s, trace_s   the traced part of the window
  check_per_kind          finished requests of each kind compared
  reference_block         rows the reference runs at a time
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from counts import einsum as counts
from harness import program, seeded
from reference.einet import Reference, precision
from reference.structure import layout_of

LL_KINDS = ("joint_ll", "marginal_ll", "conditional_ll")
# the kinds that draw with Gumbel noise: their choices stand apart by the
# noise's spread, so rounding flips one only where the reference's best
# and second-best scores all but tie; MPE's greedy choices tie often
NOISY_KINDS = ("sample", "conditional_sample")
# a drawn row whose every variable is within this of the reference's took
# the same choices: rounding moves a draw by ~1e-6, a different choice by
# a leaf's spread
DRAW_TOL = 1e-3
# a choice whose two best scores lie closer than this, over max(1, |best|),
# is a tie to float32 rounding: the served LLs part from the reference's
# by under 5e-7 of their size, so two sound sides can pick either child
TIE_REL = 1e-5


def schedule(traffic: Dict, seconds: float, seed: int, d: int,
             data: str = "standard_normal") -> Dict:
    """Due times (s from the window's start), kinds, rows (of ``data``),
    evidence and seeds of the requests of one run."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[seeded.rng(seed, "arrivals").permutation(n)]
    g = seeded.rng(seed, "requests")
    kinds = traffic["kinds"]
    x = (g.random((n, d), dtype=np.float32) if data == "unit_uniform"
         else g.standard_normal((n, d), dtype=np.float32))
    return {"due": np.cumsum(gaps),
            "kind": [kinds[i % len(kinds)] for i in range(n)],
            "x": x,
            "evidence": g.random((n, d)) < float(traffic["evidence_share"]),
            "seed": g.integers(0, 2 ** 62, n)}


def _heaviness(kind: str) -> int:
    """Order of capture: the drawing kinds (noise and a top-down pass)
    before the likelihood kinds."""
    return ("sample", "conditional_sample", "mpe", "conditional_ll",
            "marginal_ll", "joint_ll").index(kind)


def setup(ctx) -> Dict:
    lay = layout_of(ctx.config)
    ctx.note("layout worked out")
    model = program.build_model(ctx.config, ctx.device)
    ctx.note("program's model built")
    eng = program.engine(model, ctx.traffic["max_batch"])
    return {"layout": lay, "model": model, "engine": eng}


def prime(ctx, st: Dict, seed: int) -> None:
    """Load ``seed``'s weights; capture every (kind, bucket) program the
    traffic can use."""
    params = seeded.params(st["layout"], seed, ctx.device,
                           seeded.data_of(ctx.config))
    program.load_params(st["model"], params)
    del params
    ctx.note("weights made")
    # the largest programs first: the smaller ones then fit in the blocks
    # the larger left free in the shared graph pool
    eng = st["engine"]
    eng.warmup(kinds=sorted(set(ctx.traffic["kinds"]), key=_heaviness),
               buckets=sorted(eng.buckets, reverse=True))
    ctx.note(f"{eng.num_programs} programs captured")


def window(ctx, st: Dict, seed: int, seconds: float) -> Dict:
    from harness.trace import Window

    tr, eng, lay = ctx.traffic, st["engine"], st["layout"]
    sch = schedule(tr, seconds, seed, lay.num_vars, seeded.data_of(ctx.config))
    n = len(sch["due"])
    reqs = [program.request(i, sch["kind"][i], sch["x"][i], sch["evidence"][i],
                            sch["seed"][i]) for i in range(n)]
    # the run's requests are made before the window, some hundreds of
    # thousands of objects that a server would never hold at once: kept
    # out of the collector's full passes (each about 0.3 s over them),
    # which would otherwise stall the loop at random times in the window
    gc.collect()
    gc.freeze()
    buckets = eng.buckets
    tw = Window() if ctx.trace else None
    done = np.full(n, np.nan)
    values: Dict[int, np.ndarray] = {}
    # (kind, rows, bucket, step seconds, in the traced part, end time)
    batches: List = []
    traced = None
    stats0 = dict(eng.stats)
    stats_end = None
    nxt = 0
    span = (lambda label: tw.span(label)) if tw else (
        lambda label: contextlib.nullcontext())
    setup_s = ctx.since_start()
    t0 = time.perf_counter()
    limit = seconds + float(tr["drain_s"])
    while True:
        now = time.perf_counter() - t0
        if tw is not None and not tw.on and traced is None and now >= tr["trace_from_s"]:
            tw.start()
        elif tw is not None and tw.on and now >= tr["trace_from_s"] + tr["trace_s"]:
            traced = tw.stop()
        if stats_end is None and now >= seconds:
            stats_end = dict(eng.stats)
        if now >= limit:
            if tw is not None and tw.on:
                traced = tw.stop()
            break
        while nxt < n and sch["due"][nxt] <= now:
            eng.submit(reqs[nxt])
            nxt += 1
        if len(eng.queue):
            with span("serve.step"):
                s0 = time.perf_counter()
                res = eng.step()
                s1 = time.perf_counter()
            for r in res:
                done[r.req_id] = s1 - t0
                values[r.req_id] = r.value
            if res:
                rows = len(res)
                bucket = min(b for b in buckets if b >= rows)
                batches.append((res[0].kind, rows, bucket, s1 - s0,
                                tw is not None and tw.on, s1 - t0))
            continue
        if nxt >= n:
            if tw is None or not tw.on:
                break
            traced = tw.stop()
            continue
        with span("arrival wait"):
            wait = sch["due"][nxt] - (time.perf_counter() - t0)
            if wait > 2e-3:
                time.sleep(wait - 1e-3)
            while time.perf_counter() - t0 < sch["due"][nxt]:
                pass
    end = time.perf_counter() - t0
    gc.unfreeze()
    if stats_end is None:
        stats_end = dict(eng.stats)
    answered = ~np.isnan(done)
    lat = np.where(answered, done, end) - sch["due"]
    in_window = [b for b in batches if b[5] <= seconds]
    run = {"kind": "serve", "setup_s": setup_s, "window_s": float(seconds),
           "attempted": n, "failed": int(n - answered.sum()),
           "latency_s": lat.tolist(),
           "completed": int((done <= seconds).sum()),
           "step_s": [b[3] for b in in_window],
           "query_flops": float(sum(counts.query_flops(lay, b[0], b[1])
                                    for b in in_window)),
           "requests": int(stats_end["requests"] - stats0["requests"]),
           "padded_rows": int(stats_end["padded_rows"] - stats0["padded_rows"]),
           "trace": traced, "schedule": sch, "values": values, "seed": seed}
    if traced is not None and ctx.peak is not None:
        run["trace_bound_s"] = sum(
            counts.UPWARD_PASSES[b[0]] * counts.bound_s(
                *counts.forward(lay, b[2]), ctx.peak)
            for b in batches if b[4])
    return run


def run(ctx) -> Dict:
    st = setup(ctx)
    prime(ctx, st, ctx.seed)
    capture_s = program.capture_seconds()
    out = window(ctx, st, ctx.seed, ctx.seconds)
    out.update(capture_s=capture_s, _state=st)
    return out


def sample(ctx, run: Dict, seed: int) -> Dict[str, np.ndarray]:
    """Finished requests to compare, drawn from the seed: up to
    ``check_per_kind`` of each kind, by request id."""
    g = seeded.rng(seed, "check")
    kinds = np.array(run["schedule"]["kind"])
    out = {}
    for kind in sorted(set(kinds.tolist())):
        ids = np.array([i for i in np.flatnonzero(kinds == kind)
                        if i in run["values"]], dtype=np.int64)
        k = min(len(ids), int(ctx.traffic["check_per_kind"]))
        out[kind] = np.sort(g.choice(ids, size=k, replace=False)) if k else ids
    return out


def answers(ctx, ref: Reference, params, sch, kind, ids, tf32: bool):
    """The reference's answers to requests ``ids`` and, for a drawing kind,
    each row's narrowest margin (``Reference.draw``); else None."""
    dev = ctx.device
    x = torch.as_tensor(sch["x"][ids], device=dev)
    ev = torch.as_tensor(sch["evidence"][ids], device=dev)
    seeds = torch.as_tensor(sch["seed"][ids].astype(np.int64), device=dev)
    with precision(tf32):
        out = ref.query(params, kind, x, ev, ~ev, seeds,
                        int(ctx.traffic["reference_block"]), margin=True)
    if kind in LL_KINDS:
        return out.cpu().numpy(), None
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            evidence: Dict[str, np.ndarray],
            margin: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per kind:

      ll_gap.<kind>          an LL kind: max over its answers of
                             |answer - ref| / max(1, |ref|)
      draw_mismatch.<kind>   a drawing kind: the share of its rows with a
                             variable farther than DRAW_TOL from the
                             reference's draw on the same noise
      var_mismatch.<kind>    the share of its rows' query variables (not
                             evidence) farther than DRAW_TOL: MPE's greedy
                             choices tie to rounding, and a flipped tie
                             moves one subtree's variables, not the row

    Over the Gumbel kinds (``margin`` holds the reference's narrowest
    margin a row): ``draw_mismatch.noisy`` the share of rows off the
    reference's draw; ``draw_wrong.noisy`` the share off it although no
    choice of the reference's tree ties (margin TIE_REL or more), since
    where one ties both children are the draw of that noise to float32;
    ``draw_tied.noisy`` the share of rows with such a tie, which the
    latter cannot judge; ``draw_flip_margin.noisy`` the widest margin of
    a row off the reference's draw (0 where none is).  ``ll_gap`` and
    ``draw_mismatch`` over all kinds; the rows compared.  The cell's
    limits file says which of them decide ``correct``."""
    out: Dict[str, float] = {}
    lls, draws, rows = [], [], 0
    noisy, tied, flip = [], [], [0.0]
    for kind in sorted(got):
        a, b = got[kind], want[kind]
        if not len(a):
            continue
        rows += len(a)
        if kind in LL_KINDS:
            lls.append(float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))))
            out[f"ll_gap.{kind}"] = lls[-1]
        else:
            far = np.abs(a - b) > DRAW_TOL
            bad = far.any(axis=1)
            draws.append(bad)
            if kind in NOISY_KINDS:
                noisy.append(bad)
                tied.append(margin[kind] < TIE_REL)
                flip.extend(margin[kind][bad].tolist())
            out[f"draw_mismatch.{kind}"] = float(bad.mean())
            query = ~evidence[kind] if kind != "sample" else np.ones_like(far)
            out[f"var_mismatch.{kind}"] = float(far[query].mean())
    out["ll_gap"] = max(lls) if lls else float("nan")
    out["draw_mismatch"] = float(np.concatenate(draws).mean()) if draws else float("nan")
    if noisy:
        bad, tie = np.concatenate(noisy), np.concatenate(tied)
        out["draw_mismatch.noisy"] = float(bad.mean())
        out["draw_wrong.noisy"] = float((bad & ~tie).mean())
        out["draw_tied.noisy"] = float(tie.mean())
        out["draw_flip_margin.noisy"] = float(max(flip))
    else:
        for k in ("draw_mismatch", "draw_wrong", "draw_tied", "draw_flip_margin"):
            out[f"{k}.noisy"] = float("nan")
    out["rows_compared"] = float(rows)
    return out


def check(ctx, run: Dict) -> Dict[str, float]:
    ref = Reference(ctx.config, ctx.device)
    params = seeded.params(ref.lay, run["seed"], ctx.device,
                           seeded.data_of(ctx.config))
    sch = run["schedule"]
    ids = sample(ctx, run, run["seed"])
    got = {k: np.stack([run["values"][i] for i in v]) if len(v) else np.zeros(0)
           for k, v in ids.items()}
    want = {k: answers(ctx, ref, params, sch, k, v, False)
            for k, v in ids.items() if len(v)}
    return compare({k: got[k] for k in want}, {k: w[0] for k, w in want.items()},
                   {k: sch["evidence"][ids[k]] for k in want},
                   {k: w[1] for k, w in want.items()})


def control(ctx, seed: int, seconds: float) -> Dict[str, float]:
    """The reference in TF32 put in the program's place, on the requests
    a run of ``seconds`` would compare."""
    ref = Reference(ctx.config, ctx.device)
    data = seeded.data_of(ctx.config)
    params = seeded.params(ref.lay, seed, ctx.device, data)
    sch = schedule(ctx.traffic, seconds, seed, ref.lay.num_vars, data)
    fake = {"schedule": sch, "values": dict.fromkeys(range(len(sch["due"])))}
    ids = sample(ctx, fake, seed)
    want = {k: answers(ctx, ref, params, sch, k, v, False) for k, v in ids.items()}
    got = {k: answers(ctx, ref, params, sch, k, v, True)[0] for k, v in ids.items()}
    return compare(got, {k: w[0] for k, w in want.items()},
                   {k: sch["evidence"][v] for k, v in ids.items()},
                   {k: w[1] for k, w in want.items()})


def permute_answers(eng) -> None:
    """Plant a fault in ``eng``: each step hands its requests' answers on
    rotated by one row within the bucket, as a wrong gather or scatter of
    rows would."""
    step = eng.step

    def rotated():
        res = step()
        vals = [r.value for r in res]
        for r, v in zip(res, vals[1:] + vals[:1]):
            r.value = v
        return res

    eng.step = rotated
