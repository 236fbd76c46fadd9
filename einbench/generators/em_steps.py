"""Training traffic: stochastic EM steps through the port's ``make_em_step``
on batches that are made on the device from the seed and held there, as a
training set is.  Step k takes batch k mod ``batches``.

Set-up builds the model and its step once, loads the seed's weights, and
drives the first three steps through the same step and feed that the
window then uses; the losses and the parameters after steps 1 and 3 are
what the reference is compared with.  Traffic file keys:

  rows          rows a step
  microbatches  pieces a step's statistics are summed over
  batches       distinct device-resident batches
  em            laplace_alpha, stat_floor, step_size (Sato's lambda)
  trace_from    the window's step at which the traced part starts
  trace_steps   steps the traced part covers
  reference_block  rows the reference runs at a time
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import torch

from counts import einsum as counts
from harness import program, seeded
from reference.einet import Reference, leaves_of, precision
from reference.structure import layout_of

FIRST_STEPS = 3


def _leaves(params: Dict) -> List[torch.Tensor]:
    return [t for t in leaves_of(params) if t.numel()]


def setup(ctx) -> Dict:
    lay = layout_of(ctx.config)
    ctx.note("layout worked out")
    model = program.build_model(ctx.config, ctx.device)
    ctx.note("program's model built")
    tr = ctx.traffic
    return {"layout": lay, "model": model,
            "step": program.em_step(model, tr["em"], tr["microbatches"])}


def prime(ctx, st: Dict, seed: int) -> None:
    """Load ``seed``'s weights and batches and run the first steps."""
    tr, lay, model = ctx.traffic, st["layout"], st["model"]
    data = seeded.data_of(ctx.config)
    params = seeded.params(lay, seed, ctx.device, data)
    have = [tuple(t.shape) for t in leaves_of(program.params_of(model))]
    want = [tuple(t.shape) for t in leaves_of(params)]
    if have != want:
        raise RuntimeError(f"the program's parameters {have} are not the "
                           f"layout's {want}")
    program.load_params(model, params)
    del params
    st["data"] = seeded.batches(tr["batches"], tr["rows"], lay.num_vars, seed,
                                ctx.device, data)
    ctx.note("weights and batches made")
    st["seed"], st["first"], st["snaps"] = seed, [], {}
    for i in range(FIRST_STEPS):
        st["first"].append(float(st["step"](st["data"][i])))
        ctx.note(f"step {i + 1}")
        if i + 1 in (1, FIRST_STEPS):
            st["snaps"][i + 1] = [t.detach().to("cpu", copy=True)
                                  for t in _leaves(program.params_of(model))]
            ctx.note(f"parameters after step {i + 1} copied to the host")


def window(ctx, st: Dict) -> Dict:
    """Steps until ``ctx.seconds`` have passed (the step crossing the end
    counts); with ``ctx.trace`` a fenced profile of ``trace_steps`` of
    them."""
    from harness.trace import Window

    tr = ctx.traffic
    data, nb, step = st["data"], tr["batches"], st["step"]
    tw = Window() if ctx.trace else None
    times: List[float] = []
    traced = None
    i = FIRST_STEPS
    setup_s = ctx.since_start()
    t0 = time.perf_counter()
    while True:
        if tw is not None and len(times) == tr["trace_from"]:
            tw.start()
        with tw.span("train.step") if tw is not None else contextlib.nullcontext():
            s0 = time.perf_counter()
            step(data[i % nb])
            times.append(time.perf_counter() - s0)
        i += 1
        if tw is not None and tw.on and len(times) == tr["trace_from"] + tr["trace_steps"]:
            traced = tw.stop()
        if time.perf_counter() - t0 >= ctx.seconds and (tw is None or traced):
            break
    window_s = time.perf_counter() - t0
    rows, lay = tr["rows"], st["layout"]
    run = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "steps": len(times), "rows": rows, "step_s": times,
           "attempted": len(times), "failed": 0,
           "step_flops": counts.em_step_flops(lay, rows), "trace": traced}
    if traced is not None and ctx.peak is not None:
        run["trace_steps"] = tr["trace_steps"]
        run["trace_bound_s"] = tr["trace_steps"] * (
            counts.bound_s(*counts.forward(lay, rows), ctx.peak)
            + counts.bound_s(*counts.backward(lay, rows), ctx.peak))
    return run


def run(ctx) -> Dict:
    st = setup(ctx)
    prime(ctx, st, ctx.seed)
    capture_s = program.capture_seconds()
    out = window(ctx, st)
    out.update(capture_s=capture_s, first=st["first"], snaps=st["snaps"],
               seed=st["seed"], _state=st)
    return out


def reference_steps(ctx, ref: Reference, seed: int, tf32: bool,
                    rows: int = 0, step_size=None):
    """The reference's first steps from ``seed``'s weights and batches:
    (initial leaves, losses, {1: leaves after step 1, 3: after step 3});
    ``rows`` > 0 keeps only that many rows of each batch."""
    tr = ctx.traffic
    data = seeded.data_of(ctx.config)
    p = seeded.params(ref.lay, seed, ctx.device, data)
    x = seeded.batches(tr["batches"], tr["rows"], ref.lay.num_vars, seed,
                       ctx.device, data)[:FIRST_STEPS, :rows or tr["rows"]].clone()
    p0 = [t.clone() for t in _leaves(p)]
    em = tr["em"] if step_size is None else dict(tr["em"], step_size=step_size)
    losses, snaps = [], {}
    with precision(tf32):
        for i in range(FIRST_STEPS):
            p, ll = ref.em_step(p, x[i], em, tr["reference_block"])
            losses.append(ll)
            if i + 1 in (1, FIRST_STEPS):
                snaps[i + 1] = [t.clone() for t in _leaves(p)]
    return p0, losses, snaps


def compare(p0, ref_losses, ref_snaps, losses, snaps,
            detail: bool = False) -> Dict[str, float]:
    """The numbers that decide ``correct``:

      loss_gap     max over the first steps of |loss - ref| / |ref|
      change1_gap  worst leaf: | |p1 - p0| - |r1 - p0| | / max(|r1 - p0|,
                   the median leaf's |r1 - p0|): the first step's change
                   (lambda times the M-step's pull) as the step applied it
      change3_gap  the same after three steps
      change1_gap_median, change3_gap_median
                   the median leaf's gap: the leaves below the root, whose
                   posteriors do not carry the rounding of a row's whole
                   log-likelihood as the root pair's do

    Leaves whose reference change is under a thousandth of the median
    leaf's (a one-class prior, which EM never moves) are left out of all.
    ``diff1`` and ``diff3`` (|p - r| over the same scale) and their medians
    are readings; ``detail`` adds each leaf's gap (``change1_gap.leaf<i>``)."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))}
    for k in sorted(ref_snaps):
        dev = p0[0].device
        ref_n = [float(torch.linalg.vector_norm(r - a)) for r, a in zip(ref_snaps[k], p0)]
        got_n, diff = [], []
        for g, r, a in zip(snaps[k], ref_snaps[k], p0):
            g = g.to(dev)
            got_n.append(float(torch.linalg.vector_norm(g - a)))
            diff.append(float(torch.linalg.vector_norm(g - r)))
        med = statistics.median(ref_n)
        keep = [i for i, n in enumerate(ref_n) if n >= 1e-3 * med]
        scale = [max(ref_n[i], med) for i in range(len(ref_n))]
        gaps = [abs(got_n[i] - ref_n[i]) / scale[i] for i in keep]
        diffs = [diff[i] / scale[i] for i in keep]
        out[f"change{k}_gap"] = max(gaps)
        out[f"change{k}_gap_median"] = statistics.median(gaps)
        out[f"change{k}_worst_leaf"] = float(keep[gaps.index(max(gaps))])
        out[f"diff{k}"] = max(diffs)
        out[f"diff{k}_median"] = statistics.median(diffs)
        out[f"leaves_left_out{k}"] = float(len(ref_n) - len(keep))
        if detail:
            for i, g, d in zip(keep, gaps, diffs):
                out[f"change{k}_gap.leaf{i}"] = g
                out[f"diff{k}.leaf{i}"] = d
    return out


def check(ctx, run: Dict, detail: bool = False) -> Dict[str, float]:
    ref = Reference(ctx.config, ctx.device)
    p0, ref_losses, ref_snaps = reference_steps(ctx, ref, run["seed"], False)
    return compare(p0, ref_losses, ref_snaps, run["first"], run["snaps"],
                   detail)


def control(ctx, seed: int, fault: str = "tf32",
            detail: bool = False) -> Dict[str, float]:
    """The reference put in the program's place, computed in TF32
    (``fault`` "tf32", the control), on half of every batch, the mean
    taken over the rest ("half_batch"), or with steps that return the
    parameters unchanged ("unchanged"): the faults a step can have."""
    ref = Reference(ctx.config, ctx.device)
    p0, ref_losses, ref_snaps = reference_steps(ctx, ref, seed, False)
    if fault == "tf32":
        _, losses, snaps = reference_steps(ctx, ref, seed, True)
    elif fault == "half_batch":
        _, losses, snaps = reference_steps(ctx, ref, seed, False,
                                           rows=ctx.traffic["rows"] // 2)
    else:  # "unchanged": a step that leaves the parameters as they were
        _, losses, snaps = reference_steps(ctx, ref, seed, False, step_size=0.0)
    return compare(p0, ref_losses, ref_snaps, losses, snaps, detail)
