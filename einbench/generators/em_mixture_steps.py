"""Training traffic for a mixture of EiNets: stochastic soft EM steps of the
whole mixture through the port's ``make_mixture_em_step`` on batches that
every component sees, made on the device from the seed and held there.
Step k takes batch k mod ``batches``.  The interface of ``em_steps``
(``setup``, ``prime``, ``window``, ``run``, ``check``, ``control``), so the
harness and its control test read it unchanged.

The configuration's ``data`` is "clustered_unit_uniform": ``num_components``
centres drawn uniformly in [0, 1)^D, each row a uniformly chosen centre
plus ``SPREAD`` N(0, 1) noise, clipped to [0, 1).  Component c's weights
come from a stream of the run's seed of its own, drawn as
``seeded.params`` draws a single EiNet's, with its leaf means at centre c
plus the same noise; the mixture weights start uniform.  So the
responsibilities route rows as a k-means-initialised mixture's do, and no
component starves (the reading ``min_component_share``).  At the cell's
size a row's own component leads every other by thousands of nats, so
its responsibilities are one-hot in float32 (the reading
``soft_row_share``): the cell cannot tell soft routing from hard, and the
tier-1 RAT case (``tests/test_torch_mixture_soft_em.py``) holds the soft
weighting.

Set-up builds the mixture and its step once, loads the seed's weights and
drives the first three steps through the same step and feed that the
window then uses; the losses and the parameters after steps 1 and 3 are
what the reference (``reference.mixture``) is compared with.  Traffic file
keys: those of ``em_steps`` and ``weight_alpha``, the Laplace term of the
mixture weights' statistics.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from generators import em_steps
from harness import mixture_program, program, seeded
from reference.einet import leaves_of, precision
from reference.mixture import MixtureReference
from reference.structure import layout_of

FIRST_STEPS = em_steps.FIRST_STEPS
DATA = "clustered_unit_uniform"
SPREAD = 0.1
# the largest float32 below 1: rows lie in [0, 1)
BELOW_ONE = 1.0 - 2.0 ** -24
# a row whose largest responsibility is below this is routed softly
SOFT_BELOW = 1.0 - 1e-6


def _components(cfg: Dict) -> int:
    if cfg.get("data") != DATA:
        raise ValueError(f"data {cfg.get('data')!r}: this generator makes "
                         f"{DATA!r} rows")
    return int(cfg["num_components"])


def centres(lay, c_n: int, seed: int, device) -> torch.Tensor:
    return torch.rand((c_n, lay.num_vars),
                      generator=seeded.generator(seed, "centres", device),
                      device=device)


def params(lay, c_n: int, seed: int, device) -> Dict:
    """The run's mixture parameters in the reference's layout."""
    mid = centres(lay, c_n, seed, device)
    comps = []
    for c in range(c_n):
        p = seeded.params(lay, seeded.stream(seed, f"component{c}"), device,
                          "unit_uniform")
        g = seeded.generator(seed, f"leaf_means{c}", device)
        mu = mid[c][:, None, None] + SPREAD * torch.randn(
            p["phi"].shape[:3], generator=g, device=device)
        p["phi"] = torch.stack([mu, mu * mu + 1.0], -1)
        comps.append(p)
    return {"components": comps,
            "weights": torch.full((c_n,), 1.0 / c_n, device=device)}


def batches(n: int, rows: int, lay, c_n: int, seed: int,
            device) -> torch.Tensor:
    """(n, rows, D) rows about the run's centres, made a batch at a time
    into one tensor."""
    mid = centres(lay, c_n, seed, device)
    g = seeded.generator(seed, "data", device)
    pick = torch.randint(c_n, (n, rows), generator=g, device=device)
    out = torch.empty((n, rows, lay.num_vars), device=device)
    for i in range(n):
        noise = torch.randn((rows, lay.num_vars), generator=g, device=device)
        torch.add(mid[pick[i]], noise, alpha=SPREAD, out=out[i])
    return out.clamp_(0.0, BELOW_ONE)


def stacked(p: Dict) -> Dict:
    """The reference's layout -> the program's (stacked components)."""
    comps = p["components"]
    return {"components": {
        "phi": torch.stack([q["phi"] for q in comps]),
        "einsum": [torch.stack(ws) for ws in zip(*(q["einsum"] for q in comps))],
        "mixing": [torch.stack(vs) for vs in zip(*(q["mixing"] for q in comps))],
        "class_prior": torch.stack([q["class_prior"] for q in comps])},
        "mixture_weights": p["weights"]}


def leaves(p: Dict) -> List[torch.Tensor]:
    """Every component's leaves (``leaves_of``, empty ones left out), then
    the mixture weights, in the reference's layout."""
    out = [t for q in p["components"] for t in leaves_of(q) if t.numel()]
    return out + [p["weights"]]


def program_leaves(p: Dict, c_n: int) -> List[torch.Tensor]:
    """``leaves`` of the program's (stacked) parameters."""
    comps = p["components"]
    per = [{"phi": comps["phi"][c], "einsum": [w[c] for w in comps["einsum"]],
            "mixing": [v[c] for v in comps["mixing"]],
            "class_prior": comps["class_prior"][c]} for c in range(c_n)]
    return leaves({"components": per, "weights": p["mixture_weights"]})


def setup(ctx) -> Dict:
    c_n = _components(ctx.config)
    lay = layout_of(ctx.config)
    ctx.note("layout worked out")
    mix = mixture_program.build_mixture(ctx.config, c_n, ctx.device)
    ctx.note(f"program's mixture of {c_n} built")
    tr = ctx.traffic
    return {"layout": lay, "components": c_n, "model": mix,
            "step": mixture_program.make_mixture_em_step(
                mix, tr["em"], tr["weight_alpha"], tr["microbatches"])}


def prime(ctx, st: Dict, seed: int) -> None:
    """Load ``seed``'s weights and batches and run the first steps."""
    tr, lay, c_n, mix = ctx.traffic, st["layout"], st["components"], st["model"]
    p = stacked(params(lay, c_n, seed, ctx.device))
    have = [tuple(t.shape) for t in
            program_leaves(mixture_program.mixture_params_of(mix), c_n)]
    want = [tuple(t.shape) for t in program_leaves(p, c_n)]
    if have != want:
        raise RuntimeError(f"the program's parameters {have} are not the "
                           f"layout's {want}")
    mixture_program.load_mixture_params(mix, p)
    del p
    st["data"] = batches(tr["batches"], tr["rows"], lay, c_n, seed, ctx.device)
    ctx.note("weights and batches made")
    st["seed"], st["first"], st["snaps"] = seed, [], {}
    for i in range(FIRST_STEPS):
        st["first"].append(float(st["step"](st["data"][i])))
        ctx.note(f"step {i + 1}")
        if i + 1 in (1, FIRST_STEPS):
            st["snaps"][i + 1] = [
                t.detach().to("cpu", copy=True) for t in program_leaves(
                    mixture_program.mixture_params_of(mix), c_n)]
            ctx.note(f"parameters after step {i + 1} copied to the host")


def window(ctx, st: Dict) -> Dict:
    """``em_steps.window``; the counted work is the components' C times
    one EiNet's at the step's rows."""
    run = em_steps.window(ctx, st)
    c_n = st["components"]
    run["components"] = c_n
    run["step_flops"] *= c_n
    if "trace_bound_s" in run:
        run["trace_bound_s"] *= c_n
    return run


def run(ctx) -> Dict:
    st = setup(ctx)
    prime(ctx, st, ctx.seed)
    capture_s = program.capture_seconds()
    out = window(ctx, st)
    out.update(capture_s=capture_s, first=st["first"], snaps=st["snaps"],
               seed=st["seed"], _state=st)
    return out


def reference_steps(ctx, ref: MixtureReference, seed: int, tf32: bool,
                    rows: int = 0, step_size=None, resp: str = "soft"):
    """The reference's first steps from ``seed``'s weights and batches:
    (initial leaves, losses, {1: leaves after step 1, 3: after step 3},
    the first step's responsibilities); ``rows`` > 0 keeps only that many
    rows of each batch; ``resp`` "uniform" weighs every component's
    statistics 1/C, "hard" by the one-hot argmax of the responsibilities,
    in place of the responsibilities ("soft")."""
    tr, lay, c_n = ctx.traffic, ref.lay, ref.num_components
    p = params(lay, c_n, seed, ctx.device)
    x = batches(tr["batches"], tr["rows"], lay, c_n, seed,
                ctx.device)[:FIRST_STEPS, :rows or tr["rows"]].clone()
    p0 = [t.clone() for t in leaves(p)]
    em = tr["em"] if step_size is None else dict(tr["em"], step_size=step_size)
    losses, snaps, first_r = [], {}, None
    with precision(tf32):
        for i in range(FIRST_STEPS):
            given = None
            if resp == "uniform":
                given = torch.full((x.shape[1], c_n), 1.0 / c_n,
                                   device=ctx.device)
            elif resp == "hard":
                r = ref.responsibilities(p, x[i], tr["reference_block"])
                given = torch.nn.functional.one_hot(r.argmax(1), c_n).to(r)
            p, loss, r = ref.em_step(p, x[i], em, tr["weight_alpha"],
                                     tr["reference_block"], given)
            losses.append(loss)
            if first_r is None:
                first_r = r
            if i + 1 in (1, FIRST_STEPS):
                snaps[i + 1] = [t.clone() for t in leaves(p)]
    return p0, losses, snaps, first_r


def compare(p0, ref_losses, ref_snaps, losses, snaps,
            detail: bool = False) -> Dict[str, float]:
    """``em_steps.compare`` over every component's leaves and the mixture
    weights (the last leaf), and

      weights_gap  max over components of |w - w_ref| / w_ref after the
                   last step compared."""
    out = em_steps.compare(p0, ref_losses, ref_snaps, losses, snaps, detail)
    k = max(ref_snaps)
    got, want = snaps[k][-1].to(ref_snaps[k][-1].device), ref_snaps[k][-1]
    out["weights_gap"] = float(((got - want).abs() / want).max())
    return out


def check(ctx, run: Dict, detail: bool = False) -> Dict[str, float]:
    ref = MixtureReference(ctx.config, ctx.device)
    p0, ref_losses, ref_snaps, r = reference_steps(ctx, ref, run["seed"],
                                                   False)
    out = compare(p0, ref_losses, ref_snaps, run["first"], run["snaps"],
                  detail)
    out["min_component_share"] = float(r.sum(0).min() / r.shape[0])
    out["soft_row_share"] = float((r.amax(1) < SOFT_BELOW).float().mean())
    return out


def control(ctx, seed: int, fault: str = "tf32",
            detail: bool = False) -> Dict[str, float]:
    """The reference put in the program's place, computed in TF32
    (``fault`` "tf32", the control), on half of every batch, the mean
    taken over the rest ("half_batch"), with steps that return the
    parameters unchanged ("unchanged"), or with every component's
    statistics weighted 1/C ("uniform") or by the argmax of the
    responsibilities ("hard") in place of the responsibilities."""
    ref = MixtureReference(ctx.config, ctx.device)
    p0, ref_losses, ref_snaps, _ = reference_steps(ctx, ref, seed, False)
    if fault == "tf32":
        _, losses, snaps, _ = reference_steps(ctx, ref, seed, True)
    elif fault == "half_batch":
        _, losses, snaps, _ = reference_steps(ctx, ref, seed, False,
                                              rows=ctx.traffic["rows"] // 2)
    elif fault == "unchanged":
        _, losses, snaps, _ = reference_steps(ctx, ref, seed, False,
                                              step_size=0.0)
    elif fault in ("uniform", "hard"):
        _, losses, snaps, _ = reference_steps(ctx, ref, seed, False,
                                              resp=fault)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return compare(p0, ref_losses, ref_snaps, losses, snaps, detail)
