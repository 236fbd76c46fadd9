"""Training-pipeline benchmark -> BENCH_torch_train.json.

The port of the reference's ``benchmarks/bench_train.py``.  It measures
the EM step program (``repro_torch.train.make_em_step``: on the card
captured CUDA graphs -- a microbatch's E-step replayed once a microbatch
into static accumulators, then the M-step and blend -- through the
program registry; the E-step's gradients through the backward kernels)
against the per-step path (the eager microbatch loop of ``em_statistics``
and ``accumulate_statistics``, then ``m_step`` and ``blend_params``), and
reports kernel-against-plain gradient parity beside it:

  PYTHONPATH=src python -m repro_torch.bench.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.bench.train        # 3-arch sweep
  PYTHONPATH=src python -m repro_torch.bench.train --card

The sweep keeps the reference's cells (einet_rat / einet_rat_large /
einet_pd at its CPU-sized batches), so the two packages' reports line up
cell for cell.  ``--card`` runs ``CARD_CELLS`` instead, the same archs at
the configs' own batches, which is what ``slo_torch.json``'s train
budgets hold.  The report keeps the reference's schema; "backend" is the
device type ("cuda" or "cpu"), "device" the card's name and "profile"
"smoke", "reference" or "card".  The step
writes the model's parameters in place, so every path and every timing
rep starts from a saved copy of the initial parameters (``load_params``),
which keeps the step's graphs valid (no tensor moves).  Exit status gates
grad parity (``PARITY_TOL``), the per-row speedup floor (>= 1.0 or a
``SPEEDUP_WAIVERS`` entry) and grouped execution; ``--smoke`` skips the
timing gate but keeps the others.
"""

from __future__ import annotations

import argparse
import datetime

import numpy as np
import torch

from repro_torch import compile as compile_lib
from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.bench import clone_tree, device_name, sync, write_report
from repro_torch.configs import EinetConfig, get_config
from repro_torch.core.einet import resolve_device
from repro_torch.core.em import (
    EMConfig,
    accumulate_statistics,
    blend_params,
    em_statistics,
    leaf_scatter,
    load_params,
    m_step,
    params_of,
    zeros_like_statistics,
)
from repro_torch.kernels import ops
from repro_torch.kernels.log_einsum_exp import log_einsum_exp_plain
from repro_torch.launch.cells import build_einet
from repro_torch.train import TrainConfig, make_em_step

SMOKE_CONFIG = EinetConfig(
    name="einet-rat-train-smoke",
    structure="rat",
    # 32 vars (not fewer): small var counts collide region scopes across
    # repetitions, which breaks canonical layout and would silently drop the
    # smoke run to the per-layer path -- 32/2/2 is the smallest RAT shape
    # whose whole circuit depth-groups
    num_vars=32,
    depth=2,
    num_repetitions=2,
    num_sums=4,
    batch_size=64,
)

PD_SMOKE_CONFIG = EinetConfig(
    name="einet-pd-train-smoke",
    structure="pd",
    # 32 vars as a 4x8 image with delta=2 cuts on both axes: a 4-pair PD
    # circuit whose 3 interior pairs compile to ONE gather-grouped segment
    # (launches 7 -> 3)
    height=4,
    width=8,
    num_channels=1,
    delta=2,
    pd_axes=("h", "w"),
    num_sums=4,
    batch_size=64,
)

# (arch id, benchmark batch, microbatches, timed steps): the reference's
# cells; pass --batch/--steps to override
DEFAULT_CELLS = (
    ("einet_rat", 256, 4, 3),
    ("einet_rat_large", 16, 2, 2),
    ("einet_pd", 32, 2, 2),
)

# the card profile: the same archs and microbatch counts at the configs'
# own batches -- einet_rat and einet_pd their ``batch_size``, einet_rat_large
# its per-chip share (its 65,536 rows are 256 a chip over 256 chips)
CARD_CELLS = (
    ("einet_rat", 2048, 4, 10),
    ("einet_rat_large", 256, 2, 3),
    ("einet_pd", 512, 2, 10),
)

PARITY_TOL = 1e-4

# Every non-smoke results[] row must show speedup >= 1.0 (the step program
# at least as fast as the per-step path) OR carry an explicit waiver here:
# arch id -> reason string, recorded verbatim in the row's
# ``speedup_waiver`` field.  Add entries ONLY with a root-cause note.
SPEEDUP_WAIVERS: dict = {
    "einet_rat_large": (
        "work-bound: both paths run the same kernels over 530.6M "
        "parameters (the M-step and blend read and write 2 GB a step), so "
        "the launches the step program saves are inside run-to-run noise; "
        "1.006-1.02x at B=16 on an NVIDIA H100 80GB HBM3 (700 W)"),
}


def _grad_parity(model) -> float:
    """Max abs diff of the gradients, the kernel op's backward (K2 on the
    card, its plain version on the CPU) against autograd through the plain
    forward, on the model's widest einsum layer (its real (L, K_out, K)
    shapes, at most 8 cells, 16 rows)."""
    spec = max(model.pair_specs, key=lambda s: s.num_partitions)
    l, k, ko = min(spec.num_partitions, 8), spec.k_in, spec.k_out
    gen = torch.Generator().manual_seed(0)
    w = torch.softmax(torch.randn(l, ko, k * k, generator=gen), -1)
    lnl = -torch.randn(16, l, k, generator=gen).abs() * 10.0
    lnr = -torch.randn(16, l, k, generator=gen).abs() * 10.0
    args = [t.to(model.device) for t in (w.reshape(l, ko, k, k), lnl, lnr)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args]
        return torch.autograd.grad(fn(*leaves).mean(), leaves)

    gk = grads(ops.log_einsum_exp)
    gr = grads(log_einsum_exp_plain)
    return max(float((a - b).abs().max()) for a, b in zip(gk, gr))


def _time_steps(step_fn, model, saved, x, steps: int, reps: int) -> float:
    """Best-of-reps mean seconds per step, each rep from the saved
    parameters, after two warm-up steps (the first captures)."""
    dev = model.device
    load_params(model, saved)
    step_fn(x)
    step_fn(x)
    best = float("inf")
    for _ in range(reps):
        load_params(model, saved)
        sync(dev)
        with obs.timed("bench.train.steps", steps=steps) as t:
            for _ in range(steps):
                step_fn(x)
            sync(dev)
        best = min(best, t.seconds / steps)
    load_params(model, saved)
    return best


def _best_s(fn, dev, reps: int) -> float:
    """Best seconds of ``reps`` calls of ``fn`` after one warm call, each
    ending in a device synchronisation."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        with obs.timed("bench.train.call") as t:
            fn()
            sync(dev)
        best = min(best, t.seconds)
    return best


def leaf_scatter_timing(arch: str = "einet_pd", batch: int = 32,
                        reps: int = 3, device=None) -> dict:
    """How much of an ``em_statistics`` call is the leaf-statistic fan-out
    scatter (``core.em.leaf_scatter``, an ``index_copy_`` into (D, K, R,
    |T|))?  Times the eager E-step against the scatter alone at its real
    operand shapes."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = build_einet(cfg, device=dev)
    d_vars = model.num_vars
    x = torch.from_numpy(
        np.random.RandomState(0).randn(batch, d_vars).astype(np.float32)
    ).to(dev)
    d, k, r = model.phi.shape[:3]
    t_dim = model.ef.num_stats
    p_len = len(model.leaf_spec.pair_var)
    rng = np.random.RandomState(1)
    sp = torch.from_numpy(rng.rand(p_len, k, t_dim).astype(np.float32)).to(dev)
    sd = torch.from_numpy(rng.rand(p_len, k).astype(np.float32)).to(dev)
    full_s = _best_s(lambda: em_statistics(model, x), dev, reps)
    scatter_s = _best_s(lambda: leaf_scatter(model, sp, sd), dev, reps)
    return {
        "arch": cfg.name,
        "arch_id": arch,
        "batch": batch,
        "num_pairs": int(p_len),
        "scatter_out_shape": [int(d), int(k), int(r), int(t_dim)],
        "em_statistics_ms": round(full_s * 1e3, 3),
        "leaf_scatter_ms": round(scatter_s * 1e3, 3),
        "scatter_fraction": round(scatter_s / max(full_s, 1e-12), 4),
    }


def _block(value: torch.Tensor) -> None:
    sync(value.device)


def segment_breakdown(model, x: torch.Tensor) -> dict:
    """Per-segment time breakdown of one forward pass, measured eagerly.

    The ``plan.segment`` spans in ``EiNet._forward_planned*`` are host
    time; to charge device time to each segment this enables obs tracing,
    installs a device synchronise as the obs sync hook (each span then
    waits for its own segment's output before closing) and runs one
    forward, eagerly and outside the program registry, after one warm
    forward.  Returns {segment kind: {launches, eager_ms}}: the
    synchronisations inflate the absolute numbers against the step's
    graphs, but the relative per-kind split is what the breakdown is for.
    """
    if not model.grouped_active:
        return {}
    with torch.inference_mode():
        model.log_likelihood(x)
    sync(model.device)
    mark = obs.num_events()
    was_enabled = obs.enabled()
    obs.configure(trace=True)
    obs.set_sync(_block)
    try:
        with torch.inference_mode():
            _block(model.log_likelihood(x))
    finally:
        obs.set_sync(None)
        obs.configure(trace=was_enabled)
    out: dict = {}
    for e in obs.trace_events()[mark:]:
        if e["name"] != "plan.segment":
            continue
        d = out.setdefault(e["args"]["kind"], {"launches": 0, "eager_ms": 0.0})
        d["launches"] += 1
        d["eager_ms"] += e["dur"] / 1e3
    for d in out.values():
        d["eager_ms"] = round(d["eager_ms"], 3)
    return out


def _per_step_path(model, em_cfg: EMConfig, num_microbatches: int):
    """The per-step path, op by op: one E-step a microbatch accumulated in
    order (``accumulate_statistics``), then ``m_step`` and ``blend_params``
    written into the model (``load_params``)."""

    def step(x):
        mb = x.shape[0] // num_microbatches
        acc = zeros_like_statistics(model)
        for i in range(num_microbatches):
            acc = accumulate_statistics(
                acc, em_statistics(model, x[i * mb:(i + 1) * mb]))
        mini = m_step(model, acc, em_cfg)
        load_params(model, blend_params(model, params_of(model), mini,
                                        em_cfg.step_size))
        return float(acc["ll"] / acc["count"])

    return step


def bench_cell(arch: str, cfg: EinetConfig, batch: int, microbatches: int,
               steps: int, reps: int, device=None, seed: int = 0,
               sentry=None) -> dict:
    """One row of the report.  ``sentry`` (an active
    ``analysis.CompileSentry``) wraps the step program, named
    ``em_step[<arch>]``."""
    dev = resolve_device(device)
    model = build_einet(cfg, device=dev, seed=seed)
    d = model.num_vars
    x = torch.from_numpy(
        np.random.RandomState(0).randn(batch, d).astype(np.float32)
    ).to(dev)
    em_cfg = EMConfig()
    saved = clone_tree(params_of(model))

    fused = make_em_step(
        model, TrainConfig(em=em_cfg, num_microbatches=microbatches),
        registry=compile_lib.ProgramRegistry())
    if sentry is not None:
        fused = sentry.wrap(fused, name=f"em_step[{arch}]")
    per_step = _per_step_path(model, em_cfg, microbatches)

    # first call of each path (the step program captures), from the same
    # parameters, checking they agree while we're at it
    with obs.timed("bench.train.first_fused") as t:
        fused(x)
        sync(dev)
    compile_fused_s = t.seconds
    pf = clone_tree(params_of(model))
    load_params(model, saved)
    with obs.timed("bench.train.first_per_step") as t:
        per_step(x)
        sync(dev)
    compile_per_step_s = t.seconds
    step_parity = max(
        float((a - b).abs().max())
        for a, b in zip(tree_lib.flatten(pf)[1],
                        tree_lib.flatten(params_of(model))[1])
        if a.numel()  # unmixed layers carry (0, 0, K) stubs
    )
    del pf

    fused_s = _time_steps(fused, model, saved, x, steps, reps)
    per_step_s = _time_steps(per_step, model, saved, x, steps, reps)
    parity = _grad_parity(model)
    segments = segment_breakdown(model, x)
    waiver = SPEEDUP_WAIVERS.get(arch)
    speedup = per_step_s / fused_s
    return {
        "arch": cfg.name,
        "arch_id": arch,
        "num_vars": d,
        "num_sums": model.K,
        "num_params_m": round(model.num_params() / 1e6, 3),
        "batch": batch,
        "microbatches": microbatches,
        "steps_timed": steps,
        "fused_ms_per_step": round(fused_s * 1e3, 2),
        "per_step_ms_per_step": round(per_step_s * 1e3, 2),
        "fused_steps_per_s": round(1.0 / fused_s, 3),
        "per_step_steps_per_s": round(1.0 / per_step_s, 3),
        "speedup": round(speedup, 3),
        "speedup_ok": speedup >= 1.0 or waiver is not None,
        "speedup_waiver": waiver,
        # kernel launches per forward: per-layer loop vs depth-grouped plan
        "grouping": model.grouping_summary(),
        # eager per-segment forward split (obs plan.segment spans)
        "segment_breakdown": segments,
        "compile_fused_s": round(compile_fused_s, 2),
        "compile_per_step_s": round(compile_per_step_s, 2),
        "update_parity_max_abs_diff": step_parity,
        "grad_parity_max_abs_diff": parity,
        "grad_parity_ok": parity <= PARITY_TOL,
    }


def main(smoke: bool = False, archs=None, batch: int = 0, steps: int = 0,
         reps: int = 2, out: str = "BENCH_torch_train.json", device=None,
         seed: int = 0, card: bool = False, sentry=None) -> dict:
    """Run the bench; returns the report, or {} when a gate fails.
    ``card`` runs ``CARD_CELLS`` in place of the reference's; ``sentry``
    (an active ``analysis.CompileSentry``) wraps each cell's step program.
    ``out=""`` writes no BENCH file and appends no history row."""
    dev = resolve_device(device)
    profile = "smoke" if smoke else "card" if card else "reference"
    if smoke:
        cells = [
            ("smoke", SMOKE_CONFIG, SMOKE_CONFIG.batch_size, 4, 3),
            ("smoke-pd", PD_SMOKE_CONFIG, PD_SMOKE_CONFIG.batch_size, 4, 3),
        ]
        reps = 1
    else:
        cells = [
            (a, get_config(a), batch or b, m, steps or s)
            for a, b, m, s in (CARD_CELLS if card else DEFAULT_CELLS)
            if archs is None or a in archs
        ]
    results = []
    for arch, cfg, b, m, s in cells:
        print(f"[bench_train] {cfg.name}: batch={b} microbatches={m} ...")
        r = bench_cell(arch, cfg, b, m, s, reps, dev, seed, sentry=sentry)
        g = r["grouping"]
        print(
            f"  fused {r['fused_ms_per_step']:.2f} ms/step vs per-step "
            f"{r['per_step_ms_per_step']:.2f} ms/step "
            f"(x{r['speedup']:.2f}); launches "
            f"{g['launches_per_layer']}->{g['launches_grouped']}; "
            f"grad parity {r['grad_parity_max_abs_diff']:.2e}; update "
            f"parity {r['update_parity_max_abs_diff']:.2e}"
        )
        if r["segment_breakdown"]:
            split = ", ".join(
                f"{k}: {v['launches']} launch(es) {v['eager_ms']:.3f} ms"
                for k, v in sorted(r["segment_breakdown"].items())
            )
            print(f"  segments (eager forward): {split}")
        results.append(r)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    parity_ok = all(r["grad_parity_ok"] for r in results)
    speedup_ok = smoke or all(r["speedup_ok"] for r in results)
    # grouped-execution gate: EVERY arch must run grouped -- RAT via fused
    # (canonical) segments, PD via gather segments -- unless waived
    grouped_ok = all(
        r["grouping"]["fused_groups"] >= 1
        or r["grouping"]["gather_groups"] >= 1
        or r["arch_id"] in SPEEDUP_WAIVERS
        for r in results
    )
    for r in results:
        if not r["speedup_ok"]:
            print(f"SPEEDUP REGRESSION (unwaived): {r['arch_id']} "
                  f"x{r['speedup']:.3f} < 1.0")
    # the leaf-statistic fan-out microbenchmark: at einet_pd scale even
    # when --arch narrowed the sweep; skipped under --smoke (null)
    scatter = None if smoke else leaf_scatter_timing(
        "einet_pd", batch=get_config("einet_pd").batch_size if card else 32,
        device=dev)
    if scatter:
        print(
            f"[bench_train] leaf scatter ({scatter['arch']}): "
            f"{scatter['leaf_scatter_ms']:.3f} ms of "
            f"{scatter['em_statistics_ms']:.3f} ms em_statistics "
            f"({100 * scatter['scatter_fraction']:.1f}%)"
        )
    report = {
        "results": results,
        "leaf_scatter": scatter,
        "smoke": smoke,
        "profile": profile,
        "backend": dev.type,
        "device": device_name(dev),
        "parity_ok": parity_ok,
        "speedup_ok": speedup_ok,
        "grouped_ok": grouped_ok,
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    if not parity_ok:
        print(f"GRAD PARITY FAILURE (> {PARITY_TOL})")
    if not grouped_ok:
        print("GROUPED-EXECUTION FAILURE: an arch expected to depth-group "
              "fell back to the per-layer path")
    write_report("train", report, out)
    return report if (parity_ok and speedup_ok and grouped_ok) else {}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, parity-gated only (CI profile)")
    ap.add_argument("--card", action="store_true",
                    help="the card profile: CARD_CELLS, the configs' own "
                    "batches (what slo_torch.json holds)")
    ap.add_argument("--arch", action="append", default=None,
                    help="restrict to this arch id (repeatable)")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the per-cell benchmark batch")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the models' initial parameters")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="BENCH_torch_train.json")
    args = ap.parse_args()
    result = main(smoke=args.smoke, archs=args.arch, batch=args.batch,
                  steps=args.steps, reps=args.reps, out=args.out,
                  device=args.device, seed=args.seed, card=args.card)
    raise SystemExit(0 if result else 1)
