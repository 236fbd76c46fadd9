#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

1. Prints the card's name and power limit, turns TF32 off (and prints the
   settings), and builds the six CUDA kernels from
   src/repro_torch/kernels/csrc with nvcc (sm_90a), one nvcc process a
   source, all at once.
2. Forward kernel phase: holds K1 (log_einsum_exp_fwd.cu) and K3
   (grouped_fwd.cu) against their plain PyTorch versions on the card (rtol
   1e-5, atol 1e-5; -inf and NEG_INF rows exactly) at einet_rat's shapes
   (B = 2048), at odd K, at K = 40, with saturated rows and ragged batches,
   and times each kernel, its plain version and a torch.einsum yardstick.
3. Backward kernel phase: holds K2 (log_einsum_exp_bwd.cu) and K4
   (grouped_bwd.cu) against their plain backward versions at einet_rat's
   shapes, odd K, K = 40, the K = 64 run of einet_rat_large, ragged batches
   and saturated rows (input gradients rtol = atol = 1e-5 with the plain
   version's exact zeros kept; weight gradients, summed over the batch in
   another order, rtol 1e-4 and atol 1e-4 max|gw|), checks that two calls
   give bitwise-equal gradients, and times each kernel, its plain version
   and torch.autograd.grad through the plain forward.
4. Gather kernel phase: holds K5 (gather_fwd.cu) and K6 (gather_bwd.cu),
   the gather run of a Poon-Domingos interior with its mixing, against
   their plain versions at einet_pd's run gather[0,2) (B = 512, its leaf
   rows), at K = 32, at the reference's PD_SMOKE_SHAPES (a 5-depth run at
   odd K = 3), on ragged batches, -inf and NEG_INF rows and a masked mixing
   child, with the tolerances above and two calls bitwise equal; times each
   kernel, its plain version and a yardstick (K5: the per-depth torch.einsum
   chain plus log_mix_exp; K6: torch.autograd.grad through the plain
   forward) and prints the row tiles and K6's partial-gradient bytes.
5. Serve phase: builds einet_rat at full width on the card (seed 0), serves
   the 256-request mixed stream through ServeEngine(max_batch=64) with the
   kernel launch counters reset just before, checks every result against
   direct one-request calls (LL within 1e-5, sampling/decode identical) and
   a few LLs against the CPU plain path, then times joint_ll on one
   2048-row batch, whole and stage by stage.
6. E-step phase: one em_statistics and one em_update on the first 2048 rows
   of the reference's synthetic data, on the card (fused plan, K3 + K4) and
   on the CPU plain path, and on the card per layer (K1 + K2): statistics
   within rtol 1e-4, atol 1e-6 B, parameters within rtol 1e-4, atol 1e-6.
7. Training phase: full EM for 3 steps on one batch (the LL may not drop by
   more than 1e-5 |LL| a step), then 20 stochastic EM steps at B = 2048 in
   each plan, with the launch counters reset just before each run and the
   launches per step asserted (fused: K3 1, K4 1; per layer: K1 4, K2 4).
8. einet_pd (the paper's SVHN config at full width, seed 0, B = 512, the
   reference's mixture-image data): the serve phase as in 5 (K5 and K1
   launched, engine against direct, a few LLs against the CPU), joint_ll
   through the plan (K5 1, K1 1) against the per-layer forward (K1 3),
   timed whole and by stage; the E-step as in 6 on the card planned (K5 +
   K6 + K1 + K2), twice and bitwise equal, against the CPU plain path and
   against the card per layer; training as in 7 (planned: K5 1, K6 1, K1 1,
   K2 1 a step; per layer: K1 3, K2 3).
9. einet_rat_large: K3 and K4 against their plain versions at its K = 64
   fused run [0, 2) (B = 64), then joint_ll at B = 256 through its plan
   (3 K3 + 1 K1 launches) against its per-layer forward (7 K1 launches).
10. Prints the launch counts of every main path (each kernel must have run
   on them), a JSON "kernels" line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It also exits non-zero when no CUDA device is present.  It imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
RTOL = ATOL = 1e-5


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def assert_close(got, want, what: str, exact=()) -> float:
    """rtol/atol on finite entries; non-finite entries, and the outputs
    indexed by each (row, cell) in ``exact`` (whose inputs are at -inf or
    NEG_INF saturation), must agree exactly.  Returns the max |diff| over
    finite entries."""
    import torch

    for idx in exact:
        if not torch.equal(got[idx], want[idx]):
            raise AssertionError(f"{what}: saturated output {idx} differs")
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{what}: finiteness differs from the plain version")
    if not torch.equal(got[~fin], want[~fin]):
        raise AssertionError(f"{what}: non-finite entries differ")
    if not torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(
            f"{what}: max |diff| {(got[fin] - want[fin]).abs().max().item():.3e}"
            f" beyond rtol={RTOL}, atol={ATOL}")
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def assert_grad_close(got, want, what: str, weight: bool = False) -> dict:
    """A backward kernel's output against its plain version: finite
    everywhere, exact zeros where the plain version has them, and within
    rtol = atol = 1e-5 (an input gradient) or, for a weight gradient summed
    over the batch in another order, rtol 1e-4 and atol 1e-4 max|want|.
    Returns the max absolute difference and its ratio to max|want|."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite gradient")
    zero = want == 0
    if not bool((got[zero] == 0).all()):
        raise AssertionError(f"{what}: exact zeros of the plain version differ")
    scale = want.abs().max().item()
    rtol, atol = (1e-4, 1e-4 * scale) if weight else (RTOL, ATOL)
    diff = (got - want).abs()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{what}: max |diff| {diff.max().item():.3e} beyond rtol={rtol}, "
            f"atol={atol:.3e}")
    return {"abs": diff.max().item(),
            "rel": diff.max().item() / scale if scale else 0.0}


def bwd_cost(b, cells, k, k_out):
    """(bytes, flops) of one pair's backward: ln_l, ln_r and g read, gl and
    gr written, W read and gw written once; the three contractions (s, the
    c = ginv W of the input gradients, dW) at 2 K^2 K_out flops each and the
    row and column sums of c at 4 K^2, per cell and row."""
    n_bytes = 4 * (4 * b * cells * k + b * cells * k_out
                   + 2 * cells * k_out * k * k)
    return n_bytes, b * cells * (6 * k * k * k_out + 4 * k * k)


def bound(n_bytes, flops):
    """(bound ms, what bounds it) on the card's published peaks."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def counts_of(ops):
    return {op.name: op.launches for op in ops.KERNEL_OPS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import em, poon_domingos
    from repro_torch.core.einet import EiNet
    from repro_torch.core.layers import NEG_INF, log_mix_exp
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.grouped import (
        gather_grouped_log_einsum_exp_bwd_cuda,
        gather_grouped_log_einsum_exp_bwd_plain,
        gather_grouped_log_einsum_exp_cuda, gather_grouped_log_einsum_exp_plain,
        grouped_log_einsum_exp_bwd_cuda, grouped_log_einsum_exp_bwd_plain,
        grouped_log_einsum_exp_cuda, grouped_log_einsum_exp_plain,
        pick_gather_tile_b)
    from repro_torch.kernels.log_einsum_exp import (
        log_einsum_exp_bwd_cuda, log_einsum_exp_bwd_plain,
        log_einsum_exp_cuda, log_einsum_exp_plain)
    from repro_torch.launch.cells import build_einet
    from repro_torch.launch.train import (
        batch_at, synthetic_pd_data, synthetic_rat_data)
    from repro_torch.serve import (
        ServeEngine, direct_call, mixed_requests, parity)
    from repro_torch.train import TrainConfig, make_em_step

    card = smi_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"float32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reports = build.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"built {len(reports)} kernels with nvcc in {build_s:.2f} s [{card}]")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ------------------------------------------------ forward kernel phase
    cfg = get_config("einet_rat")
    b_full = cfg.batch_size
    model = build_einet(cfg, device=dev, seed=0)
    gen = torch.Generator().manual_seed(0)
    x_full = torch.randn(b_full, model.num_vars, generator=gen).to(dev)
    with torch.inference_mode():
        leaf = model._leaf_rows(model.leaf_log_prob(x_full, None))
        # the per-pair inputs the main path hands the kernels: the chain of
        # plain-version outputs from the leaf rows up
        inputs, cur = [], leaf
        for i, sp in enumerate(model.pair_specs):
            half = sp.num_partitions
            w = model.einsum[i].detach()
            inputs.append((w, cur[:, :half], cur[:, half: 2 * half]))
            cur = log_einsum_exp_plain(*inputs[-1])
        seg = model.exec_plan[0]
        if not (seg.kind == "fused" and (seg.start, seg.stop) ==
                (0, len(model.pair_specs))):
            raise AssertionError(f"einet_rat plan is {model.exec_plan}")
        ws = [model.einsum[t].detach() for t in range(seg.start, seg.stop)]

    def frame(ln_l, ln_r):
        a = torch.clamp(ln_l.amax(-1, keepdim=True), min=NEG_INF)
        ap = torch.clamp(ln_r.amax(-1, keepdim=True), min=NEG_INF)
        return torch.exp(ln_l - a), torch.exp(ln_r - ap)

    rng = np.random.RandomState(0)

    def rand_w(cells, k_out, k):
        w = torch.from_numpy(rng.rand(cells, k_out, k, k).astype(np.float32))
        return (w / w.sum((-2, -1), keepdim=True)).to(dev)

    def rand_x(b, rows, k):
        x = torch.from_numpy(
            (rng.randn(b, rows, k) * 4 - 20).astype(np.float32)).to(dev)
        x[0, :, :] = NEG_INF           # every cell fully masked
        x[1, 0, :] = -float("inf")     # cell 0 at log 0
        x[2, 1, : k // 2 + 1] = -float("inf")
        x[3, 0, :] = 4 * NEG_INF       # cell 0 saturated below the clamp
        return x

    def rand_g(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    with torch.inference_mode():
        # K1 at every pair of einet_rat
        k1_err, k1_rows = 0.0, []
        for i, (w, l, r) in enumerate(inputs):
            got = log_einsum_exp_cuda(w, l, r)
            k1_err = max(k1_err, assert_close(
                got, log_einsum_exp_plain(w, l, r), f"K1 pair {i}"))
            el, er = frame(l, r)
            l_cells, k_out, k, _ = w.shape
            n_bytes = 4 * (2 * b_full * l_cells * k + w.numel()
                           + b_full * l_cells * k_out)
            flops = 2 * b_full * l_cells * k_out * k * k
            k1_rows.append({
                "shape": f"B={b_full} L={l_cells} K={k} K_out={k_out}",
                "ms": time_ms(lambda: log_einsum_exp_cuda(w, l, r)),
                "plain_ms": time_ms(lambda: log_einsum_exp_plain(w, l, r)),
                "library_ms": time_ms(lambda: torch.einsum(
                    "lkij,bli,blj->blk", w, el, er)),
                "bytes": n_bytes, "flops": flops,
            })
        # K3 at einet_rat's fused run [0, 4)
        got = grouped_log_einsum_exp_cuda(ws, leaf)
        k3_err = assert_close(
            got, grouped_log_einsum_exp_plain(ws, leaf), "K3 fused[0,4)")
        frames = [frame(l, r) for _, l, r in inputs]
        n_bytes = 4 * (leaf.numel() + sum(w.numel() for w in ws)
                       + got.numel())
        flops = sum(2 * b_full * w.shape[0] * w.shape[1] * w.shape[2] ** 2
                    for w in ws)
        k3_row = {
            "shape": f"B={b_full} x={tuple(leaf.shape)} G={len(ws)} "
                     f"K_out={[w.shape[1] for w in ws]}",
            "ms": time_ms(lambda: grouped_log_einsum_exp_cuda(ws, leaf)),
            "plain_ms": time_ms(lambda: grouped_log_einsum_exp_plain(ws, leaf)),
            # yardstick: the contraction of every depth as torch.einsum on
            # its stabilised frame (one call per depth, summed)
            "einsum_chain_ms": sum(
                time_ms(lambda w=w, f=f: torch.einsum(
                    "lkij,bli,blj->blk", w, f[0], f[1]))
                for w, f in zip(ws, frames)),
            "bytes": n_bytes, "flops": flops,
        }

        # odd K, K_out tiling (K = 40), saturated rows, ragged batches
        for k in (3, 5, 13, 17, 40):
            for b in (37, 2048 + 5):
                w = rand_w(6, k if k != 3 else 1, k)
                x = rand_x(b, 12, k)
                assert_close(log_einsum_exp_cuda(w, x[:, :6], x[:, 6:]),
                             log_einsum_exp_plain(w, x[:, :6], x[:, 6:]),
                             f"K1 K={k} B={b}",
                             exact=((0,), (1, 0), (3, 0)))
                for g, l_out, kf in ((2, 3, 1), (3, 2, k)):
                    gws = [rand_w(l_out * 2 ** (g - 1 - d),
                                  k if d < g - 1 else kf, k)
                           for d in range(g)]
                    gx = rand_x(b, l_out * 2 ** g, k)
                    assert_close(grouped_log_einsum_exp_cuda(gws, gx),
                                 grouped_log_einsum_exp_plain(gws, gx),
                                 f"K3 K={k} B={b} G={g}",
                                 exact=((0,), (1, 0), (3, 0)))
        torch.cuda.synchronize()
    print(f"forward kernels: K1 and K3 agree with their plain versions "
          f"(rtol={RTOL}, atol={ATOL}); einet_rat max|diff| K1 {k1_err:.3e}, "
          f"K3 {k3_err:.3e} [{card}]")

    # ----------------------------------------------- backward kernel phase
    def check_k2(w, l, r, g, what):
        got = log_einsum_exp_bwd_cuda(w, l, r, g)
        want = log_einsum_exp_bwd_plain(w, l, r, g)
        again = log_einsum_exp_bwd_cuda(w, l, r, g)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two calls differ")
        return [assert_grad_close(got[0], want[0], f"{what} gw", weight=True),
                assert_grad_close(got[1], want[1], f"{what} gl"),
                assert_grad_close(got[2], want[2], f"{what} gr")]

    def check_k4(gws, x, g_out, what):
        got_w, got_x = grouped_log_einsum_exp_bwd_cuda(gws, x, g_out)
        want_w, want_x = grouped_log_einsum_exp_bwd_plain(gws, x, g_out)
        again_w, again_x = grouped_log_einsum_exp_bwd_cuda(gws, x, g_out)
        if not (torch.equal(got_x, again_x) and all(
                torch.equal(a, b) for a, b in zip(got_w, again_w))):
            raise AssertionError(f"{what}: two calls differ")
        errs = [assert_grad_close(a, b, f"{what} gw{d}", weight=True)
                for d, (a, b) in enumerate(zip(got_w, want_w))]
        return errs + [assert_grad_close(got_x, want_x, f"{what} gx")]

    def autograd_yardstick(fn, params, g):
        """torch.autograd.grad through the plain forward: the same gradients
        by autodiff, forward pass included."""
        req = [p.detach().clone().requires_grad_(True) for p in params]

        def run():
            with torch.enable_grad():
                return torch.autograd.grad(fn(*req), req, g)
        return run

    with torch.no_grad():
        k2_rows, k2_w_errs, k2_x_errs = [], [], []
        for i, (w, l, r) in enumerate(inputs):
            g = rand_g(b_full, w.shape[0], w.shape[1])
            errs = check_k2(w, l, r, g, f"K2 pair {i}")
            k2_w_errs.append(errs[0])
            k2_x_errs += errs[1:]
            n_bytes, flops = bwd_cost(b_full, *w.shape[:3])
            k2_rows.append({
                "shape": f"B={b_full} L={w.shape[0]} K={w.shape[2]} "
                         f"K_out={w.shape[1]}",
                "ms": time_ms(lambda: log_einsum_exp_bwd_cuda(w, l, r, g)),
                "plain_ms": time_ms(
                    lambda: log_einsum_exp_bwd_plain(w, l, r, g)),
                "library_ms": time_ms(autograd_yardstick(
                    log_einsum_exp_plain, (w, l, r), g)),
                "bytes": n_bytes, "flops": flops,
            })
        g_out = rand_g(b_full, ws[-1].shape[0], ws[-1].shape[1])
        errs = check_k4(ws, leaf, g_out, "K4 fused[0,4)")
        k4_w_errs, k4_x_errs = errs[:-1], errs[-1:]
        n_bytes = 4 * (2 * leaf.numel() + g_out.numel()
                       + 2 * sum(w.numel() for w in ws))
        flops = sum(b_full * w.shape[0] * (6 * w.shape[2] ** 2 * w.shape[1]
                                           + 4 * w.shape[2] ** 2) for w in ws)
        k4_row = {
            "shape": k3_row["shape"],
            "ms": time_ms(lambda: grouped_log_einsum_exp_bwd_cuda(
                ws, leaf, g_out)),
            "plain_ms": time_ms(lambda: grouped_log_einsum_exp_bwd_plain(
                ws, leaf, g_out)),
            "library_ms": time_ms(autograd_yardstick(
                lambda x, *w: grouped_log_einsum_exp_plain(list(w), x),
                (leaf, *ws), g_out)),
            "bytes": n_bytes, "flops": flops,
        }
        for k in (3, 5, 13, 17, 40):
            for b in (37, 2048 + 5):
                w = rand_w(6, k if k != 3 else 1, k)
                x = rand_x(b, 12, k)
                errs = check_k2(w, x[:, :6], x[:, 6:],
                                rand_g(b, 6, w.shape[1]), f"K2 K={k} B={b}")
                k2_w_errs.append(errs[0])
                k2_x_errs += errs[1:]
                for g, l_out, kf in ((2, 3, 1), (3, 2, k)):
                    gws = [rand_w(l_out * 2 ** (g - 1 - d),
                                  k if d < g - 1 else kf, k)
                           for d in range(g)]
                    gx = rand_x(b, l_out * 2 ** g, k)
                    errs = check_k4(gws, gx, rand_g(b, l_out, kf),
                                    f"K4 K={k} B={b} G={g}")
                    k4_w_errs += errs[:-1]
                    k4_x_errs += errs[-1:]
        torch.cuda.synchronize()

    def worst(errs, key):
        return max(e[key] for e in errs)

    print(f"backward kernels: K2 and K4 agree with their plain versions and "
          f"are bitwise deterministic over two calls; input gradients max "
          f"|diff| K2 {worst(k2_x_errs, 'abs'):.3e}, K4 "
          f"{worst(k4_x_errs, 'abs'):.3e} (rtol=atol={RTOL}); weight "
          f"gradients max |diff| K2 {worst(k2_w_errs, 'abs'):.3e} (relative to "
          f"max|gw| {worst(k2_w_errs, 'rel'):.3e}), K4 "
          f"{worst(k4_w_errs, 'abs'):.3e} (relative "
          f"{worst(k4_w_errs, 'rel'):.3e}) [{card}]")

    # ------------------------------------------------- gather kernel phase
    pd_cfg = get_config("einet_pd")
    b_pd = pd_cfg.batch_size
    pd = build_einet(pd_cfg, device=dev, seed=0)
    if [(sg.start, sg.stop, sg.kind) for sg in pd.exec_plan] != [
            (0, 2, "gather"), (2, 3, "layer")]:
        raise AssertionError(f"einet_pd plan is {pd.exec_plan}")
    pd_tab = pd.exec_plan[0].tables
    pd_data = torch.from_numpy(synthetic_pd_data(pd.num_vars))
    pd_data_dev = pd_data.to(dev)
    pd_xb = pd_data_dev[:b_pd]
    with torch.no_grad():
        pd_leaf = pd._leaf_rows(pd.leaf_log_prob(pd_xb, None))
        pd_ws = [pd.einsum[t].detach() for t in range(2)]
        pd_vs = [pd.mixing[1].detach()]

    def check_k5(tables, ws_, vs_, x, what, exact=()):
        got = gather_grouped_log_einsum_exp_cuda(tables, ws_, vs_, x)
        again = gather_grouped_log_einsum_exp_cuda(tables, ws_, vs_, x)
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls differ")
        return assert_close(
            got, gather_grouped_log_einsum_exp_plain(tables, ws_, vs_, x),
            what, exact)

    def check_k6(tables, ws_, vs_, x, g, what):
        def flat(r):
            return list(r[0]) + list(r[1]) + [r[2]]
        got = flat(gather_grouped_log_einsum_exp_bwd_cuda(tables, ws_, vs_,
                                                          x, g))
        again = flat(gather_grouped_log_einsum_exp_bwd_cuda(tables, ws_, vs_,
                                                            x, g))
        want = flat(gather_grouped_log_einsum_exp_bwd_plain(tables, ws_, vs_,
                                                            x, g))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two calls differ")
        errs = [assert_grad_close(a, b, f"{what} gw{i}", weight=True)
                for i, (a, b) in enumerate(zip(got[:-1], want[:-1]))]
        return errs, assert_grad_close(got[-1], want[-1], f"{what} gx")

    def smoke_tables(h, w, delta, k):
        m = EiNet(poon_domingos(h, w, delta), num_sums=k, device="meta")
        return next(sg.tables for sg in m.exec_plan if sg.kind == "gather")

    def masked(tables):
        """The run with the last child of its first mixing slot masked."""
        return dataclasses.replace(tables, mix_mask=tuple(
            None if m is None else tuple(
                tuple(0 if (i, j) == (0, len(row) - 1) else v
                      for j, v in enumerate(row)) for i, row in enumerate(m))
            for m in tables.mix_mask))

    def rand_wv(tables, k):
        ws_ = [rand_w(len(l), k, k) for l in tables.left]
        vs_ = []
        for child, mask in zip(tables.mix_child, tables.mix_mask):
            if child is not None:
                v = (torch.from_numpy(rng.rand(len(child), len(child[0]), k)
                                      .astype(np.float32)) + 0.1) * \
                    torch.tensor(mask, dtype=torch.float32)[:, :, None]
                vs_.append((v / v.sum(1, keepdim=True)).to(dev))
        return ws_, vs_

    with torch.no_grad():
        # einet_pd's run at B = 512 on its leaf rows, then other widths,
        # the reference's PD_SMOKE_SHAPES (a 5-depth run at odd K = 3),
        # ragged batches, -inf and NEG_INF rows and a masked mixing child
        k5_err = check_k5(pd_tab, pd_ws, pd_vs, pd_leaf,
                          "K5 einet_pd gather[0,2)")
        pd_g = rand_g(b_pd, pd_tab.num_new_rows, pd.K)
        k6_w_errs, e = check_k6(pd_tab, pd_ws, pd_vs, pd_leaf, pd_g,
                                "K6 einet_pd gather[0,2)")
        k6_x_errs = [e]
        cases = [("einet_pd_mnist width", pd_tab, 32, 256),
                 ("masked child", masked(pd_tab), 40, 37),
                 ("masked child", masked(pd_tab), 5, 517)] + [
            (f"PD_SMOKE {sh}", smoke_tables(*sh), sh[-1], b)
            for sh in ((4, 8, 2, 4), (2, 8, 2, 6), (4, 4, 1, 3))
            for b in (37, 517)]
        for name, tables, k, b in cases:
            ws_, vs_ = rand_wv(tables, k)
            x = rand_x(b, tables.num_in_rows, k)
            what = f"{name} K={k} B={b}"
            k5_err = max(k5_err, check_k5(tables, ws_, vs_, x, f"K5 {what}",
                                          exact=((0,),)))
            errs, e = check_k6(tables, ws_, vs_, x,
                               rand_g(b, tables.num_new_rows, k), f"K6 {what}")
            k6_w_errs += errs
            k6_x_errs.append(e)
        # times at einet_pd's run; the yardstick is each depth's contraction
        # as torch.einsum on its stabilised frame plus its mixing as
        # log_mix_exp (one call each, summed): no single call computes K5
        yard, buf = 0.0, pd_leaf
        for t, w in enumerate(pd_ws):
            lr = (buf[:, list(pd_tab.left[t])], buf[:, list(pd_tab.right[t])])
            f = frame(*lr)
            yard += time_ms(lambda w=w, f=f: torch.einsum(
                "lkij,bli,blj->blk", w, f[0], f[1]))
            sv = log_einsum_exp_plain(w, *lr)
            if pd_tab.mix_child[t] is not None:
                child = torch.tensor(pd_tab.mix_child[t], device=dev)
                mask = torch.tensor(pd_tab.mix_mask[t], dtype=torch.float32,
                                    device=dev)
                ln = sv[:, child]
                yard += time_ms(lambda ln=ln, mask=mask: log_mix_exp(
                    pd_vs[0], ln, mask))
                sv = torch.cat([sv, log_mix_exp(pd_vs[0], ln, mask)], 1)
            buf = torch.cat([buf, sv], 1)
        n_w = sum(w.numel() for w in pd_ws) + sum(v.numel() for v in pd_vs)
        n_new = b_pd * pd_tab.num_new_rows * pd.K
        k5_row = {
            "shape": f"B={b_pd} x={tuple(pd_leaf.shape)} "
                     f"cells={[len(l) for l in pd_tab.left]} K={pd.K}",
            "ms": time_ms(lambda: gather_grouped_log_einsum_exp_cuda(
                pd_tab, pd_ws, pd_vs, pd_leaf)),
            "plain_ms": time_ms(lambda: gather_grouped_log_einsum_exp_plain(
                pd_tab, pd_ws, pd_vs, pd_leaf)),
            "einsum_chain_ms": yard,
            "bytes": 4 * (pd_leaf.numel() + n_w + n_new),
            "flops": sum(2 * b_pd * len(l) * pd.K ** 3 for l in pd_tab.left),
        }
        k6_row = {
            "shape": k5_row["shape"],
            "ms": time_ms(lambda: gather_grouped_log_einsum_exp_bwd_cuda(
                pd_tab, pd_ws, pd_vs, pd_leaf, pd_g)),
            "plain_ms": time_ms(lambda: gather_grouped_log_einsum_exp_bwd_plain(
                pd_tab, pd_ws, pd_vs, pd_leaf, pd_g)),
            "library_ms": time_ms(autograd_yardstick(
                lambda x, *wv: gather_grouped_log_einsum_exp_plain(
                    pd_tab, list(wv[:2]), list(wv[2:]), x),
                (pd_leaf, *pd_ws, *pd_vs), pd_g)),
            "bytes": 4 * (2 * pd_leaf.numel() + n_new + 2 * n_w),
            "flops": sum(b_pd * len(l) * (6 * pd.K ** 3 + 4 * pd.K ** 2)
                         for l in pd_tab.left),
        }
        torch.cuda.synchronize()
    tiles = (pick_gather_tile_b(pd_tab, pd.K, b_pd),
             pick_gather_tile_b(pd_tab, pd.K, b_pd, backward=True))
    n_tiles = -(-b_pd // tiles[1])
    print(f"gather kernels: K5 and K6 agree with their plain versions and "
          f"are bitwise deterministic over two calls; K5 max |diff| "
          f"{k5_err:.3e} (rtol=atol={RTOL}); K6 input gradients max |diff| "
          f"{worst(k6_x_errs, 'abs'):.3e}, weight and mixing gradients max "
          f"|diff| {worst(k6_w_errs, 'abs'):.3e} (relative to max|gw| "
          f"{worst(k6_w_errs, 'rel'):.3e}); einet_pd B={b_pd}: row tiles "
          f"{tiles[0]} (K5, {-(-b_pd // tiles[0])} blocks) and {tiles[1]} "
          f"(K6, {n_tiles} blocks), K6 partial gradients {n_tiles} x "
          f"{4 * n_w} B = {n_tiles * 4 * n_w / 2 ** 20:.1f} MiB [{card}]")

    # -------------------------------------------------------- serve phase
    reqs = mixed_requests(model.num_vars, 256, seed=0)
    engine = ServeEngine(model, max_batch=64)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = counts_of(ops)
    plain_counts = {op.name: op.plain_calls for op in ops.KERNEL_OPS}
    if (serve_counts["log_einsum_exp"] == 0
            or serve_counts["grouped_log_einsum_exp"] == 0
            or serve_counts["log_einsum_exp_bwd"]
            or serve_counts["grouped_log_einsum_exp_bwd"]
            or any(plain_counts.values())):
        raise AssertionError(f"serve path launches {serve_counts}, "
                             f"plain-version calls {plain_counts}")
    steady = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    call = direct_call(model)
    direct = {r.req_id: call(r) for r in reqs}
    par = parity(reqs, served, direct)
    print(f"serve parity: LL max|engine - direct| {par['ll_max_abs_diff']:.3e}"
          f", sampling/decode mismatches {par['sample_mismatches']} [{card}]")
    if par["ll_max_abs_diff"] > 1e-5 or par["sample_mismatches"]:
        raise AssertionError(f"engine/direct parity violated: {par}")
    for r in reqs:
        v = np.asarray(served[r.req_id].value)
        want = () if r.kind in ("joint_ll", "marginal_ll", "conditional_ll") \
            else (model.num_vars,)
        if v.shape != want or not np.isfinite(v).all():
            raise AssertionError(f"request {r.req_id} ({r.kind}): {v.shape}")
        if r.kind in ("conditional_sample", "mpe") and not np.array_equal(
                v[r.evidence_mask], r.x[r.evidence_mask]):
            raise AssertionError(f"request {r.req_id}: evidence changed")

    # the card against the CPU plain path on a few rows, same seed
    cpu_model = EiNet(model.graph, num_sums=model.K,
                      num_classes=model.num_classes,
                      exponential_family=model.ef, device="cpu", seed=0)
    with torch.inference_mode():
        ll_card = model.log_likelihood(x_full[:8]).cpu()
        ll_cpu = cpu_model.log_likelihood(x_full[:8].cpu())
    if not torch.allclose(ll_card, ll_cpu, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"card LL {ll_card} vs CPU {ll_cpu}")

    with torch.inference_mode():
        ll_ms = time_ms(lambda: model.log_likelihood(x_full), iters=10)
        if not bool(torch.isfinite(model.log_likelihood(x_full)).all()):
            raise AssertionError("joint_ll on the 2048-row batch not finite")
        # where a joint_ll batch spends its time, stage by stage
        e = model.leaf_log_prob(x_full, None)
        root = model.forward_from_e(None, leaf_rows=leaf)
        stages = {
            "leaf EF log_prob": time_ms(
                lambda: model.leaf_log_prob(x_full, None), iters=10),
            "leaf rows": time_ms(lambda: model._leaf_rows(e), iters=10),
            "plan walk (K3 + root mixing)": time_ms(
                lambda: model.forward_from_e(None, leaf_rows=leaf), iters=10),
            "class logsumexp": time_ms(lambda: torch.logsumexp(
                root + torch.log(model.class_prior)[None], -1), iters=10),
        }
    qps = len(reqs) / min(steady)

    # ------------------------------------------------------- E-step phase
    def flat_stats(tree, prefix=""):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in flat_stats(v, k)]
        if isinstance(tree, list):
            return [p for i, v in enumerate(tree)
                    for p in flat_stats(v, f"{prefix}[{i}]")]
        return [(prefix, tree.detach().cpu())]

    def compare_stats(a, b, what, rtol, atol, scaled=None):
        """Every tensor of a statistics or parameter dict against another:
        rtol, atol (for a name in ``scaled``, its value times the block's
        max |b| instead).  Prints each block's max |diff|; raises after printing if
        any block is out of tolerance.  Returns the largest |diff| and the
        largest |diff| / max|b| over the blocks."""
        worst_abs = worst_rel = 0.0
        lines, bad = [], []
        for (name, x), (_, y) in zip(flat_stats(a), flat_stats(b)):
            if x.shape != y.shape:
                raise AssertionError(f"{what} {name}: {x.shape} vs {y.shape}")
            if x.numel() == 0:
                continue
            scale = y.abs().max().item()
            tol = scaled[name] * scale if name in (scaled or {}) else atol
            d = (x - y).abs().max().item()
            lines.append(f"{name} {d:.2e}")
            if not torch.allclose(x, y, rtol=rtol, atol=tol):
                bad.append(f"{name} (max |diff| {d:.3e} beyond rtol={rtol}, "
                           f"atol={tol:.1e})")
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel, d / scale if scale else 0.0)
        print(f"{what}: max |diff| by block: " + ", ".join(lines))
        if bad:
            raise AssertionError(f"{what}: " + "; ".join(bad))
        return worst_abs, worst_rel

    data = torch.from_numpy(synthetic_rat_data(model.num_vars))
    data_dev = data.to(dev)
    xb = data_dev[:b_full]
    em_cfg = em.EMConfig()
    model_pl = build_einet(cfg, device=dev, seed=0, grouped=False)
    ops.reset_counts()
    stats_card = em.em_statistics(model, xb)
    stats_pl = em.em_statistics(model_pl, xb)
    torch.cuda.synchronize()
    estep_counts = counts_of(ops)
    if estep_counts != {"log_einsum_exp": 4, "log_einsum_exp_bwd": 4,
                        "grouped_log_einsum_exp": 1,
                        "grouped_log_einsum_exp_bwd": 1,
                        "gather_grouped_log_einsum_exp": 0,
                        "gather_grouped_log_einsum_exp_bwd": 0}:
        raise AssertionError(f"E-step launches {estep_counts}")
    t0 = time.perf_counter()
    stats_cpu = em.em_statistics(cpu_model, data[:b_full])
    cpu_estep_s = time.perf_counter() - t0
    stat_atol = 1e-6 * b_full
    d_cpu = compare_stats(stats_card, stats_cpu, "E-step card vs CPU", 1e-4,
                          stat_atol)
    d_pl = compare_stats(stats_pl, stats_card, "E-step per-layer vs fused",
                         1e-4, stat_atol)
    # em_update is em_statistics then m_step.  phi's mean entries are
    # sum_b p x / sum_b p over white noise, whose numerator cancels to near
    # 0, so phi's atol is 1e-4 of its scale; the weights' atol is 1e-6
    new_card = em.m_step(model, stats_card, em_cfg)
    phi_tol = {"phi": 1e-4}
    p_cpu = compare_stats(new_card, em.m_step(cpu_model, stats_cpu, em_cfg),
                          "em_update card vs CPU", 1e-4, 1e-6, phi_tol)
    p_pl = compare_stats(em.m_step(model_pl, stats_pl, em_cfg), new_card,
                         "em_update per-layer vs fused", 1e-4, 1e-6, phi_tol)
    print(f"E-step einet_rat B={b_full} (synthetic data, seed-0 weights): "
          f"card (K3 + K4) vs CPU plain: statistics max |diff| "
          f"{d_cpu[0]:.3e} (at most {d_cpu[1]:.3e} of a block's max; rtol "
          f"1e-4, atol {stat_atol:.1e}), em_update parameters max |diff| "
          f"{p_cpu[0]:.3e} (at most {p_cpu[1]:.3e} of a block's max; rtol "
          f"1e-4, atol 1e-6, phi 1e-4 max|phi|); card per layer (K1 + K2) "
          f"vs fused: statistics {d_pl[0]:.3e} ({d_pl[1]:.3e}), parameters "
          f"{p_pl[0]:.3e} ({p_pl[1]:.3e}); CPU E-step "
          f"{cpu_estep_s:.2f} s [{card}]")

    # ----------------------------------------------------- training phase
    def train_run(m, mode, steps, batches, want):
        step = make_em_step(m, TrainConfig(mode=mode))
        ops.reset_counts()
        lls, times = [], []
        for i in range(steps):
            x = batches(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lls.append(step(x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = counts_of(ops)
        if any(got[k] != want.get(k, 0) * steps for k in got):
            raise AssertionError(
                f"{mode} EM: launches {got} in {steps} steps, expected "
                f"{want} a step")
        if not all(np.isfinite(lls)):
            raise AssertionError(f"{mode} EM: LL {lls}")
        return {"lls": lls, "median_ms": sorted(times)[len(times) // 2] * 1e3,
                "counts": got}

    fused_want = {"grouped_log_einsum_exp": 1, "grouped_log_einsum_exp_bwd": 1}
    layer_want = {"log_einsum_exp": 4, "log_einsum_exp_bwd": 4}
    full_model = build_einet(cfg, device=dev, seed=0)
    full = train_run(full_model, "full", 3, lambda i: xb, fused_want)
    with torch.inference_mode():
        full["lls"].append(full_model.log_likelihood(xb).mean().item())
    for a, b in zip(full["lls"], full["lls"][1:]):
        if b < a - 1e-5 * abs(a):
            raise AssertionError(f"full EM lowered the batch LL: {full['lls']}")
    print(f"full EM einet_rat B={b_full}, 3 steps on one batch: mean LL "
          + " -> ".join(f"{v:.4f}" for v in full["lls"])
          + f" (non-decreasing) [{card}]")
    train = {}
    for label, m, want in (("fused", model, fused_want),
                           ("per-layer", model_pl, layer_want)):
        train[label] = train_run(m, "stochastic", 20,
                                 lambda i: batch_at(data_dev, i, b_full), want)
        r = train[label]
        print(f"stochastic EM einet_rat {label} plan {m.grouping_summary()['segments']}"
              f" B={b_full}, 20 steps: median {r['median_ms']:.3f} ms/step, "
              f"mean LL first {r['lls'][0]:.4f}, last {r['lls'][-1]:.4f}, "
              f"launches a step " + ", ".join(
                  f"{k} {v // 20}" for k, v in r["counts"].items())
              + f" [{card}]")
    # where a fused stochastic step spends its time, stage by stage
    with torch.no_grad():
        stats = em.em_statistics(model, xb)
        step_stages = {
            "leaf EF log_prob + leaf rows": time_ms(
                lambda: model._leaf_rows(model.leaf_log_prob(xb, None)),
                iters=5, warmup=1),
            "em_statistics (leaf layer, forward, backward, leaf statistics)":
                time_ms(lambda: em.em_statistics(model, xb), iters=5,
                        warmup=1),
            "m_step + blend": time_ms(lambda: em.blend_params(
                model, em.params_of(model), em.m_step(model, stats, em_cfg),
                em_cfg.step_size), iters=5, warmup=1),
        }
    print(f"stochastic EM step stages (fused, B={b_full}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in step_stages.items()) + f" [{card}]")
    del model_pl, full_model, cpu_model, stats

    # ---------------------------------------------- einet_pd serve phase
    pd_reqs = mixed_requests(pd.num_vars, 256, seed=0)
    pd_engine = ServeEngine(pd, max_batch=64)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pd_served = pd_engine.run(pd_reqs)
    torch.cuda.synchronize()
    pd_serve_s = time.perf_counter() - t0
    pd_serve_counts = counts_of(ops)
    plain_counts = {op.name: op.plain_calls for op in ops.KERNEL_OPS}
    if (pd_serve_counts["gather_grouped_log_einsum_exp"] == 0
            or pd_serve_counts["log_einsum_exp"] == 0
            or any(v for k, v in pd_serve_counts.items()
                   if k.endswith("_bwd") or k.startswith("grouped"))
            or any(plain_counts.values())):
        raise AssertionError(f"einet_pd serve path launches "
                             f"{pd_serve_counts}, plain-version calls "
                             f"{plain_counts}")
    pd_steady = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd_engine.run(pd_reqs)
        torch.cuda.synchronize()
        pd_steady.append(time.perf_counter() - t0)
    call = direct_call(pd)
    pd_par = parity(pd_reqs, pd_served, {r.req_id: call(r) for r in pd_reqs})
    print(f"einet_pd serve parity: LL max|engine - direct| "
          f"{pd_par['ll_max_abs_diff']:.3e}, sampling/decode mismatches "
          f"{pd_par['sample_mismatches']} [{card}]")
    if pd_par["ll_max_abs_diff"] > 1e-5 or pd_par["sample_mismatches"]:
        raise AssertionError(f"einet_pd engine/direct parity violated: "
                             f"{pd_par}")
    for r in pd_reqs:
        v = np.asarray(pd_served[r.req_id].value)
        want = () if r.kind in ("joint_ll", "marginal_ll", "conditional_ll") \
            else (pd.num_vars,)
        if v.shape != want or not np.isfinite(v).all():
            raise AssertionError(f"einet_pd request {r.req_id} ({r.kind}): "
                                 f"{v.shape}")
        if r.kind in ("conditional_sample", "mpe") and not np.array_equal(
                v[r.evidence_mask], r.x[r.evidence_mask]):
            raise AssertionError(f"einet_pd request {r.req_id}: evidence "
                                 "changed")
    pd_cpu = EiNet(pd.graph, num_sums=pd.K, num_classes=pd.num_classes,
                   exponential_family=pd.ef, device="cpu", seed=0)
    pd_pl = build_einet(pd_cfg, device=dev, seed=0, grouped=False)
    with torch.inference_mode():
        ll_card = pd.log_likelihood(pd_xb[:8]).cpu()
        ll_cpu = pd_cpu.log_likelihood(pd_data[:8])
        if not torch.allclose(ll_card, ll_cpu, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"einet_pd card LL {ll_card} vs CPU {ll_cpu}")
        ops.reset_counts()
        pd_ll_plan = pd.log_likelihood(pd_xb)
        torch.cuda.synchronize()
        pd_plan_counts = counts_of(ops)
        ops.reset_counts()
        pd_ll_layer = pd_pl.log_likelihood(pd_xb)
        torch.cuda.synchronize()
        pd_layer_counts = counts_of(ops)
        if (pd_plan_counts["gather_grouped_log_einsum_exp"],
                pd_plan_counts["log_einsum_exp"],
                pd_layer_counts["log_einsum_exp"]) != (1, 1, 3):
            raise AssertionError(f"einet_pd joint_ll launches: planned "
                                 f"{pd_plan_counts}, per layer "
                                 f"{pd_layer_counts}")
        if not bool(torch.isfinite(pd_ll_plan).all()) or not torch.allclose(
                pd_ll_plan, pd_ll_layer, rtol=1e-5, atol=1e-4):
            raise AssertionError(
                f"einet_pd joint_ll planned vs per layer: max |diff| "
                f"{(pd_ll_plan - pd_ll_layer).abs().max().item():.3e}")
        pd_ll_ms = time_ms(lambda: pd.log_likelihood(pd_xb), iters=10)
        pd_e = pd.leaf_log_prob(pd_xb, None)
        pd_root = pd.forward_from_e(None, leaf_rows=pd_leaf)
        pd_stages = {
            "leaf EF log_prob": time_ms(
                lambda: pd.leaf_log_prob(pd_xb, None), iters=10),
            "leaf rows": time_ms(lambda: pd._leaf_rows(pd_e), iters=10),
            "plan walk (K5 + K1 + root mixing)": time_ms(
                lambda: pd.forward_from_e(None, leaf_rows=pd_leaf), iters=10),
            "per-layer walk (3 K1 + 2 mixing)": time_ms(
                lambda: pd_pl.forward_from_e(None, leaf_rows=pd_leaf),
                iters=10),
            "class logsumexp": time_ms(lambda: torch.logsumexp(
                pd_root + torch.log(pd.class_prior)[None], -1), iters=10),
        }
        del pd_e
    pd_qps = len(pd_reqs) / min(pd_steady)
    print(f"einet_pd joint_ll B={b_pd}: planned (K5 1, K1 1 launches) "
          f"against per layer (K1 3) max |diff| "
          f"{(pd_ll_plan - pd_ll_layer).abs().max().item():.3e}, card "
          f"against the CPU plain path on 8 rows max |diff| "
          f"{(ll_card - ll_cpu).abs().max().item():.3e} [{card}]")

    # --------------------------------------------- einet_pd E-step phase
    ops.reset_counts()
    pd_stats = em.em_statistics(pd, pd_xb)
    torch.cuda.synchronize()
    pd_estep_counts = counts_of(ops)
    pd_stats2 = em.em_statistics(pd, pd_xb)
    ops.reset_counts()
    pd_stats_pl = em.em_statistics(pd_pl, pd_xb)
    torch.cuda.synchronize()
    pd_estep_pl_counts = counts_of(ops)
    planned_want = {"log_einsum_exp": 1, "log_einsum_exp_bwd": 1,
                    "gather_grouped_log_einsum_exp": 1,
                    "gather_grouped_log_einsum_exp_bwd": 1}
    layer_want_pd = {"log_einsum_exp": 3, "log_einsum_exp_bwd": 3}
    for got, want in ((pd_estep_counts, planned_want),
                      (pd_estep_pl_counts, layer_want_pd)):
        if any(got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"einet_pd E-step launches {got}, expected "
                                 f"{want}")
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_stats(pd_stats), flat_stats(pd_stats2))):
        raise AssertionError("einet_pd: two planned E-steps differ")
    t0 = time.perf_counter()
    pd_stats_cpu = em.em_statistics(pd_cpu, pd_data[:b_pd])
    pd_cpu_estep_s = time.perf_counter() - t0
    pd_stat_atol = 1e-6 * b_pd
    pd_d_cpu = compare_stats(pd_stats, pd_stats_cpu,
                             "einet_pd E-step card vs CPU", 1e-4, pd_stat_atol)
    pd_d_pl = compare_stats(pd_stats_pl, pd_stats,
                            "einet_pd E-step per-layer vs planned", 1e-4,
                            pd_stat_atol)
    pd_new = em.m_step(pd, pd_stats, em_cfg)
    pd_p_cpu = compare_stats(pd_new, em.m_step(pd_cpu, pd_stats_cpu, em_cfg),
                             "einet_pd em_update card vs CPU", 1e-4, 1e-6,
                             phi_tol)
    pd_p_pl = compare_stats(em.m_step(pd_pl, pd_stats_pl, em_cfg), pd_new,
                            "einet_pd em_update per-layer vs planned", 1e-4,
                            1e-6, phi_tol)
    print(f"E-step einet_pd B={b_pd} (synthetic images, seed-0 weights): "
          f"card planned (K5 + K6 + K1 + K2, bitwise equal over two calls) "
          f"vs CPU plain: statistics max |diff| {pd_d_cpu[0]:.3e} (at most "
          f"{pd_d_cpu[1]:.3e} of a block's max; rtol 1e-4, atol "
          f"{pd_stat_atol:.1e}), em_update parameters max |diff| "
          f"{pd_p_cpu[0]:.3e} ({pd_p_cpu[1]:.3e}); card per layer (K1 + K2) "
          f"vs planned: statistics {pd_d_pl[0]:.3e} ({pd_d_pl[1]:.3e}), "
          f"parameters {pd_p_pl[0]:.3e} ({pd_p_pl[1]:.3e}); CPU E-step "
          f"{pd_cpu_estep_s:.2f} s [{card}]")
    del pd_stats2, pd_stats_pl, pd_stats_cpu, pd_cpu

    # -------------------------------------------- einet_pd training phase
    pd_full_model = build_einet(pd_cfg, device=dev, seed=0)
    pd_full = train_run(pd_full_model, "full", 3, lambda i: pd_xb,
                        planned_want)
    with torch.inference_mode():
        pd_full["lls"].append(pd_full_model.log_likelihood(pd_xb).mean().item())
    for a, b in zip(pd_full["lls"], pd_full["lls"][1:]):
        if b < a - 1e-5 * abs(a):
            raise AssertionError(f"einet_pd full EM lowered the batch LL: "
                                 f"{pd_full['lls']}")
    print(f"full EM einet_pd B={b_pd}, 3 steps on one batch: mean LL "
          + " -> ".join(f"{v:.4f}" for v in pd_full["lls"])
          + f" (non-decreasing) [{card}]")
    pd_train = {}
    for label, m, want in (("planned", pd, planned_want),
                           ("per-layer", pd_pl, layer_want_pd)):
        pd_train[label] = train_run(
            m, "stochastic", 20, lambda i: batch_at(pd_data_dev, i, b_pd),
            want)
        r = pd_train[label]
        print(f"stochastic EM einet_pd {label} plan "
              f"{m.grouping_summary()['segments']} B={b_pd}, 20 steps: median "
              f"{r['median_ms']:.3f} ms/step, mean LL first {r['lls'][0]:.4f}, "
              f"last {r['lls'][-1]:.4f}, launches a step " + ", ".join(
                  f"{k} {v // 20}" for k, v in r["counts"].items() if v)
              + f" [{card}]")
    with torch.no_grad():
        stats = em.em_statistics(pd, pd_xb)
        pd_step_stages = {
            "leaf EF log_prob + leaf rows": time_ms(
                lambda: pd._leaf_rows(pd.leaf_log_prob(pd_xb, None)),
                iters=5, warmup=1),
            "em_statistics (leaf layer, forward, backward, leaf statistics)":
                time_ms(lambda: em.em_statistics(pd, pd_xb), iters=5,
                        warmup=1),
            "m_step + blend": time_ms(lambda: em.blend_params(
                pd, em.params_of(pd), em.m_step(pd, stats, em_cfg),
                em_cfg.step_size), iters=5, warmup=1),
        }
    print(f"stochastic EM step stages (einet_pd planned, B={b_pd}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in pd_step_stages.items())
          + f" [{card}]")
    del pd_pl, pd_full_model, stats
    torch.cuda.empty_cache()

    # ---------------------------------------------- einet_rat_large phase
    big_cfg = get_config("einet_rat_large")
    t0 = time.perf_counter()
    big = build_einet(big_cfg, device=dev, seed=0)
    big_build_s = time.perf_counter() - t0
    kinds = [(s.start, s.stop, s.kind) for s in big.exec_plan]
    if kinds != [(0, 2, "fused"), (2, 4, "fused"), (4, 6, "fused"),
                 (6, 7, "layer")]:
        raise AssertionError(f"einet_rat_large plan is {kinds}")
    big_data = torch.from_numpy(synthetic_rat_data(big.num_vars)).to(dev)
    with torch.no_grad():
        big_leaf = big._leaf_rows(big.leaf_log_prob(big_data[:64], None))
        big_ws = [big.einsum[t].detach() for t in range(2)]
        got = grouped_log_einsum_exp_cuda(big_ws, big_leaf)
        big_k3_err = assert_close(
            got, grouped_log_einsum_exp_plain(big_ws, big_leaf),
            "K3 einet_rat_large fused[0,2)")
        big_g = rand_g(*got.shape)
        errs = check_k4(big_ws, big_leaf, big_g, "K4 einet_rat_large fused[0,2)")
        big_k4_w, big_k4_x = errs[:-1], errs[-1]
        big_k3_ms = time_ms(lambda: grouped_log_einsum_exp_cuda(
            big_ws, big_leaf), iters=5, warmup=1)
        big_k4_ms = time_ms(lambda: grouped_log_einsum_exp_bwd_cuda(
            big_ws, big_leaf, big_g), iters=5, warmup=1)
        del got, big_leaf, big_g
    torch.cuda.empty_cache()
    x256 = big_data[:256]
    with torch.inference_mode():
        ops.reset_counts()
        ll_plan = big.log_likelihood(x256)
        torch.cuda.synchronize()
        big_counts = counts_of(ops)
        big_ll_ms = time_ms(lambda: big.log_likelihood(x256), iters=3,
                            warmup=1)
    del big
    torch.cuda.empty_cache()
    big_pl = build_einet(big_cfg, device=dev, seed=0, grouped=False)
    with torch.inference_mode():
        ops.reset_counts()
        ll_layer = big_pl.log_likelihood(x256)
        torch.cuda.synchronize()
        big_pl_counts = counts_of(ops)
    del big_pl
    torch.cuda.empty_cache()
    if (big_counts["grouped_log_einsum_exp"], big_counts["log_einsum_exp"]) \
            != (3, 1) or big_pl_counts["log_einsum_exp"] != 7:
        raise AssertionError(f"einet_rat_large launches: planned "
                             f"{big_counts}, per layer {big_pl_counts}")
    if not bool(torch.isfinite(ll_plan).all()) or not torch.allclose(
            ll_plan, ll_layer, rtol=1e-5, atol=1e-4):
        raise AssertionError(
            f"einet_rat_large joint_ll planned vs per layer: max |diff| "
            f"{(ll_plan - ll_layer).abs().max().item():.3e}")
    print(f"einet_rat_large (K=64) fused[0,2) B=64: K3 {big_k3_ms:.3f} ms "
          f"(max |diff| {big_k3_err:.3e}), K4 {big_k4_ms:.3f} ms (gx max "
          f"|diff| {big_k4_x['abs']:.3e}, dW max |diff| / max|dW| "
          f"{max(e['rel'] for e in big_k4_w):.3e}); joint_ll B=256 through "
          f"the plan (K3 3, K1 1 launches) {big_ll_ms:.3f} ms, against the "
          f"per-layer forward (K1 7) max |diff| "
          f"{(ll_plan - ll_layer).abs().max().item():.3e}; model built in "
          f"{big_build_s:.1f} s [{card}]")

    # ------------------------------------------------------------- report
    # the main paths: serving, and training in both plans (full EM
    # included), of einet_rat and of einet_pd
    paths = {"einet_rat serve": serve_counts,
             "einet_rat full EM": full["counts"],
             "einet_rat stochastic EM fused": train["fused"]["counts"],
             "einet_rat stochastic EM per-layer": train["per-layer"]["counts"],
             "einet_pd serve": pd_serve_counts,
             "einet_pd full EM": pd_full["counts"],
             "einet_pd stochastic EM planned": pd_train["planned"]["counts"],
             "einet_pd stochastic EM per-layer":
                 pd_train["per-layer"]["counts"]}
    for name, c in paths.items():
        print(f"launches on the {name} path: " + ", ".join(
            f"{k} {v}" for k, v in c.items()) + f" [{card}]")
    counts = {k: sum(c[k] for c in paths.values()) for k in serve_counts}
    if not all(counts.values()):
        raise AssertionError(f"a kernel never ran on the main paths: {counts}")
    kernel_json = []

    def report(name, source, replaces, op, rows, err, yardstick, lib_ms):
        n_bytes = sum(r["bytes"] for r in rows)
        flops = sum(r["flops"] for r in rows)
        b_ms, b_by = bound(n_bytes, flops)
        for r in rows:
            rb, rby = bound(r["bytes"], r["flops"])
            print(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, {yardstick} "
                  f"{r.get('library_ms', r.get('einsum_chain_ms')):.4f} ms, "
                  f"bound {rb:.4f} ms ({rby}) [{card}]")
        kernel_json.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[op], "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

    csrc = "src/repro_torch/kernels/csrc/"
    report("log_einsum_exp_fwd", csrc + "log_einsum_exp_fwd.cu",
           "src/repro/kernels/log_einsum_exp.py:182", "log_einsum_exp",
           k1_rows, k1_err, "einsum yardstick",
           sum(r["library_ms"] for r in k1_rows))
    report("log_einsum_exp_bwd", csrc + "log_einsum_exp_bwd.cu",
           "src/repro/kernels/log_einsum_exp.py:224", "log_einsum_exp_bwd",
           k2_rows, max(worst(k2_x_errs, "abs"), worst(k2_w_errs, "abs")),
           "autograd through the plain forward",
           sum(r["library_ms"] for r in k2_rows))
    report("grouped_fwd", csrc + "grouped_fwd.cu",
           "src/repro/kernels/grouped.py:305", "grouped_log_einsum_exp",
           [k3_row], k3_err, "einsum chain yardstick", None)
    report("grouped_bwd", csrc + "grouped_bwd.cu",
           "src/repro/kernels/grouped.py:380", "grouped_log_einsum_exp_bwd",
           [k4_row], max(worst(k4_x_errs, "abs"), worst(k4_w_errs, "abs")),
           "autograd through the plain forward", k4_row["library_ms"])
    report("gather_fwd", csrc + "gather_fwd.cu",
           "src/repro/kernels/grouped.py:718", "gather_grouped_log_einsum_exp",
           [k5_row], k5_err, "einsum chain + mixing yardstick", None)
    report("gather_bwd", csrc + "gather_bwd.cu",
           "src/repro/kernels/grouped.py:780",
           "gather_grouped_log_einsum_exp_bwd", [k6_row],
           max(worst(k6_x_errs, "abs"), worst(k6_w_errs, "abs")),
           "autograd through the plain forward", k6_row["library_ms"])
    print("In the JSON line K1 and K2 are summed over einet_rat's 4 pairs (one "
          "per-layer pass), K3 and K4 are one fused [0,4) pass, all at "
          f"B={b_full}; K5 and K6 are einet_pd's gather[0,2) at B={b_pd}; "
          "launches are summed over the main paths above; K2, K4 and K6's "
          "library_ms is torch.autograd.grad through the plain forward "
          "(forward included)")
    print(f"serve: {len(reqs)} mixed requests, first pass {serve_s:.3f} s, "
          f"steady {min(steady):.3f} s ({qps:.1f} req/s), "
          f"{engine.stats['steps'] // 3} engine steps a pass [{card}]")
    print(f"joint_ll einet_rat B={b_full}: {ll_ms:.4f} ms a batch "
          f"({b_full / ll_ms * 1e3:.0f} rows/s) [{card}]")
    print("joint_ll stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items()) + f" [{card}]")
    print(f"einet_pd serve: {len(pd_reqs)} mixed requests, first pass "
          f"{pd_serve_s:.3f} s, steady {min(pd_steady):.3f} s "
          f"({pd_qps:.1f} req/s), {pd_engine.stats['steps'] // 3} engine "
          f"steps a pass [{card}]")
    print(f"joint_ll einet_pd B={b_pd}: {pd_ll_ms:.4f} ms a batch "
          f"({b_pd / pd_ll_ms * 1e3:.0f} rows/s) [{card}]")
    print("einet_pd joint_ll stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in pd_stages.items()) + f" [{card}]")
    print(json.dumps({"kernels": kernel_json}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
