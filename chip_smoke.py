#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

1. Prints the card's name and power limit, turns TF32 off (and prints the
   settings), and builds every CUDA kernel from src/repro_torch/kernels/csrc
   with nvcc (sm_90a), one nvcc process a source, all at once.
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
4. Serve phase: builds einet_rat at full width on the card (seed 0), serves
   the 256-request mixed stream through ServeEngine(max_batch=64) with the
   kernel launch counters reset just before, checks every result against
   direct one-request calls (LL within 1e-5, sampling/decode identical) and
   a few LLs against the CPU plain path, then times joint_ll on one
   2048-row batch, whole and stage by stage.
5. E-step phase: one em_statistics and one em_update on the first 2048 rows
   of the reference's synthetic data, on the card (fused plan, K3 + K4) and
   on the CPU plain path, and on the card per layer (K1 + K2): statistics
   within rtol 1e-4, atol 1e-6 B, parameters within rtol 1e-4, atol 1e-6.
6. Training phase: full EM for 3 steps on one batch (the LL may not drop by
   more than 1e-5 |LL| a step), then 20 stochastic EM steps at B = 2048 in
   each plan, with the launch counters reset just before each run and the
   launches per step asserted (fused: K3 1, K4 1; per layer: K1 4, K2 4).
7. einet_rat_large: K3 and K4 against their plain versions at its K = 64
   fused run [0, 2) (B = 64), then joint_ll at B = 256 through its plan
   (3 K3 + 1 K1 launches) against its per-layer forward (7 K1 launches).
8. Prints the launch counts, a JSON "kernels" line, the nvidia-smi line,
   and last {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It also exits non-zero when no CUDA device is present.  It imports
nothing of JAX.
"""

from __future__ import annotations

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
    from repro_torch.core import em
    from repro_torch.core.einet import EiNet
    from repro_torch.core.layers import NEG_INF
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.grouped import (
        grouped_log_einsum_exp_bwd_cuda, grouped_log_einsum_exp_bwd_plain,
        grouped_log_einsum_exp_cuda, grouped_log_einsum_exp_plain)
    from repro_torch.kernels.log_einsum_exp import (
        log_einsum_exp_bwd_cuda, log_einsum_exp_bwd_plain,
        log_einsum_exp_cuda, log_einsum_exp_plain)
    from repro_torch.launch.cells import build_einet
    from repro_torch.launch.train import batch_at, synthetic_rat_data
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
                        "grouped_log_einsum_exp_bwd": 1}:
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
    # the main paths: serving, and training in both plans (full EM included)
    paths = {"serve": serve_counts, "full EM": full["counts"],
             "stochastic EM fused": train["fused"]["counts"],
             "stochastic EM per-layer": train["per-layer"]["counts"]}
    for name, c in paths.items():
        print(f"launches on the {name} path: " + ", ".join(
            f"{k} {v}" for k, v in c.items()) + f" [{card}]")
    counts = {k: sum(c[k] for c in paths.values()) for k in serve_counts}
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
    print("In the JSON line K1 and K2 are summed over einet_rat's 4 pairs (one "
          "per-layer pass), K3 and K4 are one fused [0,4) pass, all at "
          f"B={b_full}; launches are summed over the main paths above; K2 and "
          "K4's library_ms is torch.autograd.grad through the plain forward "
          "(forward included)")
    print(f"serve: {len(reqs)} mixed requests, first pass {serve_s:.3f} s, "
          f"steady {min(steady):.3f} s ({qps:.1f} req/s), "
          f"{engine.stats['steps'] // 3} engine steps a pass [{card}]")
    print(f"joint_ll einet_rat B={b_full}: {ll_ms:.4f} ms a batch "
          f"({b_full / ll_ms * 1e3:.0f} rows/s) [{card}]")
    print("joint_ll stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items()) + f" [{card}]")
    print(json.dumps({"kernels": kernel_json}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
