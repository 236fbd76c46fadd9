#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

1. Prints the card's name and power limit, turns TF32 off, and builds every
   CUDA kernel from src/repro_torch/kernels/csrc with nvcc (sm_90a).
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card (rtol 1e-5, atol 1e-5; -inf and NEG_INF rows exactly) at einet_rat's
   shapes (B = 2048), at odd K, with saturated rows and a ragged batch, and
   times the kernel, its plain version and a torch.einsum yardstick.
3. Serve phase: builds einet_rat at full width on the card (seed 0), serves
   the 256-request mixed stream through ServeEngine(max_batch=64) with the
   kernel launch counters reset just before, checks every result against
   direct one-request calls (LL within 1e-5, sampling/decode identical) and
   a few LLs against the CPU plain path, then times joint_ll on one
   2048-row batch, whole and stage by stage.
4. Prints the launch counts, one line per kernel, a JSON "kernels" line,
   the nvidia-smi line, and last {"ok": true, "device": {...}}.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.einet import EiNet
    from repro_torch.core.layers import NEG_INF
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.grouped import (
        grouped_log_einsum_exp_cuda, grouped_log_einsum_exp_plain)
    from repro_torch.kernels.log_einsum_exp import (
        log_einsum_exp_cuda, log_einsum_exp_plain)
    from repro_torch.launch.cells import build_einet
    from repro_torch.serve import (
        ServeEngine, direct_call, mixed_requests, parity)

    card = smi_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reports = build.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"built {len(reports)} kernels with nvcc in {build_s:.2f} s [{card}]")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ------------------------------------------------------- kernel phase
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

        for k in (3, 5, 13, 17, 40):
            for b in (37, 2048 + 5):
                w = rand_w(6, k if k != 3 else 1, k)
                x = rand_x(b, 12, k)
                assert_close(log_einsum_exp_cuda(w, x[:, :6], x[:, 6:]),
                             log_einsum_exp_plain(w, x[:, :6], x[:, 6:]),
                             f"K1 K={k} B={b}",
                             exact=((0,), (1, 0), (3, 0)))
                if k == 40:
                    continue
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
    print(f"kernel phase: K1 and K3 agree with their plain versions "
          f"(rtol={RTOL}, atol={ATOL}); einet_rat max|diff| K1 {k1_err:.3e}, "
          f"K3 {k3_err:.3e} [{card}]")

    # -------------------------------------------------------- serve phase
    reqs = mixed_requests(model.num_vars, 256, seed=0)
    engine = ServeEngine(model, max_batch=64)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {op.name: op.launches for op in ops.KERNEL_OPS}
    plain_counts = {op.name: op.plain_calls for op in ops.KERNEL_OPS}
    if any(v == 0 for v in counts.values()) or any(plain_counts.values()):
        raise AssertionError(
            f"main path launches {counts}, plain-version calls {plain_counts}")
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

    # ------------------------------------------------------------- report
    print("kernels: " + ", ".join(
        f"{k} launches {v} (plain-version calls {plain_counts[k]})"
        for k, v in counts.items()) + f" on the serve pass [{card}]")
    kernel_json = []
    k1_time = sum(r["ms"] for r in k1_rows)
    k1_plain = sum(r["plain_ms"] for r in k1_rows)
    k1_lib = sum(r["library_ms"] for r in k1_rows)
    k1_bound_b = sum(r["bytes"] for r in k1_rows) / HBM_BYTES_PER_S * 1e3
    k1_bound_f = sum(r["flops"] for r in k1_rows) / FP32_FLOPS_PER_S * 1e3
    for r in k1_rows:
        bb, bf = r["bytes"] / HBM_BYTES_PER_S * 1e3, r["flops"] / FP32_FLOPS_PER_S * 1e3
        print(f"K1 log_einsum_exp {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, einsum yardstick "
              f"{r['library_ms']:.4f} ms, bound {max(bb, bf):.4f} ms "
              f"({'bytes' if bb >= bf else 'operations'}) [{card}]")
    kernel_json.append({
        "name": "log_einsum_exp_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/log_einsum_exp_fwd.cu",
        "replaces": "src/repro/kernels/log_einsum_exp.py:182",
        "launches": counts["log_einsum_exp"], "max_abs_err": k1_err,
        "ms": k1_time, "plain_ms": k1_plain,
        "bound_ms": max(k1_bound_b, k1_bound_f),
        "bound_by": "bytes" if k1_bound_b >= k1_bound_f else "operations",
        "library_ms": k1_lib,
    })
    bb = k3_row["bytes"] / HBM_BYTES_PER_S * 1e3
    bf = k3_row["flops"] / FP32_FLOPS_PER_S * 1e3
    print(f"K3 grouped_log_einsum_exp {k3_row['shape']}: kernel "
          f"{k3_row['ms']:.4f} ms, plain {k3_row['plain_ms']:.4f} ms, einsum "
          f"chain yardstick {k3_row['einsum_chain_ms']:.4f} ms, bound "
          f"{max(bb, bf):.4f} ms ({'bytes' if bb >= bf else 'operations'}) "
          f"[{card}]")
    kernel_json.append({
        "name": "grouped_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_fwd.cu",
        "replaces": "src/repro/kernels/grouped.py:305",
        "launches": counts["grouped_log_einsum_exp"], "max_abs_err": k3_err,
        "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
        "bound_ms": max(bb, bf),
        "bound_by": "bytes" if bb >= bf else "operations",
        "library_ms": None,
    })
    print(f"K1 times above are summed over einet_rat's 4 pairs in the JSON "
          f"line (one sampling forward pass); K3 is one LL forward pass")
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
