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
   (B = 2048), at odd K, at K = 40 and 64, at K_out below, between and
   above K1's 8-output tile, on one row, with saturated rows and ragged
   batches; checks that K3's output equals the per-layer K1 chain's and a
   second call's bit for bit and that a row computed alone equals that row
   in the batch; and times K3, its plain version, a torch.einsum chain and
   the per-layer K1 launches at the same pairs.
3. Backward kernel phase: holds K2 (log_einsum_exp_bwd.cu) and K4
   (grouped_bwd.cu) against their plain backward versions at the same
   shapes and the K = 64 run of einet_rat_large (input gradients rtol =
   atol = 1e-5 with the plain version's exact zeros kept; weight gradients,
   summed over the batch in another order, rtol 1e-4 and atol 1e-4
   max|gw|), checks that two calls give bitwise-equal gradients, and times
   K4, its plain version, its yardstick and the per-layer K2 launches at
   the same pairs.  Then row independence: K1's output and K2's gl and gr
   of a row computed alone are bitwise the same row inside a batch of 512,
   at K = 10 and 40, and K4's gx inside einet_rat's batch of 2048.
4. Gather kernel phase: holds K5 (gather_fwd.cu) and K6 (gather_bwd.cu),
   the gather run of a Poon-Domingos interior with its mixing, against
   their plain versions at einet_pd's run gather[0,2) (B = 512, its leaf
   rows), at K = 32, at the reference's PD_SMOKE_SHAPES (a 5-depth run at
   odd K = 3), on ragged batches, -inf and NEG_INF rows and a masked mixing
   child, with the tolerances above and two calls bitwise equal; K5's new
   rows against K6's recompute bit for bit, and K5's rows and K6's gx of a
   row alone against the same row in B = 512; times each kernel, its plain
   version and a yardstick (K5: the per-depth torch.einsum chain plus
   log_mix_exp; K6: autograd through the einsum chain plus log_mix_exp),
   K5 (at B = 512 and at the serve bucket B = 64) beside the per-layer K1
   launches and log_mix_exp at its pairs, K6 (at B = 512, beside the
   per-layer K2 launches, and at B = 64, the hard mixture step's rows), and the device time of each CUDA kernel inside one K6, K4, K5
   and K3 call (torch.profiler); prints K5's and K6's per-depth geometry
   and K6's partial bytes.
5. Serve phase: builds einet_rat at full width on the card (seed 0), serves
   the 256-request mixed stream through ServeEngine(max_batch=64) (each
   batch a replay of a captured CUDA graph) with the kernel launch
   counters reset just before, checks every result against eager
   one-request calls (legacy_call: LL within 1e-5, sampling/decode
   identical) and
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
   These steps run op by op (the update functions, then load_params), so
   that the counters see each step; phase 13 holds the step programs'
   graphs against them.
8. einet_pd (the paper's SVHN config at full width, seed 0, B = 512, the
   reference's mixture-image data): the serve phase as in 5 (K5 and K1
   launched, engine against eager calls, a few LLs against the CPU), joint_ll
   through the plan (K5 1, K1 1) against the per-layer forward (K1 3),
   timed whole and by stage; the E-step as in 6 on the card planned (K5 +
   K6 + K1 + K2), twice and bitwise equal, against the CPU plain path and
   against the card per layer; training as in 7 (planned: K5 1, K6 1, K1 1,
   K2 1 a step; per layer: K1 3, K2 3).
9. einet_rat_large: K3 and K4 against their plain versions at its K = 64
   fused run [0, 2) (B = 64), K3 also bit for bit against its K1 chain;
   K3 and K4 timed there as rows of their reports (off the main paths)
   beside their plain versions, yardsticks and per-layer chains, then
   joint_ll at B = 256 through its plan (3 K3 + 1 K1 launches) against its
   per-layer forward (7 K1 launches), both timed.
10. Mixture of EiNets (§4.2): einet_celeba x 8 components (seed 0) on the
   procedural CelebA stand-in (to_domain "normal").  k-means (C = 8) on
   the card, whose partition must equal a second card run's and the CPU
   port's, and the same on 12,288 procedural CelebA rows, past the
   8,192-row threshold where k-means runs its contiguous-block minibatch
   iterations; 10 hard stochastic EM steps at 64 rows a component, op by op
   as in 7 (launches a step asserted: K5 8, K6 8, K1 8, K2 8; step 0 bit
   for bit 8 single-model stochastic_em_update calls of a separate
   einet_celeba); the soft E-step at B = 512 twice bitwise and against the
   CPU plain path (statistics rtol 1e-4, atol 1e-6 B, n_weight
   included); 10 soft stochastic EM steps op by op (same launches), timed
   whole and by stage; full
   soft EM 3 steps on one batch (monotone); mixture_joint_ll at B = 512
   (K5 8, K1 8) against the CPU (rtol 1e-5, atol 1e-4); and 256 requests
   over all ten mixture kinds through ServeEngine(max_batch=64): req/s
   after a warm pass, parity with eager one-request calls (LL and
   responsibility within 1e-5, sampling and MPE identical), responsibility
   rows summing to 1 within 1e-6, and mixture_mpe rows alone equal to
   theirs in a batch of 64 bit for bit.
11. Eval phase: the image-evaluation workbench (repro_torch.eval.run_eval)
   end to end, twice on the procedural stand-ins: one EiNet at einet_pd's
   structure and width (svhn geometry, K = 40, 80 EM steps at batch 128)
   and the mixture einet_celeba x 8 (k-means, 20 hard EM steps at 64 rows
   a component).  Each trains, streams 256 test rows through
   ServeEngine(max_batch=32) for joint and marginal bits per dim, inpaints
   8 images under the four Fig. 4 masks and draws 16 samples.  Gates:
   parity_mismatches_total == 0 (engine against direct one-row calls, bit
   for bit), the training run's launches (its steps are replays of a step
   program's graph: K5, K6, K1, K2 twice each a component, its warm-up and
   its capture), no wrapper launch in a joint_ll engine batch but the one
   that captures its program (K5, K1 twice each a component: the warm-up
   run and the capture), and one replay of each joint_ll program against
   an eager call on its batch (torch.profiler: the same bits and CUDA
   kernels, the eager call's ops launching K5, K1 once each a component),
   the single EiNet's joint and marginal LLs on the card against the CPU
   plain path (rtol 1e-5, atol 1e-4), the train LL rising, finite bits
   per dim, and metrics.json plus valid PNG grids of the expected size.
   Prints bits per dim, engine rows/s, inpainting req/s and MSEs, warm-up
   seconds, serve p50/p95/p99 from repro_torch.obs and wall seconds.  Then
   holds K5 and K6 against their plain versions (two calls bitwise) at
   every (tables, B) the two runs launched them at (counted by wrapping
   the ops' kernels): the training batches (B = 128, and 64 a component),
   every engine bucket (1 to 32) and the direct calls.
12. Graph-serving phase: the serve bench's bench.serve.bench_model
   (serve.run_benchmark with the bench's gates; 256 requests, max_batch 64,
   reps 3, a fresh program registry) on einet_rat, einet_pd and einet_celeba
   x 8 (all six kinds, and the ten mixture kinds), each batch and each
   direct request a replay of a captured CUDA graph, the eager one-request
   path the legacy baseline; the launch counters set to 0 just before each
   run and read just after (they count the wrappers' calls: warm-up runs
   and captures, no replay).  Gates: the report's parity against the
   direct and the legacy paths (LL within 1e-5 relative, sampling/decode
   identical); every kind served by graphs; (a) every captured program's
   output equals an eager model.query on the same assembled batch bit for
   bit, and (d) one replay runs the same CUDA kernels, by name and number,
   as that eager call (both under torch.profiler), whose ops launch K5 1,
   K1 1 at einet_pd joint_ll; (b) every program replayed in reverse
   capture order with the outputs kept on the card until all have
   replayed, then each equal to eager (the shared memory pool); (c) after
   one in-place EM step (no recapture, outputs moved) and after
   class_prior is replaced (exactly one recapture a program), programs
   equal eager on the new weights; (e) row_noise on the card equals the
   CPU's bit for bit for seeds 0, 1, 2^31, 2^63 - 1 at lead 0 and 8.
   Prints the report (warm-up and capture seconds, engine req/s, per-kind
   p50/p95/p99, program-cache counts, direct and legacy req/s and the two
   speedups), the programs and their memory pool, each program's kernels
   a replay and replays, the mixture's per-component sampling step, and
   the device's busy share over one steady pass (torch.profiler).  Then
   times K5 (einet_pd's gather run) and K1 (its root pair) at the serve
   buckets B = 1..64, one launch at a time and replayed from a graph,
   beside their bounds.
13. Training-graph phase (train_graph_phase): the training steps as
   captured CUDA graphs through compile.REGISTRY, at full width.  (a) 20
   graph steps against 20 eager steps (the update functions and
   load_params) of a second model from the same parameters, LLs and
   parameters bit for bit, for einet_rat (fused, per layer), einet_pd
   (planned, per layer) and einet_celeba x 8 (hard, soft); (b) the first
   graph step alone too; the launch counters (set to 0 just before the
   graph steps, read just after) hold the warm-up and the capture, twice
   the eager step's launches, and one replay of each step graph runs the
   eager step's CUDA kernels by name and number (profiled); prints graph
   and eager ms/step, capture seconds, pool MiB, the busy share of one
   graph step, and one replay's span between CUDA events split into its
   kernels' device time by class (profiled) and the rest.  (c) The health vector of a graph step on the card against
   the CPU plain path at einet_rat (B = 2048) and einet_pd (B = 512):
   counts and fractions exact (the clamp fraction counted on the card's
   parameters), LL and entropy rtol 1e-5, norms rtol 1e-4; health-off
   parameters equal health-on bit for bit.  (d) einet_rat_large: the step
   graph at 4 microbatches of 1,024 rows bit for bit the eager microbatch
   loop, its E-step at B = 16 against the CPU plain path (statistics rtol
   1e-4, atol 1e-6 B), a checkpoint's save and restore seconds, and the
   config's own 65,536-row step (64 microbatches of 1,024) timed with its
   memory peak; the card's graph pools by segment after the 4 x 1,024-row
   program, after its drop, and after the 65,536-row step, whose pools must
   hold at most 1.10 x the same program captured into a fresh model (each
   step capture has a pool of its own).  (g) Run before (d): a replaced
   parameter makes einet_rat's step program recapture once, into a fresh
   pool (the old one released), both steps bit for bit eager ones.
   (e) ft.run_training on einet_pd's graph step: 12 steps,
   checkpoint_every 4, failures at steps 5 and 9; the final parameters
   equal an uninterrupted run's bit for bit and neither the step graph nor
   the model's serving programs recapture.  (f) A NaN row from step 3 on
   with health on: fit raises DivergenceError leaving one incident bundle
   of six files, and under "continue" runs every step leaving one.
14. Paper comparison phase (paper_phase, repro_torch.bench): Table 1 on
   all 20 binary proxies at the reference's quick sizes with 10 EM epochs
   (max |dLL| EiNet against NaiveEiNet < 1e-3, EM raises every test LL);
   NaiveEiNet against EiNet at einet_rat's width on 2,000 x 512 rows (LL
   rtol 1e-5, atol 1e-4; E-step statistics rtol 1e-4, atol 1e-6 B; the
   naive LL against the CPU plain path; no K1-K6 launch from the naive net,
   the EiNet's plan's kernels from its own); Fig. 3 (train time, peak
   memory) and Fig. 6 (inference) over K in {2, ..., 40}, eager and graph,
   each naive point out of memory recorded and the first such K printed;
   Fig. 4 quick (EM learns, argmax inpainting beats mean-fill).
15. Distributed phase (dist_phase): the sharded EM step.  (a) NCCL at a
   world of 1 on a (data=1, model=1) mesh: 20 make_sharded_em_step steps
   at einet_rat (B = 2048, fused) and einet_pd (B = 512, planned) bit for
   bit 20 make_em_step steps of a second model (LLs and parameters), the
   same wrapper launches (the counters set to 0 just before and read just
   after), one replay of each running the same hand-written kernels
   (profiled); ms/step of both, the reduce stage and one all_reduce of
   the statistics (CUDA events).  (b) Two ranks spawned on the one card
   over gloo with CUDA tensors (NCCL will not put two ranks on one
   device): einet_pd at B = 512 on a (2, 1) mesh (256 rows a rank, from
   the sharded loader) and a (1, 2) mesh (the M-step on each rank's model
   shard), 5 steps each held against one process's step on all 512 rows
   from the same parameters (step-0 statistics rtol 1e-4, atol 1e-6 B;
   parameters rtol 1e-4, atol 1e-6; mean LL 1e-4 + 1e-6 |LL|), the ranks'
   parameters bit for bit equal; the (1, 2) parameters resharded onto
   (2, 1) and back bit for bit; compressed_psum within 5% of the exact
   sum and bit for bit the CPU's.  NCCL across cards is not exercised.
16. Production-bench phase (bench_phase): the four production benches of
   repro_torch.bench at their full profiles (the reference's cells), with
   tracing on, into chiprun_out/bench, serve and train at their card
   profiles (``--card``: the sizes slo_torch.json's budgets hold): serve
   at einet_rat and einet_pd (256 requests, max_batch 64; parity within
   1e-5, the grouped plan) in a CompileSentry (engine captures at most
   kinds x buckets, one direct program a kind, no key captured twice);
   train (einet_rat B=2048 in 4 microbatches, einet_rat_large B=256 in 2,
   einet_pd B=512 in 2: the step program against the eager per-step path,
   K2 against autograd through the plain forward within 1e-4, each cell's
   segment breakdown) in a CompileSentry wrapping each step program (one
   signature and one capture event over all its calls, no recapture, no
   finding, the plan grouped); mixture and eval at the reference's cells
   (a launch-bound 32-variable component; a 16x16x3 PD net): mixture (C = 4, 16, 32: one
   make_mixture_em_step graph against a loop of C make_em_step programs,
   parameters within 1e-6), its graph pools at C = 32 one a program, all
   distinct, released after the cell; eval (512 rows of a 16x16x3 PD net,
   engine against eager dense chunks, 0 parity mismatches).  Then the
   phase's trace and metrics validated by repro_torch.obs.check, slo
   --check against slo_torch.json, and dryrun --verify over every
   registered arch (health probes on the card); K5 and K6 held against
   their plain versions at every (tables, B) the benches launched them at.
17. Prints the launch counts of every main path (each kernel must have run
   on them; the paper phase's EiNet side, the sharded steps and the
   production benches among them) and the shapes (B, L, K_out, K) K1 and K2 were launched at
   there (counted by wrapping the ops' kernels, whose launch counters stay
   as they are); times K1 and K2 at each of those shapes (and K1 at
   einet_pd's pairs at B = 64) on fresh inputs with their geometry, K2's
   dW batch splits and partial bytes, each row with its plain version, its
   yardstick, its bound and its launches; prints the rule-2 ranking (worst
   kernel/yardstick factor, then launches x (ms - bound)), a JSON
   "kernels" line with a "rows" list per kernel, the nvidia-smi line, and
   last {"ok": true, "device": {...}}.

The yardsticks, which the port never calls: K1 one torch.einsum on the
stabilised frame; K2, K4 and K6 torch.autograd.grad through a forward whose
contraction is one torch.einsum("lkij,bli,blj->blk") a depth on the
stabilised frame (K4: the per-depth chain; K6: plus log_mix_exp for its
mixing), forward included; K3 and K5 none (their einsum chain is shown).
TF32 is off for all of them.

Any failed check raises, and the script exits non-zero without the last
line.  It also exits non-zero when no CUDA device is present.  It imports
nothing of JAX.

  python3 chip_smoke.py --compare

prints only a hash of each kernel's outputs on seeded inputs and its time
there, for holding two trees' kernels against each other, bit for bit and
in time, in one call.

  python3 chip_smoke.py --pool

prints the card's graph pools by segment through einet_rat_large's
drop-then-capture sequence (a copy beside another tree's src/ probes that
tree).

  python3 chip_smoke.py --dist

builds the kernels and runs only the distributed phase (15).

  python3 chip_smoke.py --bench

builds the kernels and runs the production-bench phase (16) three times
(chiprun_out/bench/run0-2), then slo --check on each run: the calibration
of slo_torch.json.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
RTOL = ATOL = 1e-5
# (K, K_out, B) of the extra K1/K2 checks beside the odd-K sweep
PAIR_EXTRA = ((64, 64, 37), (64, 64, 300), (10, 2, 2053), (17, 7, 37),
              (40, 9, 517), (10, 12, 37), (40, 40, 1), (13, 1, 2))


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


def kernel_parts(fn, calls: int = 10) -> list:
    """Device time of each CUDA kernel that ``fn`` launches, by
    torch.profiler over ``calls`` calls after a warm-up: [(name, launches a
    call, us a call)], largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0 and e.count:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            rows.append((name, e.count / calls, us / calls))
    return sorted(rows, key=lambda r: -r[2])


def counts_of(ops):
    return {op.name: op.launches for op in ops.KERNEL_OPS}


# (op name, B, L, K_out, K) -> launches of K1 and K2 since the last reset:
# filled by record_shapes, cleared with the launch counters
SHAPES = collections.Counter()


def record_shapes(op):
    """Wrap a per-pair op's kernel so that each launch also counts its
    shape in SHAPES.  The op's own launch counter is left as it is."""
    kernel = op.kernel

    def run(w, ln_left, *rest):
        SHAPES[(op.name, ln_left.shape[0], *w.shape[:3])] += 1
        return kernel(w, ln_left, *rest)
    op.kernel = run


# (op name, B, id of the tables) -> launches of K5 and K6 since the last
# reset, filled by record_gather_shapes; TABLES holds each id's tables
GATHER_SHAPES = collections.Counter()
TABLES = {}


def record_gather_shapes(op):
    """Wrap a gather run's op (K5 or K6) so that each launch also counts
    its batch and tables in GATHER_SHAPES (the launch counter is left as
    it is)."""
    kernel = op.kernel

    def run(tables, ws_, vs_, x, *rest, **kw):
        TABLES.setdefault(id(tables), tables)
        GATHER_SHAPES[(op.name, x.shape[0], id(tables))] += 1
        return kernel(tables, ws_, vs_, x, *rest, **kw)
    op.kernel = run


def reset(ops):
    ops.reset_counts()
    SHAPES.clear()
    GATHER_SHAPES.clear()


# the eval phase's two workbench runs (EvalConfig keywords; the rest is
# EvalConfig's default: 256 eval rows with parity on 64, 8 inpainting images
# under the four masks, 16 samples, max_batch 32): one EiNet at einet_pd's
# structure and width (32x32x3, Delta=8, K=40, 80 EM steps at batch 128),
# and the §4.2 mixture einet_celeba x 8 (hard EM cut from 80 steps to 20)
EVAL_RUNS = {
    "einet_pd K=40": dict(dataset="svhn", source="procedural", num_sums=40),
    "einet_celeba x8": dict(dataset="celeba", source="procedural",
                            num_sums=40, mixture=8, batch=512, steps=20),
}


def png_check(path: str, width: int, height: int, channels: int) -> None:
    """A PNG the workbench wrote: signature, IHDR (8-bit grey or RGB of
    ``width`` x ``height``), every chunk's CRC, and image data that inflates
    to one filter byte and ``width * channels`` bytes a scanline."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG signature")
    pos, chunks, idat = 8, [], b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        chunks.append(kind)
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    color = 0 if channels == 1 else 2
    if chunks[0] != b"IHDR" or chunks[-1] != b"IEND" or \
            ihdr != (width, height, 8, color, 0, 0, 0):
        raise AssertionError(f"{path}: chunks {chunks}, IHDR {ihdr}; "
                             f"expected {width}x{height}, colour {color}")
    if len(zlib.decompress(idat)) != height * (1 + width * channels):
        raise AssertionError(f"{path}: image data of the wrong size")


def grid_size(n: int, columns: int, h: int, w: int, pad: int = 2):
    """(width, height) of ``save_image_grid``'s canvas for n tiles."""
    cols = max(1, min(columns, n))
    rows = -(-n // cols)
    return cols * (w + pad) + pad, rows * (h + pad) + pad


def eval_phase(card: str, dev) -> dict:
    """Each ``EVAL_RUNS`` workbench run end to end on ``dev`` (the launch
    counters set to 0 just before ``run_eval`` and read just after), its
    gates, and its figures printed.  The launches of its parts are read by
    wrapping the workbench's trainers and the engine's batch execution for
    the run; returns each run's launch counts, K1/K2 shapes and K5/K6
    (B, tables)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import em
    from repro_torch.data import to_domain
    from repro_torch.eval import workbench
    from repro_torch.eval.masks import make_mask
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_einet
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import assemble_batch

    k5, k6 = "gather_grouped_log_einsum_exp", "gather_grouped_log_einsum_exp_bwd"
    k1, k2 = "log_einsum_exp", "log_einsum_exp_bwd"
    # part -> (launches, captured a program) of each call
    parts = collections.defaultdict(list)
    # engine joint_ll key -> (model, program, the requests of its first
    # batch, component)
    programs = {}
    trained = {}

    def since(before):
        after = counts_of(ops)
        return {k: after[k] - before[k] for k in after}

    def counting_trainer(fn):
        def run(model, *args):
            before = counts_of(ops)
            out = fn(model, *args)
            parts["train"].append((since(before), False))
            trained["model"] = model
            return out
        return run

    orig = (workbench._train, workbench._train_mixture, ServeEngine._execute)

    def execute(self, kind, component, reqs):
        before = counts_of(ops)
        compiles = self.registry.stats["compiles"]
        out = orig[2](self, kind, component, reqs)
        parts[kind].append((since(before),
                            self.registry.stats["compiles"] > compiles))
        if kind.endswith("joint_ll"):
            key = self._key(kind, self._bucket_for(len(reqs)), component)
            programs.setdefault(key, (self.model, self._programs[key], reqs,
                                      component))
        return out

    def exactly(got, want, what):
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    workbench._train = counting_trainer(orig[0])
    workbench._train_mixture = counting_trainer(orig[1])
    ServeEngine._execute = execute
    runs = {}
    try:
        for name, kw in EVAL_RUNS.items():
            parts.clear()
            programs.clear()
            trained.clear()
            cfg = workbench.EvalConfig(device=str(dev), out_dir=out_dir, **kw)
            n_c = max(1, cfg.mixture)
            prefix = "mixture_" if cfg.mixture >= 2 else ""
            obs.METRICS.reset()
            obs.reset()
            obs.configure(trace=True)
            torch.cuda.synchronize()
            reset(ops)
            rec = workbench.run_eval(cfg)
            torch.cuda.synchronize()
            counts, shapes = counts_of(ops), collections.Counter(SHAPES)
            gather_shapes = collections.Counter(GATHER_SHAPES)
            obs.configure(trace=False)
            with open(obs.export_trace(os.path.join(out_dir, "trace.json"))
                      ) as f:
                spans = collections.Counter()
                for e in json.load(f)["traceEvents"]:
                    if e["ph"] == "X":
                        spans[e["name"]] += e["dur"] / 1e6
            what = f"eval {name}"
            # -- gates
            if rec["parity_mismatches_total"] != 0:
                raise AssertionError(
                    f"{what}: {rec['parity_mismatches_total']} engine results "
                    "differ from the direct one-row calls (bitwise)")
            steps = rec["train_steps"]
            if steps != cfg.steps or len(parts["train"]) != 1:
                raise AssertionError(f"{what}: {steps} EM steps")
            # the training steps are a step program's replays: the wrappers
            # run in its warm-up and its capture only (K5, K6, K1, K2 once
            # each a component in each)
            exactly(parts["train"][0][0], {k: 2 * n_c for k in
                                           (k5, k6, k1, k2)},
                    f"{what}: {steps} EM steps (a graph step's warm-up and "
                    f"capture)")
            # an engine joint_ll batch replays its program's graph: no
            # wrapper runs, except in the batch that captures the program
            # (its warm-up run and its capture, K5 and K1 once each a
            # component in each)
            ll_batches = parts[prefix + "joint_ll"]
            if not ll_batches:
                raise AssertionError(f"{what}: no engine joint_ll batch")
            for got, captured in ll_batches:
                n = 2 * n_c if captured else 0
                exactly(got, {k5: n, k1: n},
                        f"{what}: an engine {prefix}joint_ll batch"
                        + (" (capture)" if captured else ""))
            # what a replay runs: one replay of each joint_ll program
            # against an eager call on its first batch (profiled): the same
            # bits and kernels, the eager call's ops launching K5 and K1
            # once each a component
            ll_kernels = {}
            for key, (m, prog, rs, comp) in programs.items():
                got, ll_kernels[key], _ = replay_against_eager(
                    m, prog, assemble_batch(m, rs, key[1]), key[0], comp,
                    f"{what}: engine program {key}")
                exactly(got, {k5: n_c, k1: n_c},
                        f"{what}: the eager call of program {key}")
            if not rec["train_ll_last"] > rec["train_ll_first"]:
                raise AssertionError(
                    f"{what}: train LL {rec['train_ll_first']} -> "
                    f"{rec['train_ll_last']}")
            bpds = (rec["bpd_joint"]["bpd"], rec["bpd_marginal"]["bpd"])
            if not all(np.isfinite(bpds)):
                raise AssertionError(f"{what}: bits per dim {bpds}")
            h, w, c = rec["height"], rec["width"], rec["channels"]
            run_dir = os.path.join(out_dir, rec["run_name"])
            if not os.path.isfile(os.path.join(run_dir, "metrics.json")):
                raise AssertionError(f"{what}: no metrics.json")
            png_check(os.path.join(run_dir, "samples.png"),
                      *grid_size(cfg.num_samples, 8, h, w), c)
            for mk in cfg.mask_kinds:
                png_check(os.path.join(run_dir, f"inpaint_{mk}.png"),
                          *grid_size(4 * cfg.inpaint_rows, cfg.inpaint_rows,
                                     h, w), c)
            # -- the single EiNet's LLs on the card against the CPU plain
            # path, with the trained parameters copied across
            cpu_line = ""
            if n_c == 1:
                model = trained["model"]
                data = workbench.resolve_dataset(cfg)
                spec = data.spec
                test_x, _ = to_domain(data.test_x, cfg.family)
                x64 = torch.from_numpy(test_x[:64]).to(dev)
                ev = make_mask(cfg.marginal_mask, h, w, c, seed=cfg.seed)
                ev64 = torch.from_numpy(np.repeat(ev[None], 64, 0)).to(dev)
                cpu = build_einet(workbench.pd_config_for(cfg, spec),
                                  device="cpu", seed=cfg.seed)
                em.load_params(cpu, em.params_of(model))
                diffs = []
                with torch.inference_mode():
                    for kind, m in (("joint", None), ("marginal", ev64)):
                        got = model.log_likelihood(x64, m).cpu()
                        want = cpu.log_likelihood(
                            x64.cpu(), None if m is None else m.cpu())
                        if not bool(torch.isfinite(got).all()) or \
                                not torch.allclose(got, want, rtol=1e-5,
                                                   atol=1e-4):
                            raise AssertionError(
                                f"{what}: {kind} LL card vs CPU max |diff| "
                                f"{(got - want).abs().max().item():.3e}")
                        diffs.append((got - want).abs().max().item())
                del cpu
                cpu_line = (f"; joint and marginal LL of 64 eval rows on the "
                            f"card vs the CPU plain path max |diff| "
                            f"{diffs[0]:.3e} and {diffs[1]:.3e} (rtol 1e-5, "
                            f"atol 1e-4)")
            # -- figures
            bj, bm, inp = rec["bpd_joint"], rec["bpd_marginal"], \
                rec["inpainting"]
            req = obs.METRICS.sum_histogram("serve.request.seconds")
            lat = {q: obs.percentile_from_counts(req, q) * 1e3
                   for q in (50, 95, 99)}
            step_ms = obs.percentile_from_counts(
                obs.METRICS.sum_histogram("train.step.seconds"), 50) * 1e3
            n_par = (bj["parity_rows"] + min(cfg.eval_rows, 64)
                     + inp["parity_rows"] + cfg.num_samples)
            print(f"{what}: {rec['dataset']} ({rec['dataset_source']}) "
                  f"{h}x{w}x{c}, {rec['num_params']} parameters, "
                  f"{steps} EM steps as graph replays (launches in the "
                  f"step program's warm-up and capture " + ", ".join(
                      f"{k} {v}" for k, v in
                      parts["train"][0][0].items() if v)
                  + f"), train LL {rec['train_ll_first']:.4f} -> "
                  f"{rec['train_ll_last']:.4f}"
                  + (f", k-means clusters {rec['cluster_sizes']}"
                     if rec["cluster_sizes"] else "")
                  + f"; {len(ll_batches)} engine {prefix}joint_ll batches "
                  f"({sum(c for _, c in ll_batches)} captures), one replay "
                  f"of each of its {len(programs)} programs runs the "
                  f"kernels of an eager call launching {k5} {n_c}, {k1} "
                  f"{n_c} (" + ", ".join(
                      f"{sum(v.values())}" for v in ll_kernels.values())
                  + f" CUDA kernels); parity mismatches 0 of {n_par} requests held bit "
                  f"for bit against direct one-row calls{cpu_line} [{card}]")
            print(f"{what}: bpd joint {bj['bpd']:.6f} ({bj['num_rows']} rows, "
                  f"mean LL {bj['mean_ll']:.4f}), marginal ({bm['mask']}, "
                  f"{bm['evidence_dims']} dims) {bm['bpd']:.6f}; engine "
                  f"{bj['engine_rows_per_s']:.1f} rows/s (joint_ll, "
                  f"{bj['engine_seconds']:.4f} s), warm-up "
                  f"{bj['warmup_seconds']:.4f} s (joint_ll kind, "
                  f"{rec['engine_programs']} (kind, bucket) keys in all); "
                  f"wall {rec['wall_seconds']:.3f} s [{card}]")
            print(f"{what}: inpainting {inp['requests_per_s']:.1f} req/s "
                  f"({inp['num_requests']} requests); " + "; ".join(
                      f"{mk} sample MSE {m['conditional_sample_mse']:.6f}, "
                      f"MPE {m['mpe_mse']:.6f}, mean-fill "
                      f"{m['mean_fill_mse']:.6f}"
                      for mk, m in inp["per_mask"].items())
                  + f" [{card}]")
            busy = spans["train.step"] + spans["serve.warmup"] + \
                spans["serve.step"]
            print(f"{what}: time by obs span: train.step "
                  f"{spans['train.step']:.3f} s, serve.warmup "
                  f"{spans['serve.warmup']:.3f} s, serve.step (every engine "
                  f"batch) {spans['serve.step']:.3f} s (eval.ll_stream "
                  f"{spans['eval.ll_stream']:.3f} s, eval.inpaint "
                  f"{spans['eval.inpaint']:.3f} s of it); the rest of the "
                  f"{rec['wall_seconds']:.3f} s wall (the direct one-row "
                  f"parity calls, k-means, data, artifacts) "
                  f"{rec['wall_seconds'] - busy:.3f} s [{card}]")
            print(f"{what}: serve latency (repro_torch.obs, {sum(req)} "
                  f"requests, queue wait included) p50 {lat[50]:.3f} ms, p95 "
                  f"{lat[95]:.3f} ms, p99 {lat[99]:.3f} ms; [obs] "
                  f"{obs.format_summary()} [{card}]")
            runs[name] = {"counts": counts, "shapes": shapes,
                          "gather_shapes": gather_shapes, "record": rec,
                          "latency_ms": lat, "step_ms": step_ms}
            trained.clear()
            programs.clear()
            torch.cuda.empty_cache()
    finally:
        workbench._train, workbench._train_mixture, ServeEngine._execute = orig
        shutil.rmtree(out_dir, ignore_errors=True)
    return runs


def bits_equal(a, b) -> bool:
    """Two float32 tensors equal bit for bit (NaN payloads included)."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def eager_em_step(model, tcfg):
    """The EM step of ``tcfg`` op by op -- the update function, then
    ``load_params`` -- returning the mean LL as a float: the oracle the
    step programs are held against."""
    from repro_torch.core import em
    from repro_torch.train import (em_update_microbatched,
                                   stochastic_em_update_microbatched)

    update = (stochastic_em_update_microbatched if tcfg.mode == "stochastic"
              else em_update_microbatched)

    def step(x):
        new, ll = update(model, x, tcfg.em, tcfg.num_microbatches)
        em.load_params(model, new)
        return float(ll)

    return step


def eager_mixture_step(mix, mcfg):
    """The mixture EM step of ``mcfg`` op by op (its update function, then
    ``load_mixture_params``), returning the mean LL as a float."""
    from repro_torch.mixture.train import (
        hard_mixture_em_update, load_mixture_params, mixture_em_update,
        stochastic_mixture_em_update)

    if mcfg.assign == "hard":
        update = hard_mixture_em_update
    elif mcfg.mode == "stochastic":
        update = stochastic_mixture_em_update
    else:
        update = mixture_em_update

    def step(x):
        new, ll = update(mix, x, mcfg)
        load_mixture_params(mix, new)
        return float(ll)

    return step


def device_busy_share(fn) -> float:
    """Share of one call of ``fn`` (which ends with results on the host)
    during which the card ran kernels or copies: the summed device time of
    the CUDA events torch.profiler records, over the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e6 / wall


# marker kernels that fence a profiled window (device_kernels): in a long
# process torch.profiler can drop the first kernels of a session (5 and 8
# of 825 in one run) and can report kernels that ran before it, so the
# kernels counted are those between the last leading and the first
# trailing marker, and each window must show markers on both sides
FENCE_KERNELS = 64
_FENCE = {}


# profiled windows that lost a side's markers and were taken again
FENCE_RETRIES = collections.Counter()


def _fence(tries: int = 3) -> str:
    """Launch FENCE_KERNELS in-place XORs of a one-byte tensor; returns
    the name their kernel records under (found once, by profiling them:
    the name that shows FENCE_KERNELS times).  A profiling session that
    records no CUDA kernel at all (one did, once, late in a long process)
    is taken again, up to ``tries`` times in all, then raises."""
    import torch

    first = "t" not in _FENCE
    if first:
        _FENCE["t"] = torch.zeros(1, dtype=torch.int8, device="cuda")
        torch.cuda.synchronize()
    for _ in range(FENCE_KERNELS):
        _FENCE["t"].bitwise_xor_(_FENCE["t"])
    if first:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _fence()
                torch.cuda.synchronize()
                time.sleep(0.02)
            names = collections.Counter(e.name for e in prof.events()
                                        if e.device_type == DeviceType.CUDA)
            if names:
                _FENCE["name"] = names.most_common(1)[0][0]
                break
            FENCE_RETRIES["a marker session recorded no CUDA kernel"] += 1
        else:
            raise AssertionError(f"{tries} torch.profiler sessions in turn "
                                 "recorded no CUDA kernel")
    return _FENCE.get("name", "")


def device_kernels(fn, tries: int = 3):
    """The CUDA kernels that one call of ``fn`` runs on the card, by name,
    as torch.profiler records them (copies and memsets left out; a CUDA
    graph's replay shows each of its kernel nodes), and ``fn``'s result.
    The call runs between two fences of marker kernels, 5 ms apart from
    each, in a session that waits 20 ms after it starts and before it
    ends; the kernels counted are those that start after the leading
    markers end and before the trailing ones start.  A window without
    markers on both sides is taken again, up to ``tries`` times in all,
    then raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fence = _fence()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            _fence()
            torch.cuda.synchronize()
            time.sleep(0.005)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
            _fence()
            torch.cuda.synchronize()
            time.sleep(0.02)
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))),
                    key=lambda e: e.time_range.start)
        marks = [e for e in ev if e.name == fence]
        # the call lies in the widest gap between two consecutive markers,
        # at least the 5 ms waits wide
        gaps = [(marks[i + 1].time_range.start - marks[i].time_range.end, i)
                for i in range(len(marks) - 1)]
        gap, i = max(gaps) if gaps else (0, 0)
        if gap >= 5e3:  # us
            if i + 1 > FENCE_KERNELS or len(marks) - i - 1 > FENCE_KERNELS:
                raise AssertionError(
                    f"a profiled window's markers split {i + 1} / "
                    f"{len(marks) - i - 1}: the call ran markers")
            lo, hi = marks[i].time_range.end, marks[i + 1].time_range.start
            ran = collections.Counter(e.name for e in ev if e.name != fence
                                      and lo <= e.time_range.start < hi)
            return ran, out
        first = ev.index(marks[0]) if marks else len(ev)
        FENCE_RETRIES[f"{len(marks)} markers, {first} other kernels before "
                      f"them, {len(ev) - len(marks) - first} after"] += 1
    raise AssertionError(f"{tries} profiled windows in turn lost the markers "
                         f"on one side of their call: {dict(FENCE_RETRIES)}")


def replay_against_eager(model, prog, batch, kind, comp, what):
    """One call of ``prog`` (a captured graph: copy in, replay, copy out)
    against one eager ``model.query`` on the same ``batch``, both under
    torch.profiler: the outputs must be equal bit for bit and the replay
    must run the same kernels, by name and number, as the eager call (a
    dropped or repeated node fails).  Returns the eager call's op launches
    (its wrappers' counts), the kernels a replay runs and the eager output
    on the host."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import run_query

    replayed, got = device_kernels(lambda: prog(batch))
    before = counts_of(ops)
    ran, want = device_kernels(lambda: run_query(model, batch, kind, comp))
    op_launches = {k: v - before[k] for k, v in counts_of(ops).items()
                   if v != before[k]}
    want = want.cpu()
    if not bits_equal(got.cpu(), want):
        raise AssertionError(f"{what}: the program's output differs from "
                             "eager model.query")
    if replayed != ran or not replayed:
        diff = {k: (replayed[k], ran[k]) for k in set(replayed) | set(ran)
                if replayed[k] != ran[k]}
        raise AssertionError(f"{what}: one replay runs {sum(replayed.values())}"
                             f" kernels, one eager call {sum(ran.values())}; "
                             f"(replay, eager) by name where they differ: "
                             f"{diff}")
    return op_launches, replayed, want


def mixture_sampling_path(mix, batch) -> dict:
    """The mixture's per-component sampling step on one batch
    (``_sample_components``: every component over all rows, each row
    keeping its choice), eagerly: its kernel launches and host ms
    (synchronised), for sampling and for MPE.  Its bits equal those of the
    grouped sampling it replaced (tests/test_torch_mixture.py)."""
    import torch

    from repro_torch.core.layers import NEG_INF
    from repro_torch.kernels import ops

    x, ev = batch["x"], batch["evidence_mask"]
    out = {}
    with torch.inference_mode():
        for mode in ("sample", "argmax"):
            noise = None if mode == "argmax" else mix.component.row_noise(
                batch["seeds"], lead=mix.num_components)
            logits = torch.clamp(mix._log_weights()[None]
                                 + mix.component_log_likelihoods(x, ev),
                                 min=NEG_INF)
            choice = mix._choose(logits, noise)
            torch.cuda.synchronize()
            before = counts_of(ops)
            t0 = time.perf_counter()
            mix._sample_components(choice, x, ev, noise, mode)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[mode] = {"ms": ms, "launches": {
                k: v - before[k] for k, v in counts_of(ops).items()
                if v != before[k]},
                "components": int(torch.unique(choice).numel())}
    return out


# rows of the procedural CelebA set k-means clusters past its minibatch
# threshold (mixture.train.KMEANS_MINIBATCH_THRESHOLD, 8,192)
KMEANS_BIG_ROWS = 12288

# the graph-serving phase's streams: 256 requests, max_batch 64
GRAPH_REQUESTS = 256
GRAPH_MAX_BATCH = 64
ROW_NOISE_SEEDS = (0, 1, 2 ** 31, 2 ** 63 - 1)


def graph_phase(card: str, dev, models: dict) -> dict:
    """Serving through captured CUDA graphs at full width.  ``models`` maps
    a name to (model, requests, in-place EM step, its batch).  For each:
    ``bench.serve.bench_model`` (the serve bench's ``serve.run_benchmark``
    with its grouped gate; 256 requests, max_batch 64, a fresh registry;
    the launch counters set to 0 just before and read just after; they
    count the wrappers' calls, so the warm-up runs and captures, and no
    replay), its parity against the direct and the eager paths, then the
    gates: (a) every captured program's output equals an eager
    ``model.query`` on the same assembled batch bit for bit, and (d) one
    replay runs the same CUDA kernels, by name and number, as that eager
    call (both profiled); (b) every program replayed in reverse capture
    order, each output kept on the card while the others replay, then
    each equal to eager; (c) the same after one in-place EM step (no
    recapture) and after one parameter tensor is replaced (exactly one
    recapture a program).  And (e): ``row_noise`` on the card equals the
    CPU's bit for bit.  Returns each model's figures and launch counts."""
    import types

    import torch
    from torch import nn

    from repro_torch import compile as compile_lib
    from repro_torch.bench import serve as serve_bench
    from repro_torch.core.einet import EiNet
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, format_report
    from repro_torch.serve.engine import assemble_batch, run_query

    # (e) counter-based noise: the same bits on the card and the CPU
    for name, (model, *_rest) in models.items():
        if not isinstance(model, EiNet):
            continue
        cpu = types.SimpleNamespace(device=torch.device("cpu"),
                                    noise_size=model.noise_size)
        for lead in (0, 8):
            got = model.row_noise(list(ROW_NOISE_SEEDS), lead=lead).cpu()
            want = EiNet.row_noise(cpu, list(ROW_NOISE_SEEDS), lead=lead)
            if not bits_equal(got, want):
                raise AssertionError(f"{name}: row_noise on the card differs "
                                     f"from the CPU's (lead {lead})")
    print(f"row_noise (Philox4x32-10) on the card equals the CPU's bit for "
          f"bit for seeds {list(ROW_NOISE_SEEDS)}, lead 0 and 8 [{card}]")

    def parse(key):
        """(kind, bucket, component) of an engine or a direct key."""
        if key[0] == "direct":
            return key[1], 1, (key[2] if len(key) > 2 else None)
        return key[0], key[1], (key[2] if len(key) > 2 else None)

    out = {}
    for name, (model, reqs, em_step, x_em) in models.items():
        reg = compile_lib.ProgramRegistry()
        torch.cuda.synchronize()
        reset(ops)
        t0 = time.perf_counter()
        rep = serve_bench.bench_model(model, reqs, name, GRAPH_MAX_BATCH,
                                      reps=3, registry=reg, profile="card")
        bench_s = time.perf_counter() - t0
        if not rep["grouped_ok"]:
            raise AssertionError(f"{name}: the plan is not grouped")
        counts, shapes = counts_of(ops), collections.Counter(SHAPES)
        gather_shapes = collections.Counter(GATHER_SHAPES)
        print(f"graph serve {name}:\n" + format_report(rep) + f" [{card}]")
        for what, pre in (("direct (per-request graphs)", ""),
                          ("legacy (eager)", "legacy_")):
            print(f"graph serve {name} parity against {what}: LL max|diff| "
                  f"{rep[pre + 'll_max_abs_diff']:.3e} (relative "
                  f"{rep[pre + 'll_max_rel_diff']:.3e}), sampling/decode "
                  f"mismatches {rep[pre + 'sample_mismatches']} [{card}]")
            if rep[pre + "ll_max_rel_diff"] > 1e-5 or \
                    rep[pre + "sample_mismatches"]:
                raise AssertionError(f"{name}: engine (graphs) against "
                                     f"{what}: {rep}")
        table = reg.table(model)
        keys = list(table)
        replays = {k: p.replays for k, p in table.items()
                   if p.kind == "graph"}
        kinds = {parse(k)[0] for k in keys}
        if kinds != set(model.query_kinds) or len(replays) != len(keys):
            raise AssertionError(f"{name}: programs {keys} are not graphs "
                                 f"of every kind {model.query_kinds}")
        pool_mb = reg.pool_bytes(model) / 2 ** 20
        t_gates = time.perf_counter()
        batches, eager = {}, {}
        # (a) and (d): each program against an eager query on its batch
        launch_rows, kernel_rows = {}, {}
        for key in keys:
            kind, bucket, comp = parse(key)
            rs = [r for r in reqs if r.kind == kind
                  and r.component == comp][:bucket]
            batch = batches[key] = assemble_batch(model, rs, bucket)
            launch_rows[key], kernel_rows[key], eager[key] = \
                replay_against_eager(model, table[key], batch, kind, comp,
                                     f"{name} {key}")
        # (b) every program in reverse capture order, the outputs kept on
        # the card until all have replayed
        kept = {key: table[key](batches[key]) for key in reversed(keys)}
        for key, got in kept.items():
            if not bits_equal(got.cpu(), eager[key]):
                raise AssertionError(f"{name} {key}: differs from eager "
                                     "after the reverse-order replays")
        del kept
        # (c) weights written in place, then a replaced tensor
        compiles0 = reg.stats["compiles"]
        em_step(x_em)
        moved = 0
        for key in keys:
            kind, _, comp = parse(key)
            got = table[key](batches[key]).cpu()
            want = run_query(model, batches[key], kind, comp).cpu()
            if not bits_equal(got, want):
                raise AssertionError(f"{name} {key}: after an in-place EM "
                                     "step the program differs from eager")
            moved += not bits_equal(want, eager[key])
        if reg.stats["compiles"] != compiles0 or not moved:
            raise AssertionError(f"{name}: an in-place EM step recaptured "
                                 f"or changed no output ({moved} moved)")
        model.class_prior = nn.Parameter(model.class_prior.detach().clone())
        t_re = time.perf_counter()
        for key in keys:
            kind, _, comp = parse(key)
            before = reg.stats["compiles"]
            got = table[key](batches[key]).cpu()
            again = table[key](batches[key]).cpu()
            want = run_query(model, batches[key], kind, comp).cpu()
            if reg.stats["compiles"] - before != 1:
                raise AssertionError(
                    f"{name} {key}: a replaced tensor cost "
                    f"{reg.stats['compiles'] - before} recaptures")
            if not (bits_equal(got, want) and bits_equal(again, want)):
                raise AssertionError(f"{name} {key}: after a recapture the "
                                     "program differs from eager")
        recapture_s = time.perf_counter() - t_re
        gates_s = time.perf_counter() - t_gates
        # the device's busy share over one steady engine pass (the
        # registry's programs, already captured)
        engine = ServeEngine(model, max_batch=GRAPH_MAX_BATCH, registry=reg)
        engine.run(reqs)
        busy = device_busy_share(lambda: engine.run(reqs))
        n_eng = sum(1 for k in keys if k[0] != "direct")
        print(f"graph serve {name}: {len(keys)} programs ({n_eng} engine "
              f"(kind, bucket[, component]) keys, {len(keys) - n_eng} "
              f"direct), capture {rep['compile_s']:.3f} s in the engine's "
              f"warm-up pass, pool {pool_mb:.1f} MiB; gates (a) programs "
              f"equal eager bit for bit, (b) also in reverse capture order, "
              f"(c) after an in-place EM step (0 recaptures, {moved} of "
              f"{len(keys)} outputs changed) and a replaced "
              f"class_prior (1 recapture each, {recapture_s:.3f} s for all), "
              f"(d) one replay runs the same kernels as eager "
              f"(torch.profiler); engine "
              f"{rep['engine_qps']:.1f} req/s, direct (per-request graphs) "
              f"{rep['direct_qps']:.1f}, legacy (eager) {rep['legacy_qps']:.1f}"
              f" ({rep['speedup']:.2f}x, {rep['speedup_vs_jitted']:.2f}x); "
              f"device busy {busy:.3f} of a steady pass (idle "
              f"{1 - busy:.3f}); run_benchmark {bench_s:.3f} s, gates "
              f"(a)-(d) {gates_s:.3f} s [{card}]")
        print(f"graph serve {name}, each program: (CUDA kernels one replay "
              f"runs, equal to one eager call's; replays in run_benchmark) "
              + "; ".join(f"{k} {sum(kernel_rows[k].values())}/{replays[k]}"
                          for k in keys) + f" [{card}]")
        for key in keys:
            if key[0] == "joint_ll" or key[0] == "mixture_joint_ll":
                print(f"graph serve {name} {key}: one replay runs the "
                      f"kernels of an eager call whose ops launch "
                      f"{launch_rows[key]}")
        sampling = None
        if hasattr(model, "num_components"):
            key = max((k for k in keys if k[0] == "mixture_conditional_sample"),
                      key=lambda k: k[1])
            sampling = mixture_sampling_path(model, batches[key])
            for mode, v in sampling.items():
                print(f"graph serve {name} per-component sampling ({mode}) at "
                      f"B={key[1]}, {v['components']} components chosen, "
                      f"every component over all rows: {v['ms']:.3f} ms "
                      f"eager, launches {v['launches']} [{card}]")
        out[name] = {"report": rep, "counts": counts, "shapes": shapes,
                     "gather_shapes": gather_shapes, "programs": len(keys),
                     "pool_mb": pool_mb, "busy": busy,
                     "launch_rows": launch_rows, "kernel_rows": kernel_rows,
                     "replays": replays, "seconds": bench_s,
                     "sampling": sampling}
        del engine, table, batches, eager
        torch.cuda.empty_cache()
    return out


def graph_time_ms(fn, launches: int = 20, reps: int = 20) -> float:
    """Device ms a call of ``fn`` takes replayed from a CUDA graph that
    holds ``launches`` calls of it (no host cost between them)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, iters=reps) / launches


def serve_bucket_times(card: str, dev, pd) -> list:
    """K5 at einet_pd's gather run and K1 at its root pair, at every serve
    bucket B = 1..64, on fresh inputs from the seed: launched one at a time
    (CUDA events around 20 calls, the wrapper's host cost included) and
    replayed from a CUDA graph of 20 launches (device time alone), each
    beside its bound.  The launch counters are untouched (the wrappers'
    kernels are called directly)."""
    import numpy as np
    import torch

    from repro_torch.kernels.grouped import gather_grouped_log_einsum_exp_cuda
    from repro_torch.kernels.log_einsum_exp import log_einsum_exp_cuda

    rng = np.random.RandomState(0)
    seg = pd.exec_plan[0]
    tab = seg.tables
    span = range(seg.start, seg.stop)
    ws = [pd.einsum[t].detach() for t in span]
    vs = [pd.mixing[t].detach() for t in span
          if pd.pair_specs[t].mix_global is not None]
    w1 = pd.einsum[pd.exec_plan[1].start].detach()
    cells, k_out = w1.shape[0], w1.shape[1]
    k = pd.K
    n_w = sum(w.numel() for w in ws) + sum(v.numel() for v in vs)
    rows = []
    with torch.no_grad():
        for b in (1, 2, 4, 8, 16, 32, 64):
            x = torch.from_numpy((rng.randn(b, tab.num_in_rows, k) * 4 - 20)
                                 .astype(np.float32)).to(dev)
            lr = torch.from_numpy((rng.randn(b, 2 * cells, k) * 4 - 20)
                                  .astype(np.float32)).to(dev)
            cases = (
                ("K5", lambda x=x: gather_grouped_log_einsum_exp_cuda(
                    tab, ws, vs, x),
                 4 * (x.numel() + n_w + b * tab.num_new_rows * k),
                 sum(2 * b * len(l) * k ** 3 for l in tab.left)),
                ("K1", lambda lr=lr: log_einsum_exp_cuda(
                    w1, lr[:, :cells], lr[:, cells:]),
                 4 * (2 * b * cells * k + w1.numel() + b * cells * k_out),
                 2 * b * cells * k_out * k * k),
            )
            for name, fn, n_bytes, flops in cases:
                b_ms, b_by = bound(n_bytes, flops)
                rows.append({"kernel": name, "B": b, "eager_ms": time_ms(fn),
                             "graph_ms": graph_time_ms(fn), "bound_ms": b_ms,
                             "bound_by": b_by})
    for r in rows:
        print(f"serve bucket {r['kernel']} einet_pd B={r['B']}: one at a "
              f"time {r['eager_ms']:.4f} ms, in a graph {r['graph_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}) [{card}]")
    return rows


# the training-graph phase: steps a case, batch rows of each case
TRAIN_GRAPH_STEPS = 20
# einet_rat_large's microbatch gates: 4 x 1024 rows against the eager loop,
# then the config's own 65,536-row step as 64 x 1024
BIG_MICROBATCH_ROWS = 1024
BIG_GATE_MICROBATCHES = 4
# health slots held exactly (counts and fractions), at rtol 1e-5 (LL and
# entropy) and at rtol 1e-4 (statistic norms), card against the CPU
HEALTH_RTOL = {"ll.mean": 1e-5, "ll.min": 1e-5, "weight.entropy": 1e-5,
               "stat.norm.max": 1e-4, "stat.norm.mean": 1e-4}
INCIDENT_FILES = {"incident.json", "metrics.json", "trace.json",
                  "health_history.json", "params.npz", "params_tree.txt"}


# the port's hand-written kernels, by the CUDA function names of csrc/
OWN_KERNELS = ("lee_", "grouped_", "gather_", "mix_", "scatter_mix",
               "accumulate_kernel", "gv_sum", "gx_kernel", "init_kernel")


def replay_breakdown(replay) -> dict:
    """Where one replay of a graph spends the card's time: its span between
    two CUDA events (ms), the summed device time of its kernels by class
    (profiled, ms: the port's hand-written kernels, PyTorch's elementwise
    kernels, its reductions, the rest), and the span less the kernels (the
    gaps between the graph's nodes, and its copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    by = collections.Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(
                ("Memcpy", "Memset")):
            continue
        name = e.name
        kind = ("hand-written" if any(k in name for k in OWN_KERNELS)
                else "elementwise" if "elementwise" in name
                else "reduction" if "reduce" in name.lower() else "other")
        by[kind] += e.time_range.elapsed_us() / 1e3
    return {"span_ms": span, "kernels_ms": dict(by),
            "gaps_ms": span - sum(by.values())}


def pool_segments() -> dict:
    """Graph memory pool id -> (segments, bytes, allocated bytes) of every
    private pool the caching allocator holds on the card (the default pool,
    id (0, 0), left out), from ``torch.cuda.memory_snapshot()``."""
    import torch

    out = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg["segment_pool_id"])
        if pid == (0, 0):
            continue
        n, total, used = out.get(pid, (0, 0, 0))
        out[pid] = (n + 1, total + seg["total_size"],
                    used + seg["allocated_size"])
    return out


def pools_beyond(base: dict) -> dict:
    """The private pools on the card that ``base`` (an earlier
    ``pool_segments()``) did not hold."""
    return {k: v for k, v in pool_segments().items() if k not in base}


def pool_text(pools: dict) -> str:
    total = sum(v[1] for v in pools.values())
    return (f"{len(pools)} pools, {total / 2 ** 30:.3f} GiB"
            + "".join(f"; {k}: {n} segments, {t / 2 ** 20:.1f} MiB, "
                      f"{u / 2 ** 20:.1f} MiB allocated"
                      for k, (n, t, u) in sorted(pools.items())))


def pool_probe() -> int:
    """``--pool``: einet_rat_large's drop-then-capture sequence with the
    card's graph pools by segment at each stage: a 4 x 1,024-row step
    program captured and stepped once, dropped, then the 65,536-row program
    captured (``StepProgram._capture``: no step), against the same capture
    into a fresh model.  Runs against either tree's ``src/`` (a copy of this
    script beside another tree's ``src/`` probes that tree)."""
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import compile as compile_lib
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.cells import build_einet
    from repro_torch.launch.train import batch_at, synthetic_rat_data
    from repro_torch.train import TrainConfig, make_em_step

    build.build(force=True)
    card = smi_line()
    dev = torch.device("cuda")

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def show(stage, base):
        pools = pools_beyond(base)
        print(f"pool probe, {stage}: {pool_text(pools)}; allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB [{card}]")
        return sum(v[1] for v in pools.values())

    cfg = get_config("einet_rat_large")
    base = pool_segments()
    big = build_einet(cfg, device=dev, seed=0)
    data = torch.from_numpy(synthetic_rat_data(big.num_vars)).to(dev)
    n_big = cfg.batch_size // BIG_MICROBATCH_ROWS
    step = make_em_step(big, TrainConfig(
        num_microbatches=BIG_GATE_MICROBATCHES))
    step(batch_at(data, 0, BIG_GATE_MICROBATCHES * BIG_MICROBATCH_ROWS))
    torch.cuda.synchronize()
    show("the 4 x 1,024-row program captured and stepped", base)
    compile_lib.REGISTRY.table(big).clear()
    del step
    free()
    show("after its drop and empty_cache", base)
    x_big = batch_at(data, 2, cfg.batch_size)
    graphs = make_em_step(big, TrainConfig(num_microbatches=n_big))._capture(
        big, x_big)
    torch.cuda.synchronize()
    after = show(f"the {cfg.batch_size}-row program captured", base)
    del graphs, big
    compile_lib.REGISTRY.clear()
    free()
    show("all dropped", base)
    fresh_model = build_einet(cfg, device=dev, seed=0)
    graphs = make_em_step(fresh_model, TrainConfig(
        num_microbatches=n_big))._capture(fresh_model, x_big)
    torch.cuda.synchronize()
    fresh = show(f"the {cfg.batch_size}-row program captured into a fresh "
                 "model", base)
    print(f"pool probe: after the drop {after / 2 ** 30:.3f} GiB against "
          f"{fresh / 2 ** 30:.3f} GiB fresh ({after / fresh:.3f}x) [{card}]")
    print(card)
    return 0


def train_graph_phase(card: str, dev, mix_data, compare_stats) -> dict:
    """Training through captured step graphs at full width, every step
    program from ``make_em_step`` / ``make_mixture_em_step`` through
    ``compile.REGISTRY`` unless a gate needs its own registry.

    (a)+(b) einet_rat (fused, per layer), einet_pd (planned, per layer)
    and einet_celeba x 8 (hard, soft): 20 graph steps against 20 eager
    steps (the update functions and ``load_params``) of a second model from
    the same parameters, LL and parameters bit for bit, the first step on
    its own too; the launch counters (set to 0 just before the graph
    steps, read just after) hold the step program's warm-up and capture, 2x
    the eager step's launches; one replay of each step graph runs the same
    CUDA kernels, by name and number, as one eager step (profiled); each
    case's ms/step graph and eager, capture seconds, pool MiB, the
    device's busy share over one graph step, and where one replay's time
    goes (``replay_breakdown``).
    (c) health on the card against the CPU plain path (einet_rat fused at
    B=2048, einet_pd planned at B=512): counts and fractions exact, LL and
    entropy rtol 1e-5, norms rtol 1e-4; health-off parameters equal
    health-on parameters bit for bit.
    (d) einet_rat_large: its step graph at 4 microbatches of 1,024 rows
    against the eager microbatch loop bit for bit, its E-step at B=16 on
    the card against the CPU plain path (statistics rtol 1e-4, atol 1e-6
    B), a checkpoint's save and restore seconds, then the config's own
    65,536-row step (64 microbatches of 1,024 rows), timed, with its
    memory peak; the pool gate: after the 4 x 1,024-row program's drop and
    the 65,536-row step, the card's graph pools (beyond those held before
    (d)) hold at most 1.10 x that program captured into a fresh model.
    (g), before (d): a replaced parameter makes einet_rat's step program
    recapture once, into a fresh pool, the old pool released, both steps
    bit for bit eager ones.
    (e) ``ft.run_training`` on einet_pd's graph step: 12 steps,
    checkpoint_every=4, failures at steps 5 and 9; the final parameters
    equal an uninterrupted run's bit for bit, and neither the step graph
    nor the model's serving programs recapture across the restores (a
    served joint_ll batch equals eager afterwards).
    (f) batches with a NaN row from step 3 on, health on: ``fit`` raises
    ``DivergenceError`` leaving one incident bundle of six files; under
    "continue" it runs every step and leaves one bundle.

    Returns the graph runs' launch counts and K1/K2 shapes (the main
    path's) and the figures."""
    import gc

    import numpy as np
    import torch

    from repro_torch import compile as compile_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import em
    from repro_torch.data.datasets import array_loader
    from repro_torch.dist import fault_tolerance as ft
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_einet, build_mixture
    from repro_torch.launch.train import (
        batch_at, synthetic_pd_data, synthetic_rat_data)
    from repro_torch.mixture import (
        MixtureTrainConfig, make_mixture_em_step, prepare_mixture_training)
    from repro_torch.mixture.train import mixture_params_of
    from repro_torch.obs import health as health_lib
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import assemble_batch, run_query
    from repro_torch.train import TrainConfig, fit, make_em_step
    from repro_torch.train.pipeline import stochastic_em_update_microbatched

    rat_cfg, pd_cfg = get_config("einet_rat"), get_config("einet_pd")
    mix_cfg = get_config("einet_celeba")
    n_mix = 8
    rat_data = torch.from_numpy(synthetic_rat_data(rat_cfg.num_vars)).to(dev)
    pd_probe = build_einet(pd_cfg, device="meta")
    pd_data = torch.from_numpy(synthetic_pd_data(pd_probe.num_vars)).to(dev)
    del pd_probe
    b_rat, b_pd, b_mix = rat_cfg.batch_size, pd_cfg.batch_size, 512
    out = {"counts": collections.Counter(), "shapes": collections.Counter(),
           "cases": {}}

    def params(m):
        return [p.detach() for p in m.parameters()]

    def same_params(a, b):
        return all(bits_equal(x, y) for x, y in zip(params(a), params(b)))

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def rat(grouped=True):
        return build_einet(rat_cfg, device=dev, seed=0, grouped=grouped)

    def pd(grouped=True):
        return build_einet(pd_cfg, device=dev, seed=0, grouped=grouped)

    def mixture(assign):
        g = build_mixture(mix_cfg, n_mix, device=dev, seed=0)
        e = build_mixture(mix_cfg, n_mix, device=dev, seed=0)
        if assign == "hard":
            loader, _ = prepare_mixture_training(g, mix_data, seed=0,
                                                 global_batch=b_mix)
            e.load_state_dict(g.state_dict())
        else:
            loader = array_loader(mix_data, b_mix)
        cfg = MixtureTrainConfig(assign=assign)
        return (g, e, make_mixture_em_step(g, cfg),
                eager_mixture_step(e, cfg),
                lambda i: torch.from_numpy(loader.batch_at(i)["x"]).to(dev))

    def einet_case(make, data, b):
        g, e = make(), make()
        return (g, e, make_em_step(g, TrainConfig()),
                eager_em_step(e, TrainConfig()),
                lambda i: batch_at(data, i, b))

    cases = {
        "einet_rat fused": lambda: einet_case(rat, rat_data, b_rat),
        "einet_rat per-layer": lambda: einet_case(
            lambda: rat(False), rat_data, b_rat),
        "einet_pd planned": lambda: einet_case(pd, pd_data, b_pd),
        "einet_pd per-layer": lambda: einet_case(
            lambda: pd(False), pd_data, b_pd),
        f"einet_celeba x{n_mix} hard": lambda: mixture("hard"),
        f"einet_celeba x{n_mix} soft": lambda: mixture("soft"),
    }
    # ---- (a) + (b)
    for name, make in cases.items():
        g, e, g_step, e_step, batches = make()
        xs = [batches(i) for i in range(TRAIN_GRAPH_STEPS)]
        torch.cuda.synchronize()
        reset(ops)
        lls_g, t_g = [], []
        for i, x in enumerate(xs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lls_g.append(g_step(x))
            torch.cuda.synchronize()
            t_g.append(time.perf_counter() - t0)
            if i == 0:
                first = [p.clone() for p in params(g)]
        g_counts = counts_of(ops)
        g_shapes = collections.Counter(SHAPES)
        reset(ops)
        lls_e, t_e = [], []
        for i, x in enumerate(xs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lls_e.append(e_step(x))
            torch.cuda.synchronize()
            t_e.append(time.perf_counter() - t0)
            if i == 0 and not all(bits_equal(a, b) for a, b in
                                  zip(first, params(e))):
                raise AssertionError(f"training graphs {name}: the first "
                                     "graph step differs from one eager "
                                     "step")
        e_counts = counts_of(ops)
        del first
        if lls_g != lls_e or not same_params(g, e):
            raise AssertionError(
                f"training graphs {name}: {TRAIN_GRAPH_STEPS} graph steps "
                f"differ from {TRAIN_GRAPH_STEPS} eager steps (LLs "
                f"{lls_g[:3]}... vs {lls_e[:3]}...)")
        want = {k: 2 * v // TRAIN_GRAPH_STEPS for k, v in e_counts.items()}
        if (g_counts != want or any(v % TRAIN_GRAPH_STEPS
                                    for v in e_counts.values())
                or not any(want.values())):
            raise AssertionError(
                f"training graphs {name}: launches {g_counts} in "
                f"{TRAIN_GRAPH_STEPS} graph steps, expected the warm-up and "
                f"the capture, {want} (eager: {e_counts})")
        prog = g_step
        graph = next(iter(prog.graphs.values()))
        replayed, _ = device_kernels(lambda: prog.replay(graph, xs[0]))
        ran, _ = device_kernels(lambda: e_step(xs[0]))
        if replayed != ran or not replayed:
            diff = {k: (replayed[k], ran[k]) for k in set(replayed) | set(ran)
                    if replayed[k] != ran[k]}
            raise AssertionError(
                f"training graphs {name}: one replay runs "
                f"{sum(replayed.values())} kernels, one eager step "
                f"{sum(ran.values())}; (replay, eager) where they differ: "
                f"{diff}")
        busy = device_busy_share(lambda: g_step(xs[1]))
        busy_e = device_busy_share(lambda: e_step(xs[1]))
        where = replay_breakdown(lambda: prog.replay(graph, xs[2]))
        fig = {"graph_ms": statistics.median(t_g[1:]) * 1e3,
               "eager_ms": statistics.median(t_e[1:]) * 1e3,
               "first_graph_ms": t_g[0] * 1e3,
               "capture_s": prog.capture_s,
               "pool_mib": compile_lib.REGISTRY.pool_bytes(g) / 2 ** 20,
               "busy": busy, "busy_eager": busy_e,
               "kernels_a_replay": sum(replayed.values()),
               "launches": g_counts, "replay": where}
        out["cases"][name] = fig
        out["counts"].update(g_counts)
        out["shapes"].update(g_shapes)
        print(f"training graphs {name}: {TRAIN_GRAPH_STEPS} graph steps "
              f"equal {TRAIN_GRAPH_STEPS} eager steps bit for bit (LL "
              f"{lls_g[0]:.4f} -> {lls_g[-1]:.4f}; the first step alone "
              f"too); graph {fig['graph_ms']:.3f} ms/step, eager "
              f"{fig['eager_ms']:.3f} ms/step (medians of steps 1-19), first "
              f"graph step {fig['first_graph_ms']:.1f} ms with capture "
              f"{fig['capture_s']:.3f} s, pool {fig['pool_mib']:.1f} MiB; "
              f"device busy over one graph step {busy:.3f}, one eager step "
              f"{busy_e:.3f}; a replay runs the eager step's "
              f"{fig['kernels_a_replay']} CUDA kernels; wrapper launches "
              "(warm-up and capture) " + ", ".join(
                  f"{k} {v}" for k, v in g_counts.items() if v)
              + f"; one replay {where['span_ms']:.3f} ms between CUDA "
              f"events: kernels " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(
                      where["kernels_ms"].items(), key=lambda kv: -kv[1]))
              + f", gaps and copies {where['gaps_ms']:.3f} ms [{card}]")
        del g, e, g_step, e_step, prog, graph, xs
        free()

    # ---- (c) health on the card against the CPU plain path
    for name, make, data, b in (("einet_rat fused", rat, rat_data, b_rat),
                                ("einet_pd planned", pd, pd_data, b_pd)):
        on, off = make(), make()
        cfg = rat_cfg if name.startswith("einet_rat") else pd_cfg
        cpu = build_einet(cfg, device="cpu", seed=0)
        x = batch_at(data, 0, b)
        ll_on, hv = make_em_step(on, TrainConfig(health=True))(x)
        ll_off = make_em_step(off, TrainConfig(health=False))(x)
        if ll_on != ll_off or not same_params(on, off):
            raise AssertionError(f"health {name}: the health-off step's "
                                 "parameters differ from the health-on "
                                 "step's")
        t0 = time.perf_counter()
        ll_cpu, hv_cpu = make_em_step(cpu, TrainConfig(health=True))(x.cpu())
        cpu_s = time.perf_counter() - t0
        spec = on.health_spec
        got, want = spec.to_dict(hv), spec.to_dict(hv_cpu)
        # a parameter pinned at a clamp bound sits there up to rounding, so
        # the card's clamp fraction is held against the CPU's count on the
        # card's own new parameters
        want["leaf.clamp_frac"] = float(cpu.ef.clamp_fraction(
            on.phi.detach().cpu()))
        diffs = []
        for slot in spec.names:
            a, w = got[slot], want[slot]
            rtol = HEALTH_RTOL.get(slot)
            ok = (a == w if rtol is None
                  else bool(np.isfinite(a)) and abs(a - w) <= rtol * abs(w))
            diffs.append(f"{slot} {a:.6g}/{w:.6g}")
            if not ok:
                raise AssertionError(
                    f"health {name}: slot {slot} on the card {a!r}, on the "
                    f"CPU {w!r} (rtol {rtol or 'exact'})")
        print(f"health {name} B={b}: the vector on the card (a graph step) "
              f"equals the CPU plain path's (counts and fractions exact, the "
              f"clamp fraction on the card's parameters, LL and entropy rtol "
              f"1e-5, norms rtol 1e-4; CPU step {cpu_s:.2f} "
              f"s); health-off parameters equal health-on bit for bit; card/"
              f"CPU: " + ", ".join(diffs) + f" [{card}]")
        del on, off, cpu
        free()

    # ---- (g) a recaptured step program takes a fresh pool: a replaced
    # parameter moves a pointer, the old graphs and pool go, the step still
    # equals the eager one bit for bit
    g, e = rat(), rat()
    step, e_step = make_em_step(g, TrainConfig()), eager_em_step(
        e, TrainConfig())
    base = pool_segments()
    lls = [(step(batch_at(rat_data, 0, b_rat)),
            e_step(batch_at(rat_data, 0, b_rat)))]
    first_pools = compile_lib.REGISTRY.pools(g)
    compiles0 = compile_lib.REGISTRY.stats["compiles"]
    for m in (g, e):
        m.class_prior = torch.nn.Parameter(m.class_prior.detach().clone())
    lls.append((step(batch_at(rat_data, 1, b_rat)),
                e_step(batch_at(rat_data, 1, b_rat))))
    free()
    new_pools = compile_lib.REGISTRY.pools(g)
    left = set(map(tuple, first_pools)) & set(pools_beyond(base))
    recaptures = compile_lib.REGISTRY.stats["compiles"] - compiles0
    if recaptures != 1 or (
            set(map(tuple, new_pools)) & set(map(tuple, first_pools))):
        raise AssertionError(f"step recapture: {recaptures} compiles, pools "
                             f"{first_pools} -> {new_pools}")
    if left or any(a != b for a, b in lls) or not same_params(g, e):
        raise AssertionError(
            f"step recapture: pools left behind {left}, LLs {lls}, or "
            "parameters differ from the eager steps")
    print(f"step recapture (einet_rat, class_prior replaced): one "
          f"recapture into a fresh pool {new_pools} (was {first_pools}, "
          f"released), no assert, both steps bit for bit eager [{card}]")
    del g, e, step, e_step
    free()

    # ---- (d) einet_rat_large through microbatches; the pool gate
    pools_base = pool_segments()
    big_cfg = get_config("einet_rat_large")
    big, big_e = (build_einet(big_cfg, device=dev, seed=0) for _ in range(2))
    big_data = torch.from_numpy(synthetic_rat_data(big.num_vars)).to(dev)
    n_gate = BIG_GATE_MICROBATCHES
    x_gate = batch_at(big_data, 0, n_gate * BIG_MICROBATCH_ROWS)
    tcfg = TrainConfig(num_microbatches=n_gate)
    step = make_em_step(big, tcfg)
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll_g = step(x_gate)
    torch.cuda.synchronize()
    gate_first_s = time.perf_counter() - t0
    out["counts"].update(counts_of(ops))
    out["shapes"].update(SHAPES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, ll_e = stochastic_em_update_microbatched(big_e, x_gate, tcfg.em,
                                                  n_gate)
    em.load_params(big_e, new)
    torch.cuda.synchronize()
    gate_eager_s = time.perf_counter() - t0
    del new
    if ll_g != float(ll_e) or not same_params(big, big_e):
        raise AssertionError(
            f"einet_rat_large: the {n_gate}-microbatch step graph differs "
            "from the eager microbatch loop")
    gate_capture_s = step.capture_s
    x2 = batch_at(big_data, 1, n_gate * BIG_MICROBATCH_ROWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(x2)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    gate_pools = pools_beyond(pools_base)
    del big_e, step, x2
    compile_lib.REGISTRY.table(big).clear()
    free()
    dropped_pools = pools_beyond(pools_base)
    print(f"graph pools: the {n_gate} x {BIG_MICROBATCH_ROWS}-row step "
          f"program {pool_text(gate_pools)}; after its drop and empty_cache "
          f"{pool_text(dropped_pools)} [{card}]")
    # the E-step at B=16 against the CPU plain path
    x16 = big_data[:16]
    stats = em.em_statistics(big, x16)
    t0 = time.perf_counter()
    big_cpu = build_einet(big_cfg, device="cpu", seed=0)
    big_cpu.load_state_dict({k: v.cpu() for k, v in big.state_dict().items()})
    stats_cpu = em.em_statistics(big_cpu, x16.cpu())
    big_cpu_s = time.perf_counter() - t0
    big_d = compare_stats(stats, stats_cpu,
                          "einet_rat_large E-step B=16 card vs CPU plain",
                          1e-4, 1e-6 * 16)
    del stats, stats_cpu, big_cpu
    free()
    # a checkpoint of its training state: save (synchronous) and restore
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(ck_dir, async_write=False)
        state = {"last_ll": ll_g, "params": em.params_of(big), "step": 2}
        t0 = time.perf_counter()
        mgr.save(2, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, back = mgr.restore(state)
        em.load_params(big, back["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(root, f))
                       for root, _, files in os.walk(ck_dir) for f in files)
        del back, state
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    free()
    # the config's own step: 65,536 rows as 64 microbatches of 1,024
    n_big = big_cfg.batch_size // BIG_MICROBATCH_ROWS
    step = make_em_step(big, TrainConfig(num_microbatches=n_big))
    x_big = batch_at(big_data, 2, big_cfg.batch_size)
    torch.cuda.reset_peak_memory_stats()
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll_big = step(x_big)
    torch.cuda.synchronize()
    big_first_s = time.perf_counter() - t0
    out["counts"].update(counts_of(ops))
    out["shapes"].update(SHAPES)
    big_capture_s = step.capture_s
    big_step_s = big_first_s - big_capture_s
    big_peak = torch.cuda.max_memory_allocated()
    big_pool = compile_lib.REGISTRY.pool_bytes(big)
    big_pools = pools_beyond(pools_base)
    if not np.isfinite(ll_big):
        raise AssertionError(f"einet_rat_large 65,536-row step: LL {ll_big}")
    out["big"] = {"gate_s": gate_s, "gate_first_s": gate_first_s,
                  "gate_eager_s": gate_eager_s,
                  "gate_capture_s": gate_capture_s,
                  "estep16_cpu_s": big_cpu_s, "save_s": save_s,
                  "restore_s": restore_s, "ckpt_bytes": ck_bytes,
                  "step_s": big_step_s, "capture_s": big_capture_s,
                  "rows_per_s": big_cfg.batch_size / big_step_s,
                  "peak_gib": big_peak / 2 ** 30,
                  "pool_gib": big_pool / 2 ** 30}
    print(f"einet_rat_large (K=64, {big.num_params()} parameters): the "
          f"{n_gate} x {BIG_MICROBATCH_ROWS}-row step graph equals the eager "
          f"microbatch loop bit for bit (first call {gate_first_s:.3f} s with "
          f"capture {gate_capture_s:.3f} s, eager {gate_eager_s:.3f} s, graph "
          f"{gate_s:.3f} s/step); E-step B=16 card vs CPU plain max |diff| "
          f"{big_d[0]:.3e} (at most {big_d[1]:.3e} of a block's max; CPU "
          f"{big_cpu_s:.1f} s with its build); checkpoint "
          f"{ck_bytes / 2 ** 20:.1f} MiB saved in {save_s:.3f} s, restored "
          f"in place in {restore_s:.3f} s [{card}]")
    print(f"einet_rat_large {big_cfg.batch_size}-row step ({n_big} x "
          f"{BIG_MICROBATCH_ROWS}): {big_step_s:.3f} s/step, "
          f"{big_cfg.batch_size / big_step_s:.1f} rows/s (the first call "
          f"{big_first_s:.3f} s less its capture {big_capture_s:.3f} s), LL "
          f"{ll_big:.4f}, memory peak {big_peak / 2 ** 30:.2f} GiB allocated, "
          f"graph pool {big_pool / 2 ** 30:.2f} GiB [{card}]")
    del big, step
    free()
    # the pool gate: the same program captured (no step) into a fresh model
    fresh = build_einet(big_cfg, device=dev, seed=0)
    fresh_step = make_em_step(fresh, TrainConfig(num_microbatches=n_big))
    fresh_step.capture(x_big)
    torch.cuda.synchronize()
    fresh_pool = compile_lib.REGISTRY.pool_bytes(fresh)
    fresh_pools = pools_beyond(pools_base)
    held = sum(v[1] for v in big_pools.values())
    print(f"graph pools: the {big_cfg.batch_size}-row program after the "
          f"drop {pool_text(big_pools)} (registry: {big_pool / 2 ** 30:.3f} "
          f"GiB); captured into a fresh model {pool_text(fresh_pools)} "
          f"(registry: {fresh_pool / 2 ** 30:.3f} GiB); "
          f"{held / fresh_pool:.4f}x [{card}]")
    if held > 1.10 * fresh_pool:
        raise AssertionError(
            f"pool gate: after the drop the card holds {held} B of graph "
            f"pools, more than 1.10 x the {fresh_pool} B of the same "
            "program captured into a fresh model")
    out["big"].update({"held_gib": held / 2 ** 30,
                       "fresh_pool_gib": fresh_pool / 2 ** 30,
                       "gate_pool_gib": sum(
                           v[1] for v in gate_pools.values()) / 2 ** 30,
                       "dropped_pool_gib": sum(
                           v[1] for v in dropped_pools.values()) / 2 ** 30})
    del fresh, fresh_step, x_big, big_data
    free()

    # ---- (e) the fault-tolerant loop on einet_pd's graph step
    reg = compile_lib.ProgramRegistry()
    pd_a, pd_b = pd(), pd()
    engine = ServeEngine(pd_a, max_batch=8, registry=reg)
    engine.warmup(kinds=["joint_ll"])
    compiles0 = reg.stats["compiles"]
    ck_root = tempfile.mkdtemp(prefix="chip_smoke_ft_")

    def loop(model, step, directory, injector=None):
        def load_state(s):
            em.load_params(model, s["params"])
            return {"last_ll": float(s["last_ll"]),
                    "params": em.params_of(model), "step": int(s["step"])}

        def step_fn(s, x):
            return {"last_ll": step(x), "params": em.params_of(model),
                    "step": s["step"] + 1}

        init = {"last_ll": 0.0, "step": 0, "params": {
            k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
            for k, v in em.params_of(model).items()}}
        return ft.run_training(
            step_fn, init, lambda i: batch_at(pd_data, i, b_pd),
            CheckpointManager(directory), 12,
            ft.LoopConfig(checkpoint_every=4, max_restarts=5),
            fail_injector=injector, load_state=load_state)

    crashed = set()

    def injector(i):
        if i in (5, 9) and i not in crashed:
            crashed.add(i)
            raise RuntimeError(f"injected failure at step {i}")

    try:
        t0 = time.perf_counter()
        _, stats_a = loop(pd_a, make_em_step(pd_a, TrainConfig(),
                                             registry=reg),
                          os.path.join(ck_root, "a"), injector)
        ft_s = time.perf_counter() - t0
        _, stats_b = loop(pd_b, make_em_step(pd_b, TrainConfig()),
                          os.path.join(ck_root, "b"))
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    if stats_a["restarts"] != 2 or stats_b["restarts"] != 0:
        raise AssertionError(f"run_training restarts {stats_a['restarts']}, "
                             f"{stats_b['restarts']}")
    if not same_params(pd_a, pd_b):
        raise AssertionError("run_training with failures at steps 5 and 9 "
                             "ends in other parameters than an "
                             "uninterrupted run")
    key = next(k for k in reg.table(pd_a) if "joint_ll" in str(k))
    prog = reg.table(pd_a)[key]
    batch = assemble_batch(pd_a, [], key[1])
    served = prog(batch)
    with torch.inference_mode():
        want = run_query(pd_a, batch, "joint_ll", None)
    if reg.stats["compiles"] != compiles0 + 1:
        raise AssertionError(
            f"run_training: {reg.stats['compiles'] - compiles0} compiles "
            "across the run (one step capture expected, no recapture)")
    if not bits_equal(served, want):
        raise AssertionError("einet_pd joint_ll program after the restores "
                             "differs from eager")
    print(f"run_training einet_pd graph step: 12 steps, checkpoint_every=4, "
          f"failures at steps 5 and 9 -> {stats_a['restarts']} restarts, "
          f"final parameters equal an uninterrupted run's bit for bit; "
          f"{compiles0} serving programs and the step graph recaptured 0 "
          f"times (one step capture in the run), a served joint_ll batch "
          f"equals eager after the restores; {ft_s:.3f} s [{card}]")
    del pd_a, pd_b, engine, prog, reg
    free()

    # ---- (f) the divergence flight recorder
    nan_xs = []
    for i in range(6):
        x = batch_at(rat_data, i, b_rat).clone()
        if i >= 3:
            x[0, 0] = float("nan")
        nan_xs.append(x)
    inc_root = tempfile.mkdtemp(prefix="chip_smoke_incidents_")
    try:
        for policy in ("abort", "continue"):
            m = rat()
            where = os.path.join(inc_root, policy)
            hp = health_lib.HealthPolicy(on_incident=policy,
                                         incident_dir=where)
            raised = None
            lls = []
            try:
                lls = fit(m, nan_xs, TrainConfig(health=True),
                          health_policy=hp)
            except health_lib.DivergenceError as err:
                raised = err
            bundles = os.listdir(where)
            if len(bundles) != 1:
                raise AssertionError(f"flight recorder {policy}: bundles "
                                     f"{bundles}")
            files = set(os.listdir(os.path.join(where, bundles[0])))
            with open(os.path.join(where, bundles[0], "incident.json")) as f:
                inc = json.load(f)
            if files != INCIDENT_FILES or inc["step"] != 3:
                raise AssertionError(f"flight recorder {policy}: {files}, "
                                     f"step {inc['step']}")
            if (policy == "abort") != (raised is not None) or (
                    policy == "continue" and len(lls) != len(nan_xs)):
                raise AssertionError(f"flight recorder {policy}: raised "
                                     f"{raised!r}, {len(lls)} steps")
            print(f"flight recorder ({policy}): a NaN row from step 3 on -> "
                  + (f"DivergenceError ({raised.reason})" if raised
                     else f"{len(lls)} steps run") + f"; one bundle at step "
                  f"{inc['step']} with {sorted(files)} [{card}]")
            del m
    finally:
        shutil.rmtree(inc_root, ignore_errors=True)
    free()
    return out


# the paper phase: Table 1's EM epochs on all 20 proxies, and the rows of
# the naive/EiNet parity at einet_rat's width (the paper's Fig. 3 data size)
PAPER_EPOCHS = 10
PAPER_ROWS = 2000


def paper_phase(card: str, dev, compare_stats) -> dict:
    """The paper's comparison (``repro_torch.bench``) on the card.

    (a) Table 1 over all 20 binary proxies at the reference's quick sizes
    (``table1.MAX_VARS`` variables, 400 / 200 rows) with 10 EM epochs:
    max |dLL| (EiNet against NaiveEiNet) < 1e-3 and the test LL after EM
    above the initial model's, on every proxy.
    (b) NaiveEiNet against EiNet at einet_rat's full width (D=4, R=10,
    K=10) on Fig. 3's 2,000 x 512 rows, the same parameters: LL rtol 1e-5,
    atol 1e-4; E-step statistics rtol 1e-4, atol 1e-6 B; the naive LL on the
    card against the port's CPU plain path (rtol 1e-5, atol 1e-4); the
    launch counters, set to 0 just before and read just after, show no
    K1-K6 launch from the naive net's LL and E-step, and the EiNet's plan's
    kernels from its own.
    (c) Fig. 3 and Fig. 6 over the full profile's K sweep (2,000 x 512 rows
    and 100 rows, D=4, R=10), eager and graph, with each naive point out of
    memory recorded and the first such K printed.
    (d) Fig. 4 quick: EM learns and the argmax inpainting beats mean-fill.

    Returns the launch counts of the EiNet paths of (a)-(d) (each part
    with the counters set to 0 just before, read just after) and the
    figures."""
    import gc

    import numpy as np
    import torch

    from repro_torch.bench import fig3, fig4, fig6, table1
    from repro_torch.configs import get_config
    from repro_torch.core import em
    from repro_torch.core.baseline import NaiveEiNet
    from repro_torch.data.synthetic import TWENTY_DATASETS
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_einet

    out = {"counts": collections.Counter()}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def part(fn):
        """``fn()`` between a counter reset and a read; its time too."""
        free()
        reset(ops)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = counts_of(ops)
        out["counts"].update(got)
        return res, got, sec

    # ---- (a) Table 1 on all 20 proxies
    rows, _, t1_s = part(lambda: table1.run(
        quick=True, device=dev, datasets=TWENTY_DATASETS,
        epochs=PAPER_EPOCHS))
    print(table1.HEADER)
    for r in rows:
        print(",".join(str(x) for x in r))
    if len(rows) != 20 or not table1.gate(rows):
        raise AssertionError("Table 1: parity below 1e-3 and EM above the "
                             "initial model must hold on all 20 proxies")
    print(f"Table 1 on all 20 proxies (at most {table1.MAX_VARS} variables, "
          f"{table1.N_TRAIN}/{table1.N_TEST} rows, {PAPER_EPOCHS} EM epochs "
          f"through graph steps): max |dLL| "
          f"{max(r[4] for r in rows):.3e}, EM raises every test LL; "
          f"{t1_s:.2f} s [{card}]")
    out["table1"] = {"rows": rows, "seconds": t1_s}

    # ---- (b) NaiveEiNet against EiNet at einet_rat's width
    net = build_einet(get_config("einet_rat"), device=dev, seed=0)
    naive = NaiveEiNet(net.graph, num_sums=net.K,
                       num_classes=net.num_classes,
                       exponential_family=net.ef, device=dev)
    naive.load_state_dict(net.state_dict())
    x = fig3.data(PAPER_ROWS, net.num_vars, dev)

    def ll_and_stats(m):
        with torch.inference_mode():
            ll = m.log_likelihood(x)
        return ll, em.em_statistics(m, x)

    (ll_n, st_n), naive_counts, naive_s = part(lambda: ll_and_stats(naive))
    if any(naive_counts.values()):
        raise AssertionError(f"NaiveEiNet launched kernels: {naive_counts}")
    (ll_e, st_e), einet_counts, einet_s = part(lambda: ll_and_stats(net))
    kinds = collections.Counter(seg.kind for seg in net.exec_plan)
    want = {"grouped_log_einsum_exp": 2 * kinds["fused"],
            "grouped_log_einsum_exp_bwd": kinds["fused"],
            "log_einsum_exp": 2 * kinds["layer"],
            "log_einsum_exp_bwd": kinds["layer"]}
    if any(einet_counts[k] != want.get(k, 0) for k in einet_counts):
        raise AssertionError(f"EiNet LL and E-step launched {einet_counts}, "
                             f"its plan {dict(kinds)} wants {want}")
    ll_d = assert_ll(ll_n, ll_e, "NaiveEiNet LL vs EiNet LL")
    compare_stats(st_n, st_e, f"einet_rat B={PAPER_ROWS} E-step NaiveEiNet "
                  "vs EiNet", 1e-4, 1e-6 * PAPER_ROWS)
    naive_cpu = NaiveEiNet(net.graph, num_sums=net.K,
                           num_classes=net.num_classes,
                           exponential_family=net.ef, device="cpu")
    naive_cpu.load_state_dict({k: v.cpu()
                               for k, v in net.state_dict().items()})
    with torch.inference_mode():
        ll_cpu = naive_cpu.log_likelihood(x.cpu())
    cpu_d = assert_ll(ll_n, ll_cpu, "NaiveEiNet LL card vs CPU plain")
    print(f"NaiveEiNet vs EiNet, einet_rat (D=4, R=10, K=10, "
          f"{len(net.pair_specs)} pairs) B={PAPER_ROWS}: LL max |diff| "
          f"{ll_d:.3e}, statistics within rtol 1e-4, atol 1e-6 B, naive LL "
          f"card vs CPU max |diff| {cpu_d:.3e}; launches naive "
          f"{naive_counts} (none), EiNet {einet_counts} (plan "
          f"{dict(kinds)}); LL + E-step naive {naive_s * 1e3:.1f} ms, EiNet "
          f"{einet_s * 1e3:.1f} ms [{card}]")
    del net, naive, naive_cpu, x, ll_n, st_n, ll_e, st_e, ll_cpu

    # ---- (c) Fig. 3 and Fig. 6 over the K sweep
    ks = {"K": fig3.PROFILES["full"]["sweeps"]["K"]}
    rows3, _, f3_s = part(lambda: fig3.run(quick=False, device=dev,
                                           sweeps=ks))
    print(fig3.HEADER)
    for r in rows3:
        print(fig3.format_row(r))
    if any(r[3] == fig3.OOM for r in rows3 if r[0] == "einet"):
        raise AssertionError("Fig. 3: an EiNet point ran out of memory")
    rows6, _, f6_s = part(lambda: fig6.run(quick=False, device=dev,
                                           sweeps=ks))
    print(fig6.HEADER)
    for r in rows6:
        print(fig6.format_row(r))
    print(f"Fig. 3 / Fig. 6 K sweep at 2,000 x 512 / 100 rows (D=4, R=10): "
          f"first naive OOM K {fig3.first_oom(rows3)} / "
          f"{fig3.first_oom(rows6)}; naive/einet at the largest K both ran "
          f"{fig3.ratios(rows3)}; {f3_s:.2f} / {f6_s:.2f} s [{card}]")
    out["fig3"], out["fig6"] = rows3, rows6

    # ---- (d) Fig. 4 quick
    fig4_dir = tempfile.mkdtemp(prefix="chip_smoke_fig4_")
    try:
        r4, _, f4_s = part(lambda: fig4.run(quick=True, device=dev,
                                            out_dir=fig4_dir))
    finally:
        shutil.rmtree(fig4_dir, ignore_errors=True)
    if not (fig4.gate(r4) and r4["samples_finite"]):
        raise AssertionError(f"Fig. 4 quick: {r4}")
    print("Fig. 4 quick (12 x 12 x 3 PD, K=8, 3 epochs): " + ", ".join(
        f"{k} {v}" for k, v in r4.items()) + f"; {f4_s:.2f} s [{card}]")
    out["fig4"] = r4
    free()
    return out


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
    import torch

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



# the distributed phase: sharded EM steps a case (a), the rows a step of the
# two-rank run (b) and its steps, and the compressed all-reduce's length
DIST_STEPS = 20
DIST_RANK_STEPS = 5
DIST_PSUM_N = 100_000
DIST_TIMEOUT_S = 300
# an all-reduce a replay in (a): iterations timed with CUDA events
DIST_REDUCE_ITERS = 20


def own_kernel_names() -> set:
    """The names of the hand-written CUDA kernels (every ``__global__``
    function in the port's csrc/)."""
    import re

    src = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    names = set()
    for f in os.listdir(src):
        with open(os.path.join(src, f)) as fh:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                fh.read()))
    return names


def own_kernels(ran, names) -> dict:
    """The hand-written kernels among a profiled call's, by name (the
    profiler's demangled names, e.g. "void (anonymous
    namespace)::grouped_fwd_kernel<2>(float const*, ...)")."""
    out = collections.Counter()
    for name, n in ran.items():
        base = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0].split("<")[0].split("::")[-1].strip()
        if base in names:
            out[base] += n
    return dict(out)


def dist_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the phase's part (b): gloo with CUDA tensors on the one
    card.  einet_pd at B=512 on a (2, 1) mesh (256 rows a rank, from the
    sharded loader) and on a (1, 2) mesh (the M-step on each rank's model
    shard), DIST_RANK_STEPS sharded steps each after holding the step-0
    statistics this rank reduces; then the (1, 2) parameters resharded onto
    (2, 1) and back; then ``compressed_psum`` of seeded tensors on the
    card and on the CPU.  Writes what it found to ``rank_<r>.pt``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import em
    from repro_torch.data.datasets import array_loader
    from repro_torch.dist import elastic
    from repro_torch.dist import sharding as shlib
    from repro_torch.launch.cells import build_einet
    from repro_torch.launch.mesh import dp_index, dp_shards, make_mesh_for
    from repro_torch.launch.train import synthetic_pd_data
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.train import TrainConfig, make_sharded_em_step

    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        cfg = get_config("einet_pd")
        b = cfg.batch_size
        out = {"backend": dist.get_backend(), "cases": {}}
        meshes = {"(2, 1)": make_mesh_for(world, 1, device_type="cuda"),
                  "(1, 2)": make_mesh_for(world, 2, device_type="cuda")}
        for name, mesh in meshes.items():
            model = build_einet(cfg, device=dev, seed=0)
            rows = synthetic_pd_data(model.num_vars)
            loader = array_loader(rows, b, num_shards=dp_shards(mesh),
                                  shard_id=dp_index(mesh))
            xs = [torch.from_numpy(loader.batch_at(i)["x"]).to(dev)
                  for i in range(DIST_RANK_STEPS)]
            stats = shlib.reduce_like_params(em.em_statistics(model, xs[0]),
                                             mesh)
            shapes = em.zeros_like_statistics(model, "meta")
            placed = tree_lib.leaves_like(
                shapes, shlib.tree_shardings(mesh, shapes))
            model_dim = mesh.mesh_dim_names.index("model")
            step = make_sharded_em_step(model, TrainConfig(), mesh)

            def host(t):
                return t.detach().to("cpu", copy=True)

            def host_params():
                return {k: (host(v) if not isinstance(v, list)
                            else [host(t) for t in v])
                        for k, v in em.params_of(model).items()}

            lls, times, params = [], [], [host_params()]
            for x in xs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lls.append(step(x))
                times.append(time.perf_counter() - t0)
                params.append(host_params())
            case = {
                "coord": mesh.get_coordinate(), "rows": xs[0].shape[0],
                "lls": lls, "ms": [t * 1e3 for t in times],
                "stats": tree_lib.unflatten_like(
                    stats, [host(t) for t in tree_lib.flatten(stats)[1]],
                    lambda _, new: new),
                "block_dims": [p[model_dim].dim if isinstance(
                    p[model_dim], Shard) else None for p in placed],
                "params": params}
            out["cases"][name] = case
            if name == "(1, 2)":
                tree = em.params_of(model)
                a = elastic.reshard(tree, mesh)
                moved = elastic.reshard(a, meshes["(2, 1)"])
                back = elastic.reshard(moved, mesh)
                full = [shlib.gather_full(x.to_local(), x.placements,
                                          x.device_mesh)
                        for x in tree_lib.flatten(moved)[1]]
                out["reshard"] = {
                    "blocks_equal": all(
                        torch.equal(u.to_local().view(torch.int32),
                                    v.to_local().view(torch.int32))
                        for u, v in zip(tree_lib.flatten(a)[1],
                                        tree_lib.flatten(back)[1])),
                    "full_equal": all(
                        torch.equal(f.view(torch.int32), t.view(torch.int32))
                        for f, t in zip(full, tree_lib.flatten(tree)[1])),
                    "sharded": sum(shlib.is_sharded(x.placements)
                                   for x in tree_lib.flatten(a)[1])}
            del model, step
        g = np.random.RandomState(40 + rank).randn(DIST_PSUM_N).astype(
            np.float32)
        r = (0.01 * np.random.RandomState(50 + rank).randn(DIST_PSUM_N)
             ).astype(np.float32)
        on_card = compressed_psum(torch.from_numpy(g).to(dev), None,
                                  torch.from_numpy(r).to(dev))
        on_cpu = compressed_psum(torch.from_numpy(g), None,
                                 torch.from_numpy(r))
        out["psum"] = {"card": [t.cpu() for t in on_card],
                       "cpu": list(on_cpu), "g": g}
        torch.save(out, os.path.join(tmp, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dist_phase(card: str, dev, compare_stats) -> dict:
    """Distributed EM on the one card.

    (a) NCCL at a world of 1 on a (data=1, model=1) mesh:
    ``make_sharded_em_step`` for DIST_STEPS stochastic steps at einet_rat
    (B=2048, fused) and einet_pd (B=512, planned) against ``make_em_step``
    on a second model from the same parameters: LLs and parameters bit for
    bit; the wrapper launches (warm-up and capture, counters set to 0 just
    before the sharded steps and read just after) equal; one replay of each
    program runs the same hand-written kernels by name and number
    (profiled).  Prints ms/step of both and the all-reduce's time from CUDA
    events: the step's ``reduce`` stage, and one ``dist.all_reduce`` of a
    buffer of the statistics' size.
    (b) Two ranks spawned on the card over gloo with CUDA tensors (NCCL
    will not put two ranks on one device): einet_pd at B=512 for
    DIST_RANK_STEPS steps on a (2, 1) mesh (256 rows a rank) and a (1, 2)
    mesh, each step held against a single-process step on all 512 rows
    from the same parameters: statistics (step 0) rtol 1e-4, atol 1e-6 B;
    parameters rtol 1e-4, atol 1e-6; mean LL within 1e-4 + 1e-6 |LL| (one
    float32 step of einet_pd's mean LL is 2.4e-4); parameters bit
    for bit equal across the ranks; the (1, 2)
    parameters resharded onto (2, 1) and back bit for bit;
    ``compressed_psum`` within 5% of the exact sum and bit for bit the
    CPU's.

    Returns (a)'s launch counts and K1/K2 shapes (a main path's) and the
    figures."""
    import gc

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import em
    from repro_torch.dist import sharding as shlib
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_einet
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import (
        batch_at, synthetic_pd_data, synthetic_rat_data)
    from repro_torch.train import (
        TrainConfig, make_em_step, make_sharded_em_step)

    out = {"counts": collections.Counter(), "shapes": collections.Counter(),
           "cases": {}}
    names = own_kernel_names()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # ---- (a) NCCL, a world of 1
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh_for(1, 1, device_type="cuda")
            backend = dist.get_backend()
            for arch in ("einet_rat", "einet_pd"):
                cfg = get_config(arch)
                b = cfg.batch_size
                s_model = build_einet(cfg, device=dev, seed=0)
                r_model = build_einet(cfg, device=dev, seed=0)
                make = (synthetic_pd_data if cfg.structure == "pd"
                        else synthetic_rat_data)
                data = torch.from_numpy(make(s_model.num_vars)).to(dev)
                xs = [batch_at(data, i, b) for i in range(DIST_STEPS)]
                s_step = make_sharded_em_step(s_model, TrainConfig(), mesh)
                r_step = make_em_step(r_model, TrainConfig())
                runs = {}
                for tag, step in (("sharded", s_step), ("make_em_step",
                                                         r_step)):
                    torch.cuda.synchronize()
                    reset(ops)
                    lls, times = [], []
                    for x in xs:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        lls.append(step(x))
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    runs[tag] = {"lls": lls, "counts": counts_of(ops),
                                 "shapes": collections.Counter(SHAPES),
                                 "ms": statistics.median(times[1:]) * 1e3}
                s_run, r_run = runs["sharded"], runs["make_em_step"]
                if s_run["lls"] != r_run["lls"] or not all(
                        bits_equal(p.detach(), q.detach()) for p, q in
                        zip(s_model.parameters(), r_model.parameters())):
                    raise AssertionError(
                        f"dist (a) {arch}: {DIST_STEPS} sharded steps at a "
                        f"world of 1 differ from make_em_step's (LLs "
                        f"{s_run['lls'][:3]}... vs {r_run['lls'][:3]}...)")
                if s_run["counts"] != r_run["counts"] or not any(
                        s_run["counts"].values()):
                    raise AssertionError(
                        f"dist (a) {arch}: wrapper launches {s_run['counts']}"
                        f" against make_em_step's {r_run['counts']}")
                s_graph = next(iter(s_step.graphs.values()))
                r_graph = next(iter(r_step.graphs.values()))
                s_ran, _ = device_kernels(
                    lambda: s_step.replay(s_graph, xs[0]))
                r_ran, _ = device_kernels(
                    lambda: r_step.replay(r_graph, xs[0]))
                s_own, r_own = own_kernels(s_ran, names), own_kernels(
                    r_ran, names)
                if s_own != r_own or not s_own:
                    raise AssertionError(
                        f"dist (a) {arch}: one sharded replay runs the hand-"
                        f"written kernels {s_own}, one make_em_step replay "
                        f"{r_own} (kernels of the sharded replay: "
                        f"{sorted(s_ran)})")
                reduce = s_step._fn.reduce
                reduce_ms = time_ms(lambda: reduce(s_model, s_graph.acc),
                                    iters=DIST_REDUCE_ITERS)
                floats = sum(t.numel() for t in tree_lib.flatten(
                    s_graph.acc["stats"])[1])
                buf = torch.ones(floats, device=dev)
                allreduce_ms = time_ms(lambda: dist.all_reduce(buf),
                                       iters=DIST_REDUCE_ITERS)
                fig = {"sharded_ms": s_run["ms"], "make_em_step_ms":
                       r_run["ms"], "reduce_ms": reduce_ms,
                       "allreduce_ms": allreduce_ms, "floats": floats,
                       "kernels_a_replay": s_own,
                       "all_kernels_a_replay": (sum(s_ran.values()),
                                                sum(r_ran.values()))}
                out["cases"][f"{arch} world 1"] = fig
                out["counts"].update(s_run["counts"])
                out["shapes"].update(s_run["shapes"])
                print(f"dist (a) {arch} B={b}, {backend} world 1, mesh "
                      f"(data=1, model=1): {DIST_STEPS} sharded steps equal "
                      f"{DIST_STEPS} make_em_step steps bit for bit (LL "
                      f"{s_run['lls'][0]:.4f} -> {s_run['lls'][-1]:.4f}); "
                      f"{s_run['ms']:.3f} against {r_run['ms']:.3f} ms/step "
                      f"(medians of steps 1-{DIST_STEPS - 1}); wrapper "
                      "launches (warm-up and capture) " + ", ".join(
                          f"{k} {v}" for k, v in s_run["counts"].items() if v)
                      + " in both; a replay runs the same hand-written "
                      "kernels " + ", ".join(f"{k} {v}" for k, v in
                                            sorted(s_own.items()))
                      + f" ({fig['all_kernels_a_replay'][0]} CUDA kernels "
                      f"in all, make_em_step's {fig['all_kernels_a_replay'][1]}"
                      f"); the reduce stage {reduce_ms:.4f} ms, one "
                      f"all_reduce of its {floats:,} floats "
                      f"{allreduce_ms:.4f} ms (CUDA events) [{card}]")
                del s_model, r_model, s_step, r_step, s_graph, r_graph, buf
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # ---- (b) two ranks on the card over gloo
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = mp.start_processes(dist_rank, args=(2, tmp), nprocs=2,
                                 start_method="spawn", join=False)
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError("dist (b): the two ranks did not "
                                         f"finish in {DIST_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank_{r}.pt"),
                            weights_only=False) for r in range(2)]
        backend = ranks[0]["backend"]
        cfg = get_config("einet_pd")
        b = cfg.batch_size
        ref = build_einet(cfg, device=dev, seed=0)
        data = torch.from_numpy(synthetic_pd_data(ref.num_vars)).to(dev)
        xs = [batch_at(data, i, b) for i in range(DIST_RANK_STEPS)]
        ref_stats = em.em_statistics(ref, xs[0])
        ref_step = make_em_step(ref, TrainConfig())
        for name in ("(2, 1)", "(1, 2)"):
            cases = [r["cases"][name] for r in ranks]
            for c in cases:
                coord = c["coord"]
                blocks = [t if d is None else t.chunk(2, d)[coord[1]]
                          for t, d in zip(tree_lib.flatten(ref_stats)[1],
                                          c["block_dims"])]
                want = tree_lib.unflatten_like(ref_stats, blocks,
                                               lambda _, new: new)
                compare_stats(c["stats"], want,
                              f"dist (b) {name} rank at {coord}: step-0 "
                              f"statistics ({c['rows']} rows a rank) against "
                              f"one process on {b}", 1e-4, 1e-6 * b)
                # each step against one single-process step on all the
                # rows from the same parameters (a trajectory of steps
                # drifts apart by rounding, which EM amplifies)
                d_ll = 0.0
                for i, x in enumerate(xs):
                    em.load_params(ref, {k: (v.to(dev) if not isinstance(
                        v, list) else [t.to(dev) for t in v])
                        for k, v in c["params"][i].items()})
                    ll = ref_step(x)
                    d_ll = max(d_ll, abs(ll - c["lls"][i]))
                    # 1e-4, plus 1e-6 |LL|: at einet_pd's |LL| of about
                    # 3,300 one float32 step of the mean is 2.4e-4
                    if abs(ll - c["lls"][i]) > 1e-4 + 1e-6 * abs(ll):
                        raise AssertionError(
                            f"dist (b) {name} step {i}: mean LL "
                            f"{c['lls'][i]} against one process's {ll}")
                    compare_stats(c["params"][i + 1], em.params_of(ref),
                                  f"dist (b) {name} rank at {coord}: "
                                  f"parameters after step {i} against one "
                                  "process's step", 1e-4, 1e-6)
            same = all(bits_equal(u, v) for u, v in zip(
                tree_lib.flatten(cases[0]["params"])[1],
                tree_lib.flatten(cases[1]["params"])[1]))
            if not same or cases[0]["lls"] != cases[1]["lls"]:
                raise AssertionError(f"dist (b) {name}: the two ranks' "
                                     "parameters differ")
            ms = statistics.median(cases[0]["ms"][1:])
            out["cases"][f"einet_pd {name} {backend}"] = {
                "rows": cases[0]["rows"], "ms": ms,
                "first_ms": cases[0]["ms"][0], "d_ll": d_ll}
            print(f"dist (b) einet_pd B={b} on a {name} (data, model) mesh, "
                  f"two ranks on one card over {backend} with CUDA tensors: "
                  f"{cases[0]['rows']} rows a rank; {DIST_RANK_STEPS} "
                  f"sharded steps, each within rtol 1e-4 of one process's "
                  f"step on all {b} rows from the same parameters (mean LL "
                  f"max |diff| {d_ll:.2e}); parameters "
                  f"bit for bit equal across the ranks; {ms:.3f} ms/step "
                  f"(median of steps 1-{DIST_RANK_STEPS - 1}; first step "
                  f"with capture {cases[0]['ms'][0]:.1f} ms) [{card}]")
        for r in ranks:
            rs = r["reshard"]
            if not (rs["blocks_equal"] and rs["full_equal"]
                    and rs["sharded"]):
                raise AssertionError(f"dist (b): reshard (1, 2) -> (2, 1) -> "
                                     f"(1, 2) {rs}")
        exact = sum(torch.from_numpy(r["psum"]["g"]) for r in ranks)
        for rank, r in enumerate(ranks):
            p = r["psum"]
            rel = float((p["card"][0] - exact).abs().max()
                        / exact.abs().max())
            if rel >= 0.05:
                raise AssertionError(f"dist (b) compressed_psum rank {rank}: "
                                     f"{rel:.3e} relative to the exact sum")
            if not all(bits_equal(u, v) for u, v in zip(p["card"],
                                                        p["cpu"])):
                raise AssertionError(
                    f"dist (b) compressed_psum rank {rank}: the card's sum "
                    f"and residual differ from the CPU's by "
                    + ", ".join(f"{float((u - v).abs().max()):.3e} in "
                                f"{int((u != v).sum())}" for u, v in
                                zip(p["card"], p["cpu"])))
        out["ranks_s"] = ranks_s
        print(f"dist (b): (1, 2) parameters resharded onto (2, 1) and back "
              f"bit for bit ({ranks[0]['reshard']['sharded']} leaves sharded "
              f"on the model dim); compressed_psum of {DIST_PSUM_N:,} floats "
              f"a rank within {rel:.3e} of the exact sum (gate 5%) and bit "
              f"for bit the CPU's, sum and residual; the two ranks' "
              f"processes {ranks_s:.1f} s, spawn included [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# the production-bench phase: the four benches' full profiles and their
# gates, into chiprun_out/bench (serve's second arch into einet_pd/)
BENCH_DIR = os.path.join(ROOT, "chiprun_out", "bench")
BENCH_SERVE_ARCHS = ("einet_rat", "einet_pd")
# a calibration call (--bench) runs the phase this many times
BENCH_RUNS = 3


def bench_phase(card: str, dev, out_dir: str = BENCH_DIR,
                slo_check: bool = True) -> dict:
    """The production benches (``repro_torch.bench.{serve,train,mixture,
    eval}``) at full size, with tracing on, writing their BENCH files
    under ``out_dir`` (history rows under ``artifacts/bench_history_torch``):

      * serve's card profile at einet_rat (``out_dir``) and einet_pd
        (``out_dir/einet_pd``) inside a ``CompileSentry``: the engine's
        captures at most kinds x buckets, one direct program a kind, and
        no key captured twice;
      * train's card profile inside a ``CompileSentry`` wrapping each
        cell's step program: one capture event a program over all its
        calls, no recapture, no finding, the plan grouped;
      * mixture, its pools inspected at C=32 (one pool a step program, the
        mixture's and each of the C loop models', all distinct), and all
        released once the cell's models are gone;
      * eval;

    then the trace of the phase and the metrics snapshot validated by
    ``obs.check``, ``slo --check`` against ``slo_torch.json`` on both
    directories (unless ``slo_check`` is False: a calibration call checks
    after all its runs), and ``dryrun --verify`` over every registered arch
    (health probes on the card).  The launch counters are set to 0 just
    before the benches and read just after.  Returns the reports, counts,
    K1/K2 shapes, K5/K6 (tables, B) and seconds."""
    import gc

    import torch

    from repro_torch import obs
    from repro_torch.analysis import CompileSentry
    from repro_torch.bench import eval as eval_bench
    from repro_torch.bench import mixture as mixture_bench
    from repro_torch.bench import serve as serve_bench
    from repro_torch.bench import train as train_bench
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.obs import check as check_lib
    from repro_torch.obs import slo as slo_lib

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    out = {"reports": {}, "seconds": {}}
    # the phase's own trace and metrics: the earlier phases' (the flight
    # recorder's NaN health gauges among them) are not this phase's export
    obs.reset()
    obs.METRICS.reset()
    obs.configure(trace=True)
    torch.cuda.synchronize()
    reset(ops)
    try:
        # ---- serve, at both archs
        for arch in BENCH_SERVE_ARCHS:
            d = out_dir if arch == BENCH_SERVE_ARCHS[0] else \
                os.path.join(out_dir, arch)
            t0 = time.perf_counter()
            with CompileSentry() as sentry:
                rep = serve_bench.main(
                    arch=arch, out=os.path.join(d, "BENCH_torch_serve.json"),
                    device=dev, card=True)
            out["seconds"][f"serve {arch}"] = time.perf_counter() - t0
            if not rep:
                raise AssertionError(f"bench serve {arch}: a gate failed")
            keys = [e["key"] for e in sentry.compile_events]
            direct = [k for k in keys if k.startswith("('direct'")]
            engine = len(keys) - len(direct)
            bound = len(rep["kinds"]) * len(rep["buckets"])
            if (engine > bound or len(direct) != len(rep["kinds"])
                    or len(set(keys)) != len(keys)
                    or rep["program_cache"]["registry_compiles"] != engine):
                raise AssertionError(
                    f"bench serve {arch}: {engine} engine captures (bound "
                    f"kinds x buckets = {bound}), {len(direct)} direct, "
                    f"the engine's registry {rep['program_cache']}, keys "
                    f"{keys}")
            out["reports"][f"serve {arch}"] = rep
            print(f"bench serve {arch}: engine {rep['engine_qps']:.1f} req/s, "
                  f"p99 " + ", ".join(f"{k} {v['p99']:.3f} ms" for k, v in
                                      sorted(rep["latency_ms"].items()))
                  + f"; {rep['speedup_vs_jitted']:.2f}x per-request "
                  f"programs, {rep['speedup']:.2f}x eager; parity "
                  f"{rep['parity_max_abs_diff']:.3e}; sentry: {engine} engine "
                  f"captures <= kinds x buckets = {bound}, {len(direct)} "
                  f"direct, no key twice [{card}]")
            gc.collect()
            torch.cuda.empty_cache()
        # ---- train
        t0 = time.perf_counter()
        with CompileSentry() as sentry:
            rep = train_bench.main(
                out=os.path.join(out_dir, "BENCH_torch_train.json"),
                device=dev, card=True, sentry=sentry)
        out["seconds"]["train"] = time.perf_counter() - t0
        if not rep:
            raise AssertionError("bench train: a gate failed")
        for row in rep["results"]:
            # one signature, one capture event over all the program's calls
            # (the first call's included), no recapture; and grouped, which
            # the bench's own gate does not hold a waived arch to
            name = f"em_step[{row['arch_id']}]"
            g = row["grouping"]
            if (sentry.compiles(name) != 1 or sentry.captures(name) != 1
                    or sentry.recaptures(name)
                    or not (g["fused_groups"] or g["gather_groups"])):
                raise AssertionError(
                    f"bench train {row['arch_id']}: {sentry.compiles(name)} "
                    f"signatures, {sentry.captures(name)} capture events, "
                    f"{sentry.recaptures(name)} recaptures of its step "
                    f"program; grouping {g}\n" + sentry.report())
        sentry.assert_no_leaks()
        out["reports"]["train"] = rep
        for row in rep["results"]:
            print(f"bench train {row['arch_id']} (B={row['batch']}, "
                  f"{row['microbatches']} microbatches): step program "
                  f"{row['fused_ms_per_step']:.2f} ms/step, per-step path "
                  f"{row['per_step_ms_per_step']:.2f} ms/step "
                  f"({row['speedup']:.2f}x), first step with capture "
                  f"{row['compile_fused_s']:.2f} s; update parity "
                  f"{row['update_parity_max_abs_diff']:.3e}, K2 against "
                  f"autograd {row['grad_parity_max_abs_diff']:.3e}; sentry: "
                  f"1 capture, 0 recaptures"
                  + (f"; speedup waived: {row['speedup_waiver']}"
                     if row["speedup_waiver"] else "") + f" [{card}]")
            print(f"segment breakdown {row['arch_id']} (one eager forward, "
                  f"each segment synchronised): " + ", ".join(
                      f"{k}: {v['launches']} segment(s) {v['eager_ms']:.3f} ms"
                      for k, v in sorted(row["segment_breakdown"].items()))
                  + f" [{card}]")
        ls = rep["leaf_scatter"]
        print(f"bench train leaf scatter ({ls['arch']}, B={ls['batch']}): "
              f"{ls['leaf_scatter_ms']:.3f} ms of {ls['em_statistics_ms']:.3f}"
              f" ms em_statistics ({100 * ls['scatter_fraction']:.2f}%) "
              f"[{card}]")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- mixture, the pools at C = 32
        pools = {}

        def inspect(mix, nets, reg):
            if mix.num_components != 32:
                return
            held = [reg.pools(m) for m in [mix] + nets]
            flat = [tuple(h) for hs in held for h in hs]
            if any(len(hs) != 1 for hs in held) or len(set(flat)) != len(flat):
                raise AssertionError(
                    f"bench mixture C=32: pools a step program "
                    f"{[len(hs) for hs in held]}, {len(set(flat))} distinct")
            pools["bytes"] = [reg.pool_bytes(m) for m in [mix] + nets]
            pools["ids"] = set(flat)

        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep = mixture_bench.main(
            out=os.path.join(out_dir, "BENCH_torch_mixture.json"),
            device=dev, inspect=inspect)
        out["seconds"]["mixture"] = time.perf_counter() - t0
        if not rep:
            raise AssertionError("bench mixture: the parity gate failed")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left = set(pool_segments()) & pools["ids"]
        if not pools.get("bytes") or left:
            raise AssertionError(f"bench mixture C=32: pools {pools}, still "
                                 f"held after the cell: {left}")
        out["reports"]["mixture"] = rep
        for row in rep["results"]:
            print(f"bench mixture {row['cell']}: one mixture step program "
                  f"{row['vmapped_ms_per_step']:.2f} ms/step, a loop of "
                  f"{row['num_components']} step programs "
                  f"{row['looped_ms_per_step']:.2f} ms/step "
                  f"({row['speedup']:.2f}x); parameter parity "
                  f"{row['param_parity_max_abs_diff']:.3e} [{card}]")
        mb = [b / 2 ** 20 for b in pools["bytes"]]
        print(f"bench mixture C=32 pools: {len(mb)} step programs (the "
              f"mixture's and 32 loop models'), one pool each, all distinct: "
              f"mixture {mb[0]:.2f} MiB, loop models {min(mb[1:]):.2f}-"
              f"{max(mb[1:]):.2f} MiB ({sum(mb[1:]):.1f} MiB together); all "
              f"released after the cell [{card}]")
        # ---- eval
        t0 = time.perf_counter()
        rep = eval_bench.main(
            out=os.path.join(out_dir, "BENCH_torch_eval.json"), device=dev)
        out["seconds"]["eval"] = time.perf_counter() - t0
        if not rep:
            raise AssertionError("bench eval: parity mismatches")
        out["reports"]["eval"] = rep
        print(f"bench eval {rep['arch']}: engine {rep['engine_rows_per_s']:.1f}"
              f" rows/s, dense direct {rep['direct_rows_per_s']:.1f} rows/s "
              f"({rep['engine_vs_direct']:.3f}x), inpainting "
              f"{rep['inpaint_requests_per_s']:.1f} req/s, parity mismatches "
              f"{rep['parity_mismatches']} [{card}]")
    finally:
        obs.configure(trace=False)
    torch.cuda.synchronize()
    out["counts"] = counts_of(ops)
    out["shapes"] = collections.Counter(SHAPES)
    out["gather_shapes"] = collections.Counter(GATHER_SHAPES)
    print("bench phase launches: " + ", ".join(
        f"{k} {v}" for k, v in out["counts"].items()) + f" [{card}]")
    if not all(out["counts"].values()):
        raise AssertionError(f"bench phase: a kernel never ran: "
                             f"{out['counts']}")

    # ---- the trace and the metrics, by obs.check
    trace = obs.export_trace(os.path.join(out_dir, "trace.json"))
    metrics = os.path.join(out_dir, "metrics.json")
    with open(metrics, "w") as f:
        json.dump(obs.METRICS.snapshot(), f)
    problems = (check_lib.validate_trace(
        trace, ("serve.", "plan.", "compile.", "bench.", "eval."))
        + check_lib.validate_metrics_file(metrics))
    if problems:
        raise AssertionError(f"bench phase trace/metrics: {problems[:5]}")
    n_events = obs.num_events()
    print(f"bench phase trace: {n_events} events ({obs.dropped_events()} "
          f"dropped), {sum(1 for e in obs.trace_events() if e['name'] == 'plan.segment')}"
          f" plan.segment spans; trace and metrics valid by obs.check "
          f"[{card}]")
    obs.reset()

    # ---- slo --check, dryrun --verify
    if slo_check:
        bench_slo_check([out_dir])
    t0 = time.perf_counter()
    if dryrun.main(["--verify", "--all", "--health-dir",
                    os.path.join(out_dir, "health")]) != 0:
        raise AssertionError("dryrun --verify failed")
    out["seconds"]["dryrun --verify"] = time.perf_counter() - t0
    print(f"dryrun --verify: {len(REGISTRY)} archs clean, health probes on "
          f"the card [{card}]")
    print("bench phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()) + f" [{card}]")
    return out


def bench_slo_check(dirs) -> None:
    """``python -m repro_torch.obs.slo --check`` against slo_torch.json on
    each bench directory (the serve-only einet_pd one included); raises on
    any breach."""
    from repro_torch.obs import slo as slo_lib

    slo = os.path.join(ROOT, "slo_torch.json")
    bad = []
    for d in dirs:
        for sub in (d, os.path.join(d, BENCH_SERVE_ARCHS[1])):
            if slo_lib.main(["--check", "--dir", sub, "--slo", slo]):
                bad.append(sub)
    if bad:
        raise AssertionError(f"slo --check failed in {bad}")


def bench_only() -> int:
    """``--bench``: builds the kernels and runs the production-bench phase
    BENCH_RUNS times (into chiprun_out/bench/run<i>), then ``slo --check``
    on every run: the calibration of slo_torch.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops

    build.build(force=True)
    card = smi_line()
    print(f"card: {card}")
    record_shapes(ops.log_einsum_exp)
    record_shapes(ops.log_einsum_exp_bwd)
    record_gather_shapes(ops.gather_grouped_log_einsum_exp)
    record_gather_shapes(ops.gather_grouped_log_einsum_exp_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = []
    for i in range(BENCH_RUNS):
        t0 = time.perf_counter()
        d = os.path.join(BENCH_DIR, f"run{i}")
        bench_phase(card, torch.device("cuda"), d, slo_check=False)
        dirs.append(d)
        print(f"bench phase run {i}: {time.perf_counter() - t0:.3f} s "
              f"[{card}]")
    bench_slo_check(dirs)
    print(card)
    return 0


def assert_ll(got, want, what: str) -> float:
    """LLs within rtol 1e-5, atol 1e-4 (any device; compared on the CPU);
    returns the max |diff|."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    d = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"{what}: max |diff| {d:.3e} beyond rtol 1e-5, "
                             "atol 1e-4")
    return d


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
    from repro_torch.core.layers import NEG_INF, log_mix_exp, stabilized_frame
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.grouped import (
        gather_grouped_log_einsum_exp_bwd_cuda,
        gather_grouped_log_einsum_exp_bwd_plain,
        gather_grouped_log_einsum_exp_cuda, gather_grouped_log_einsum_exp_plain,
        grouped_log_einsum_exp_bwd_cuda, grouped_log_einsum_exp_bwd_plain,
        grouped_log_einsum_exp_cuda, grouped_log_einsum_exp_plain,
        bwd_geometry, bwd_partial_bytes, fwd_geometry, gather_bwd_geometry,
        gather_bwd_partial_bytes, gather_fwd_geometry)
    from repro_torch.kernels.log_einsum_exp import (
        dw_geometry, dw_partial_bytes, dw_splits, launch_geometry,
        log_einsum_exp_bwd_cuda, log_einsum_exp_bwd_plain,
        log_einsum_exp_cuda, log_einsum_exp_plain)
    from repro_torch.data import load_image_dataset, to_domain
    from repro_torch.data.datasets import (
        SPECS, array_loader, procedural_images)
    from repro_torch.mixture.train import KMEANS_MINIBATCH_THRESHOLD
    from repro_torch.launch.cells import build_einet, build_mixture
    from repro_torch.launch.train import (
        batch_at, synthetic_pd_data, synthetic_rat_data)
    from repro_torch.mixture import (
        EiNetMixture, MixtureTrainConfig, blend_mixture_params, kmeans,
        make_mixture_em_step, mixture_em_statistics, mixture_m_step,
        prepare_mixture_training)
    from repro_torch import compile as compile_lib
    from repro_torch.serve import (
        ServeEngine, legacy_call, mixed_requests, mixture_requests, parity)
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

    record_shapes(ops.log_einsum_exp)
    record_shapes(ops.log_einsum_exp_bwd)
    record_gather_shapes(ops.gather_grouped_log_einsum_exp)
    record_gather_shapes(ops.gather_grouped_log_einsum_exp_bwd)

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
        return stabilized_frame(ln_l, ln_r)[2:]

    # The yardsticks' forwards (the port never calls them): a pair's
    # contraction as one torch.einsum on the stabilised frame, a canonical
    # run as the chain of those, a gather run as that chain on gathered
    # children plus log_mix_exp for its mixing.  Autograd through them is
    # the backward kernels' yardstick.
    def einsum_pair(w, ln_l, ln_r):
        a, ap, el, er = stabilized_frame(ln_l, ln_r)
        return a + ap + torch.log(
            torch.einsum("lkij,bli,blj->blk", w, el, er))

    def einsum_chain(ws_, x):
        for w in ws_:
            x = einsum_pair(w, x[:, :w.shape[0]], x[:, w.shape[0]:
                                                    2 * w.shape[0]])
        return x

    def einsum_gather(tables, ws_, vs_, x):
        buf, vi = x, 0
        for t in range(tables.num_depths):
            s = einsum_pair(ws_[t], buf[:, list(tables.left[t])],
                            buf[:, list(tables.right[t])])
            if tables.mix_child[t] is not None:
                mask = torch.tensor(tables.mix_mask[t], dtype=torch.float32,
                                    device=x.device)
                child = torch.tensor(tables.mix_child[t], device=x.device)
                s = torch.cat([s, log_mix_exp(vs_[vi], s[:, child], mask)], 1)
                vi += 1
            buf = torch.cat([buf, s], 1)
        return buf[:, x.shape[1]:]

    def k1_chain(ws_, x):
        """The per-layer plan's K1 launches over a canonical run."""
        for w in ws_:
            h = w.shape[0]
            x = log_einsum_exp_cuda(w, x[:, :h], x[:, h: 2 * h])
        return x

    def k1_chain_ms(pairs, **kw):
        return sum(time_ms(lambda w=w, l=l, r=r: log_einsum_exp_cuda(w, l, r),
                           **kw) for w, l, r in pairs)

    def check_k3_bits(ws_, x, got, what, alone):
        """K3's output equals the per-layer K1 chain's and a second call's
        bit for bit, and a row computed alone equals that row in the
        batch."""
        if not torch.equal(got, k1_chain(ws_, x)):
            raise AssertionError(f"{what}: differs from the per-layer K1 "
                                 "chain")
        if not torch.equal(got, grouped_log_einsum_exp_cuda(ws_, x)):
            raise AssertionError(f"{what}: two calls differ")
        for b in alone:
            if not torch.equal(got[b: b + 1], grouped_log_einsum_exp_cuda(
                    ws_, x[b: b + 1])):
                raise AssertionError(f"{what}: row {b} alone differs from the "
                                     f"same row in a batch of {x.shape[0]}")

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
        k1_err = 0.0
        for i, (w, l, r) in enumerate(inputs):
            got = log_einsum_exp_cuda(w, l, r)
            k1_err = max(k1_err, assert_close(
                got, log_einsum_exp_plain(w, l, r), f"K1 pair {i}"))
        # K3 at einet_rat's fused run [0, 4): against its plain version,
        # and bit for bit against the per-layer K1 launches it fuses, two
        # calls of its own, and each row computed alone
        got = grouped_log_einsum_exp_cuda(ws, leaf)
        k3_err = assert_close(
            got, grouped_log_einsum_exp_plain(ws, leaf), "K3 fused[0,4)")
        check_k3_bits(ws, leaf, got, "K3 einet_rat fused[0,4)",
                      (0, 1, 3, 37, 200, b_full - 1))
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
            # the per-layer plan's K1 launches at the same pairs: what the
            # fused kernel has to beat (not a yardstick)
            "chain_ms": k1_chain_ms(inputs),
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
        # K1's other register tiles and ragged K_out tiles: K = 64 (the
        # per-layer einet_rat_large), K_out below, between and above the
        # 8-output tile, one row
        for k, k_out, b in PAIR_EXTRA:
            w = rand_w(6, k_out, k)
            x = rand_x(b, 12, k) if b > 3 else rand_x(b + 4, 12, k)[4:]
            assert_close(log_einsum_exp_cuda(w, x[:, :6], x[:, 6:]),
                         log_einsum_exp_plain(w, x[:, :6], x[:, 6:]),
                         f"K1 K={k} K_out={k_out} B={b}",
                         exact=((0,), (1, 0), (3, 0)) if b > 3 else ())
        torch.cuda.synchronize()
    k3_outs = tuple(w.shape[1] for w in ws)
    print(f"forward kernels: K1 and K3 agree with their plain versions "
          f"(rtol={RTOL}, atol={ATOL}); einet_rat max|diff| K1 {k1_err:.3e}, "
          f"K3 {k3_err:.3e}; K3 at einet_rat's fused[0,4) B={b_full} equals "
          f"the per-layer K1 chain and a second call bit for bit, and rows "
          f"computed alone the same rows in the batch; K3 geometry "
          f"{fwd_geometry(len(ws), model.K, k3_outs, b_full, ws[-1].shape[0])}"
          f" [{card}]")

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
        """torch.autograd.grad through ``fn``, a forward whose contraction
        is one torch.einsum a depth (einsum_pair): the same gradients by
        autodiff, forward pass included."""
        req = [p.detach().clone().requires_grad_(True) for p in params]

        def run():
            with torch.enable_grad():
                return torch.autograd.grad(fn(*req), req, g)
        return run

    with torch.no_grad():
        k2_w_errs, k2_x_errs = [], []
        for i, (w, l, r) in enumerate(inputs):
            g = rand_g(b_full, w.shape[0], w.shape[1])
            errs = check_k2(w, l, r, g, f"K2 pair {i}")
            k2_w_errs.append(errs[0])
            k2_x_errs += errs[1:]
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
                lambda x, *w: einsum_chain(w, x), (leaf, *ws), g_out)),
            "bytes": n_bytes, "flops": flops,
            # the per-layer plan's K2 launches at the same pairs: what the
            # fused kernel has to beat (not a yardstick)
            "chain_ms": sum(
                time_ms(lambda w=w, l=l, r=r, g=rand_g(
                    b_full, w.shape[0], w.shape[1]):
                    log_einsum_exp_bwd_cuda(w, l, r, g))
                for w, l, r in inputs),
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
        for k, k_out, b in PAIR_EXTRA:
            w = rand_w(6, k_out, k)
            x = rand_x(b, 12, k) if b > 3 else rand_x(b + 4, 12, k)[4:]
            errs = check_k2(w, x[:, :6], x[:, 6:], rand_g(b, 6, k_out),
                            f"K2 K={k} K_out={k_out} B={b}")
            k2_w_errs.append(errs[0])
            k2_x_errs += errs[1:]
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

    # row independence: a row computed alone is bitwise the same row inside
    # a batch of 512 (K1's output, K2's gl and gr), at K = 10 and K = 40
    with torch.no_grad():
        alone_rows = (0, 1, 3, 37, 200, 511)
        for k in (10, 40):
            for k_out in (k, 1):
                w = rand_w(6, k_out, k)
                x = rand_x(512, 12, k)
                l, r = x[:, :6], x[:, 6:]
                g = rand_g(512, 6, k_out)
                out = log_einsum_exp_cuda(w, l, r)
                _, gl, gr = log_einsum_exp_bwd_cuda(w, l, r, g)
                for b in alone_rows:
                    one = slice(b, b + 1)
                    _, gl1, gr1 = log_einsum_exp_bwd_cuda(
                        w, l[one], r[one], g[one].contiguous())
                    if not (torch.equal(out[one], log_einsum_exp_cuda(
                            w, l[one], r[one])) and torch.equal(gl[one], gl1)
                            and torch.equal(gr[one], gr1)):
                        raise AssertionError(
                            f"K1/K2 K={k} K_out={k_out}: row {b} alone "
                            "differs from the same row in a batch of 512")
        torch.cuda.synchronize()
    print(f"row independence: K1's output and K2's gl, gr of rows "
          f"{alone_rows} computed alone are bitwise equal to the same rows "
          f"in a batch of 512, at K=10 and K=40, K_out=K and 1 [{card}]")
    # K4's gx at einet_rat's fused run: a row alone against the same row in
    # a batch of 2048
    with torch.no_grad():
        k4_alone = (0, 1, 3, 37, 200, 2047)
        x = rand_x(b_full, leaf.shape[1], model.K)
        g = rand_g(b_full, ws[-1].shape[0], ws[-1].shape[1])
        _, gx = grouped_log_einsum_exp_bwd_cuda(ws, x, g)
        for b in k4_alone:
            one = slice(b, b + 1)
            _, gx1 = grouped_log_einsum_exp_bwd_cuda(ws, x[one],
                                                     g[one].contiguous())
            if not torch.equal(gx[one], gx1):
                raise AssertionError(f"K4 einet_rat fused[0,4): row {b} "
                                     f"alone differs from the same row in "
                                     f"a batch of {b_full}")
        torch.cuda.synchronize()
    k_outs = tuple(w.shape[1] for w in ws)
    print(f"row independence: K4's gx of rows {k4_alone} computed alone is "
          f"bitwise equal to the same rows in a batch of {b_full} (einet_rat "
          f"fused[0,4)); K4 geometry there "
          f"{bwd_geometry(len(ws), model.K, k_outs, b_full, ws[-1].shape[0])}"
          f", dW partials "
          f"{bwd_partial_bytes(len(ws), model.K, k_outs, b_full, ws[-1].shape[0])}"
          f" B [{card}]")

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
        # K5's new rows equal, bit for bit, the rows K6's recompute writes,
        # and a row computed alone equals that row in the batch
        k5_out = gather_grouped_log_einsum_exp_cuda(pd_tab, pd_ws, pd_vs,
                                                    pd_leaf)
        if not torch.equal(k5_out, gather_grouped_log_einsum_exp_bwd_cuda(
                pd_tab, pd_ws, pd_vs, pd_leaf, pd_g, keep_rows=True)[3]):
            raise AssertionError("K5 einet_pd gather[0,2): differs from K6's "
                                 "recompute")
        k5_alone = (0, 1, 3, 37, 200, b_pd - 1)
        for b in k5_alone:
            if not torch.equal(k5_out[b: b + 1],
                               gather_grouped_log_einsum_exp_cuda(
                                   pd_tab, pd_ws, pd_vs, pd_leaf[b: b + 1])):
                raise AssertionError(f"K5 einet_pd gather[0,2): row {b} alone "
                                     f"differs from the same row in a batch "
                                     f"of {b_pd}")
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
        # times at einet_pd's run (B = 512 and the serve bucket B = 64);
        # the yardstick is each depth's contraction as torch.einsum on its
        # stabilised frame plus its mixing as log_mix_exp (one call each,
        # summed): no single call computes K5.  The per-layer plan's
        # launches at the same pairs (K1, and log_mix_exp) and its K2
        # launches stand beside K5 and K6.
        n_w = sum(w.numel() for w in pd_ws) + sum(v.numel() for v in pd_vs)
        k5_rows = []
        for b_row in (b_pd, 64):
            x_row = pd_leaf[:b_row]
            yard, fchain, chain, buf = 0.0, 0.0, 0.0, x_row
            for t, w in enumerate(pd_ws):
                lr = (buf[:, list(pd_tab.left[t])],
                      buf[:, list(pd_tab.right[t])])
                f = frame(*lr)
                yard += time_ms(lambda w=w, f=f: torch.einsum(
                    "lkij,bli,blj->blk", w, f[0], f[1]))
                fchain += k1_chain_ms([(w, *lr)])
                if b_row == b_pd:
                    chain += time_ms(lambda w=w, lr=lr, g=rand_g(
                        b_pd, w.shape[0], pd.K): log_einsum_exp_bwd_cuda(
                            w, *lr, g))
                sv = log_einsum_exp_plain(w, *lr)
                if pd_tab.mix_child[t] is not None:
                    child = torch.tensor(pd_tab.mix_child[t], device=dev)
                    mask = torch.tensor(pd_tab.mix_mask[t],
                                        dtype=torch.float32, device=dev)
                    ln = sv[:, child]
                    mix_ms = time_ms(lambda ln=ln, mask=mask: log_mix_exp(
                        pd_vs[0], ln, mask))
                    yard += mix_ms
                    fchain += mix_ms
                    sv = torch.cat([sv, log_mix_exp(pd_vs[0], ln, mask)], 1)
                buf = torch.cat([buf, sv], 1)
            n_new = b_row * pd_tab.num_new_rows * pd.K
            k5_rows.append({
                "shape": f"B={b_row} x={tuple(x_row.shape)} "
                         f"cells={[len(l) for l in pd_tab.left]} K={pd.K}",
                "ms": time_ms(lambda x_row=x_row:
                              gather_grouped_log_einsum_exp_cuda(
                                  pd_tab, pd_ws, pd_vs, x_row)),
                "plain_ms": time_ms(lambda x_row=x_row:
                                    gather_grouped_log_einsum_exp_plain(
                                        pd_tab, pd_ws, pd_vs, x_row)),
                "einsum_chain_ms": yard,
                "chain_ms": fchain,
                "bytes": 4 * (x_row.numel() + n_w + n_new),
                "flops": sum(2 * b_row * len(l) * pd.K ** 3
                             for l in pd_tab.left),
            })
            if b_row == b_pd:
                k6_chain = chain
        k5_row = k5_rows[0]
        # K6 at B = 512 and at B = 64, the hard mixture step's rows a
        # component (K5 and K6 also held against their plain versions there)
        k6_rows = []
        for k5r, b_row in zip(k5_rows, (b_pd, 64)):
            x_row, g_row = pd_leaf[:b_row], pd_g[:b_row].contiguous()
            if b_row != b_pd:
                what = f"einet_pd gather[0,2) B={b_row}"
                k5_err = max(k5_err, check_k5(pd_tab, pd_ws, pd_vs, x_row,
                                              f"K5 {what}"))
                errs, e = check_k6(pd_tab, pd_ws, pd_vs, x_row, g_row,
                                   f"K6 {what}")
                k6_w_errs += errs
                k6_x_errs.append(e)
            k6_rows.append({
                "shape": k5r["shape"],
                "ms": time_ms(lambda x_row=x_row, g_row=g_row:
                              gather_grouped_log_einsum_exp_bwd_cuda(
                                  pd_tab, pd_ws, pd_vs, x_row, g_row)),
                "plain_ms": time_ms(lambda x_row=x_row, g_row=g_row:
                                    gather_grouped_log_einsum_exp_bwd_plain(
                                        pd_tab, pd_ws, pd_vs, x_row, g_row)),
                "library_ms": time_ms(autograd_yardstick(
                    lambda x, *wv: einsum_gather(pd_tab, wv[:2], wv[2:], x),
                    (x_row, *pd_ws, *pd_vs), g_row)),
                "bytes": 4 * (2 * x_row.numel() + g_row.numel() + 2 * n_w),
                "flops": sum(b_row * len(l) * (6 * pd.K ** 3 + 4 * pd.K ** 2)
                             for l in pd_tab.left),
            })
        k6_row = k6_rows[0]
        k6_row["chain_ms"] = k6_chain
        # K6's gx: a row alone against the same row in a batch of 512
        k6_alone = (0, 1, 3, 37, 200, b_pd - 1)
        x = rand_x(b_pd, pd_tab.num_in_rows, pd.K)
        g = rand_g(b_pd, pd_tab.num_new_rows, pd.K)
        gx = gather_grouped_log_einsum_exp_bwd_cuda(pd_tab, pd_ws, pd_vs, x,
                                                    g)[2]
        for b in k6_alone:
            one = slice(b, b + 1)
            gx1 = gather_grouped_log_einsum_exp_bwd_cuda(
                pd_tab, pd_ws, pd_vs, x[one], g[one].contiguous())[2]
            if not torch.equal(gx[one], gx1):
                raise AssertionError(f"K6 einet_pd gather[0,2): row {b} alone "
                                     f"differs from the same row in a batch "
                                     f"of {b_pd}")
        torch.cuda.synchronize()
    with torch.no_grad():
        parts = {
            "K6 einet_pd gather[0,2) B=512": kernel_parts(
                lambda: gather_grouped_log_einsum_exp_bwd_cuda(
                    pd_tab, pd_ws, pd_vs, pd_leaf, pd_g)),
            f"K4 einet_rat fused[0,4) B={b_full}": kernel_parts(
                lambda: grouped_log_einsum_exp_bwd_cuda(ws, leaf, g_out)),
            f"K5 einet_pd gather[0,2) B={b_pd}": kernel_parts(
                lambda: gather_grouped_log_einsum_exp_cuda(
                    pd_tab, pd_ws, pd_vs, pd_leaf)),
            f"K3 einet_rat fused[0,4) B={b_full}": kernel_parts(
                lambda: grouped_log_einsum_exp_cuda(ws, leaf)),
        }
    for what, rows in parts.items():
        print(f"{what}, device time by kernel (torch.profiler, 10 calls): "
              + "; ".join(f"{n} x{c:g} {us:.1f} us" for n, c, us in rows)
              + f"; sum {sum(r[2] for r in rows):.1f} us a call [{card}]")
    k6_part = gather_bwd_partial_bytes(pd_tab, pd.K, b_pd)
    print(f"gather kernels: K5 and K6 agree with their plain versions and "
          f"are bitwise deterministic over two calls; K5 max |diff| "
          f"{k5_err:.3e} (rtol=atol={RTOL}); K6 input gradients max |diff| "
          f"{worst(k6_x_errs, 'abs'):.3e}, weight and mixing gradients max "
          f"|diff| {worst(k6_w_errs, 'abs'):.3e} (relative to max|gw| "
          f"{worst(k6_w_errs, 'rel'):.3e}); einet_pd B={b_pd}: K5 depth by "
          f"depth, K1 (tile, subtiles) per depth "
          f"{gather_fwd_geometry(pd_tab, pd.K, b_pd)} (B=64: "
          f"{gather_fwd_geometry(pd_tab, pd.K, 64)}), its new rows equal "
          f"K6's recompute bit for bit and rows {k5_alone} computed alone "
          f"the same rows in the batch; K6 depth by depth, "
          f"K1 (tile, subtiles) and K2 (tile, subtiles, JT, K_out tile, "
          f"batch splits) per depth "
          f"{gather_bwd_geometry(pd_tab, pd.K, b_pd)}, dW partials "
          f"{k6_part} B = {k6_part / 2 ** 20:.1f} MiB; K6's gx of "
          f"rows {k6_alone} computed alone is bitwise equal to the same rows "
          f"in a batch of {b_pd} [{card}]")

    # -------------------------------------------------------- serve phase
    reqs = mixed_requests(model.num_vars, 256, seed=0)
    engine = ServeEngine(model, max_batch=64)
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = counts_of(ops)
    serve_shapes = collections.Counter(SHAPES)
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
    call = legacy_call(model)
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
    data = torch.from_numpy(synthetic_rat_data(model.num_vars))
    data_dev = data.to(dev)
    xb = data_dev[:b_full]
    em_cfg = em.EMConfig()
    model_pl = build_einet(cfg, device=dev, seed=0, grouped=False)
    reset(ops)
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
        # the step op by op, so that the launch counters see every step
        # (a graph replay launches through no wrapper; the training-graph
        # phase holds the graph steps against these)
        step = eager_em_step(m, TrainConfig(mode=mode))
        reset(ops)
        lls, times = [], []
        for i in range(steps):
            x = batches(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lls.append(step(x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = counts_of(ops)
        shapes = collections.Counter(SHAPES)
        if any(got[k] != want.get(k, 0) * steps for k in got):
            raise AssertionError(
                f"{mode} EM: launches {got} in {steps} steps, expected "
                f"{want} a step")
        if not all(np.isfinite(lls)):
            raise AssertionError(f"{mode} EM: LL {lls}")
        return {"lls": lls, "median_ms": sorted(times)[len(times) // 2] * 1e3,
                "counts": got, "shapes": shapes}

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
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pd_served = pd_engine.run(pd_reqs)
    torch.cuda.synchronize()
    pd_serve_s = time.perf_counter() - t0
    pd_serve_counts = counts_of(ops)
    pd_serve_shapes = collections.Counter(SHAPES)
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
    call = legacy_call(pd)
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
        reset(ops)
        pd_ll_plan = pd.log_likelihood(pd_xb)
        torch.cuda.synchronize()
        pd_plan_counts = counts_of(ops)
        reset(ops)
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
    reset(ops)
    pd_stats = em.em_statistics(pd, pd_xb)
    torch.cuda.synchronize()
    pd_estep_counts = counts_of(ops)
    pd_stats2 = em.em_statistics(pd, pd_xb)
    reset(ops)
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
        big_geo = (2, big.K, (big.K, big.K), big_leaf.shape[0],
                   big_ws[-1].shape[0])
        got = grouped_log_einsum_exp_cuda(big_ws, big_leaf)
        big_k3_err = assert_close(
            got, grouped_log_einsum_exp_plain(big_ws, big_leaf),
            "K3 einet_rat_large fused[0,2)")
        check_k3_bits(big_ws, big_leaf, got, "K3 einet_rat_large fused[0,2)",
                      (0, big_leaf.shape[0] - 1))
        big_g = rand_g(*got.shape)
        errs = check_k4(big_ws, big_leaf, big_g, "K4 einet_rat_large fused[0,2)")
        big_k4_w, big_k4_x = errs[:-1], errs[-1]
        big_k3_ms = time_ms(lambda: grouped_log_einsum_exp_cuda(
            big_ws, big_leaf), iters=5, warmup=1)
        big_k3_geo = fwd_geometry(2, big.K, (big.K, big.K), big_leaf.shape[0],
                                  big_ws[-1].shape[0])
        big_k4_ms = time_ms(lambda: grouped_log_einsum_exp_bwd_cuda(
            big_ws, big_leaf, big_g), iters=5, warmup=1)
        # the same run as a row of K4's report (no launches on the main
        # paths); its per-layer K2 chain runs on the plain forward's inputs
        big_in, cur = [], big_leaf
        for w in big_ws:
            h = w.shape[0]
            big_in.append((w, cur[:, :h], cur[:, h: 2 * h]))
            cur = log_einsum_exp_plain(*big_in[-1])
        b_big = big_leaf.shape[0]
        k3_big_row = {
            "shape": f"B={b_big} x={tuple(big_leaf.shape)} G=2 "
                     f"K_out={[w.shape[1] for w in big_ws]} (einet_rat_large)",
            "ms": big_k3_ms,
            "plain_ms": time_ms(lambda: grouped_log_einsum_exp_plain(
                big_ws, big_leaf), iters=1, warmup=0),
            "einsum_chain_ms": sum(time_ms(
                lambda w=w, f=frame(l, r): torch.einsum(
                    "lkij,bli,blj->blk", w, f[0], f[1]), iters=2, warmup=1)
                for w, l, r in big_in),
            "chain_ms": k1_chain_ms(big_in, iters=2, warmup=1),
            "bytes": 4 * (big_leaf.numel() + sum(w.numel() for w in big_ws)
                          + got.numel()),
            "flops": sum(2 * b_big * w.shape[0] * w.shape[1] * w.shape[2] ** 2
                         for w in big_ws),
            "launches": 0,
        }
        k4_big_row = {
            "shape": f"B={b_big} x={tuple(big_leaf.shape)} G=2 "
                     f"K_out={[w.shape[1] for w in big_ws]} (einet_rat_large)",
            "ms": big_k4_ms,
            "plain_ms": time_ms(lambda: grouped_log_einsum_exp_bwd_plain(
                big_ws, big_leaf, big_g), iters=1, warmup=0),
            "library_ms": time_ms(autograd_yardstick(
                lambda x, *w: einsum_chain(w, x), (big_leaf, *big_ws), big_g),
                iters=2, warmup=1),
            "chain_ms": sum(time_ms(
                lambda w=w, l=l, r=r, g=rand_g(b_big, w.shape[0], w.shape[1]):
                log_einsum_exp_bwd_cuda(w, l, r, g), iters=2, warmup=1)
                for w, l, r in big_in),
            "bytes": 4 * (2 * big_leaf.numel() + big_g.numel()
                          + 2 * sum(w.numel() for w in big_ws)),
            "flops": sum(b_big * w.shape[0] * (6 * w.shape[2] ** 2
                                                * w.shape[1]
                                                + 4 * w.shape[2] ** 2)
                         for w in big_ws),
            "launches": 0,
        }
        del got, big_leaf, big_g, big_in, cur
    torch.cuda.empty_cache()
    x256 = big_data[:256]
    with torch.inference_mode():
        reset(ops)
        ll_plan = big.log_likelihood(x256)
        torch.cuda.synchronize()
        big_counts = counts_of(ops)
        big_ll_ms = time_ms(lambda: big.log_likelihood(x256), iters=3,
                            warmup=1)
    del big
    torch.cuda.empty_cache()
    big_pl = build_einet(big_cfg, device=dev, seed=0, grouped=False)
    with torch.inference_mode():
        reset(ops)
        ll_layer = big_pl.log_likelihood(x256)
        torch.cuda.synchronize()
        big_pl_counts = counts_of(ops)
        big_pl_ll_ms = time_ms(lambda: big_pl.log_likelihood(x256), iters=3,
                               warmup=1)
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
    print(f"einet_rat_large (K=64) fused[0,2) B=64: K4 geometry "
          f"{bwd_geometry(*big_geo)}, dW partials "
          f"{bwd_partial_bytes(*big_geo)} B [{card}]")
    print(f"einet_rat_large (K=64) fused[0,2) B=64: K3 {big_k3_ms:.3f} ms "
          f"(max |diff| {big_k3_err:.3e}; equal to the per-layer K1 chain "
          f"and a second call bit for bit, rows alone too; geometry "
          f"{big_k3_geo}), K4 {big_k4_ms:.3f} ms (gx max "
          f"|diff| {big_k4_x['abs']:.3e}, dW max |diff| / max|dW| "
          f"{max(e['rel'] for e in big_k4_w):.3e}); joint_ll B=256 through "
          f"the plan (K3 3, K1 1 launches) {big_ll_ms:.3f} ms, per layer (K1 "
          f"7) {big_pl_ll_ms:.3f} ms, max |diff| "
          f"{(ll_plan - ll_layer).abs().max().item():.3e}; model built in "
          f"{big_build_s:.1f} s [{card}]")

    # ---------------------------------------------- mixture phase (§4.2)
    # einet_celeba x 8: one shared structure, parameters stacked on a
    # component axis, trained on the procedural CelebA stand-in
    n_mix = 8
    mix_cfg = get_config("einet_celeba")
    t0 = time.perf_counter()
    mix = build_mixture(mix_cfg, n_mix, device=dev, seed=0)
    mix_build_s = time.perf_counter() - t0
    celeba = load_image_dataset("celeba", source="procedural")
    mix_data, _ = to_domain(celeba.train_x, "normal")
    mix_kinds = [(s.start, s.stop, s.kind) for s in mix.component.exec_plan]
    if mix_kinds != [(0, 2, "gather"), (2, 3, "layer")]:
        raise AssertionError(f"einet_celeba plan is {mix_kinds}")
    # k-means inside the hard-EM setup on the card, again on the card, and
    # on the CPU: one partition
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix_loader, km = prepare_mixture_training(mix, mix_data, seed=0,
                                              global_batch=512)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    km_card2 = kmeans(mix_data, n_mix, device=dev)
    t0 = time.perf_counter()
    km_cpu = kmeans(mix_data, n_mix, device="cpu")
    km_cpu_s = time.perf_counter() - t0
    if not (np.array_equal(km.assignments, km_card2.assignments)
            and np.array_equal(km.centers, km_card2.centers)):
        raise AssertionError("k-means: two card runs differ")
    if not np.array_equal(km.assignments, km_cpu.assignments):
        raise AssertionError(
            f"k-means: card and CPU partitions differ in "
            f"{int((km.assignments != km_cpu.assignments).sum())} rows")
    km_center_diff = float(np.abs(km.centers - km_cpu.centers).max())
    print(f"k-means einet_celeba x{n_mix} on {len(mix_data)} procedural "
          f"CelebA rows (D={mix_data.shape[1]}): counts "
          f"{km.counts.tolist()}, inertia {km.inertia:.6f}; the partition "
          f"equals a second card run's (centres bit for bit) and the CPU's "
          f"(centres max |diff| {km_center_diff:.3e}); card {km_s:.3f} s "
          f"with the mixture's init, CPU {km_cpu_s:.3f} s; mixture of "
          f"{mix.num_params()} parameters built in {mix_build_s:.2f} s "
          f"[{card}]")
    # k-means past the minibatch threshold (the contiguous-block minibatch
    # iterations prepare_mixture_training takes above it) on a procedural
    # CelebA set of KMEANS_BIG_ROWS rows: two card runs and the CPU
    big_u8, _ = procedural_images(SPECS["celeba"], KMEANS_BIG_ROWS, seed=2)
    big_km_data, _ = to_domain(big_u8, "normal")
    del big_u8
    km_big = {}
    for run_name, where in (("card", dev), ("card again", dev),
                            ("CPU", "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km_big[run_name] = kmeans(big_km_data, n_mix,
                                  batch=KMEANS_MINIBATCH_THRESHOLD,
                                  device=where)
        torch.cuda.synchronize()
        km_big[run_name + " s"] = time.perf_counter() - t0
    a, b, c = km_big["card"], km_big["card again"], km_big["CPU"]
    if not (np.array_equal(a.assignments, b.assignments)
            and np.array_equal(a.centers, b.centers)):
        raise AssertionError(f"k-means at {KMEANS_BIG_ROWS} rows: two card "
                             "runs differ")
    if not np.array_equal(a.assignments, c.assignments):
        raise AssertionError(
            f"k-means at {KMEANS_BIG_ROWS} rows: card and CPU partitions "
            f"differ in {int((a.assignments != c.assignments).sum())} rows")
    print(f"k-means past the minibatch threshold: {KMEANS_BIG_ROWS} "
          f"procedural CelebA rows (D={big_km_data.shape[1]}), C={n_mix}, "
          f"blocks of {KMEANS_MINIBATCH_THRESHOLD}: counts "
          f"{a.counts.tolist()}, inertia {a.inertia:.6f}; the partition "
          f"equals a second card run's (centres bit for bit) and the CPU's "
          f"(centres max |diff| "
          f"{float(np.abs(a.centers - c.centers).max()):.3e}); card "
          f"{km_big['card s']:.3f} / {km_big['card again s']:.3f} s, CPU "
          f"{km_big['CPU s']:.3f} s [{card}]")
    del big_km_data, km_big, a, b, c

    def mixture_run(mcfg, steps, batches, want, first=None):
        """``steps`` mixture EM steps with the launch counters set to 0
        just before and read just after; launches a step asserted against
        ``want``; ``first`` sees the parameters after step 0."""
        step = eager_mixture_step(mix, mcfg)
        xs = [batches(i) for i in range(steps)]
        torch.cuda.synchronize()
        reset(ops)
        lls, times = [], []
        for i, x in enumerate(xs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lls.append(step(x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0 and first is not None:
                first()
        got = counts_of(ops)
        shapes = collections.Counter(SHAPES)
        if any(got[k] != want.get(k, 0) * steps for k in got):
            raise AssertionError(
                f"mixture {mcfg.assign} {mcfg.mode} EM: launches {got} in "
                f"{steps} steps, expected {want} a step")
        if not all(np.isfinite(lls)):
            raise AssertionError(f"mixture EM: LL {lls}")
        return {"lls": lls, "median_ms": sorted(times)[len(times) // 2] * 1e3,
                "counts": got, "shapes": shapes}

    mix_want = {k: n_mix for k in (
        "gather_grouped_log_einsum_exp", "gather_grouped_log_einsum_exp_bwd",
        "log_einsum_exp", "log_einsum_exp_bwd")}
    # hard EM's first step, bit for bit, against 8 single-model steps of a
    # separate einet_celeba on the same batches
    x_hard0 = torch.from_numpy(mix_loader.batch_at(0)["x"]).to(dev)
    single = build_einet(mix_cfg, device=dev, seed=0)
    want_first = []
    for c in range(n_mix):
        em.load_params(single, mix.component_params(c))
        want_first.append(em.stochastic_em_update(single, x_hard0[c])[0])
    del single
    got_first = []
    hard = mixture_run(
        MixtureTrainConfig(assign="hard"), 10,
        lambda i: torch.from_numpy(mix_loader.batch_at(i)["x"]).to(dev),
        mix_want, first=lambda: got_first.extend(
            {k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
             for k, v in mix.component_params(c).items()}
            for c in range(n_mix)))
    for c in range(n_mix):
        if not all(torch.equal(a, b) for (_, a), (_, b) in zip(
                flat_stats(got_first[c]), flat_stats(want_first[c]))):
            raise AssertionError(f"hard mixture EM step 0, component {c}: "
                                 "differs from the single-model step")
    # the hard step at its own shape (B = 64 rows a component, einet_celeba's
    # tables, each component's weights): every component's E-step
    # statistics on the card against the CPU plain path, and K5 and K6 on
    # its leaf rows against their plain versions (K1 and K2 are held at
    # every shape the main paths launch them at, in the report below)
    mix_cpu = EiNetMixture(
        EiNet(mix.component.graph, num_sums=mix.component.K,
              num_classes=mix.component.num_classes,
              exponential_family=mix.component.ef, device="cpu"), n_mix)

    def mix_to_cpu():
        mix_cpu.load_state_dict({k: v.cpu()
                                 for k, v in mix.state_dict().items()})

    mix_to_cpu()
    b_hard = x_hard0.shape[1]
    hard_stat_atol = 1e-6 * b_hard
    hard_stats, hard_d_cpu = [], [0.0, 0.0]
    for c in range(n_mix):
        with mix.bound(c) as net:
            hard_stats.append(em.em_statistics(net, x_hard0[c]))
        with mix_cpu.bound(c) as net:
            d = compare_stats(hard_stats[c],
                              em.em_statistics(net, x_hard0[c].cpu()),
                              f"hard E-step einet_celeba component {c} "
                              f"B={b_hard} card vs CPU", 1e-4, hard_stat_atol)
        hard_d_cpu = [max(a, b) for a, b in zip(hard_d_cpu, d)]
    mix_tab = mix.component.exec_plan[0].tables
    hard_k5_err, hard_k6_w, hard_k6_x = 0.0, [], []
    with torch.no_grad():
        for c in range(n_mix):
            with mix.bound(c) as net:
                lr = net._leaf_rows(net.leaf_log_prob(x_hard0[c], None))
                ws_ = [net.einsum[t].detach() for t in range(2)]
                vs_ = [net.mixing[t].detach() for t in range(2)
                       if net.pair_specs[t].mix_global is not None]
            what = f"einet_celeba component {c} gather[0,2) B={b_hard}"
            hard_k5_err = max(hard_k5_err,
                              check_k5(mix_tab, ws_, vs_, lr, f"K5 {what}"))
            g = rand_g(b_hard, mix_tab.num_new_rows, mix.component.K)
            errs, e = check_k6(mix_tab, ws_, vs_, lr, g, f"K6 {what}")
            hard_k6_w += errs
            hard_k6_x.append(e)
    k6_w_errs += hard_k6_w
    k6_x_errs += hard_k6_x
    torch.cuda.synchronize()
    k5_err = max(k5_err, hard_k5_err)
    print(f"hard E-step einet_celeba x{n_mix} at B={b_hard} a component: "
          f"card vs CPU plain statistics max |diff| {hard_d_cpu[0]:.3e} (at "
          f"most {hard_d_cpu[1]:.3e} of a block's max; rtol 1e-4, atol "
          f"{hard_stat_atol:.1e}) for every component; K5 and K6 on each "
          f"component's weights and leaf rows agree with their plain versions "
          f"(two calls bitwise; K5 max |diff| {hard_k5_err:.3e}, K6 gx max "
          f"|diff| {worst(hard_k6_x, 'abs'):.3e}, dW and dV max |diff| / "
          f"max|want| {worst(hard_k6_w, 'rel'):.3e}) [{card}]")
    # where a hard step spends its time: per component, the leaf rows, the
    # E-step (leaf rows included) and the M-step with its blend

    def hard_stage(stage):
        def run():
            for c in range(n_mix):
                with mix.bound(c) as net:
                    if stage == "leaf":
                        with torch.no_grad():
                            net._leaf_rows(net.leaf_log_prob(x_hard0[c], None))
                    elif stage == "estep":
                        em.em_statistics(net, x_hard0[c])
                    else:
                        em.blend_params(net, em.params_of(net), em.m_step(
                            net, hard_stats[c], em_cfg), em_cfg.step_size)
        return time_ms(run, iters=5, warmup=1)

    hard_stages = {
        f"leaf rows ({n_mix} components)": hard_stage("leaf"),
        f"em_statistics ({n_mix} components, leaf rows included)":
            hard_stage("estep"),
        f"M-step + blend ({n_mix} components)": hard_stage("mstep"),
    }
    del got_first, want_first, x_hard0, hard_stats
    print(f"hard stochastic EM einet_celeba x{n_mix}, {mix_loader.per_host} "
          f"rows a component, 10 steps: median {hard['median_ms']:.3f} "
          f"ms/step, mean LL first {hard['lls'][0]:.4f}, last "
          f"{hard['lls'][-1]:.4f}, launches a step " + ", ".join(
              f"{k} {v // 10}" for k, v in hard["counts"].items() if v)
          + f"; step 0 bit for bit {n_mix} single-model stochastic_em_update "
          f"calls [{card}]")
    print("hard step stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in hard_stages.items()) + f" [{card}]")

    # the soft E-step: twice bitwise, and against the CPU plain path
    b_mix = 512
    soft_loader = array_loader(mix_data, b_mix)
    x_soft = torch.from_numpy(soft_loader.batch_at(0)["x"]).to(dev)
    reset(ops)
    mix_stats = mixture_em_statistics(mix, x_soft)
    torch.cuda.synchronize()
    mix_estep_counts = counts_of(ops)
    if any(mix_estep_counts[k] != mix_want.get(k, 0)
           for k in mix_estep_counts):
        raise AssertionError(f"soft E-step launches {mix_estep_counts}")
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_stats(mix_stats),
            flat_stats(mixture_em_statistics(mix, x_soft)))):
        raise AssertionError("soft mixture E-step: two calls differ")
    mix_to_cpu()
    t0 = time.perf_counter()
    mix_stats_cpu = mixture_em_statistics(mix_cpu, x_soft.cpu())
    mix_cpu_estep_s = time.perf_counter() - t0
    mix_stat_atol = 1e-6 * b_mix
    mix_d_cpu = compare_stats(mix_stats, mix_stats_cpu,
                              f"soft E-step einet_celeba x{n_mix} card vs "
                              "CPU", 1e-4, mix_stat_atol)
    print(f"soft E-step einet_celeba x{n_mix} B={b_mix} (K5 + K1 + K6 + K2 "
          f"{n_mix} each, bitwise equal over two calls) vs CPU plain: "
          f"statistics max |diff| {mix_d_cpu[0]:.3e} (at most "
          f"{mix_d_cpu[1]:.3e} of a block's max; rtol 1e-4, atol "
          f"{mix_stat_atol:.1e}; n_weight {mix_stats['n_weight'].sum():.3f} "
          f"= B); CPU E-step {mix_cpu_estep_s:.2f} s [{card}]")
    del mix_stats_cpu
    soft = mixture_run(
        MixtureTrainConfig(assign="soft"), 10,
        lambda i: torch.from_numpy(soft_loader.batch_at(i)["x"]).to(dev),
        mix_want)

    def mix_leaf_rows():
        with torch.no_grad():
            for c in range(n_mix):
                with mix.bound(c) as net:
                    net._leaf_rows(net.leaf_log_prob(x_soft, None))

    stats_now = mixture_em_statistics(mix, x_soft)
    mix_stages = {
        f"leaf rows ({n_mix} components)": time_ms(mix_leaf_rows, iters=5,
                                                   warmup=1),
        "mixture_em_statistics (leaf rows, forward, grad, leaf statistics)":
            time_ms(lambda: mixture_em_statistics(mix, x_soft), iters=5,
                    warmup=1),
        "M-step + blend": time_ms(lambda: blend_mixture_params(
            mix, mixture_m_step(mix, stats_now, em_cfg),
            em_cfg.step_size), iters=5, warmup=1),
    }
    del stats_now
    print(f"soft stochastic EM einet_celeba x{n_mix} B={b_mix}, 10 steps: "
          f"median {soft['median_ms']:.3f} ms/step, mean LL first "
          f"{soft['lls'][0]:.4f}, last {soft['lls'][-1]:.4f}, launches a "
          f"step " + ", ".join(f"{k} {v // 10}" for k, v in
                               soft["counts"].items() if v) + f" [{card}]")
    print("soft step stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in mix_stages.items()) + f" [{card}]")

    def busy_line(what, fn, wall_ms):
        """The device time of every CUDA kernel ``fn`` launches
        (torch.profiler, 3 calls) against its wall time: the idle share."""
        parts = kernel_parts(fn, calls=3)
        busy = sum(us for _, _, us in parts) / 1e3
        print(f"{what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
              f"(idle share {1 - busy / wall_ms:.3f}), "
              f"{sum(n for _, n, _ in parts):.0f} CUDA kernel launches a "
              f"call; largest " + ", ".join(
                  f"{name} {n:.0f}x {us:.1f} us" for name, n, us in parts[:4])
              + f" [{card}]")

    busy_line(f"soft E-step einet_celeba x{n_mix} B={b_mix}",
              lambda: mixture_em_statistics(mix, x_soft),
              mix_stages["mixture_em_statistics (leaf rows, forward, grad, "
                         "leaf statistics)"])
    mix_full = mixture_run(MixtureTrainConfig(assign="soft", mode="full"), 3,
                           lambda i: x_soft, mix_want)
    with torch.inference_mode():
        mix_full["lls"].append(mix.log_likelihood(x_soft).mean().item())
    for a, b in zip(mix_full["lls"], mix_full["lls"][1:]):
        if b < a - 1e-5 * abs(a):
            raise AssertionError(f"full soft mixture EM lowered the batch "
                                 f"LL: {mix_full['lls']}")
    print(f"full soft EM einet_celeba x{n_mix} B={b_mix}, 3 steps on one "
          f"batch: mean LL " + " -> ".join(
              f"{v:.4f}" for v in mix_full["lls"])
          + f" (non-decreasing) [{card}]")

    # mixture_joint_ll at B = 512, against the CPU plain path
    mix_to_cpu()
    with torch.inference_mode():
        reset(ops)
        mix_ll = mix.log_likelihood(x_soft)
        torch.cuda.synchronize()
        mix_ll_counts = counts_of(ops)
        mix_ll_shapes = collections.Counter(SHAPES)
        if (mix_ll_counts["gather_grouped_log_einsum_exp"],
                mix_ll_counts["log_einsum_exp"]) != (n_mix, n_mix) or any(
                v for k, v in mix_ll_counts.items() if k.endswith("_bwd")):
            raise AssertionError(f"mixture_joint_ll launches {mix_ll_counts}")
        mix_ll_cpu = mix_cpu.log_likelihood(x_soft.cpu())
        if not bool(torch.isfinite(mix_ll).all()) or not torch.allclose(
                mix_ll.cpu(), mix_ll_cpu, rtol=1e-5, atol=1e-4):
            raise AssertionError(
                f"mixture_joint_ll card vs CPU: max |diff| "
                f"{(mix_ll.cpu() - mix_ll_cpu).abs().max().item():.3e}")
        mix_ll_ms = time_ms(lambda: mix.log_likelihood(x_soft), iters=10)
        busy_line(f"mixture_joint_ll einet_celeba x{n_mix} B={b_mix}",
                  lambda: mix.log_likelihood(x_soft), mix_ll_ms)
    print(f"mixture_joint_ll einet_celeba x{n_mix} B={b_mix}: "
          f"{mix_ll_ms:.4f} ms a batch, launches " + ", ".join(
              f"{k} {v}" for k, v in mix_ll_counts.items() if v)
          + f"; card vs CPU plain max |diff| "
          f"{(mix_ll.cpu() - mix_ll_cpu).abs().max().item():.3e} (rtol "
          f"1e-5, atol 1e-4) [{card}]")
    del mix_cpu, mix_ll_cpu

    # serving: 256 requests over all ten mixture kinds
    mix_reqs = mixture_requests(mix, 256, seed=0)
    mix_engine = ServeEngine(mix, max_batch=64)
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix_served = mix_engine.run(mix_reqs)
    torch.cuda.synchronize()
    mix_serve_s = time.perf_counter() - t0
    mix_serve_counts = counts_of(ops)
    mix_serve_shapes = collections.Counter(SHAPES)
    if (mix_serve_counts["gather_grouped_log_einsum_exp"] == 0
            or mix_serve_counts["log_einsum_exp"] == 0
            or any(v for k, v in mix_serve_counts.items()
                   if k.endswith("_bwd") or k.startswith("grouped"))):
        raise AssertionError(f"mixture serve path launches {mix_serve_counts}")
    mix_steady = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mix_engine.run(mix_reqs)
        torch.cuda.synchronize()
        mix_steady.append(time.perf_counter() - t0)
    call = legacy_call(mix)
    mix_par = parity(mix_reqs, mix_served,
                     {r.req_id: call(r) for r in mix_reqs},
                     mix.value_kinds)
    resp_err = 0.0
    for r in mix_reqs:
        v = np.asarray(mix_served[r.req_id].value)
        if r.kind == "mixture_responsibility":
            want_shape = (n_mix,)
            resp_err = max(resp_err, abs(float(v.sum()) - 1.0))
        elif r.kind.endswith(("sample", "mpe")):
            want_shape = (mix.num_vars,)
        else:
            want_shape = ()
        if v.shape != want_shape or not np.isfinite(v).all():
            raise AssertionError(f"mixture request {r.req_id} ({r.kind}): "
                                 f"{v.shape}")
        if r.kind in ("mixture_conditional_sample", "mixture_mpe",
                      "mixture_component_sample", "mixture_component_mpe") \
                and not np.array_equal(v[r.evidence_mask],
                                       r.x[r.evidence_mask]):
            raise AssertionError(f"mixture request {r.req_id}: evidence "
                                 "changed")
    if mix_par["ll_max_abs_diff"] > 1e-5 or mix_par["sample_mismatches"]:
        raise AssertionError(f"mixture engine/direct parity violated: "
                             f"{mix_par}")
    if resp_err > 1e-6:
        raise AssertionError(f"responsibility rows sum to 1 within "
                             f"{resp_err:.3e}")
    with torch.inference_mode():
        x64 = torch.from_numpy(np.stack([r.x for r in mix_reqs[:64]])).to(dev)
        ev64 = torch.from_numpy(
            np.stack([r.evidence_mask for r in mix_reqs[:64]])).to(dev)
        seeds64 = [r.seed for r in mix_reqs[:64]]
        mpe64 = mix.conditional_sample_per_key(seeds64, x64, ev64,
                                               mode="argmax")
        for b in (0, 37, 63):
            alone = mix.conditional_sample_per_key(
                seeds64[b: b + 1], x64[b: b + 1], ev64[b: b + 1],
                mode="argmax")
            if not torch.equal(alone[0], mpe64[b]):
                raise AssertionError(f"mixture_mpe row {b} alone differs "
                                     "from the same row in a batch of 64")
    # all the requests of the steady passes over all their time
    mix_qps = len(mix_reqs) * len(mix_steady) / sum(mix_steady)
    print(f"mixture serve einet_celeba x{n_mix}: {len(mix_reqs)} requests "
          f"over all ten kinds, parity with direct one-request calls: LL and "
          f"responsibility max |diff| {mix_par['ll_max_abs_diff']:.3e}, "
          f"sampling/decode mismatches {mix_par['sample_mismatches']}; "
          f"responsibility rows sum to 1 within {resp_err:.1e}; mixture_mpe "
          f"rows alone equal theirs in a batch of 64 bit for bit [{card}]")
    mix_engine_steps = mix_engine.stats["steps"] // 3
    del mix_engine, mix_served, mix_stats
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- eval phase
    # the image-evaluation workbench end to end (repro_torch.eval): training,
    # bits per dim, Fig. 4 inpainting and sample grids, every query through
    # the engine and held bit for bit against direct one-row calls
    evals = eval_phase(card, dev)
    # K5 and K6 at every (tables, B) the eval runs launched them at (the
    # training batches, every engine bucket, the direct calls), on fresh
    # inputs made from the seed, held against their plain versions; the
    # launches counted above are untouched
    def hold_gather(gather, label):
        """K5 and K6 against their plain versions at every (tables, B) in
        ``gather`` (GATHER_SHAPES of a run), on fresh inputs made from the
        seed (two calls bitwise); returns (K5 max |diff|, K6 gw errors, K6
        gx errors)."""
        k5_name = ops.gather_grouped_log_einsum_exp.name
        k6_name = ops.gather_grouped_log_einsum_exp_bwd.name
        k5_e, k6_w, k6_x, held = 0.0, [], [], []
        with torch.no_grad():
            for (op_name, b, tables), n in gather.items():
                if op_name != k5_name:
                    continue
                k = tables.k
                ws_, vs_ = rand_wv(tables, k)
                # the special rows (masked, -inf, saturated) from B = 8 up
                x = rand_x(b, tables.num_in_rows, k) if b >= 8 else \
                    rand_x(b + 4, tables.num_in_rows, k)[4:]
                what = (f"{label} cells={[len(l) for l in tables.left]} "
                        f"K={k} B={b}")
                k5_e = max(k5_e, check_k5(tables, ws_, vs_, x, f"K5 {what}"))
                n6 = gather.get((k6_name, b, tables), 0)
                if n6:
                    errs, e = check_k6(tables, ws_, vs_, x,
                                       rand_g(b, tables.num_new_rows, k),
                                       f"K6 {what}")
                    k6_w += errs
                    k6_x.append(e)
                held.append(f"B={b} K={k} (K5 {n}, K6 {n6} launches)")
        k5_keys, k6_keys = ({(b, t) for op_name, b, t in gather
                             if op_name == name}
                            for name in (k5_name, k6_name))
        if not k6_keys or k6_keys - k5_keys:
            raise AssertionError(f"{label}: K6 held at "
                                 f"{len(k6_keys & k5_keys)} of its "
                                 f"{len(k6_keys)} (tables, B)")
        print(f"{label} K5 and K6 against their plain versions at every "
              f"(tables, B) the {label} runs launched them at: "
              + "; ".join(held)
              + f" (two calls bitwise; K5 max |diff| {k5_e:.3e}, K6 gx "
              f"max |diff| {worst(k6_x, 'abs'):.3e}, gw max |diff| "
              f"{worst(k6_w, 'abs'):.3e}) [{card}]")
        return k5_e, k6_w, k6_x

    def by_tables(gather):
        """GATHER_SHAPES keyed by the tables themselves."""
        out = collections.Counter()
        for (op_name, b, tid), n in gather.items():
            out[(op_name, b, TABLES[tid])] += n
        return out

    eval_gather = collections.Counter()
    for run in evals.values():
        eval_gather.update(by_tables(run["gather_shapes"]))
    eval_k5_err, eval_k6_w, eval_k6_x = hold_gather(eval_gather, "eval")
    k5_err = max(k5_err, eval_k5_err)
    k6_w_errs += eval_k6_w
    k6_x_errs += eval_k6_x

    # ------------------------------------------------ graph-serving phase
    # the serve bench's run_benchmark on each full-width model through
    # captured CUDA graphs, with the program gates (a)-(e); one in-place EM
    # step a model
    t_graph = time.perf_counter()
    graphs = graph_phase(card, dev, {
        "einet_rat": (model, mixed_requests(model.num_vars, GRAPH_REQUESTS,
                                            seed=0),
                      make_em_step(model, TrainConfig()), x_full[:256]),
        "einet_pd": (pd, mixed_requests(pd.num_vars, GRAPH_REQUESTS, seed=0),
                     make_em_step(pd, TrainConfig()), pd_xb[:128]),
        f"einet_celeba x{n_mix}": (
            mix, mixture_requests(mix, GRAPH_REQUESTS, seed=0),
            make_mixture_em_step(mix, MixtureTrainConfig(assign="soft")),
            torch.from_numpy(mix_data[:128]).to(dev)),
    })
    graph_s = time.perf_counter() - t_graph
    pd_joint = graphs["einet_pd"]["launch_rows"]
    # (d) at einet_pd joint_ll: a replay runs the kernels of an eager call
    # whose ops launch K5 once and K1 once
    for key, got in pd_joint.items():
        if "joint_ll" in key[:2] and got != {
                "gather_grouped_log_einsum_exp": 1, "log_einsum_exp": 1}:
            raise AssertionError(f"einet_pd joint_ll {key}: a replay runs "
                                 f"the kernels of an eager call launching "
                                 f"{got}, expected K5 1, K1 1")
    bucket_rows = serve_bucket_times(card, dev, pd)
    print(f"graph-serving phase: {graph_s:.3f} s; profiled windows taken "
          f"again (a side's markers lost): {sum(FENCE_RETRIES.values())} "
          f"{dict(FENCE_RETRIES)} [{card}]")

    # ----------------------------------------------- training-graph phase
    # EM steps as captured graphs against eager steps, health, einet_rat_large
    # through microbatches, the fault-tolerant loop, the flight recorder
    t_tg = time.perf_counter()
    tgraphs = train_graph_phase(card, dev, mix_data, compare_stats)
    tgraph_s = time.perf_counter() - t_tg
    print(f"training-graph phase: {tgraph_s:.3f} s [{card}]")

    # ----------------------------------------------- paper comparison phase
    # Table 1, NaiveEiNet against EiNet at einet_rat's width, the Fig. 3 and
    # Fig. 6 K sweeps, Fig. 4 quick (repro_torch.bench)
    t_paper = time.perf_counter()
    paper = paper_phase(card, dev, compare_stats)
    paper_s = time.perf_counter() - t_paper
    print(f"paper comparison phase: {paper_s:.3f} s [{card}]")

    # ----------------------------------------------------- distributed phase
    # the sharded EM step: NCCL at a world of 1 against make_em_step, then
    # two ranks on the card over gloo against one process
    t_dist = time.perf_counter()
    dist_out = dist_phase(card, dev, compare_stats)
    dist_s = time.perf_counter() - t_dist
    print(f"distributed phase: {dist_s:.3f} s [{card}]")

    # ----------------------------------------------- production-bench phase
    # the four production benches' full profiles and their gates (sentry,
    # pools, trace and metrics, slo --check, dryrun --verify); then K5 and
    # K6 held at every (tables, B) the benches launched them at
    t_bench = time.perf_counter()
    benches = bench_phase(card, dev)
    b_k5_err, b_k6_w, b_k6_x = hold_gather(
        by_tables(benches["gather_shapes"]), "bench")
    k5_err = max(k5_err, b_k5_err)
    k6_w_errs += b_k6_w
    k6_x_errs += b_k6_x
    bench_s = time.perf_counter() - t_bench
    print(f"production-bench phase: {bench_s:.3f} s [{card}]")

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
                 pd_train["per-layer"]["counts"],
             "einet_celeba x8 mixture hard EM": hard["counts"],
             "einet_celeba x8 mixture soft EM": soft["counts"],
             "einet_celeba x8 mixture full soft EM": mix_full["counts"],
             "einet_celeba x8 mixture_joint_ll": mix_ll_counts,
             "einet_celeba x8 mixture serve": mix_serve_counts,
             **{f"graph serve {name}": g["counts"]
                for name, g in graphs.items()},
             **{f"eval {name}": run["counts"]
                for name, run in evals.items()},
             "training graphs (warm-ups and captures)": {
                 k: tgraphs["counts"][k] for k in serve_counts},
             "paper comparison (EiNet side)": {
                 k: paper["counts"][k] for k in serve_counts},
             "distributed EM (sharded steps, warm-ups and captures)": {
                 k: dist_out["counts"][k] for k in serve_counts},
             "production benches (serve, train, mixture, eval)": {
                 k: benches["counts"][k] for k in serve_counts}}
    for name, c in paths.items():
        print(f"launches on the {name} path: " + ", ".join(
            f"{k} {v}" for k, v in c.items()) + f" [{card}]")
    counts = {k: sum(c[k] for c in paths.values()) for k in serve_counts}
    if not all(counts.values()):
        raise AssertionError(f"a kernel never ran on the main paths: {counts}")
    # K1 and K2 at every shape the main paths launched them at (einet_pd's
    # pairs also at its largest serve bucket, B = 64), each row with the
    # launches at its shape, on fresh inputs made from the seed, held
    # against the plain version at that shape (K2 also over two calls)
    path_shapes = collections.Counter()
    for sh in (serve_shapes, full["shapes"], train["fused"]["shapes"],
               train["per-layer"]["shapes"], pd_serve_shapes,
               pd_full["shapes"], pd_train["planned"]["shapes"],
               pd_train["per-layer"]["shapes"], hard["shapes"],
               soft["shapes"], mix_full["shapes"], mix_ll_shapes,
               mix_serve_shapes, *(g["shapes"] for g in graphs.values()),
               *(run["shapes"] for run in evals.values()),
               tgraphs["shapes"], dist_out["shapes"], benches["shapes"]):
        path_shapes.update(sh)
    for (name, *shape), n in sorted(path_shapes.items()):
        print(f"{name} launches at (B, L, K_out, K) = {tuple(shape)} on the "
              f"main paths: {n}")

    def pair_rows(op_name, backward):
        shapes = {tuple(k[1:]): n for k, n in path_shapes.items()
                  if k[0] == op_name}
        if not backward:
            for b, *rest in list(shapes):
                if b == b_pd:
                    shapes.setdefault((64, *rest), 0)
        rows = []
        for (b, l_cells, k_out, k), n in sorted(
                shapes.items(), key=lambda it: (it[0][3], -it[0][0],
                                                -it[0][1], -it[0][2])):
            w = rand_w(l_cells, k_out, k)
            x = torch.from_numpy((rng.randn(b, 2 * l_cells, k) * 4 - 20)
                                 .astype(np.float32)).to(dev)
            l, r = x[:, :l_cells], x[:, l_cells:]
            what = f"B={b} L={l_cells} K={k} K_out={k_out}"
            if backward:
                g = rand_g(b, l_cells, k_out)
                err = max(e["abs"] for e in check_k2(w, l, r, g,
                                                     f"K2 {what}"))
                ms = time_ms(lambda: log_einsum_exp_bwd_cuda(w, l, r, g))
                plain_ms = time_ms(lambda: log_einsum_exp_bwd_plain(w, l, r, g))
                lib_ms = time_ms(autograd_yardstick(einsum_pair, (w, l, r), g))
                n_bytes, flops = bwd_cost(b, l_cells, k, k_out)
                print(f"K2 B={b} L={l_cells} K={k} K_out={k_out}: rows "
                      f"kernel (tile, subtiles, rows, K_out tile) "
                      f"{launch_geometry(b, l_cells, k, k_out, True)}, dW "
                      f"(JT, K_out tile) {dw_geometry(k, k_out)} in "
                      f"{dw_splits(b, l_cells, k, k_out)} batch splits, "
                      f"partials {dw_partial_bytes(b, l_cells, k, k_out)} B"
                      f" [{card}]")
            else:
                print(f"K1 B={b} L={l_cells} K={k} K_out={k_out}: (tile, "
                      f"subtiles, rows, K_out tile) "
                      f"{launch_geometry(b, l_cells, k, k_out)} [{card}]")
                err = assert_close(log_einsum_exp_cuda(w, l, r),
                                   log_einsum_exp_plain(w, l, r), f"K1 {what}")
                el, er = frame(l, r)
                ms = time_ms(lambda: log_einsum_exp_cuda(w, l, r))
                plain_ms = time_ms(lambda: log_einsum_exp_plain(w, l, r))
                lib_ms = time_ms(lambda: torch.einsum(
                    "lkij,bli,blj->blk", w, el, er))
                n_bytes = 4 * (2 * b * l_cells * k + w.numel()
                               + b * l_cells * k_out)
                flops = 2 * b * l_cells * k_out * k * k
            b_ms, b_by = bound(n_bytes, flops)
            rows.append({"shape": what, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "launches": n,
                         "bytes": n_bytes, "flops": flops})
            del w, x, l, r
        return rows

    with torch.no_grad():
        k1_rows = pair_rows("log_einsum_exp", backward=False)
        k2_rows = pair_rows("log_einsum_exp_bwd", backward=True)
    k1_err = max([k1_err] + [r["max_abs_err"] for r in k1_rows])
    print(f"K1 and K2 agree with their plain versions at each of the "
          f"{len(k1_rows)} and {len(k2_rows)} (B, L, K_out, K) shapes the "
          f"main paths launched them at (K1 max |diff| "
          f"{max(r['max_abs_err'] for r in k1_rows):.3e}, K2 "
          f"{max(r['max_abs_err'] for r in k2_rows):.3e}; K2 bitwise over two "
          f"calls) [{card}]")
    for r in [k3_row, k3_big_row] + k5_rows:
        r["library_ms"] = None
    for r in (k3_row, k4_row, k5_row, k6_row):
        r["launches"] = None  # all of the op's launches (report)
    # the B = 64 rows' times stand beside B = 512's, whose row carries all
    # of the kernel's launches
    k5_rows[1]["launches"] = k6_rows[1]["launches"] = 0
    for r in [k3_row, k3_big_row, k4_row, k4_big_row] + k5_rows + k6_rows:
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
    kernel_json = []

    def report(name, source, replaces, op, rows, err, yardstick):
        fused_of = "K2" if op.endswith("_bwd") else "K1"
        for r in rows:
            if r["launches"] is None:
                r["launches"] = counts[op]
            yard = r["library_ms"] if r["library_ms"] is not None \
                else r["einsum_chain_ms"]
            chain = ""
            if "chain_ms" in r:
                chain = (f", per-layer {fused_of} chain at the same pairs "
                         f"{r['chain_ms']:.4f} ms (fused/chain "
                         f"{r['ms'] / r['chain_ms']:.2f}x)")
            print(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, {yardstick} {yard:.4f} ms "
                  f"({r['ms'] / yard:.2f}x), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){chain}, {r['launches']} launches on the "
                  f"main paths [{card}]")
        # the kernel's figures: sums over the rows the main paths launched
        main = [r for r in rows if r["launches"]] or rows
        b_ms, b_by = bound(sum(r["bytes"] for r in main),
                           sum(r["flops"] for r in main))
        lib = [r["library_ms"] for r in main]
        kernel_json.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[op], "max_abs_err": err,
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if None in lib else sum(lib),
            "rows": [{k: r[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "launches", "chain_ms", "max_abs_err")
                if k in r} for r in rows],
        })

    csrc = "src/repro_torch/kernels/csrc/"
    report("log_einsum_exp_fwd", csrc + "log_einsum_exp_fwd.cu",
           "src/repro/kernels/log_einsum_exp.py:182", "log_einsum_exp",
           k1_rows, k1_err, "einsum yardstick")
    report("log_einsum_exp_bwd", csrc + "log_einsum_exp_bwd.cu",
           "src/repro/kernels/log_einsum_exp.py:224", "log_einsum_exp_bwd",
           k2_rows, max([worst(k2_x_errs, "abs"), worst(k2_w_errs, "abs")]
                        + [r["max_abs_err"] for r in k2_rows]),
           "autograd einsum yardstick")
    report("grouped_fwd", csrc + "grouped_fwd.cu",
           "src/repro/kernels/grouped.py:305", "grouped_log_einsum_exp",
           [k3_row, k3_big_row], max(k3_err, big_k3_err), "einsum chain")
    report("grouped_bwd", csrc + "grouped_bwd.cu",
           "src/repro/kernels/grouped.py:380", "grouped_log_einsum_exp_bwd",
           [k4_row, k4_big_row],
           max(worst(k4_x_errs, "abs"), worst(k4_w_errs, "abs")),
           "autograd einsum-chain yardstick")
    report("gather_fwd", csrc + "gather_fwd.cu",
           "src/repro/kernels/grouped.py:718", "gather_grouped_log_einsum_exp",
           k5_rows, k5_err, "einsum chain + mixing")
    report("gather_bwd", csrc + "gather_bwd.cu",
           "src/repro/kernels/grouped.py:780",
           "gather_grouped_log_einsum_exp_bwd", k6_rows,
           max(worst(k6_x_errs, "abs"), worst(k6_w_errs, "abs")),
           "autograd einsum-chain + mixing yardstick")
    # rule 2's ranking: the worst loss factor to the yardstick, then the
    # launch-weighted time above the bound (launch ms)
    rank = []
    for kj, rows in zip(kernel_json, (k1_rows, k2_rows, [k3_row, k3_big_row],
                                      [k4_row, k4_big_row], k5_rows,
                                      k6_rows)):
        factor = max(r["ms"] / (r["library_ms"] if r["library_ms"] is not None
                                else r["einsum_chain_ms"])
                     for r in rows if r["launches"] or len(rows) == 1)
        over = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)
        rank.append((factor, over, kj["name"]))
    print("ranking (worst kernel/yardstick factor, launches x (ms - bound); "
          "every kernel has had one Hopper redesign): "
          + "; ".join(f"{n} {f:.2f}x, {o:.1f} launch ms, redesigned"
                      for f, o, n in sorted(rank, reverse=True)) + f" [{card}]")
    print("In the JSON line each kernel's rows are timed at the shapes the "
          "main paths launch it at (K1 and K2: every (B, L, K_out, K) seen, "
          "on fresh inputs; K3, K4: einet_rat's fused [0,4) at "
          f"B={b_full}, and both also einet_rat_large's K=64 fused [0,2) at "
          f"B=64, off the main paths; K5, K6: einet_pd's gather[0,2) at "
          f"B={b_pd}, and at B=64, the serve bucket and the hard mixture "
          f"step's rows a component), and its ms, "
          "plain_ms, library_ms and bound_ms are the "
          "sums over its rows launched on the main paths; chain_ms is the "
          "per-layer plan's launches at the same pairs (K3, K5: K1, K5 plus "
          "log_mix_exp; K4, K6: K2); "
          "launches are summed over the main paths above.  library_ms is one "
          "torch.einsum on the stabilised frame for K1, and for K2, K4 and "
          "K6 torch.autograd.grad through a forward whose contraction is one "
          "torch.einsum a depth (K6: plus log_mix_exp), forward included; "
          "K3 and K5 have none (their rows show the einsum chain)")
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
    print(f"mixture serve einet_celeba x{n_mix}: {len(mix_reqs)} requests "
          f"over all ten kinds, first pass {mix_serve_s:.3f} s, steady "
          f"passes " + ", ".join(f"{t:.3f}" for t in mix_steady)
          + f" s ({mix_qps:.1f} req/s over all {len(mix_steady)} passes), "
          f"{mix_engine_steps} engine steps a pass [{card}]")
    print(f"mixture einet_celeba x{n_mix}: k-means {km_s:.3f} s on the card "
          f"(CPU {km_cpu_s:.3f} s), hard EM {hard['median_ms']:.3f} ms/step "
          f"({mix_loader.per_host} rows a component), soft EM "
          f"{soft['median_ms']:.3f} ms/step (B={b_mix}), mixture_joint_ll "
          f"{mix_ll_ms:.4f} ms (B={b_mix}) [{card}]")
    for name, run in evals.items():
        rec = run["record"]
        print(f"eval {name}: bpd joint {rec['bpd_joint']['bpd']:.6f}, "
              f"marginal {rec['bpd_marginal']['bpd']:.6f}; engine "
              f"{rec['bpd_joint']['engine_rows_per_s']:.1f} rows/s; EM step "
              f"p50 {run['step_ms']:.1f} ms; "
              f"inpainting {rec['inpainting']['requests_per_s']:.1f} req/s; "
              f"serve p50/p95/p99 " + "/".join(
                  f"{v:.3f}" for v in run["latency_ms"].values())
              + f" ms; wall {rec['wall_seconds']:.3f} s [{card}]")
    print(json.dumps({"kernels": kernel_json}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def compare() -> int:
    """``--compare``: builds the kernels, runs each of K1-K6 on inputs made
    from seed 0 at einet_rat's and einet_pd's shapes (K5 also at the serve
    bucket B = 64), and prints a SHA-256 of each kernel's outputs and its
    time there, so that two trees' kernels can be held against each other,
    bit for bit and in time, in one call (a copy of this script beside the
    other tree's src/ runs that tree's kernels)."""
    import hashlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped as gr
    from repro_torch.kernels import log_einsum_exp as lee
    from repro_torch.launch.cells import build_einet

    build.build(force=True)
    card = smi_line()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32)).to(dev)

    def sha(out):
        h = hashlib.sha256()
        for t in out if isinstance(out, (list, tuple)) else [out]:
            for u in t if isinstance(t, (list, tuple)) else [t]:
                h.update(u.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    rat = build_einet(get_config("einet_rat"), device=dev, seed=0)
    pd = build_einet(get_config("einet_pd"), device=dev, seed=0)
    calls = {}
    with torch.no_grad():
        ws = [rat.einsum[t].detach() for t in range(4)]
        x = rand(2048, ws[0].shape[0] * 2, rat.K, scale=4, shift=-20)
        h = ws[0].shape[0]
        g1 = rand(2048, h, rat.K)
        g4 = rand(2048, ws[-1].shape[0], ws[-1].shape[1])
        calls["K1 einet_rat pair 0 B=2048"] = lambda: lee.log_einsum_exp_cuda(
            ws[0], x[:, :h], x[:, h:])
        calls["K2 einet_rat pair 0 B=2048"] = lambda: \
            lee.log_einsum_exp_bwd_cuda(ws[0], x[:, :h], x[:, h:], g1)
        calls["K3 einet_rat fused[0,4) B=2048"] = lambda: \
            gr.grouped_log_einsum_exp_cuda(ws, x)
        calls["K4 einet_rat fused[0,4) B=2048"] = lambda: \
            gr.grouped_log_einsum_exp_bwd_cuda(ws, x, g4)
        tab = pd.exec_plan[0].tables
        pws = [pd.einsum[t].detach() for t in range(2)]
        pvs = [pd.mixing[1].detach()]
        px = rand(512, tab.num_in_rows, pd.K, scale=4, shift=-20)
        pg = rand(512, tab.num_new_rows, pd.K)
        for b in (512, 64):
            calls[f"K5 einet_pd gather[0,2) B={b}"] = lambda b=b: \
                gr.gather_grouped_log_einsum_exp_cuda(tab, pws, pvs, px[:b])
        calls["K6 einet_pd gather[0,2) B=512"] = lambda: \
            gr.gather_grouped_log_einsum_exp_bwd_cuda(tab, pws, pvs, px, pg)
        for name, fn in calls.items():
            print(f"compare {name}: outputs {sha(fn())}, "
                  f"{time_ms(fn, iters=50):.4f} ms [{card}]")
    print(card)
    return 0


def dist_only() -> int:
    """``--dist``: builds the kernels and runs only the distributed phase
    (the quickest check of the sharded EM path on the card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops

    build.build(force=True)
    card = smi_line()
    record_shapes(ops.log_einsum_exp)
    record_shapes(ops.log_einsum_exp_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dist_phase(card, torch.device("cuda"), compare_stats)
    print(f"distributed phase: {time.perf_counter() - t0:.3f} s [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit({"--compare": compare, "--pool": pool_probe,
              "--dist": dist_only, "--bench": bench_only}.get(
                  " ".join(sys.argv[1:]), main)())
