"""The leaf layer in one op (``kernels/leaf_rows.py``, ``csrc/leaf_rows.cu``)
on the CPU: the operands ``pack`` lays out for the kernel, summed in the
kernel's order and rounding, give the plain version's rows bit for bit on
every exponential family and scope layout, with and without a
marginalisation mask; the op's device dispatch and counters; its autograd
contract; the kernel's geometry, which never depends on the batch and is
found for every registered model and family, mirrored from the CUDA
source; its launch cost; and the lint on the files it touches.  The
kernel itself runs on the card (``chip_smoke.py --leaf``)."""

import pathlib

import pytest
import torch

from repro_torch.analysis.lint import lint_source, run_lint
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import EiNet, random_binary_trees
from repro_torch.core.em import em_statistics
from repro_torch.core.exponential_family import (
    Binomial, Categorical, Normal, make_exponential_family)
from repro_torch.kernels import build, leaf_rows, ops
from repro_torch.kernels.cost import launch_cost
from repro_torch.launch.cells import build_einet

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _rat13():
    # depth 2 over 13 variables: scopes of 3 and 4, so padded gathers
    return EiNet(random_binary_trees(13, 2, 3, seed=0), num_sums=5,
                 device="cpu", seed=1)


def _binomial():
    return EiNet(random_binary_trees(12, 2, 2, seed=0), num_sums=7,
                 exponential_family=Binomial(5), device="cpu", seed=2)


def _categorical():
    return EiNet(random_binary_trees(12, 2, 2, seed=0), num_sums=6,
                 exponential_family=Categorical(4), device="cpu", seed=3)


MODELS = {
    "einet_pd": lambda: build_einet(get_config("einet_pd"), device="cpu",
                                    seed=0),
    "einet_rat": lambda: build_einet(get_config("einet_rat"), device="cpu",
                                     seed=0),
    "rat13_padded": _rat13,
    "binomial": _binomial,
    "categorical": _categorical,
}


@pytest.fixture(scope="module")
def models():
    return {}


def _model(models, name):
    if name not in models:
        models[name] = MODELS[name]()
    return models[name]


def _data(model, b, seed):
    g = torch.Generator().manual_seed(seed)
    if isinstance(model.ef, Binomial):
        return torch.randint(0, model.ef.n_trials + 1, (b, model.num_vars),
                             generator=g).float()
    if isinstance(model.ef, Categorical):
        return torch.randint(0, model.ef.num_categories, (b, model.num_vars),
                             generator=g).float()
    return torch.randn(b, model.num_vars, generator=g)


def _bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _operands(model, x, mask):
    theta = model.ef.expectation_to_natural(model.phi)
    return (theta, model.ef.log_normalizer(theta),
            model.ef.sufficient_statistics(x), model.ef.log_h(x), mask,
            model.leaf_gather)


def _kernel_order_sums(tha, xs, gather, num_replica, sc):
    """The kernel's arithmetic on ``pack``'s operands, all leaves at once:
    at each scope position in ``scope_order``, one term a (row,
    component) from the (variable, replica) record and the variable's
    statistics, rounded op by op as ``leaf_term`` does (0 where keep is 0
    or the position is padded), added to the running sum."""
    pad, n_t = tha.shape[0], xs.shape[2] - 2
    total = None
    for s in leaf_rows.scope_order(gather.shape[1], sc):
        g = gather[:, s]  # (L,)
        valid = g < pad
        g = torch.where(valid, g, torch.zeros_like(g))
        rec = xs[:, g // num_replica][:, :, None]  # (B, L, 1, |T| + 2)
        p = tha[g][None]  # (1, L, K, |T| + 1)
        dot = rec[..., 0] * p[..., 0]
        for i in range(1, n_t):
            dot = dot + rec[..., i] * p[..., i]
        term = (rec[..., n_t] + dot) - p[..., n_t]
        keep = (rec[..., n_t + 1] != 0) & valid[None, :, None]
        term = torch.where(keep, term, torch.zeros_like(term))
        total = term if total is None else total + term
    return total


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_packed_operands_in_the_kernels_order_are_the_plain_rows(
        models, name, masked):
    model = _model(models, name)
    x = _data(model, 9, 0)
    mask = None
    if masked:
        g = torch.Generator().manual_seed(1)
        mask = torch.rand(x.shape, generator=g) > 0.4
    with torch.no_grad():
        args = _operands(model, x, mask)
        want = leaf_rows.leaf_rows_plain(*args)
        tha, xs = leaf_rows.pack(*args[:5])
        d, k, r, n_t = args[0].shape
        assert tha.shape == (d * r, k, n_t + 1) and tha.is_contiguous()
        assert xs.shape == (9, d, n_t + 2) and xs.is_contiguous()
        _, _, sc = leaf_rows.launch_geometry(
            9, model.leaf_gather.shape[1], model.leaf_spec.num_leaves, k, n_t)
        got = _kernel_order_sums(tha, xs, model.leaf_gather,
                                 model.leaf_spec.num_replica, sc)
        assert _bits(got, want)
        ops.reset_counts()
        got = model.leaf_rows(x, mask)
    assert got.shape == (9, model.leaf_spec.num_leaves, model.K)
    assert _bits(got, want)
    assert (ops.leaf_rows.launches, ops.leaf_rows.plain_calls) == (0, 1)
    # a row alone is its row in the batch
    with torch.no_grad():
        alone = model.leaf_rows(x[4:5], None if mask is None else mask[4:5])
    assert _bits(alone[0], got[4])


def test_padded_scopes_point_at_the_zero_row(models):
    model = _model(models, "rat13_padded")
    pad = model.num_vars * model.leaf_spec.num_replica
    assert int((model.leaf_gather == pad).sum()) > 0
    assert bool((model.leaf_gather[:, 0] < pad).all())


def test_forward_and_query_go_through_the_op(models):
    model = _model(models, "rat13_padded")
    x = _data(model, 4, 2)
    ops.reset_counts()
    with torch.inference_mode():
        model.query({"x": x}, "joint_ll")
        model.log_likelihood(x, torch.ones_like(x, dtype=torch.bool))
    assert ops.leaf_rows.plain_calls == 2
    em_statistics(model, x)
    assert ops.leaf_rows.plain_calls == 3


def test_op_dispatch_counts_and_refuses_other_devices(models):
    model = _model(models, "binomial")
    x = _data(model, 3, 3)
    with torch.no_grad():
        args = _operands(model, x, None)
    ops.reset_counts()
    out = ops.leaf_rows(*args)
    assert _bits(out, leaf_rows.leaf_rows_plain(*args))
    assert (ops.leaf_rows.launches, ops.leaf_rows.plain_calls) == (0, 1)
    meta = tuple(a if a is None else a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.leaf_rows(*meta)
    assert (ops.leaf_rows.launches, ops.leaf_rows.plain_calls) == (0, 1)
    assert ops.leaf_rows in ops.KERNEL_OPS


def test_rows_under_autograd_raise_on_backward_only(models):
    model = _model(models, "rat13_padded")
    x = _data(model, 5, 4)
    assert model.phi.requires_grad
    ll = model.log_likelihood(x)  # forwards under grad mode still run
    with torch.no_grad():
        want = model.log_likelihood(x)
    assert _bits(ll.detach(), want)
    try:
        with pytest.raises(RuntimeError, match="no_grad"):
            ll.sum().backward()
        assert model.phi.grad is None
    finally:
        model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("width,leaves,k,n_t", [
    (768, 4, 40, 2),     # einet_pd
    (32, 160, 10, 2),    # einet_rat
    (8, 2048, 64, 2),    # einet_rat_large
    (4, 12, 300, 4),     # K above a block's threads: two K tiles
    (3, 7, 7, 1),        # a Binomial's one statistic
    (6, 5, 40, 200),     # a wide Categorical: one position a stage
    (768, 4, 64, 256),   # Categorical(256) at K = 64: the K tile shrinks
    (16, 64, 3, 256),    # Categorical(256) at K = 3: a K tile past K
])
def test_geometry_and_summation_order_never_depend_on_the_batch(
        width, leaves, k, n_t):
    _, kt, sc = leaf_rows.launch_geometry(1, width, leaves, k, n_t)
    bt = leaf_rows.THREADS // kt
    assert 1 <= kt <= leaf_rows.THREADS and 1 <= sc <= width
    assert kt == min(k, leaf_rows.THREADS) or kt & (kt - 1) == 0
    assert leaf_rows.smem_bytes(kt, sc, n_t) <= leaf_rows.SMEM_LIMIT_BYTES
    order = leaf_rows.scope_order(width, sc)
    assert order == list(range(width))
    for b in range(1, 4097):
        grid, *rest = leaf_rows.launch_geometry(b, width, leaves, k, n_t)
        assert tuple(rest) == (kt, sc)
        assert leaf_rows.scope_order(width, rest[1]) == order
        assert grid == (-(-b // bt), leaves, -(-k // kt))


# the leaf families the launch CLIs build (launch/cells.py build_einet)
FAMILIES = (Normal(), make_exponential_family("binomial", n_trials=255),
            make_exponential_family("categorical", num_categories=256))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_registered_model_and_family_gets_a_geometry(arch):
    """Every registered structure, under each leaf family, at every K up to
    a block's threads (the eval CLI's ``--num-sums``) and its own, fits
    shared memory with a K tile."""
    cfg = REGISTRY[arch]
    gather = build_einet(cfg, device="meta").leaf_gather
    leaves, width = gather.shape
    for ef in FAMILIES:
        for k in sorted({*range(1, leaf_rows.THREADS + 1), cfg.num_sums}):
            _, kt, sc = leaf_rows.launch_geometry(64, width, leaves, k,
                                                  ef.num_stats)
            assert leaf_rows.smem_bytes(kt, sc, ef.num_stats) <= (
                leaf_rows.SMEM_LIMIT_BYTES)


def test_geometry_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        leaf_rows.launch_geometry(8, 4, 2, 256, 2000)


def test_geometry_mirrors_the_cuda_source():
    text = (build.CSRC / "leaf_rows.cu").read_text()
    assert f"constexpr int kLeafThreads = {leaf_rows.THREADS};" in text
    assert "const int bt = kLeafThreads / kt;" in text
    assert "return (T + 1) | 1;" in text
    assert "return T <= 2 ? 4 : leaf_stride(T);" in text
    assert "return T <= 2 ? 4 : T + 2;" in text
    for t in range(1, 9):
        assert leaf_rows.leaf_stride(t) == (t + 1) | 1
        assert leaf_rows.record_widths(t) == (
            (4, 4) if t <= 2 else ((t + 1) | 1, t + 2))
    assert "(static_cast<size_t>(kt) * leaf_param_width(T) +" in text
    assert "static_cast<size_t>(bt) * leaf_row_width(T) + 2);" in text
    # the chunks in scope order, each in order, one running sum a thread
    assert "for (int c0 = 0; c0 < S; c0 += sc)" in text
    assert "for (int s = 0; s < n; ++s)" in text
    assert "sum = (c0 + s == 0) ? term : __fadd_rn(sum, term);" in text
    # the rounding of the plain version's each operation, no FMA
    assert "__fmul_rn" in text and "__fsub_rn" in text and "fmaf" not in text
    assert "leaf_rows" in build.SOURCES
    # the kernel's name falls in neither of the benchmark's kernel rules
    assert "leaf_rows_kernel" in text and "elementwise_kernel" not in text


def test_launch_cost_counts_the_inputs_rows_and_leaf_dot():
    d, k, r, n_t, b, leaves, width = 512, 10, 10, 2, 2000, 160, 32
    m = torch.device("meta")
    theta = torch.empty(d, k, r, n_t, device=m)
    a = torch.empty(d, k, r, device=m)
    t = torch.empty(b, d, n_t, device=m)
    log_h = torch.empty(b, d, device=m)
    gather = torch.empty(leaves, width, dtype=torch.int64, device=m)
    n_bytes, flops = launch_cost("leaf_rows", theta, a, t, log_h, None, gather)
    assert flops == 2 * b * d * k * r * n_t
    assert n_bytes == 4 * (d * k * r * (n_t + 1) + b * d * (n_t + 1)
                           + b * leaves * k)
    mask = torch.empty(b, d, dtype=torch.bool, device=m)
    assert launch_cost("leaf_rows", theta, a, t, log_h, mask, gather) == (
        n_bytes + b * d, flops)


@pytest.mark.parametrize("snippet,clean", [
    ("from repro_torch.kernels.leaf_rows import leaf_rows_cuda\n", False),
    ("from repro_torch.kernels.leaf_rows import leaf_rows_plain\n", False),
    ("from repro_torch.kernels import ops\nops.leaf_rows\n", True),
])
def test_lint_keeps_the_leaf_kernel_behind_its_op(snippet, clean):
    found = lint_source(snippet, "src/repro_torch/core/somefile.py")
    assert (found == []) == clean
    if not clean:
        assert {v.rule for v in found} == {"kernel-contract"}


def test_leaf_layer_files_lint_clean():
    files = [SRC / "kernels" / "leaf_rows.py", SRC / "kernels" / "ops.py",
             SRC / "core" / "einet.py", SRC / "core" / "layers.py",
             SRC / "core" / "exponential_family.py", SRC / "core" / "em.py"]
    violations, _ = run_lint([str(f) for f in files])
    assert violations == [], "\n".join(str(v) for v in violations)
