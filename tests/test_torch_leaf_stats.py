"""The E-step's leaf statistics in one op (``kernels/leaf_stats.py``,
``csrc/leaf_stats.cu``) on the CPU: the plain version is the port's former
composition bit for bit; the kernel's order of sums (slices, chunks, row
groups, their tree), replayed in plain PyTorch from ``launch_geometry``,
gives the plain version's statistics on every family and leaf table; the
geometry fits the card's limits and follows from the shapes alone, as the
CUDA source has it; the wrapper refuses what the kernel cannot take; the
E-steps call the op once a model; its launch cost; the lint.  The kernel
itself runs on the card (``chip_smoke.py --leaf``)."""

import json
import pathlib

import pytest
import torch

from repro_torch.analysis.lint import lint_source, run_lint
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import EiNet, poon_domingos, random_binary_trees
from repro_torch.core.em import (em_statistics, leaf_scatter, leaf_statistics,
                                 variable_major_statistics)
from repro_torch.core.exponential_family import (
    Bernoulli, Binomial, Categorical, Normal)
from repro_torch.kernels import build, leaf_stats, ops
from repro_torch.kernels.cost import launch_cost
from repro_torch.launch.cells import build_einet
from repro_torch.mixture import EiNetMixture
from repro_torch.mixture.train import mixture_em_statistics

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
CU = SRC / "kernels" / "csrc" / "leaf_stats.cu"

FAMILIES = {
    "normal": Normal,
    "bernoulli": Bernoulli,
    "binomial": lambda: Binomial(5),
    "categorical256": lambda: Categorical(256),
}


def _table(name, k, family="normal"):
    ef = FAMILIES[family]()
    if name == "einet_pd":
        return build_einet(get_config("einet_pd"), device="cpu", seed=0)
    if name == "einet_rat":
        return build_einet(get_config("einet_rat"), device="cpu", seed=0)
    if name == "pd":  # 8 x 8 pixels, two channels: leaves of R = 1
        graph = poon_domingos(8, 8, 4, num_channels=2)
    else:  # 32 variables, 3 replicas of 4 leaves each
        graph = random_binary_trees(32, 2, 3, seed=0)
    return EiNet(graph, num_sums=k, exponential_family=ef, device="cpu",
                 seed=1)


_MODELS = {}


def _model(name, k=10, family="normal"):
    key = (name, k, family)
    if key not in _MODELS:
        _MODELS[key] = _table(name, k, family)
    return _MODELS[key]


def _operands(model, b, seed=0):
    """Posteriors uniform in [0, 1) and the batch's statistics."""
    gen = torch.Generator().manual_seed(seed)
    d = model.num_vars
    ef = model.ef
    if isinstance(ef, Binomial):
        x = torch.randint(0, ef.n_trials + 1, (b, d), generator=gen).float()
    elif isinstance(ef, Categorical):
        x = torch.randint(0, ef.num_categories, (b, d), generator=gen).float()
    elif isinstance(ef, Bernoulli):
        x = torch.randint(0, 2, (b, d), generator=gen).float()
    else:
        x = torch.randn(b, d, generator=gen)
    g = torch.rand(b, model.leaf_spec.num_leaves, model.K, generator=gen)
    return g, model.ef.sufficient_statistics(x), x


def _bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.parametrize("name", ["einet_pd", "einet_rat", "pd", "rat"])
def test_plain_version_is_the_former_composition_bit_for_bit(name):
    model = _model(name)
    g, t, x = _operands(model, 37)
    # the E-step's statistics as the port computed them before the kernel
    g_pairs = g[:, model.leaf_pair_leaf, :]
    t_pairs = t[:, model.leaf_pair_var, :]
    want = leaf_scatter(model, torch.einsum("bpk,bpt->pkt", g_pairs, t_pairs),
                        g_pairs.sum(0))
    got = leaf_stats.leaf_stats_plain(g, t, model.leaf_gather,
                                      model.leaf_spec.num_replica)
    via_em = leaf_statistics(model, variable_major_statistics(model, x), g)
    for a, b, c in zip(got, want, via_em):
        assert _bits(a, b) and _bits(c, b)


def _replay(g, t, gather, r, geo):
    """The kernel's sums in its order, in plain PyTorch: each group's sum
    over its rows of a chunk (at most 64, one einsum here, a running sum in
    the kernel), added to its total chunk after chunk, the groups' totals
    in a pairwise tree, the slices in order; then each leaf position's sums
    to its pair's row."""
    b, n_leaves, k = g.shape
    d, n_t = t.shape[1:]
    valid = gather < d * r
    x = t[:, torch.where(valid, gather // r, 0), :] * valid[None, :, :, None]
    zero = (g.new_zeros(n_leaves, k, gather.shape[1], n_t),
            g.new_zeros(n_leaves, k))

    def rows(lo, hi):
        if lo >= hi:
            return zero
        return (torch.einsum("blk,blst->lkst", g[lo:hi], x[lo:hi]),
                g[lo:hi].sum(0))

    slices = []
    for chunks in leaf_stats.row_blocks(b, geo):
        totals = [zero] * geo["groups"]
        for chunk in chunks:
            for i, (lo, hi) in enumerate(chunk):
                acc, den = rows(lo, hi)
                totals[i] = (totals[i][0] + acc, totals[i][1] + den)
        w = len(totals) // 2
        while w >= 1:
            for h in range(w):
                totals[h] = (totals[h][0] + totals[h + w][0],
                             totals[h][1] + totals[h + w][1])
            w //= 2
        slices.append(totals[0])
    acc, den = slices[0]
    for a, dn in slices[1:]:
        acc, den = acc + a, den + dn
    leaf, pos = torch.nonzero(valid, as_tuple=True)
    return leaf_stats.pair_scatter(gather[leaf, pos], acc[leaf, :, pos, :],
                                   den[leaf], d, r)


REPLAY_CASES = (
    [(fam, table, 10, 513) for table in ("pd", "rat") for fam in FAMILIES]
    + [("normal", "rat", k, 130) for k in (1, 10, 40, 64)]
    + [("normal", table, None, b) for table in ("einet_pd", "einet_rat")
       for b in (1, 7, 513, 2000)])


@pytest.mark.parametrize("family,table,k,b", REPLAY_CASES)
def test_the_kernels_order_of_sums_gives_the_plain_statistics(family, table,
                                                              k, b):
    model = _model(table, k, family)
    g, t, _ = _operands(model, b, seed=b)
    gather, r = model.leaf_gather, model.leaf_spec.num_replica
    geo = leaf_stats.launch_geometry(b, gather.shape[1], gather.shape[0],
                                     model.K, t.shape[2])
    want = leaf_stats.leaf_stats_plain(g, t, gather, r)
    got = _replay(g, t, gather, r, geo)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6 * b)


def _shapes():
    """(B, width, leaves, K, |T|) of every registered model at its leaf
    layer, and of the families and widths the kernel must take."""
    out = []
    for arch in REGISTRY:
        model = build_einet(get_config(arch), device="meta")
        width = model.leaf_gather.shape[1]
        for b in (1, 64, 512, 2000, 4096):
            out.append((b, width, model.leaf_spec.num_leaves, model.K,
                        model.ef.num_stats))
    for k in (1, 3, 10, 40, 64, 65, 130):
        for n_t in (1, 2, 256):
            out.append((777, 32, 12, k, n_t))
    return out


@pytest.mark.parametrize("shape", sorted(set(_shapes())))
def test_geometry_fits_the_card_and_covers_every_row_once(shape):
    b, width, n_leaves, k, n_t = shape
    geo = leaf_stats.launch_geometry(*shape)
    kt, nt = leaf_stats.TILE_K * geo["tk"], leaf_stats.TILE_N * geo["tn"]
    xw = nt + 4 if nt % 8 == 0 else nt
    assert geo["threads"] == geo["groups"] * geo["tk"] * geo["tn"]
    assert geo["threads"] <= leaf_stats.THREADS
    assert kt <= leaf_stats.K_TILE_MAX and geo["groups"] <= 8
    assert geo["groups"] & (geo["groups"] - 1) == 0
    assert geo["smem"] <= leaf_stats.SMEM_LIMIT_BYTES
    assert geo["smem"] >= 4 * (2 * geo["cb"] * (kt + xw) + nt + kt)
    assert 0 < geo["cb"] <= 64 and geo["cb"] % geo["groups"] == 0
    assert geo["cb"] // geo["groups"] <= 64  # a thread's running sum
    assert geo["rps"] % geo["cb"] == 0
    assert geo["grid"] == (-(-width * n_t // nt), n_leaves * -(-k // kt),
                           geo["slices"])
    assert geo["grid"][1] <= leaf_stats.MAX_GRID_YZ
    assert 1 <= geo["slices"] <= leaf_stats.SLICES_MAX
    assert (geo["slices"] - 1) * geo["rps"] < b <= geo["slices"] * geo["rps"]
    covered = [row for chunks in leaf_stats.row_blocks(b, geo)
               for chunk in chunks for lo, hi in chunk
               for row in range(lo, hi)]
    assert covered == list(range(b))
    # the shapes alone decide: the same shapes give the same launch
    leaf_stats.launch_geometry.cache_clear()
    assert leaf_stats.launch_geometry(*shape) == geo


def test_einet_pd_splits_the_batch_and_einet_rat_groups_its_rows():
    pd = leaf_stats.launch_geometry(512, 768, 4, 40, 2)
    rat = leaf_stats.launch_geometry(2000, 32, 160, 10, 2)
    assert pd["slices"] > 1 and pd["groups"] == 1
    assert rat["slices"] > 1 and rat["groups"] > 1
    # a serving bucket or a wide leaf layer fills the card unsplit
    assert leaf_stats.launch_geometry(7, 768, 4, 40, 2)["slices"] == 1
    assert leaf_stats.launch_geometry(4096, 32, 64, 64, 256)["slices"] == 1


def test_geometry_mirrors_the_cuda_source():
    text = CU.read_text()
    assert "constexpr int kStatsThreads = 256;" in text
    assert leaf_stats.THREADS == 256
    assert f"constexpr int kTileK = {leaf_stats.TILE_K};" in text
    assert f"constexpr int kTileN = {leaf_stats.TILE_N};" in text
    assert f"constexpr int kMaxGroups = {leaf_stats.GROUPS_MAX};" in text
    assert "constexpr int kRed = kTileK * kTileN + kTileK;" in text
    assert leaf_stats.RED_FLOATS == (leaf_stats.TILE_K * leaf_stats.TILE_N
                                     + leaf_stats.TILE_K)
    assert "const int xw = nt % 8 == 0 ? nt + 4 : nt;" in text
    assert "const int per_buf = cb * (kt + xw);" in text
    assert ("const int stage = max(2 * per_buf, groups > 1 ? nthreads * kRed"
            " : 0);") in text
    # the order of the sums: a chunk's rows, the chunks, the tree, slices
    assert "acc[a][q] = fmaf(ga[a], xa[q], acc[a][q]);" in text
    assert "for (int q = 0; q < kTileN; ++q) tot[a][q] += acc[a][q];" in text
    assert "for (int w = groups / 2; w >= 1; w /= 2)" in text
    assert "for (int sl = 1; sl < slices; ++sl)" in text
    assert "atomicAdd" not in text and "atomicCAS" not in text
    assert "leaf_stats" in build.SOURCES
    # the kernels' names fall in neither of the benchmark's kernel rules
    rules = [json.loads((ROOT / "einbench" / "kernels" / f).read_text())
             for f in ("elementwise.json", "einsum_layers.json")]
    names = ("leaf_stats_kernel", "leaf_stats_sum_kernel")
    for name in names:
        assert f"\n{name}(" in text
        assert "elementwise_kernel" not in name
        assert all(name not in rule.get("base", []) for r in rules
                   for rule in r.values())
        assert all(c not in name for r in rules for rule in r.values()
                   for c in rule.get("contains", []))


@pytest.mark.parametrize("n,ptr,want", [(40, 0, 4), (40, 8, 2), (10, 0, 2),
                                        (10, 4, 1), (1, 0, 1), (2, 16, 2)])
def test_copy_width_divides_the_rows_and_keeps_the_alignment(n, ptr, want):
    assert leaf_stats.copy_width(n, ptr) == want


def _wrapper_case(kind):
    model = _model("rat")
    g, _, x = _operands(model, 9)
    t = variable_major_statistics(model, x)
    gather, r = model.leaf_gather, model.leaf_spec.num_replica
    if kind == "dtype":
        return (g.double(), t, gather, r), TypeError
    if kind == "table dtype":
        return (g, t, gather.int(), r), TypeError
    if kind == "contiguity":
        return (g.transpose(0, 1).contiguous().transpose(0, 1), t, gather,
                r), ValueError
    if kind == "layout":  # (B, D, T)-contiguous, not variable-major
        return (g, t.contiguous(), gather, r), ValueError
    if kind == "shape":
        return (g[:, :-1], t, gather, r), ValueError
    return (g, t, gather, r), ValueError  # right in all but the device


@pytest.mark.parametrize("kind", ["dtype", "table dtype", "contiguity",
                                  "layout", "shape", "device"])
def test_wrapper_refuses_what_the_kernel_cannot_take(kind):
    args, err = _wrapper_case(kind)
    with pytest.raises(err):
        leaf_stats.leaf_stats_cuda(*args)


def test_op_dispatch_counts_and_refuses_gradients():
    model = _model("rat")
    g, t, _ = _operands(model, 5)
    gather, r = model.leaf_gather, model.leaf_spec.num_replica
    ops.reset_counts()
    got = ops.leaf_stats(g, t, gather, r)
    assert (ops.leaf_stats.launches, ops.leaf_stats.plain_calls) == (0, 1)
    assert ops.leaf_stats in ops.KERNEL_OPS
    for a, b in zip(got, leaf_stats.leaf_stats_plain(g, t, gather, r)):
        assert _bits(a, b)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.leaf_stats(g.requires_grad_(True), t, gather, r)
    with torch.no_grad():
        ops.leaf_stats(g, t, gather, r)
    assert ops.leaf_stats.plain_calls == 2
    with pytest.raises(ValueError, match="unsupported device"):
        ops.leaf_stats(g.detach().to("meta"), t.to("meta"),
                       gather.to("meta"), r)


@pytest.mark.parametrize("name", ["einet_pd", "rat"])
def test_an_estep_calls_the_op_once(name):
    model = _model(name)
    _, _, x = _operands(model, 6)
    ops.reset_counts()
    stats = em_statistics(model, x)
    assert (ops.leaf_stats.launches, ops.leaf_stats.plain_calls) == (0, 1)
    assert stats["s_phi"].shape == model.phi.shape
    assert stats["s_den"].shape == model.phi.shape[:3]


@pytest.mark.parametrize("c", [1, 3])
def test_a_soft_mixture_estep_calls_the_op_once_a_component(c):
    mix = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                             num_sums=3, device="cpu"), c)
    x = torch.randn(10, 8, generator=torch.Generator().manual_seed(2))
    ops.reset_counts()
    stats = mixture_em_statistics(mix, x)
    assert (ops.leaf_stats.launches, ops.leaf_stats.plain_calls) == (0, c)
    assert stats["s_phi"].shape == mix.phi.shape


def test_launch_cost_counts_the_reads_writes_and_contraction():
    b, d, leaves, width, k, r, n_t = 2000, 512, 160, 32, 10, 10, 2
    m = torch.device("meta")
    g = torch.empty(b, leaves, k, device=m)
    t = torch.empty(b, d, n_t, device=m)
    gather = torch.empty(leaves, width, dtype=torch.int64, device=m)
    n_bytes, flops = launch_cost("leaf_stats", g, t, gather, r)
    assert flops == 2 * b * d * r * k * n_t
    assert n_bytes == 4 * (b * leaves * k + b * d * n_t + d * k * r * (n_t + 1))


@pytest.mark.parametrize("snippet,clean", [
    ("from repro_torch.kernels.leaf_stats import leaf_stats_cuda\n", False),
    ("from repro_torch.kernels.leaf_stats import leaf_stats_plain\n", False),
    ("from repro_torch.kernels.leaf_stats import pair_scatter\n", True),
    ("from repro_torch.kernels import ops\nops.leaf_stats\n", True),
])
def test_lint_keeps_the_statistics_kernel_behind_its_op(snippet, clean):
    found = lint_source(snippet, "src/repro_torch/core/somefile.py")
    assert (found == []) == clean
    if not clean:
        assert {v.rule for v in found} == {"kernel-contract"}


def test_leaf_statistics_files_lint_clean():
    files = [SRC / "kernels" / "leaf_stats.py", SRC / "kernels" / "ops.py",
             SRC / "core" / "em.py", SRC / "mixture" / "train.py"]
    violations, _ = run_lint([str(f) for f in files])
    assert violations == [], "\n".join(str(v) for v in violations)
