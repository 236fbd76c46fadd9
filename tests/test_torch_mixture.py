"""The port's mixture of EiNets (``repro_torch.mixture``) on the CPU against
the JAX reference (``repro.mixture``), with the same parameters carried
across as numpy: k-means, the mixture's likelihoods, responsibilities and
decodes, its soft and hard EM, sampling (statistically), and serving every
mixture kind through the engine.

Tolerances: log-likelihoods rtol 1e-5, atol 1e-4 (as
``test_torch_einet.py``); statistics and parameters rtol 1e-4, atol 1e-5
(as ``test_torch_train.py``); k-means centres atol 1e-5 with assignments
equal.  The port sums in other orders than XLA, so nothing against the
reference is bitwise; hard EM is bitwise against the port's own
single-model step, which it loops over.  Sizes: the reference's
``small_mix`` (``random_binary_trees(8, 2, 2)``, K=3, C=3), a PD mixture
over ``poon_domingos(4, 8, 2)`` (K=4, C=3: the gather run and the root
pair under the component axis), and the reference's ``blobs``.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mixture as ref_mx
from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro_torch.convert import (
    mixture_params_from_jax,
    mixture_params_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.core import em, poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.core.layers import NEG_INF
from repro_torch.kernels import ops
from repro_torch.mixture import (
    MIXTURE_COMPONENT_KINDS,
    MIXTURE_QUERY_KINDS,
    EiNetMixture,
    MixtureTrainConfig,
    cluster_order,
    fit_mixture,
    hard_mixture_em_update,
    kmeans,
    make_mixture_em_step,
    microbatched_mixture_em_statistics,
    mixture_em_statistics,
    mixture_em_update,
    prepare_mixture_training,
    stacked_cluster_loader,
    stochastic_mixture_em_update,
)
from repro_torch.mixture.cluster import _tree_sum
from repro_torch.serve import (
    Request,
    ServeEngine,
    direct_call,
    mixture_requests,
    parity,
)
from repro_torch.train.pipeline import (
    em_update_microbatched,
    stochastic_em_update_microbatched,
)

ROOT = Path(__file__).resolve().parents[1]
LL_TOL = dict(rtol=1e-5, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-5)
C = 3


def _carry(ref_mix, port_mix, key):
    params = jax.jit(ref_mix.init)(jax.random.PRNGKey(key))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    port_mix.load_state_dict(mixture_params_from_jax(pnp, port_mix))
    return params, pnp


def _small_pair(key=0):
    ref = ref_mx.EiNetMixture(
        RefEiNet(ref_rbt(8, 2, 2, seed=0), num_sums=3,
                 exponential_family=RefNormal()), C)
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    params, pnp = _carry(ref, port, key)
    return ref, params, pnp, port


def _pd_pair(key=5):
    ref = ref_mx.EiNetMixture(
        RefEiNet(ref_pd(4, 8, 2), num_sums=4, exponential_family=RefNormal()),
        C)
    port = EiNetMixture(EiNet(poon_domingos(4, 8, 2), num_sums=4,
                              device="cpu"), C)
    params, pnp = _carry(ref, port, key)
    return ref, params, pnp, port


@pytest.fixture(scope="module")
def small_mix():
    return _small_pair()


@pytest.fixture(scope="module")
def pd_mix():
    return _pd_pair()


@pytest.fixture(params=["small", "pd"])
def mix_pair(request, small_mix, pd_mix):
    return small_mix if request.param == "small" else pd_mix


@pytest.fixture(scope="module")
def blobs():
    """Three well-separated Gaussian blobs, shuffled deterministically (the
    reference's fixture)."""
    rng = np.random.RandomState(0)
    centers = np.array([[-6.0] * 8, [0.0] * 8, [6.0] * 8], np.float32)
    x = np.concatenate(
        [c + rng.randn(40, 8).astype(np.float32) * 0.3 for c in centers])
    truth = np.repeat(np.arange(3), 40)
    order = rng.permutation(len(x))
    return x[order], truth[order]


def _close_trees(got, want, what, tol=TOL):
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for a, b in zip(got_l, want_l):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=what, **tol)


def _data(d, b, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(b, d).astype(np.float32), rng.rand(b, d) < 0.5


def _ref(fn, static=(0, 3)):
    """A reference function jitted, with the mixture (argument 0) and a
    config (argument 3) static: eager vmapped JAX takes seconds a call."""
    return jax.jit(fn, static_argnums=static)


def _keys(seeds):
    return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


# ------------------------------------------------------------------- k-means
@pytest.mark.parametrize("batch", [None, 32], ids=["lloyd", "minibatch"])
@pytest.mark.parametrize("seed", [0, 7])
def test_kmeans_matches_reference(blobs, batch, seed):
    x, truth = blobs
    got = kmeans(x, 3, seed=seed, batch=batch, num_iters=30, device="cpu")
    want = ref_mx.kmeans(x, 3, seed=seed, batch=batch, num_iters=30)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-5)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.inertia, want.inertia, rtol=1e-5)
    assert got.assignments.dtype == np.int32 and got.counts.dtype == np.int64
    # each cluster is pure wrt the generating blob
    for c in range(3):
        assert len(set(truth[got.assignments == c])) == 1
    np.testing.assert_array_equal(got.weights(1.0), want.weights(1.0))


def test_kmeans_on_procedural_images_matches_reference():
    from repro_torch.data import load_image_dataset, to_domain

    data, _ = to_domain(load_image_dataset(
        "celeba", source="procedural", size_cap=256).train_x, "normal")
    got = kmeans(data, 4, num_iters=10, device="cpu")
    want = ref_mx.kmeans(data, 4, num_iters=10)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-5)


def test_kmeans_validation(blobs):
    x, _ = blobs
    with pytest.raises(ValueError):
        kmeans(x, 0, device="cpu")
    with pytest.raises(ValueError):
        kmeans(x[:2], 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kmeans(x, 3)


def test_tree_sum_is_a_fixed_tree():
    rng = np.random.RandomState(3)
    for n in (1, 2, 5, 8, 37):
        t = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
        got = _tree_sum(t, 0)
        np.testing.assert_allclose(got.numpy(), t.numpy().sum(0), rtol=1e-5,
                                   atol=1e-6)
        # pairwise by halves: a power-of-two length is ((a+b)+(c+d)) ...
        pad = torch.cat([t, t.new_zeros((1 << max(n - 1, 0).bit_length())
                                        - n, 3)])
        while pad.shape[0] > 1:
            pad = pad[: pad.shape[0] // 2] + pad[pad.shape[0] // 2:]
        assert torch.equal(got, pad[0])
    assert torch.equal(_tree_sum(t.T, 1), _tree_sum(t, 0))


def test_kmeans_deterministic_across_processes(blobs, tmp_path):
    """A fresh interpreter with another hash salt derives bit-identical
    centres and assignments."""
    x, _ = blobs
    km = kmeans(x, 3, seed=7, batch=32, device="cpu")
    np.save(tmp_path / "x.npy", x)
    code = (
        "import numpy as np; from repro_torch.mixture import kmeans\n"
        f"km = kmeans(np.load(r'{tmp_path / 'x.npy'}'), 3, seed=7, "
        "batch=32, device='cpu')\n"
        f"np.save(r'{tmp_path / 'centers.npy'}', km.centers)\n"
        f"np.save(r'{tmp_path / 'assign.npy'}', km.assignments)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED="12345")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    np.testing.assert_array_equal(km.centers,
                                  np.load(tmp_path / "centers.npy"))
    np.testing.assert_array_equal(km.assignments,
                                  np.load(tmp_path / "assign.npy"))


def test_stacked_cluster_loader_matches_reference(blobs):
    x, _ = blobs
    km = kmeans(x, 3, seed=0, device="cpu")
    got_order = cluster_order(km.assignments, 3)
    want_order = ref_mx.cluster_order(km.assignments, 3)
    for a, b in zip(got_order, want_order):
        np.testing.assert_array_equal(a, b)
    assign = km.assignments.copy()
    assign[assign == 2] = 1  # an empty cluster tiles the whole dataset
    for shards in (1, 2):
        got = stacked_cluster_loader(x, assign, 3, 8, num_shards=shards,
                                     shard_id=shards - 1)
        want = ref_mx.stacked_cluster_loader(x, assign, 3, 8,
                                             num_shards=shards,
                                             shard_id=shards - 1)
        for step in range(6):
            b = got.batch_at(step)["x"]
            assert b.shape == (3, 8, 8) and b.dtype == np.float32
            np.testing.assert_array_equal(b, want.batch_at(step)["x"])


def test_prepare_mixture_training_matches_reference(blobs):
    x, _ = blobs
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    loader, km = prepare_mixture_training(port, x, seed=4, global_batch=40)
    # the reference's prepare_mixture_training, step by step: k-means (full
    # batch at this size), smoothed weights, per-component batch 40 // 3
    want_km = ref_mx.kmeans(x, C, num_iters=25, seed=4)
    want_loader = ref_mx.stacked_cluster_loader(x, want_km.assignments, C,
                                                13)
    np.testing.assert_array_equal(km.assignments, want_km.assignments)
    np.testing.assert_array_equal(port.mixture_weights.detach().numpy(),
                                  want_km.weights(alpha=1.0))
    assert loader.per_host == 13
    for step in range(3):
        np.testing.assert_array_equal(loader.batch_at(step)["x"],
                                      want_loader.batch_at(step)["x"])
    # the components are the mixture's own seeded initialisation
    fresh = EiNetMixture(port.component, C, seed=4)
    fresh.mixture_weights.data.copy_(port.mixture_weights)
    for a, b in zip(port.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the model
def test_stacked_parameters_and_binding(small_mix):
    _, _, pnp, port = small_mix
    net = port.component
    assert dict(port.named_parameters())["phi"].shape == (C, 8, 3, 2, 2)
    assert not any(p is q for p in port.parameters()
                   for q in net.parameters())
    assert port.num_params() == sum(
        a.size for a in jax.tree_util.tree_leaves(pnp))
    own = net.phi
    with port.bound(1) as bound:
        assert bound is net
        assert bound.phi.data_ptr() == port.phi[1].data_ptr()
        assert bound.einsum[1].data_ptr() == port.einsum[1][1].data_ptr()
    assert net.phi is own  # the structure's own parameters come back
    with pytest.raises(ValueError, match="component"):
        with port.bound(C):
            pass
    # the component's parameters, as the reference's component_params
    _close_trees(port.component_params(2),
                 ref_mx.EiNetMixture.component_params(None, pnp, 2),
                 "component 2", tol=dict(rtol=0, atol=0))


def test_init_draws_each_component_from_one_generator():
    net = EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                device="cpu")
    mix = EiNetMixture(net, C, seed=11)
    gen = torch.Generator().manual_seed(11)
    single = EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                   device="cpu")
    for c in range(C):
        single.init_params(gen)
        _close_trees(mix.component_params(c), em.params_of(single),
                     f"component {c}", tol=dict(rtol=0, atol=0))
    assert torch.equal(mix.mixture_weights, torch.full((C,), 1.0 / C))
    with pytest.raises(ValueError):
        EiNetMixture(net, 0)


def test_mixture_ll_kinds_match_reference(mix_pair):
    ref, params, _, port = mix_pair
    x, ev = _data(port.num_vars, 9, 1)
    xj, evj = jnp.asarray(x), jnp.asarray(ev)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    with torch.inference_mode():
        got = {
            "comp": port.component_log_likelihoods(xt),
            "joint": port.log_likelihood(xt),
            "marginal": port.log_likelihood(xt, evt),
            "conditional": port.conditional_log_likelihood(xt, ~evt, evt),
        }
    want = {
        "comp": jax.jit(ref.component_log_likelihoods)(params, xj),
        "joint": jax.jit(ref.log_likelihood)(params, xj),
        "marginal": jax.jit(ref.log_likelihood)(params, xj, evj),
        "conditional": jax.jit(ref.conditional_log_likelihood)(
            params, xj, ~evj, evj),
    }
    assert got["comp"].shape == (9, C)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **LL_TOL)


def test_responsibilities_match_reference_and_saturate(mix_pair):
    ref, params, pnp, port = mix_pair
    d = port.num_vars
    x = np.random.RandomState(2).randn(4, d).astype(np.float32)
    with torch.inference_mode():
        r = port.responsibilities(torch.from_numpy(x)).numpy()
        # rows so far in the tails that every component underflows: the
        # clamped logits resolve to the uniform posterior, not NaN
        r_sat = port.responsibilities(torch.full((2, d), 1e8)).numpy()
    np.testing.assert_allclose(
        r, np.asarray(jax.jit(ref.responsibilities)(params, jnp.asarray(x))),
        **LL_TOL)
    np.testing.assert_allclose(r.sum(1), 1.0, atol=1e-6)
    assert np.all(np.isfinite(r_sat))
    np.testing.assert_allclose(r_sat, 1.0 / C, atol=1e-6)
    zero = EiNetMixture(port.component, C)
    zero.load_state_dict(mixture_params_from_jax(
        {**pnp, "mixture_weights": np.zeros(C, np.float32)}, zero))
    with torch.inference_mode():
        r0 = zero.responsibilities(torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(r0))
    np.testing.assert_allclose(r0.sum(1), 1.0, atol=1e-6)


def test_project_params_matches_reference(small_mix):
    ref, params, pnp, _ = small_mix
    bent = jax.tree_util.tree_map(lambda a: a * 1.7 + 0.01, pnp)
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    port.load_state_dict(mixture_params_from_jax(bent, port))
    port.project_params()
    want = jax.jit(ref.project_params)(
        jax.tree_util.tree_map(jnp.asarray, bent))
    _close_trees(mixture_params_to_numpy(port), want, "projected")


def test_mpe_matches_reference(mix_pair):
    ref, params, _, port = mix_pair
    x, ev = _data(port.num_vars, 6, 3)
    want = np.asarray(jax.jit(
        ref.conditional_sample_per_key, static_argnames=("mode",))(
        params, _keys(range(6)), jnp.asarray(x), jnp.asarray(ev),
        mode="argmax"))
    with torch.inference_mode():
        got = port.conditional_sample_per_key(
            list(range(6)), torch.from_numpy(x), torch.from_numpy(ev),
            mode="argmax").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[ev], x[ev])


def test_component_kinds_are_the_component_einet(pd_mix):
    _, _, pnp, port = pd_mix
    x, ev = _data(port.num_vars, 5, 4)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    single = EiNet(poon_domingos(4, 8, 2), num_sums=4, device="cpu")
    for c in range(C):
        comp = jax.tree_util.tree_map(lambda a: a[c], pnp["components"])
        single.load_state_dict(params_from_jax(comp, single))
        batch = {"x": xt, "evidence_mask": evt, "seeds": [7, 8, 9, 10, 11]}
        got = {k: port.query(batch, k, component=c)
               for k in MIXTURE_COMPONENT_KINDS}
        with torch.inference_mode():
            want = {
                "mixture_component_ll": single.log_likelihood(xt),
                "mixture_component_sample": single.conditional_sample_per_key(
                    batch["seeds"], xt, evt),
                "mixture_component_mpe": single.conditional_sample_per_key(
                    batch["seeds"], xt, evt, mode="argmax"),
            }
        for k in got:
            assert torch.equal(got[k], want[k]), (c, k)


def _grouped_sample_components(mix, choice, x, evidence_mask, noise, mode):
    """The grouped sampler the port used before its sampling went static:
    the rows that chose c run through component c together (the oracle
    for ``EiNetMixture._sample_components``)."""
    c_n = mix.num_components
    out = torch.empty_like(x)
    for c in torch.unique(choice).tolist():
        rows = torch.nonzero(choice == c)[:, 0]
        sub_noise = None if noise is None else noise[rows, c_n:]
        with mix.bound(c) as net:
            out[rows] = net.conditional_sample(
                x[rows], evidence_mask[rows], sub_noise, mode=mode)
    return out


@pytest.mark.parametrize("mode", ["sample", "argmax"])
def test_static_sampling_equals_grouped(pd_mix, mode):
    """Every component over all rows, each row keeping its chosen one,
    equals the grouped pass over each component's rows bit for bit (every
    op computes a row alone); the choices cover all three components."""
    _, _, _, port = pd_mix
    x, ev = _data(port.num_vars, 12, 6)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    seeds = list(range(600, 612))
    with torch.inference_mode():
        noise = None
        if mode == "sample":
            noise = port.component.row_noise(seeds, lead=C)
        choice = torch.arange(12) % C
        got = port._sample_components(choice, xt, evt, noise, mode)
        want = _grouped_sample_components(port, choice, xt, evt, noise, mode)
        assert torch.equal(got, want)
        full = port.conditional_sample_per_key(seeds, xt, evt, mode=mode)
        logits = port._log_weights()[None] + port.component_log_likelihoods(
            xt, evt)
        picks = port._choose(torch.clamp(logits, min=NEG_INF), noise)
        assert torch.equal(full, _grouped_sample_components(
            port, picks, xt, evt, noise, mode))


def test_mixture_sampling_row_independent(pd_mix):
    _, _, _, port = pd_mix
    x, ev = _data(port.num_vars, 6, 5)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    seeds = [30, 31, 32, 33, 34, 35]
    with torch.inference_mode():
        full = port.conditional_sample_per_key(seeds, xt, evt)
        alone = port.conditional_sample_per_key([32], xt[2:3], evt[2:3])
        other = port.conditional_sample_per_key([320], xt[2:3], evt[2:3])
        uncond = port.sample_per_key(seeds)
        uncond_alone = port.sample_per_key(seeds[4:5])
    np.testing.assert_array_equal(full.numpy()[ev], x[ev])
    assert torch.equal(full[2], alone[0])
    assert not torch.equal(alone, other)
    assert torch.equal(uncond[4], uncond_alone[0])
    with pytest.raises(ValueError, match="seeds"):
        port.conditional_sample_per_key([1], xt, evt)
    with pytest.raises(ValueError, match="mode"):
        port.conditional_sample_per_key(seeds, xt, evt, mode="greedy")


# Sampling against the reference.  The weights are skewed and the
# components' means differ, so draws that ignore the component choice (a
# mutation that always takes component 0, tried in a scratch copy) fail
# both tests; 16384 draws a side, 5 standard errors.
DRAWS = 16384
WEIGHTS = np.array([0.15, 0.6, 0.25], np.float32)


@pytest.fixture(scope="module")
def sampler_pair(small_mix):
    ref, params, pnp, _ = small_mix
    pnp = {**pnp, "mixture_weights": WEIGHTS}
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    port.load_state_dict(mixture_params_from_jax(pnp, port))
    return ref, jax.tree_util.tree_map(jnp.asarray, pnp), port


def _moments_agree(a, b, cols):
    n = a.shape[0]
    for f in (lambda v: v, lambda v: v * v):
        fa, fb = f(a[:, cols]), f(b[:, cols])
        se = np.sqrt(fa.var(0) / n + fb.var(0) / n)
        assert np.all(np.abs(fa.mean(0) - fb.mean(0)) <= 5 * se)


def test_mixture_sample_matches_reference_statistically(sampler_pair):
    ref, params, port = sampler_pair
    seeds = list(range(40_000, 40_000 + DRAWS))
    with torch.inference_mode():
        got = port.sample_per_key(seeds).numpy()
        noise = port.component.row_noise(seeds, lead=C)
        picks = port._choose(torch.log(port.mixture_weights)[None].expand(
            DRAWS, -1), noise).numpy()
    keys = _keys(range(DRAWS))
    want = np.asarray(jax.jit(ref.sample_per_key)(
        params, keys, jnp.zeros((DRAWS, 8))))
    want_picks = np.asarray(jax.vmap(lambda k: jax.random.categorical(
        jax.random.split(k)[0], jnp.log(params["mixture_weights"])))(keys))
    for freq in (np.bincount(picks, minlength=C) / DRAWS,
                 np.bincount(want_picks, minlength=C) / DRAWS):
        se = np.sqrt(WEIGHTS * (1 - WEIGHTS) / DRAWS)
        assert np.all(np.abs(freq - WEIGHTS) <= 5 * se), freq
    assert got.shape == want.shape == (DRAWS, 8) and np.isfinite(got).all()
    _moments_agree(got, want, np.arange(8))


def test_mixture_conditional_sample_matches_reference_statistically(
        sampler_pair):
    ref, params, port = sampler_pair
    rng = np.random.RandomState(12)
    x1 = rng.randn(8).astype(np.float32)
    ev1 = np.array([1, 0, 0, 1, 0, 1, 0, 0], bool)
    x, ev = np.tile(x1, (DRAWS, 1)), np.tile(ev1, (DRAWS, 1))
    with torch.inference_mode():
        got = port.conditional_sample_per_key(
            list(range(DRAWS)), torch.from_numpy(x),
            torch.from_numpy(ev)).numpy()
    want = np.asarray(jax.jit(ref.conditional_sample_per_key)(
        params, _keys(range(7, 7 + DRAWS)), jnp.asarray(x), jnp.asarray(ev)))
    np.testing.assert_array_equal(got[:, ev1], x[:, ev1])
    _moments_agree(got, want, np.flatnonzero(~ev1))


# ----------------------------------------------------------------- soft EM
def test_soft_statistics_match_reference(mix_pair):
    ref, params, pnp, port = mix_pair
    x, _ = _data(port.num_vars, 13, 6)
    ops.reset_counts()
    got = mixture_em_statistics(port, torch.from_numpy(x))
    # one forward a component under autograd, one backward pass in all
    fwd = (ops.gather_grouped_log_einsum_exp if port.component.needs_buffer
           else ops.grouped_log_einsum_exp)
    bwd = (ops.gather_grouped_log_einsum_exp_bwd
           if port.component.needs_buffer
           else ops.grouped_log_einsum_exp_bwd)
    assert (fwd.plain_calls, bwd.plain_calls) == (C, C)
    want = _ref(ref_mx.mixture_em_statistics, (0,))(ref, params, jnp.asarray(x))
    assert set(got) == set(want)
    for key in want:
        _close_trees(got[key], want[key], key)
    np.testing.assert_allclose(got["n_weight"].sum().item(), 13, rtol=1e-5)
    # two microbatches sum to the whole batch's statistics
    whole = mixture_em_statistics(port, torch.from_numpy(
        np.concatenate([x[:6]] * 2)))
    split = microbatched_mixture_em_statistics(port, torch.from_numpy(
        np.concatenate([x[:6]] * 2)), 2)
    _close_trees(split, whole, "microbatches")
    with pytest.raises(ValueError, match="divisible"):
        microbatched_mixture_em_statistics(port, torch.from_numpy(x), 2)


def test_soft_updates_match_reference(mix_pair):
    ref, params, pnp, port = mix_pair
    x, _ = _data(port.num_vars, 13, 7)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for mode, port_fn, ref_fn in (
            ("full", mixture_em_update, ref_mx.mixture_em_update),
            ("stochastic", stochastic_mixture_em_update,
             ref_mx.stochastic_mixture_em_update)):
        cfg = MixtureTrainConfig(assign="soft", mode=mode)
        new, ll = port_fn(port, xt, cfg)
        want, want_ll = _ref(ref_fn)(ref, params, xj,
                                     ref_mx.MixtureTrainConfig(
                                         assign="soft", mode=mode))
        _close_trees(new, want, mode)
        np.testing.assert_allclose(float(ll), float(want_ll), **TOL)
    # the mixture is unchanged until a step loads the new parameters
    _close_trees(mixture_params_to_numpy(port), pnp, "unchanged",
                 tol=dict(rtol=0, atol=0))


def test_soft_steps_match_reference(small_mix):
    ref, params, pnp, _ = small_mix
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    port.load_state_dict(mixture_params_from_jax(pnp, port))
    cfg = MixtureTrainConfig(assign="soft")
    step = make_mixture_em_step(port, cfg)
    ref_cfg = ref_mx.MixtureTrainConfig(assign="soft", donate=False)
    rng = np.random.RandomState(8)
    for i in range(3):
        xb = rng.randn(16, 8).astype(np.float32)
        ll = step(torch.from_numpy(xb))
        params, want_ll = _ref(ref_mx.stochastic_mixture_em_update)(
            ref, params, jnp.asarray(xb), ref_cfg)
        np.testing.assert_allclose(ll, float(want_ll), err_msg=f"step {i}",
                                   **TOL)
        _close_trees(mixture_params_to_numpy(port), params, f"step {i}")


def test_soft_full_em_is_monotone(small_mix):
    _, _, pnp, _ = small_mix
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=0),
                              num_sums=3, device="cpu"), C)
    port.load_state_dict(mixture_params_from_jax(pnp, port))
    x = torch.from_numpy(np.random.RandomState(5).randn(24, 8)
                         .astype(np.float32))
    lls = fit_mixture(port, [x] * 6,
                      MixtureTrainConfig(assign="soft", mode="full"))
    assert all(b >= a - 1e-5 * abs(a) for a, b in zip(lls, lls[1:])), lls
    assert lls[-1] > lls[0]


def test_single_component_soft_em_is_single_model_em():
    """A one-component soft mixture EM is single-model EM."""
    net = EiNet(random_binary_trees(8, 2, 2, seed=0), num_sums=3,
                device="cpu", seed=3)
    one = EiNetMixture(net, 1, seed=3)
    x = torch.from_numpy(np.random.RandomState(6).randn(16, 8)
                         .astype(np.float32))
    new, ll = mixture_em_update(one, x)
    with one.bound(0) as bound:
        want, want_ll = em.em_update(bound, x)
    np.testing.assert_allclose(float(ll), float(want_ll), atol=1e-5)
    comp = jax.tree_util.tree_map(lambda t: t[0], new["components"])
    _close_trees(comp, want, "C=1", tol=dict(rtol=1e-5, atol=2e-6))


# ----------------------------------------------------------------- hard EM
def test_hard_em_matches_reference(mix_pair):
    ref, params, pnp, port = mix_pair
    x = np.random.RandomState(7).randn(C, 8, port.num_vars).astype(
        np.float32)
    for mode in ("stochastic", "full"):
        new, ll = hard_mixture_em_update(port, torch.from_numpy(x),
                                         MixtureTrainConfig(mode=mode))
        want, want_ll = _ref(ref_mx.hard_mixture_em_update)(
            ref, params, jnp.asarray(x), ref_mx.MixtureTrainConfig(mode=mode))
        _close_trees(new, want, mode)
        np.testing.assert_allclose(float(ll), float(want_ll), **TOL)


@pytest.mark.parametrize("mode", ["stochastic", "full"])
def test_hard_em_is_bitwise_a_loop_of_single_model_steps(pd_mix, mode):
    _, _, pnp, port = pd_mix
    x = torch.from_numpy(np.random.RandomState(9).randn(C, 8, 32).astype(
        np.float32))
    new, _ = hard_mixture_em_update(port, x, MixtureTrainConfig(mode=mode))
    update = (stochastic_em_update_microbatched if mode == "stochastic"
              else em_update_microbatched)
    single = EiNet(poon_domingos(4, 8, 2), num_sums=4, device="cpu")
    for c in range(C):
        single.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(lambda a: a[c], pnp["components"]),
            single))
        want, _ = update(single, x[c], em.EMConfig(), 1)
        got = jax.tree_util.tree_map(lambda t: t[c], new["components"])
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b), (c, mode)
    assert torch.equal(new["mixture_weights"], port.mixture_weights)


def test_hard_em_validation_and_step_config(small_mix):
    _, _, _, port = small_mix
    with pytest.raises(ValueError, match="stacked"):
        hard_mixture_em_update(port, torch.zeros((2, 4, 8)))
    with pytest.raises(ValueError, match="assign"):
        make_mixture_em_step(port, MixtureTrainConfig(assign="fuzzy"))
    with pytest.raises(ValueError, match="mode"):
        make_mixture_em_step(port, MixtureTrainConfig(mode="sgd"))


def test_mixture_step_updates_in_place(pd_mix):
    _, _, pnp, _ = pd_mix
    port = EiNetMixture(EiNet(poon_domingos(4, 8, 2), num_sums=4,
                              device="cpu"), C)
    port.load_state_dict(mixture_params_from_jax(pnp, port))
    ids = [id(p) for p in port.parameters()]
    before = [p.detach().clone() for p in port.parameters()]
    ops.reset_counts()
    make_mixture_em_step(port)(torch.from_numpy(
        np.random.RandomState(1).randn(C, 6, 32).astype(np.float32)))
    assert [id(p) for p in port.parameters()] == ids
    changed = [not torch.equal(a, b)
               for a, b in zip(before, port.parameters())]
    assert any(changed)
    assert torch.equal(port.mixture_weights,  # hard EM keeps the weights
                       torch.from_numpy(pnp["mixture_weights"].copy()))
    # each component's E-step: the gather run and the root pair, forward
    # and backward, plain on the CPU
    assert (ops.gather_grouped_log_einsum_exp.plain_calls,
            ops.gather_grouped_log_einsum_exp_bwd.plain_calls,
            ops.log_einsum_exp.plain_calls,
            ops.log_einsum_exp_bwd.plain_calls) == (C, C, C, C)
    assert sum(op.launches for op in ops.KERNEL_OPS) == 0


def _capture_nothing_counted(calls):
    """A capture that records nothing and executes nothing (as a real
    capture); a replay runs the step, counted in ``calls``."""
    def capture(run, device, pool):
        calls["captures"] += 1

        def replay():
            calls["replays"] += 1
            run()

        return replay, None

    return capture


@pytest.mark.parametrize("mode", ["stochastic", "full"])
@pytest.mark.parametrize("assign", ["hard", "soft"])
def test_mixture_graph_step_equals_the_eager_update(pd_mix, assign, mode):
    """The mixture's step program (one graph: the hard step's loop over the
    components, or the soft step) through an injected capture: cached per
    (mixture, config), one capture, the first call one step, and every step
    bit for bit the eager update followed by ``load_mixture_params``."""
    from repro_torch import compile as compile_lib
    from repro_torch.mixture.train import load_mixture_params

    _, _, pnp, _ = pd_mix

    def fresh():
        port = EiNetMixture(EiNet(poon_domingos(4, 8, 2), num_sums=4,
                                  device="cpu"), C)
        port.load_state_dict(mixture_params_from_jax(pnp, port))
        return port

    g, e = fresh(), fresh()
    calls = {"captures": 0, "replays": 0}
    reg = compile_lib.ProgramRegistry(
        capture_fn=_capture_nothing_counted(calls))
    cfg = MixtureTrainConfig(assign=assign, mode=mode)
    step = make_mixture_em_step(g, cfg, registry=reg)
    assert make_mixture_em_step(g, cfg, registry=reg) is step
    if assign == "hard":
        update = hard_mixture_em_update
    elif mode == "stochastic":
        update = stochastic_mixture_em_update
    else:
        update = mixture_em_update
    rng = np.random.RandomState(11)
    shape = (C, 6, 32) if assign == "hard" else (18, 32)
    for i in range(3):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        ll = step(x)
        new, want = update(e, x, cfg)
        load_mixture_params(e, new)
        assert ll == float(want), i
        for a, b in zip(g.parameters(), e.parameters()):
            assert torch.equal(a, b), i
    assert calls == {"captures": 1, "replays": 3}
    lls = fit_mixture(g, [x], cfg, registry=reg)
    assert calls["replays"] == 4 and len(lls) == 1


def test_mixture_learns_clustered_data(blobs):
    """k-means + hard EM on separable blobs raises the mixture LL far above
    the initialisation."""
    x, _ = blobs
    port = EiNetMixture(EiNet(random_binary_trees(8, 2, 2, seed=2),
                              num_sums=3, device="cpu"), C)
    loader, km = prepare_mixture_training(port, x, seed=2, global_batch=48)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ll0 = port.log_likelihood(xt).mean().item()
    lls = fit_mixture(port, loader, num_steps=15)
    with torch.inference_mode():
        ll1 = port.log_likelihood(xt).mean().item()
    assert len(lls) == 15 and sorted(km.counts.tolist()) == [40, 40, 40]
    assert ll1 > ll0 + 5.0, (ll0, ll1)


# ----------------------------------------------------------------- serving
def _parity_requests(mix, rng):
    """Every kind, every component of the pinned kinds, two requests each
    (the reference's engine parity test)."""
    reqs = []
    for kind in MIXTURE_QUERY_KINDS:
        comps = range(mix.num_components) \
            if kind in mix.component_kinds else [None]
        for c in comps:
            for _ in range(2):
                x = rng.randn(mix.num_vars).astype(np.float32)
                ev = rng.rand(mix.num_vars) < 0.5
                reqs.append(Request(len(reqs), kind, x=x, evidence_mask=ev,
                                    query_mask=~ev, seed=500 + len(reqs),
                                    component=c))
    return reqs


def test_engine_parity_for_every_mixture_kind(mix_pair):
    _, _, _, port = mix_pair
    engine = ServeEngine(port, max_batch=4)
    reqs = _parity_requests(port, np.random.RandomState(11))
    results = engine.run(reqs)
    call = direct_call(port)
    par = parity(reqs, results, {r.req_id: call(r) for r in reqs},
                 port.value_kinds)
    assert par["ll_max_abs_diff"] <= 1e-5 and par["sample_mismatches"] == 0
    for r in reqs:
        v = results[r.req_id].value
        if r.kind == "mixture_responsibility":
            assert v.shape == (C,)
            np.testing.assert_allclose(v.sum(), 1.0, atol=1e-6)
        elif r.kind.endswith(("sample", "mpe")):
            assert v.shape == (port.num_vars,)
            if r.kind != "mixture_sample":
                np.testing.assert_array_equal(v[r.evidence_mask],
                                              r.x[r.evidence_mask])
        else:
            assert v.shape == () and np.isfinite(v)


def test_engine_component_validation(small_mix):
    _, _, _, port = small_mix
    engine = ServeEngine(port, max_batch=4)
    with pytest.raises(ValueError):
        engine.submit(Request(0, "joint_ll"))  # a single-EiNet kind
    with pytest.raises(ValueError):
        engine.submit(Request(0, "mixture_component_sample"))  # no component
    with pytest.raises(ValueError):
        engine.submit(Request(0, "mixture_component_sample", component=9))
    with pytest.raises(ValueError):
        engine.submit(Request(0, "mixture_joint_ll", component=1))
    batch = {"x": torch.zeros(1, 8), "evidence_mask": torch.zeros(
        1, 8, dtype=torch.bool), "seeds": [0]}
    with pytest.raises(ValueError, match="requires a component"):
        port.query(batch, "mixture_component_ll")
    with pytest.raises(ValueError, match="does not take"):
        port.query(batch, "mixture_mpe", component=0)
    with pytest.raises(ValueError, match="unknown query kind"):
        port.query(batch, "mpe")
    # the same kind for different components is never coalesced
    reqs = mixture_requests(port, 40, seed=3)
    engine.run(reqs)
    assert engine.stats["requests"] == 40


def test_mixture_requests_cycle_kinds_and_components():
    # the stream reads only the mixture's kinds and sizes
    mix = types.SimpleNamespace(
        num_vars=6, num_components=4, query_kinds=MIXTURE_QUERY_KINDS,
        component_kinds=MIXTURE_COMPONENT_KINDS)
    reqs = mixture_requests(mix, 80, seed=1)
    assert [r.kind for r in reqs[:10]] == list(MIXTURE_QUERY_KINDS)
    for kind in MIXTURE_COMPONENT_KINDS:
        # the k-th request of a pinned kind asks for component k % C
        assert [r.component for r in reqs if r.kind == kind] == [
            0, 1, 2, 3, 0, 1, 2, 3]
    for r in reqs:
        if r.kind not in MIXTURE_COMPONENT_KINDS:
            assert r.component is None
        assert r.seed == 1000 + r.req_id
        np.testing.assert_array_equal(r.query_mask, ~r.evidence_mask)


# ------------------------------------------------------------ carry-across
def test_mixture_params_round_trip_and_shape_checks(pd_mix):
    _, _, pnp, port = pd_mix
    back = mixture_params_to_numpy(port)
    _close_trees(back, pnp, "round trip", tol=dict(rtol=0, atol=0))
    other = EiNetMixture(port.component, C + 1)
    with pytest.raises(ValueError, match="shape"):
        mixture_params_from_jax(pnp, other)
    short = {"components": {**pnp["components"],
                            "einsum": pnp["components"]["einsum"][:-1]},
             "mixture_weights": pnp["mixture_weights"]}
    with pytest.raises(ValueError, match="pairs"):
        mixture_params_from_jax(short, port)
    assert params_to_numpy(port)["phi"].shape == (C, 32, 4, 1, 2)


# -------------------------------------------------------------------- CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("assign", ["hard", "soft"])
def test_train_cli_mixture_on_cpu(assign):
    out = _cli("--arch", "einet_rat", "--mixture", "3", "--mixture-assign",
               assign, "--steps", "2", "--batch", "48", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert f"mixture of 3 components, {assign}" in out.stdout
    assert "ms/step" in out.stdout
    assert "grouped_log_einsum_exp_bwd 0 (3)" in out.stdout
    assert ("k-means clusters" in out.stdout) == (assign == "hard")


def test_train_cli_celeba_mixture_on_cpu(tmp_path):
    out = _cli("--arch", "einet_celeba", "--dataset", "celeba",
               "--data-dir", str(tmp_path), "--mixture", "3", "--steps", "1",
               "--batch", "24", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "celeba (procedural): 3687 train rows" in out.stdout
    assert "batch 8 a component" in out.stdout
    assert "gather_grouped_log_einsum_exp_bwd 0 (3)" in out.stdout


def test_train_cli_mixture_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _cli("--arch", "einet_celeba", "--mixture", "8", "--steps", "1")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
