"""The port's EiNet on the CPU against the JAX reference, with the same
parameters carried across as numpy (``repro_torch.convert``).

Tolerances: LL kinds rtol=1e-5, atol=1e-4 (log-densities of a 512-variable
model are around -700, where one float32 ulp is 6e-5, and the port sums in
another order than XLA); ``mpe`` (argmax decoding) must be identical.
Sampling draws from other random streams than the reference, so it is held
to the reference statistically: per-variable mean and second moment of
4096 draws on each side within 5 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import EiNet as RefEiNet
from repro.core import exponential_family as ref_ef
from repro.core import Normal as RefNormal
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro.launch.cells import build_einet as ref_build_einet
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import exponential_family as port_ef
from repro_torch.core import poon_domingos, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.core.layers import NEG_INF
from repro_torch.launch.cells import build_einet

LL_TOL = dict(rtol=1e-5, atol=1e-4)


def _carry(ref_model, port_model, seed=0):
    params = jax.jit(ref_model.init)(jax.random.PRNGKey(seed))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    port_model.load_state_dict(params_from_jax(pnp, port_model))
    return params


def _data(d, b, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(np.float32)
    ev = rng.rand(b, d) < 0.5
    return x, ev


def _ref_decode(ref, params, x, ev, key=0, mode="argmax"):
    fn = jax.jit(ref.conditional_sample, static_argnames=("mode",))
    return np.asarray(fn(params, jax.random.PRNGKey(key), jnp.asarray(x),
                         jnp.asarray(ev), mode=mode))


def _ll_kinds(ref, params, port, x, ev):
    xj, evj = jnp.asarray(x), jnp.asarray(ev)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    with torch.inference_mode():
        got = {
            "joint_ll": port.log_likelihood(xt),
            "marginal_ll": port.log_likelihood(xt, evt),
            "conditional_ll": port.conditional_log_likelihood(xt, ~evt, evt),
        }
    want = {
        "joint_ll": ref.log_likelihood(params, xj),
        "marginal_ll": ref.log_likelihood(params, xj, evj),
        "conditional_ll": ref.conditional_log_likelihood(params, xj, ~evj, evj),
    }
    for kind in got:
        np.testing.assert_allclose(got[kind].numpy(), np.asarray(want[kind]),
                                   err_msg=kind, **LL_TOL)


@pytest.fixture(scope="module")
def rat():
    ref = ref_build_einet(ref_get_config("einet_rat"))
    port = build_einet(get_config("einet_rat"), device="cpu")
    params = _carry(ref, port)
    return ref, params, port


def test_einet_rat_ll_kinds_match_reference(rat):
    ref, params, port = rat
    assert port.grouped_active  # the fused [0, 4) plan, as on the card
    x, ev = _data(port.num_vars, 8, 0)
    _ll_kinds(ref, params, port, x, ev)


def test_einet_rat_mpe_equals_reference(rat):
    ref, params, port = rat
    x, ev = _data(port.num_vars, 4, 1)
    want = _ref_decode(ref, params, x, ev)
    with torch.inference_mode():
        got = port.conditional_sample(torch.from_numpy(x),
                                      torch.from_numpy(ev), mode="argmax")
    np.testing.assert_array_equal(got.numpy(), want)


# the reference's CANONICAL_SHAPES (tests/test_grouped.py): fully canonical
# RAT shapes, including a 3-class root
CANONICAL_SHAPES = [(64, 3, 3, 10, 1), (64, 4, 2, 4, 3), (32, 2, 2, 6, 1)]


@pytest.mark.parametrize("shape", CANONICAL_SHAPES, ids=str)
def test_canonical_shapes_match_reference(shape):
    nv, depth, reps, k, nc = shape
    ref = RefEiNet(ref_rbt(nv, depth, reps, seed=0), num_sums=k,
                   num_classes=nc, exponential_family=RefNormal())
    port = EiNet(random_binary_trees(nv, depth, reps, seed=0), num_sums=k,
                 num_classes=nc, device="cpu")
    params = _carry(ref, port, seed=3)
    x, ev = _data(nv, 8, 2)
    _ll_kinds(ref, params, port, x, ev)
    want = _ref_decode(ref, params, x, ev)
    with torch.inference_mode():
        got = port.conditional_sample(torch.from_numpy(x),
                                      torch.from_numpy(ev), mode="argmax")
    np.testing.assert_array_equal(got.numpy(), want)


def test_grouped_plan_equals_per_layer_loop():
    g = random_binary_trees(64, 3, 3, seed=0)
    m_g = EiNet(g, num_sums=5, device="cpu", seed=1)
    m_p = EiNet(g, num_sums=5, grouped=False, device="cpu", seed=1)
    assert m_g.grouped_active and not m_p.grouped_active
    x = torch.from_numpy(_data(64, 6, 3)[0])
    with torch.inference_mode():
        assert torch.equal(m_g.log_likelihood(x), m_p.log_likelihood(x))


def test_pd_structure_on_cpu_matches_reference():
    """A gather-planned (Poon-Domingos) structure walks its plan on the CPU
    with the gather run's plain version, as it walks it on the card with
    the gather kernel."""
    ref = RefEiNet(ref_pd(4, 6, 2), num_sums=4, exponential_family=RefNormal())
    port = EiNet(poon_domingos(4, 6, 2), num_sums=4, device="cpu")
    assert port.needs_buffer and any(s.kind == "gather" for s in port.exec_plan)
    params = _carry(ref, port)
    x, ev = _data(port.num_vars, 5, 4)
    _ll_kinds(ref, params, port, x, ev)


# the reference's PD_SMOKE_SHAPES (tests/test_gather_grouped.py): (height,
# width, delta, K), each planned as one gather run and the root pair
PD_SMOKE_SHAPES = [(4, 8, 2, 4), (2, 8, 2, 6), (4, 4, 1, 3)]


@pytest.mark.parametrize("shape", PD_SMOKE_SHAPES, ids=str)
def test_pd_planned_forward_equals_per_layer_loop(shape):
    """The gather plan (one gather launch, the root pair per layer) is the
    per-layer loop's arithmetic, bit for bit, saturated leaf rows too."""
    h, w, delta, k = shape
    g = poon_domingos(h, w, delta)
    m_g = EiNet(g, num_sums=k, device="cpu", seed=2)
    m_p = EiNet(g, num_sums=k, grouped=False, device="cpu", seed=2)
    kinds = [s.kind for s in m_g.exec_plan]
    assert kinds == ["gather", "layer"] and not m_p.grouped_active
    x = torch.from_numpy(_data(h * w, 6, 6)[0])
    with torch.inference_mode():
        assert torch.equal(m_g.log_likelihood(x), m_p.log_likelihood(x))
        rows = m_g._leaf_rows(m_g.leaf_log_prob(x, None))
        rows[:, 0] = NEG_INF  # one leaf region fully marginalized
        a = m_g.forward_from_e(None, leaf_rows=rows)
        assert torch.isfinite(a).all()
        assert torch.equal(a, m_p.forward_from_e(None, leaf_rows=rows))


@pytest.mark.parametrize("shape", [(4, 8, 2, 4), (4, 4, 1, 3)], ids=str)
def test_pd_mpe_equals_reference(shape):
    h, w, delta, k = shape
    ref = RefEiNet(ref_pd(h, w, delta), num_sums=k,
                   exponential_family=RefNormal())
    port = EiNet(poon_domingos(h, w, delta), num_sums=k, device="cpu")
    params = _carry(ref, port, seed=4)
    x, ev = _data(h * w, 5, 7)
    want = _ref_decode(ref, params, x, ev)
    with torch.inference_mode():
        got = port.conditional_sample(torch.from_numpy(x),
                                      torch.from_numpy(ev), mode="argmax")
    np.testing.assert_array_equal(got.numpy(), want)
    _ll_kinds(ref, params, port, x, ev)


@pytest.mark.parametrize("arch", ["einet_pd", "einet_pd_mnist",
                                  "einet_celeba"])
def test_pd_archs_walk_one_gather_run(arch):
    """Every registered PD arch plans gather[0,2) layer[2,3): one gather
    launch and one per-layer launch a forward."""
    port = build_einet(get_config(arch), device="meta")
    assert [(s.start, s.stop, s.kind) for s in port.exec_plan] == [
        (0, 2, "gather"), (2, 3, "layer")]
    assert port.plan.launches()[1] == 3  # gather, root pair, root mixing


def test_full_marginalization_is_normalized():
    port = EiNet(random_binary_trees(12, 2, 3, seed=0), num_sums=5,
                 device="cpu")
    x = torch.zeros(4, 12)
    with torch.inference_mode():
        ll = port.log_likelihood(x, torch.zeros(4, 12, dtype=torch.bool))
    np.testing.assert_allclose(ll.numpy(), 0.0, atol=1e-5)


def test_project_params_and_param_round_trip_match_reference():
    ref = RefEiNet(ref_rbt(32, 2, 2, seed=0), num_sums=4,
                   exponential_family=RefNormal())
    port = EiNet(random_binary_trees(32, 2, 2, seed=0), num_sums=4,
                 device="cpu")
    params = ref.init(jax.random.PRNGKey(5))
    rng = np.random.RandomState(0)
    # push everything off its domain, then project on both sides
    noisy = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + rng.rand(*np.shape(a))).astype(np.float32),
        params)
    port.load_state_dict(params_from_jax(noisy, port))
    back = params_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(noisy),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    port.project_params()
    want = ref.project_params(jax.tree_util.tree_map(jnp.asarray, noisy))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(params_to_numpy(port))):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)


def test_params_from_jax_rejects_wrong_shapes():
    ref = RefEiNet(ref_rbt(32, 2, 2, seed=0), num_sums=4,
                   exponential_family=RefNormal())
    port = EiNet(random_binary_trees(32, 2, 2, seed=0), num_sums=3,
                 device="cpu")
    pnp = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(pnp, port)


# ------------------------------------------------------ exponential families
EF_CASES = [
    ("normal", {}, lambda r, s: np.stack(
        [r.randn(*s), r.randn(*s) ** 2 + 0.5 + r.rand(*s)], -1),
     lambda r, b, d: r.randn(b, d)),
    ("bernoulli", {}, lambda r, s: r.rand(*s, 1),
     lambda r, b, d: (r.rand(b, d) < 0.5).astype(float)),
    ("binomial", {"n_trials": 7}, lambda r, s: 7 * r.rand(*s, 1),
     lambda r, b, d: r.randint(0, 8, (b, d)).astype(float)),
    ("categorical", {"num_categories": 5}, lambda r, s: r.dirichlet(
        np.ones(5), size=s), lambda r, b, d: r.randint(0, 5, (b, d)).astype(float)),
]


@pytest.mark.parametrize("case", EF_CASES, ids=lambda c: c[0])
def test_exponential_families_match_reference(case):
    name, kw, make_phi, make_x = case
    rng = np.random.RandomState(len(name))
    phi = make_phi(rng, (6, 3, 2)).astype(np.float32)
    x = make_x(rng, 4, 6).astype(np.float32)
    a = port_ef.make_exponential_family(name, **kw)
    b = ref_ef.make_exponential_family(name, **kw)
    np.testing.assert_allclose(
        a.log_prob(torch.from_numpy(x), torch.from_numpy(phi)).numpy(),
        np.asarray(b.log_prob(jnp.asarray(x), jnp.asarray(phi))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a.mode(torch.from_numpy(phi)).numpy(),
                                  np.asarray(b.mode(jnp.asarray(phi))))
    np.testing.assert_allclose(a.project_phi(torch.from_numpy(phi)).numpy(),
                               np.asarray(b.project_phi(jnp.asarray(phi))),
                               rtol=1e-6)
    # draws from the port's uniforms follow the family's mean
    n = 20000
    u = torch.rand((n,) + phi.shape[:-1] + (a.noise_per_draw,),
                   generator=torch.Generator().manual_seed(0))
    u = torch.clamp(u, 2 ** -24, 1 - 2 ** -24)
    draws = a.sample(torch.from_numpy(phi)[None].expand(n, *phi.shape), u)
    ref_draws = np.asarray(b.sample(jax.random.PRNGKey(1), jnp.broadcast_to(
        jnp.asarray(phi), (n,) + phi.shape)))
    se = np.sqrt(draws.numpy().var(0) / n + ref_draws.var(0) / n) + 1e-6
    assert np.all(np.abs(draws.numpy().mean(0) - ref_draws.mean(0)) < 5 * se + 1e-3)


@pytest.mark.parametrize("n_trials", [1, 7, 255])
def test_binomial_log_h_constant_is_unchanged(n_trials):
    """log N! is computed once, in float32 on the CPU, and kept as a Python
    float: log h equals, bit for bit, the per-call float32 lgamma of a
    tensor it replaces, at every x in 0..N."""
    ef = port_ef.Binomial(n_trials)
    x = torch.arange(n_trials + 1, dtype=torch.float32)[None].repeat(3, 1)
    want = (torch.lgamma(torch.tensor(float(n_trials + 1)))
            - torch.lgamma(x + 1.0) - torch.lgamma(n_trials - x + 1.0))
    assert isinstance(ef.log_n_factorial, float)
    assert torch.equal(ef.log_h(x), want) and ef.log_h(x).dtype == torch.float32


def test_init_phi_uses_the_generator():
    ef = port_ef.Normal()
    a = ef.init_phi(torch.Generator().manual_seed(4), (3, 2, 2))
    b = ef.init_phi(torch.Generator().manual_seed(4), (3, 2, 2))
    assert torch.equal(a, b)
    m1 = EiNet(random_binary_trees(12, 2, 3, seed=0), num_sums=3, device="cpu",
               seed=9)
    m2 = EiNet(random_binary_trees(12, 2, 3, seed=0), num_sums=3, device="cpu",
               seed=9)
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------------------------ sampling
@pytest.fixture(scope="module")
def sampler_pair():
    ref = RefEiNet(ref_rbt(32, 2, 2, seed=0), num_sums=4,
                   exponential_family=RefNormal())
    port = EiNet(random_binary_trees(32, 2, 2, seed=0), num_sums=4,
                 device="cpu")
    params = _carry(ref, port, seed=7)
    return ref, params, port


def _moments_agree(a, b, cols):
    n = a.shape[0]
    for f in (lambda v: v, lambda v: v * v):
        fa, fb = f(a[:, cols]), f(b[:, cols])
        se = np.sqrt(fa.var(0) / n + fb.var(0) / n)
        assert np.all(np.abs(fa.mean(0) - fb.mean(0)) <= 5 * se)


def test_sample_matches_reference_statistically(sampler_pair):
    ref, params, port = sampler_pair
    n = 4096
    with torch.inference_mode():
        got = port.sample(n, seeds=range(10_000, 10_000 + n)).numpy()
    want = np.asarray(jax.jit(ref.sample, static_argnames=("num_samples",))(
        params, jax.random.PRNGKey(3), num_samples=n))
    assert got.shape == want.shape == (n, 32) and np.isfinite(got).all()
    _moments_agree(got, want, np.arange(32))


def test_conditional_sample_matches_reference_statistically(sampler_pair):
    ref, params, port = sampler_pair
    n = 4096
    rng = np.random.RandomState(11)
    x1 = rng.randn(32).astype(np.float32)
    ev1 = rng.rand(32) < 0.5
    x, ev = np.tile(x1, (n, 1)), np.tile(ev1, (n, 1))
    with torch.inference_mode():
        got = port.conditional_sample_per_key(
            list(range(n)), torch.from_numpy(x), torch.from_numpy(ev)).numpy()
    want = _ref_decode(ref, params, x, ev, key=4, mode="sample")
    np.testing.assert_array_equal(got[:, ev1], x[:, ev1])  # evidence unchanged
    _moments_agree(got, want, np.flatnonzero(~ev1))


def test_row_draw_depends_only_on_its_seed(sampler_pair):
    _, _, port = sampler_pair
    x, ev = _data(32, 6, 5)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    with torch.inference_mode():
        full = port.conditional_sample_per_key([5, 6, 7, 8, 9, 10], xt, evt)
        alone = port.conditional_sample_per_key([7], xt[2:3], evt[2:3])
        other = port.conditional_sample_per_key([7], xt[2:3], evt[2:3])
        diff = port.conditional_sample_per_key([70], xt[2:3], evt[2:3])
    assert torch.equal(full[2], alone[0]) and torch.equal(alone, other)
    assert not torch.equal(alone, diff)
    with pytest.raises(ValueError, match="seeds"):
        port.conditional_sample_per_key([1], xt, evt)


# Poon-Domingos sampling: the Gumbel draws at the interior mixing layers
# (the ("mix", i) noise slices) against the reference's draws.  With these
# params the mixing's children differ little, so 4096 draws a side cannot
# tell a mixing that always takes its first child from the right one;
# 16384 can (5 standard errors).
PD_DRAWS = 16384


@pytest.fixture(scope="module")
def pd_sampler_pair():
    ref = RefEiNet(ref_pd(4, 8, 2), num_sums=4, exponential_family=RefNormal())
    port = EiNet(poon_domingos(4, 8, 2), num_sums=4, device="cpu")
    params = _carry(ref, port, seed=7)
    # mixing layers below the root, whose draws are the ("mix", i) slices
    assert any(m.shape[0] > 0 for m in port.mixing[:-1])
    return ref, params, port


def test_pd_sample_matches_reference_statistically(pd_sampler_pair):
    ref, params, port = pd_sampler_pair
    n = PD_DRAWS
    with torch.inference_mode():
        got = port.sample(n, seeds=range(20_000, 20_000 + n)).numpy()
    want = np.asarray(jax.jit(ref.sample, static_argnames=("num_samples",))(
        params, jax.random.PRNGKey(5), num_samples=n))
    assert got.shape == want.shape == (n, 32) and np.isfinite(got).all()
    _moments_agree(got, want, np.arange(32))


def test_pd_conditional_sample_matches_reference_statistically(
        pd_sampler_pair):
    ref, params, port = pd_sampler_pair
    n = PD_DRAWS
    rng = np.random.RandomState(12)
    x1 = rng.randn(32).astype(np.float32)
    ev1 = rng.rand(32) < 0.5
    x, ev = np.tile(x1, (n, 1)), np.tile(ev1, (n, 1))
    with torch.inference_mode():
        got = port.conditional_sample_per_key(
            list(range(n)), torch.from_numpy(x), torch.from_numpy(ev)).numpy()
    want = _ref_decode(ref, params, x, ev, key=6, mode="sample")
    np.testing.assert_array_equal(got[:, ev1], x[:, ev1])  # evidence unchanged
    _moments_agree(got, want, np.flatnonzero(~ev1))
