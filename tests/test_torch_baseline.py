"""The port's naive baseline (``repro_torch.core.baseline``) on the CPU
against the reference's (``repro.core.baseline``) and against the port's
own EiNet, with the same parameters carried across as numpy.

Tolerances: LLs rtol 1e-5, atol 1e-4 (the reference's naive net against
the port's, and the port's two nets, as ``tests/test_einet.py``'s
``test_naive_baseline_parity``); one EM update's parameters rtol 1e-4,
atol 1e-6 (the E-step sums over the batch in another order); MPE decodes
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EiNet as RefEiNet
from repro.core import NaiveEiNet as RefNaiveEiNet
from repro.core import Normal as RefNormal
from repro.core import em_update as ref_em_update
from repro.core import poon_domingos as ref_pd
from repro.core import random_binary_trees as ref_rbt
from repro.core.baseline import log_einsum_exp_naive as ref_naive
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    EiNet,
    NaiveEiNet,
    em_update,
    poon_domingos,
    random_binary_trees,
)
from repro_torch.core.baseline import log_einsum_exp_naive
from repro_torch.core.layers import log_einsum_exp
from repro_torch.kernels import ops

LL_TOL = dict(rtol=1e-5, atol=1e-4)
EM_TOL = dict(rtol=1e-4, atol=1e-6)

# (name, reference graph, port graph, K): a RAT of the reference's naive
# parity test and a small Poon-Domingos graph, whose pairs have mixing
STRUCTURES = {
    "rat": (lambda: ref_rbt(12, 2, 3, seed=0),
            lambda: random_binary_trees(12, 2, 3, seed=0), 5),
    "pd": (lambda: ref_pd(4, 4, 2, 1, ("h", "w")),
           lambda: poon_domingos(4, 4, 2, 1, ("h", "w")), 3),
}


def _carry(ref, ports, seed=0):
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    for port in ports:
        port.load_state_dict(params_from_jax(pnp, port))
    return params


@pytest.fixture(scope="module", params=list(STRUCTURES))
def nets(request):
    ref_graph, port_graph, k = STRUCTURES[request.param]
    ref = RefNaiveEiNet(ref_graph(), num_sums=k,
                        exponential_family=RefNormal())
    naive = NaiveEiNet(port_graph(), num_sums=k, device="cpu")
    einet = EiNet(port_graph(), num_sums=k, device="cpu")
    params = _carry(ref, [naive, einet])
    return ref, params, naive, einet


def _data(d, b, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(b, d).astype(np.float32), rng.rand(b, d) < 0.5


def test_log_einsum_exp_naive_matches_reference():
    rng = np.random.RandomState(0)
    b, l, k_out, k = 5, 3, 4, 6
    w = rng.rand(l, k_out, k, k).astype(np.float32) + 0.05
    w /= w.sum(axis=(2, 3), keepdims=True)
    w[0, 1, 2, 3] = 0.0  # an exact zero: log(max(w, 1e-38)), a subnormal
    left = (rng.randn(b, l, k) * 3 - 10).astype(np.float32)
    right = (rng.randn(b, l, k) * 3 - 10).astype(np.float32)
    left[1, 2] = -np.inf  # a row at -inf: every product of it is -inf
    got = log_einsum_exp_naive(*map(torch.from_numpy, (w, left, right)))
    want = np.asarray(ref_naive(*map(jnp.asarray, (w, left, right))))
    assert np.isneginf(want[1, 2]).all()
    assert np.isneginf(got.numpy()[1, 2]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the einsum layer's plain path on the finite rows
    lee = log_einsum_exp(*map(torch.from_numpy, (w, left, right)))
    fin = np.isfinite(want)
    np.testing.assert_allclose(lee.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-5)


def test_naive_net_is_per_layer_and_launches_no_grouped_op(nets):
    _, _, naive, einet = nets
    assert not naive.grouped and not naive.grouped_active
    assert {s.kind for s in naive.exec_plan} == {"layer"}
    x, _ = _data(naive.num_vars, 6, 1)
    ops.reset_counts()
    with torch.inference_mode():
        naive.log_likelihood(torch.from_numpy(x))
    from repro_torch.core.em import em_statistics
    em_statistics(naive, torch.from_numpy(x))
    assert all(op.launches == 0 and op.plain_calls == 0
               for op in ops.KERNEL_OPS)
    # the EiNet of the same structure goes through the ops
    with torch.inference_mode():
        einet.log_likelihood(torch.from_numpy(x))
    assert sum(op.plain_calls for op in ops.KERNEL_OPS) > 0


def test_naive_ll_matches_reference_naive(nets):
    ref, params, naive, _ = nets
    x, ev = _data(naive.num_vars, 16, 2)
    with torch.inference_mode():
        joint = naive.log_likelihood(torch.from_numpy(x))
        marg = naive.log_likelihood(torch.from_numpy(x), torch.from_numpy(ev))
    np.testing.assert_allclose(
        joint.numpy(), np.asarray(ref.log_likelihood(params, jnp.asarray(x))),
        **LL_TOL)
    np.testing.assert_allclose(
        marg.numpy(), np.asarray(ref.log_likelihood(
            params, jnp.asarray(x), jnp.asarray(ev))), **LL_TOL)


def test_naive_baseline_parity_in_the_port(nets):
    """The port's einsum layers equal its naive log-sum-exp layers (the
    reference's ``test_naive_baseline_parity``)."""
    _, _, naive, einet = nets
    x, ev = _data(naive.num_vars, 16, 3)
    xt, evt = torch.from_numpy(x), torch.from_numpy(ev)
    with torch.inference_mode():
        for mask in (None, evt):
            np.testing.assert_allclose(
                naive.log_likelihood(xt, mask).numpy(),
                einet.log_likelihood(xt, mask).numpy(), atol=1e-4)


def test_naive_em_update_matches_reference(nets):
    ref, params, naive, _ = nets
    x, _ = _data(naive.num_vars, 24, 4)
    want, want_ll = jax.jit(lambda p, b: ref_em_update(ref, p, b))(
        params, jnp.asarray(x))
    got, got_ll = em_update(naive, torch.from_numpy(x))
    np.testing.assert_allclose(float(got_ll), float(want_ll), **LL_TOL)
    for key in ("phi", "class_prior"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **EM_TOL)
    for key in ("einsum", "mixing"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{key}[{i}]", **EM_TOL)


def test_naive_mpe_equals_einet(nets):
    ref, params, naive, einet = nets
    x, ev = _data(naive.num_vars, 8, 5)
    batch = {"x": torch.from_numpy(x), "evidence_mask": torch.from_numpy(ev),
             "seeds": torch.arange(8)}
    got = naive.query(batch, "mpe")
    np.testing.assert_array_equal(got.numpy(), einet.query(batch, "mpe").numpy())
    want = jax.jit(ref.conditional_sample, static_argnames=("mode",))(
        params, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ev),
        mode="argmax")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_naive_net_takes_the_einet_constructor():
    ref = RefEiNet(ref_rbt(8, 2, 2, seed=1), num_sums=3,
                   exponential_family=RefNormal())
    naive = NaiveEiNet(random_binary_trees(8, 2, 2, seed=1), num_sums=3,
                       num_classes=1, device="cpu", seed=4)
    einet = EiNet(random_binary_trees(8, 2, 2, seed=1), num_sums=3,
                  device="cpu", seed=4)
    for a, b in zip(naive.parameters(), einet.parameters()):
        assert torch.equal(a, b)
    assert [p.shape for p in naive.parameters()] == [
        p.shape for p in einet.parameters()]
    params = _carry(ref, [naive])
    x, _ = _data(8, 4, 6)
    with torch.inference_mode():
        got = naive.log_likelihood(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref.log_likelihood(params, jnp.asarray(x))), **LL_TOL)
