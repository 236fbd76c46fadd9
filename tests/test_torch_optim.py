"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim`` on the same inputs, carried across as numpy.

The codecs are held bit for bit: the same float32 operations in the same
order (blockwise absmax / 127, round half to even, clamp).  AdamW is held
within rtol 1e-5 (the power, cosine and square root may round their last
bit differently in XLA and ATen) for each of the three moment state
dtypes; the int8 moments within one quantization step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch import tree as tree_lib
from repro_torch.optim import adamw, compression

SIZES = [1, 255, 256, 257, 1000, 5000]


def _rand(seed, n, scale=10.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


# ------------------------------------------------------------------- codecs
@pytest.mark.parametrize("n", SIZES)
def test_int8_codec_bitwise_reference(n):
    for seed in range(3):
        x = _rand(seed, n)
        q, s = compression.quantize_int8(torch.from_numpy(x))
        rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        back = compression.dequantize_int8(q, s, (n,))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(ref_comp.dequantize_int8(rq, rs, (n,))))
        # error within half a quantization step per block
        bound = np.repeat(s.numpy(), compression.BLOCK)[:n] * 0.5 + 1e-6
        assert (np.abs(x - back.numpy()) <= bound + 1e-5).all()


def test_compress_with_feedback_bitwise_reference():
    g = _rand(0, 700, 0.1).reshape(7, 100)
    res = ref_res = None
    for i in range(4):
        (q, s), res = compression.compress_with_feedback(torch.from_numpy(g),
                                                         res)
        (rq, rs), ref_res = ref_comp.compress_with_feedback(jnp.asarray(g),
                                                            ref_res)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(res.numpy(), np.asarray(ref_res))


def test_error_feedback_removes_bias():
    g = torch.from_numpy(_rand(1, 512, 0.1))
    res, acc = None, torch.zeros(512)
    for _ in range(50):
        (q, s), res = compression.compress_with_feedback(g, res)
        acc = acc + compression.dequantize_int8(q, s, g.shape)
    assert float((acc - 50 * g).abs().max()) < float(g.abs().max()) * 0.02 + 1e-3


def test_topk_sparsify_and_densify_match_reference():
    x = np.asarray([0.1, -5.0, 0.2, 3.0, -0.05, 0.7, -0.3], np.float32)
    (vals, idx), res = compression.topk_sparsify(torch.from_numpy(x), 3, None)
    (rv, ri), rres = ref_comp.topk_sparsify(jnp.asarray(x), 3, None)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres))
    dense = compression.densify_topk(vals, idx, x.shape)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(ref_comp.densify_topk(rv, ri, x.shape)))
    np.testing.assert_allclose(dense.numpy(), [0, -5.0, 0, 3.0, 0, 0.7, 0])


def test_compressed_psum_one_rank_bitwise_reference():
    """Without a process group the job is one rank: the reference's
    ``compressed_psum`` over an axis of size 1."""
    g, r = _rand(2, 1000, 1.0), _rand(3, 1000, 0.01)
    out, res = compression.compressed_psum(torch.from_numpy(g), None,
                                           torch.from_numpy(r))
    rout, rres = jax.vmap(lambda a, b: ref_comp.compressed_psum(a, "d", b),
                          axis_name="d")(g[None], r[None])
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout)[0])
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres)[0])


# -------------------------------------------------------------------- AdamW
def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(300).astype(np.float32),
            "b": [rs.randn(5, 7).astype(np.float32),
                  rs.randn(3).astype(np.float32)]}


def _to_torch(tree):
    _, leaves = tree_lib.flatten(tree)
    return tree_lib.unflatten_like(tree, [torch.from_numpy(x) for x in leaves],
                                   lambda _, new: new)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(dtype):
    cfg = adamw.AdamWConfig(learning_rate=0.05, warmup_steps=2,
                            decay_steps=20, state_dtype=dtype)
    rcfg = ref_adamw.AdamWConfig(**cfg.__dict__)
    params = _tree(0)
    p, rp = _to_torch(params), jax.tree_util.tree_map(jnp.asarray, params)
    state, rstate = adamw.init_state(cfg, p), ref_adamw.init_state(rcfg, rp)
    for step in range(5):
        grads = _tree(10 + step)
        p, state, gn = adamw.apply_updates(cfg, p, _to_torch(grads), state)
        rp, rstate, rgn = ref_adamw.apply_updates(
            rcfg, rp, jax.tree_util.tree_map(jnp.asarray, grads), rstate)
        np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
        assert int(state["step"]) == int(rstate["step"]) == step + 1
        for a, b in zip(tree_lib.flatten(p)[1], jax.tree_util.tree_leaves(rp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        moments = tree_lib.leaves_like(p, state["moments"])
        ref_moments = tree_lib.leaves_like(params, rstate["moments"])
        for x, mom, rmom in zip(tree_lib.flatten(p)[1], moments, ref_moments):
            for k in ("m", "v"):
                got = adamw._decode(mom[k], x.shape, dtype).float().numpy()
                want = np.asarray(ref_adamw._decode(rmom[k], x.shape, dtype),
                                  np.float32)
                step_size = (np.abs(want).max() / 127.0 if dtype == "int8"
                             else 0.0)
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=step_size + 1e-7)


def test_lr_schedule_matches_reference():
    cfg = adamw.AdamWConfig(learning_rate=1.0, warmup_steps=10,
                            decay_steps=100, min_lr_ratio=0.1)
    rcfg = ref_adamw.AdamWConfig(**cfg.__dict__)
    got = [float(adamw.lr_schedule(cfg, torch.tensor(s))) for s in range(120)]
    want = [float(ref_adamw.lr_schedule(rcfg, jnp.asarray(s)))
            for s in range(120)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] < 0.2 and abs(max(got) - 1.0) < 1e-5
    assert abs(got[-1] - 0.1) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges(dtype):
    cfg = adamw.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                            warmup_steps=5, decay_steps=1000,
                            state_dtype=dtype)
    target = torch.tensor([1.5, -2.0, 0.5, 3.0])
    params = {"w": torch.zeros(4)}
    state = adamw.init_state(cfg, params)
    first = float(((params["w"] - target) ** 2).sum())
    for _ in range(120):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(((params["w"] - target) ** 2).sum()) < 0.05 * first


def test_adamw_grad_clip():
    cfg = adamw.AdamWConfig(learning_rate=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(cfg, params)
    huge = {"w": torch.tensor([1e6, -1e6, 1e6])}
    p2, _, gnorm = adamw.apply_updates(cfg, params, huge, state)
    assert float(gnorm) > 1e5
    assert float(p2["w"].abs().max()) < 5e-3
