"""The port's kernel modules on the CPU: each kernel's plain PyTorch version,
forward and backward, against the JAX reference (its XLA path and its
Pallas kernels in interpret mode), the CPU side of dispatch and autograd,
and the launch-geometry rules the CUDA wrappers apply.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these plain versions.

Tolerance: rtol=1e-5, atol=1e-5 on finite outputs.  The order of summation
differs between torch.einsum, XLA's einsum and the Pallas matmul (the
reference's own interpret path is off from its XLA path by up to 7.6e-6),
so bit equality is not expected; outputs at -inf, and at NEG_INF
saturation, must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as ref_layers
from repro.core.plan import GatherTables as RefGatherTables
from repro.kernels import ops as ref_ops
from repro_torch.configs import get_config
from repro_torch.core import layers, poon_domingos
from repro_torch.core.einet import EiNet
from repro_torch.core.layers import NEG_INF
from repro_torch.kernels import build, grouped, log_einsum_exp, ops
from repro_torch.launch.cells import build_einet

RTOL = ATOL = 1e-5
KS = (3, 4, 5, 10, 13, 17)


def _w(rng, cells, k_out, k):
    w = rng.rand(cells, k_out, k, k).astype(np.float32) + 0.05
    return w / w.sum(axis=(-2, -1), keepdims=True)


def _x(rng, b, rows, k):
    x = (rng.randn(b, rows, k) * 4 - 10).astype(np.float32)
    x[0] = NEG_INF                      # every cell fully masked
    x[1, 0] = -np.inf                   # one cell at log 0
    x[2, 1, : k // 2 + 1] = -np.inf     # partly -inf
    x[3, 0] = 4 * NEG_INF               # saturated below the clamp
    return x


def _check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_array_equal(got[0], want[0])  # NEG_INF saturation
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", KS)
def test_log_einsum_exp_plain_matches_reference(k):
    rng = np.random.RandomState(k)
    b, l_cells, k_out = 9, 3, (1 if k == 3 else k + 2)
    w, x = _w(rng, l_cells, k_out, k), _x(rng, b, 2 * l_cells, k)
    l, r = x[:, :l_cells], x[:, l_cells:]
    got = log_einsum_exp.log_einsum_exp_plain(
        torch.from_numpy(w), torch.from_numpy(l), torch.from_numpy(r))
    wj, lj, rj = jnp.asarray(w), jnp.asarray(l), jnp.asarray(r)
    _check(got, ref_layers.log_einsum_exp(wj, lj, rj, impl="xla"))
    _check(got, ref_ops.log_einsum_exp(wj, lj, rj))  # Pallas, interpret


# (G, L_out, K, K_out of the final depth): the CANONICAL_SHAPES runs of
# tests/test_grouped.py (multi-class root included) and the odd K sweep
GROUP_SHAPES = [(3, 3, 10, 1), (4, 2, 4, 3), (2, 2, 6, 1)] + [
    (2, 2, k, 2) for k in (3, 5, 13, 17)]


@pytest.mark.parametrize("shape", GROUP_SHAPES, ids=str)
def test_grouped_plain_matches_reference(shape):
    g, l_out, k, kf = shape
    rng = np.random.RandomState(sum(shape))
    ws = [_w(rng, l_out * 2 ** (g - 1 - d), k if d < g - 1 else kf, k)
          for d in range(g)]
    x = _x(rng, 7, l_out * 2 ** g, k)
    got = grouped.grouped_log_einsum_exp_plain(
        [torch.from_numpy(w) for w in ws], torch.from_numpy(x))
    wj = [jnp.asarray(w) for w in ws]
    xj = jnp.asarray(x)
    _check(got, ref_layers.grouped_log_einsum_exp(wj, xj, 1, 8, impl="xla"))
    # Pallas, interpret: one output cell per program, 8-row batch tiles
    _check(got, ref_ops.grouped_log_einsum_exp(1, 8, tuple(wj), xj))


def test_grouped_plain_is_the_per_layer_chain():
    rng = np.random.RandomState(0)
    ws = [torch.from_numpy(_w(rng, 2 * 2 ** (2 - d), 5, 5)) for d in range(3)]
    x = torch.from_numpy(_x(rng, 6, 16, 5))
    cur = x
    for w in ws:
        h = w.shape[0]
        cur = layers.log_einsum_exp(w, cur[:, :h], cur[:, h:2 * h])
    assert torch.equal(grouped.grouped_log_einsum_exp_plain(ws, x), cur)


@pytest.mark.parametrize("b,m,c,k", [(5, 2, 3, 4), (4, 1, 10, 1)])
def test_log_mix_exp_matches_reference(b, m, c, k):
    rng = np.random.RandomState(b + c)
    v = rng.rand(m, c, k).astype(np.float32) + 0.1
    mask = np.ones((m, c), np.float32)
    mask[0, -1] = 0.0  # one padded child
    v = v * mask[:, :, None]
    v /= v.sum(axis=1, keepdims=True)
    ln = (rng.randn(b, m, c, k) * 3).astype(np.float32)
    ln[0] = NEG_INF
    ln[1, 0, 0] = -np.inf
    got = layers.log_mix_exp(torch.from_numpy(v), torch.from_numpy(ln),
                             torch.from_numpy(mask))
    want = ref_layers.log_mix_exp(jnp.asarray(v), jnp.asarray(ln),
                                  jnp.asarray(mask))
    _check(got, want)


def test_normalizers_match_reference():
    rng = np.random.RandomState(3)
    w = rng.rand(3, 2, 4, 4).astype(np.float32)
    v = rng.rand(2, 3, 4).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    np.testing.assert_allclose(
        layers.normalize_einsum_weights(torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.normalize_einsum_weights(jnp.asarray(w))),
        rtol=1e-6)
    np.testing.assert_allclose(
        layers.normalize_mixing_weights(
            torch.from_numpy(v), torch.from_numpy(mask)).numpy(),
        np.asarray(ref_layers.normalize_mixing_weights(
            jnp.asarray(v), jnp.asarray(mask))),
        rtol=1e-6)


# ------------------------------------------------------------------ dispatch
def test_cpu_tensors_run_the_plain_version():
    rng = np.random.RandomState(1)
    w = torch.from_numpy(_w(rng, 2, 3, 4))
    x = torch.from_numpy(_x(rng, 5, 4, 4))
    ops.reset_counts()
    out = ops.log_einsum_exp(w, x[:, :2], x[:, 2:])
    assert torch.equal(out, layers.log_einsum_exp(w, x[:, :2], x[:, 2:]))
    ws = [torch.from_numpy(_w(rng, 2, 4, 4)), torch.from_numpy(_w(rng, 1, 2, 4))]
    out = ops.grouped_log_einsum_exp(ws, x)
    assert torch.equal(out, layers.grouped_log_einsum_exp(ws, x))
    assert out.shape == (5, 1, 2)
    assert ops.log_einsum_exp.plain_calls == 1
    assert ops.grouped_log_einsum_exp.plain_calls == 1
    assert ops.log_einsum_exp.launches == 0
    assert ops.grouped_log_einsum_exp.launches == 0
    ops.reset_counts()
    assert ops.log_einsum_exp.plain_calls == 0


def test_other_devices_and_mixed_devices_raise():
    w = torch.empty(2, 3, 4, 4, device="meta")
    x = torch.empty(5, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.log_einsum_exp(w, x[:, :2], x[:, 2:])
    with pytest.raises(ValueError, match="several devices"):
        ops.log_einsum_exp(torch.zeros(2, 3, 4, 4), x[:, :2], x[:, 2:])


# ------------------------------------------------------- launch geometry
def test_k_out_tile_fits_shared_memory():
    assert log_einsum_exp.k_out_tile(10, 10, backward=True) == 10
    kt = log_einsum_exp.k_out_tile(40, 40, backward=True)
    assert 1 <= kt < 40
    assert (log_einsum_exp.bwd_smem_bytes(40, kt)
            <= log_einsum_exp.SMEM_LIMIT_BYTES
            < log_einsum_exp.bwd_smem_bytes(40, kt + 1))
    assert log_einsum_exp.k_out_tile(10, 10) == 10
    assert log_einsum_exp.k_out_tile(10, 1) == 1
    kt = log_einsum_exp.k_out_tile(40, 40)  # one K=40 cell is 256 KB
    assert 1 <= kt < 40
    assert log_einsum_exp.smem_bytes(40, kt) <= log_einsum_exp.SMEM_LIMIT_BYTES
    assert log_einsum_exp.smem_bytes(40, kt + 1) > log_einsum_exp.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError):
        log_einsum_exp.k_out_tile(300, 1)


def test_grouped_tile_and_shared_memory_rules():
    # einet_rat's fused run [0, 4): 32-row tiles, a whole depth's 8,000
    # weight floats at a time
    tb = grouped.pick_tile_b(4, 10, [10, 10, 10, 1])
    w_f, a_f, b_f, total = grouped.smem_layout(4, 10, [10, 10, 10, 1], tb)
    assert tb == 32 and w_f == 8 * 10 * 100
    assert a_f == 32 * 16 * 10 and b_f == 32 * 8 * 10
    assert total <= log_einsum_exp.SMEM_LIMIT_BYTES
    # a K=64 subtree (einet_rat_large's fused [0, 2)): 1 MB cells are staged
    # a K_out tile at a time beside 32-row tiles
    tb = grouped.pick_tile_b(2, 64, [64, 64])
    w_f, _, _, total = grouped.smem_layout(2, 64, [64, 64], tb)
    assert tb == 32 and total <= log_einsum_exp.SMEM_LIMIT_BYTES
    assert w_f < 64 * 64 * 64 and w_f >= 64 * 64
    cells, kt = grouped.depth_chunks(2, 64, 64, w_f)
    assert cells == 1 and 1 <= kt < 64
    # refused only when one row and one weight row do not fit
    with pytest.raises(ValueError, match="single row"):
        grouped.pick_tile_b(2, 240, [240, 240])


def test_grouped_backward_shared_memory_rules():
    # einet_rat's [0, 4) at a 32-row tile: one depth's weights, the
    # 16+8+4+2 stabilised rows and maxes, cotangent areas of 8 and 16 rows
    tb = grouped.pick_tile_b(4, 10, [10, 10, 10, 1], grouped.bwd_smem_layout)
    w_f, c0, c1, total = grouped.bwd_smem_layout(4, 10, [10, 10, 10, 1], tb)
    assert tb == 32 and w_f == 8000
    assert c0 == 32 * 8 * 10 and c1 == 32 * 16 * 10
    assert total == 4 * (8000 + 32 * 30 * 11 + c0 + c1) == 104_960
    # K = 64 fits with K_out tiles, as in the forward
    tb = grouped.pick_tile_b(2, 64, [64, 64], grouped.bwd_smem_layout)
    w_f, _, _, total = grouped.bwd_smem_layout(2, 64, [64, 64], tb)
    assert total <= log_einsum_exp.SMEM_LIMIT_BYTES
    assert grouped.depth_chunks(2, 64, 64, w_f)[0] == 1
    with pytest.raises(ValueError, match="single row"):
        grouped.pick_tile_b(2, 240, [240, 240], grouped.bwd_smem_layout)


@pytest.mark.parametrize("cells,k_out,k,w_floats,want", [
    (8, 10, 10, 8000, (8, 10)),      # the whole depth
    (8, 10, 10, 2500, (2, 10)),      # whole cells, two at a time
    (2, 64, 64, 45056, (1, 11)),     # one cell's K_out tile
])
def test_depth_chunks(cells, k_out, k, w_floats, want):
    assert grouped.depth_chunks(cells, k_out, k, w_floats) == want


def test_group_geometry_rejects_non_canonical_runs():
    ws = [torch.zeros(4, 5, 5, 5), torch.zeros(2, 1, 5, 5)]
    assert grouped.group_geometry(ws, torch.zeros(3, 8, 5)) == (2, 2, 5, [5, 1])
    with pytest.raises(ValueError, match="rows"):
        grouped.group_geometry(ws, torch.zeros(3, 6, 5))
    with pytest.raises(ValueError, match="canonical halving"):
        grouped.group_geometry([torch.zeros(3, 5, 5, 5), ws[1]],
                               torch.zeros(3, 8, 5))
    with pytest.raises(ValueError, match="interior"):
        grouped.group_geometry([torch.zeros(4, 3, 5, 5), ws[1]],
                               torch.zeros(3, 8, 5))


def test_build_sources_exist_and_library_names_track_sources():
    for name in build.SOURCES:
        src = build.CSRC / f"{name}.cu"
        text = src.read_text()
        assert "sm_90a" in text and "Replaces the TPU kernel" in text
        assert build._library_path(name).name.startswith(name + "-")
    assert len({build._library_path(n) for n in build.SOURCES}) == 6
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build(force=True)


# ------------------------------------------------------------------ backward
def _check_grad(got, want):
    """rtol/atol on every entry; where the reference's gradient is exactly 0
    (inputs at -inf or saturated below the clamp), the port's is too."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[want == 0], 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", KS)
def test_log_einsum_exp_bwd_plain_matches_reference(k):
    rng = np.random.RandomState(100 + k)
    b, l_cells, k_out = 9, 3, (1 if k == 3 else k + 2)
    w, x = _w(rng, l_cells, k_out, k), _x(rng, b, 2 * l_cells, k)
    g = rng.randn(b, l_cells, k_out).astype(np.float32)
    l, r = x[:, :l_cells], x[:, l_cells:]
    got = log_einsum_exp.log_einsum_exp_bwd_plain(
        torch.from_numpy(w), torch.from_numpy(l), torch.from_numpy(r),
        torch.from_numpy(g))
    # the reference's custom VJP: K2 in Pallas interpret mode
    _, vjp = jax.vjp(ref_ops.log_einsum_exp, jnp.asarray(w), jnp.asarray(l),
                     jnp.asarray(r))
    for a, want in zip(got, vjp(jnp.asarray(g))):
        _check_grad(a, want)
    # XLA autodiff of the reference's plain op, off saturation
    x = (rng.randn(b, 2 * l_cells, k) * 3).astype(np.float32)
    l, r = x[:, :l_cells], x[:, l_cells:]
    got = log_einsum_exp.log_einsum_exp_bwd_plain(
        torch.from_numpy(w), torch.from_numpy(l), torch.from_numpy(r),
        torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: ref_layers.log_einsum_exp(*a, impl="xla"),
                     jnp.asarray(w), jnp.asarray(l), jnp.asarray(r))
    for a, want in zip(got, vjp(jnp.asarray(g))):
        _check_grad(a, want)


@pytest.mark.parametrize("shape", GROUP_SHAPES, ids=str)
def test_grouped_bwd_plain_matches_reference(shape):
    g_, l_out, k, kf = shape
    rng = np.random.RandomState(200 + sum(shape))
    ws = [_w(rng, l_out * 2 ** (g_ - 1 - d), k if d < g_ - 1 else kf, k)
          for d in range(g_)]
    x = _x(rng, 7, l_out * 2 ** g_, k)
    go = rng.randn(7, l_out, kf).astype(np.float32)
    gws, gx = grouped.grouped_log_einsum_exp_bwd_plain(
        [torch.from_numpy(w) for w in ws], torch.from_numpy(x),
        torch.from_numpy(go))
    # K4 in Pallas interpret mode: one output cell a program, 8-row tiles
    _, vjp = jax.vjp(lambda w, xx: ref_ops.grouped_log_einsum_exp(1, 8, w, xx),
                     tuple(jnp.asarray(w) for w in ws), jnp.asarray(x))
    want_ws, want_x = vjp(jnp.asarray(go))
    for a, want in zip(gws, want_ws):
        _check_grad(a, want)
    _check_grad(gx, want_x)


def test_autograd_ops_run_the_plain_backward_on_the_cpu():
    rng = np.random.RandomState(4)
    w = torch.from_numpy(_w(rng, 2, 3, 4)).requires_grad_(True)
    x = torch.from_numpy((rng.randn(5, 4, 4) * 2).astype(np.float32))
    x.requires_grad_(True)
    ops.reset_counts()
    out = ops.log_einsum_exp(w, x[:, :2], x[:, 2:])
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    gw, gx = torch.autograd.grad(out, [w, x], g)
    want = log_einsum_exp.log_einsum_exp_bwd_plain(
        w.detach(), x.detach()[:, :2], x.detach()[:, 2:], g)
    assert torch.equal(gw, want[0])
    assert torch.equal(gx, torch.cat([want[1], want[2]], 1))
    ws = [torch.from_numpy(_w(rng, 2, 4, 4)).requires_grad_(True),
          torch.from_numpy(_w(rng, 1, 2, 4)).requires_grad_(True)]
    out = ops.grouped_log_einsum_exp(ws, x)  # the weights go in a list
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, ws + [x], g)
    want_ws, want_x = grouped.grouped_log_einsum_exp_bwd_plain(
        [w.detach() for w in ws], x.detach(), g)
    for a, b in zip(grads, want_ws + [want_x]):
        assert torch.equal(a, b)
    counts = {op.name: (op.launches, op.plain_calls) for op in ops.KERNEL_OPS}
    assert counts == {"log_einsum_exp": (0, 1), "log_einsum_exp_bwd": (0, 1),
                      "grouped_log_einsum_exp": (0, 1),
                      "grouped_log_einsum_exp_bwd": (0, 1),
                      "gather_grouped_log_einsum_exp": (0, 0),
                      "gather_grouped_log_einsum_exp_bwd": (0, 0)}


@pytest.mark.parametrize("b,m,c,k", [(5, 2, 3, 4), (4, 1, 10, 1)])
def test_log_mix_exp_backward_matches_reference(b, m, c, k):
    rng = np.random.RandomState(300 + b + c)
    v = rng.rand(m, c, k).astype(np.float32) + 0.1
    mask = np.ones((m, c), np.float32)
    mask[0, -1] = 0.0  # one padded child
    v = v * mask[:, :, None]
    v /= v.sum(axis=1, keepdims=True)
    ln = (rng.randn(b, m, c, k) * 3).astype(np.float32)
    ln[0] = NEG_INF  # fully marginalized: exp(ln - a) = 1 at the padding too
    ln[1, 0, 0] = -np.inf
    g = rng.randn(b, m, k).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_(True)
    lt = torch.from_numpy(ln).requires_grad_(True)
    out = layers.log_mix_exp(vt, lt, torch.from_numpy(mask))
    gv, gln = torch.autograd.grad(out, [vt, lt], torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, bb: ref_layers.log_mix_exp(a, bb, jnp.asarray(mask)),
                     jnp.asarray(v), jnp.asarray(ln))
    want_v, want_ln = vjp(jnp.asarray(g))
    _check_grad(gv, want_v)
    _check_grad(gln, want_ln)
    assert torch.all(gln[:, 0, -1] == 0)  # the padded child


def test_plain_forward_is_row_independent():
    """A row's plain forward does not depend on the rows that share the
    call: each row of a 37-row batch equals, bit for bit, the same row run
    in batches of 1 to 8."""
    rng = np.random.RandomState(5)
    w = torch.from_numpy(_w(rng, 16, 10, 10))
    x = torch.from_numpy((rng.randn(37, 32, 10) * 3).astype(np.float32))
    full = log_einsum_exp.log_einsum_exp_plain(w, x[:, :16], x[:, 16:])
    for size in range(1, 9):
        for b0 in range(0, 37, size):
            part = x[b0: b0 + size]
            got = log_einsum_exp.log_einsum_exp_plain(w, part[:, :16],
                                                      part[:, 16:])
            assert torch.equal(got, full[b0: b0 + size]), (size, b0)
    g = torch.from_numpy(rng.randn(37, 16, 10).astype(np.float32))
    _, gl, gr = log_einsum_exp.log_einsum_exp_bwd_plain(
        w, x[:, :16], x[:, 16:], g)
    _, gl1, gr1 = log_einsum_exp.log_einsum_exp_bwd_plain(
        w, x[5:6, :16], x[5:6, 16:], g[5:6])
    assert torch.equal(gl1[0], gl[5]) and torch.equal(gr1[0], gr[5])


# ------------------------------------------------------------- gather runs
# the reference's PD_SMOKE_SHAPES (tests/test_gather_grouped.py): (height,
# width, delta, K); (4, 4, 1, 3) is a 5-depth run at odd K = 3
PD_SMOKE_SHAPES = [(4, 8, 2, 4), (2, 8, 2, 6), (4, 4, 1, 3)]


def _pd_tables(h, w, delta, k):
    model = EiNet(poon_domingos(h, w, delta), num_sums=k, device="meta")
    return next(s.tables for s in model.exec_plan if s.kind == "gather")


def _masked(tables):
    """The run with the last child of its first mixing slot masked out."""
    mask = tuple(
        None if m is None else tuple(
            tuple(0 if (i, j) == (0, len(row) - 1) else v
                  for j, v in enumerate(row)) for i, row in enumerate(m))
        for m in tables.mix_mask)
    return dataclasses.replace(tables, mix_mask=mask)


# (name, tables, K): the smoke shapes and a run with a masked mixing child
GATHER_CASES = [(str(s), _pd_tables(*s), s[-1]) for s in PD_SMOKE_SHAPES] + [
    ("masked child", _masked(_pd_tables(2, 8, 2, 6)), 5)]


def _gather_params(rng, tables, k):
    ws = [_w(rng, len(l), k, k) for l in tables.left]
    vs = []
    for child, mask in zip(tables.mix_child, tables.mix_mask):
        if child is None:
            continue
        msk = np.asarray(mask, np.float32)[:, :, None]
        v = (rng.rand(len(child), len(child[0]), k).astype(np.float32)
             + 0.1) * msk
        vs.append(v / v.sum(axis=1, keepdims=True))
    return ws, vs


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _ref_tables(tables):
    return RefGatherTables(**dataclasses.asdict(tables))


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: c[0])
def test_gather_plain_matches_reference(case):
    _, tables, k = case
    rng = np.random.RandomState(k)
    ws, vs = _gather_params(rng, tables, k)
    x = _x(rng, 9, tables.num_in_rows, k)
    got = grouped.gather_grouped_log_einsum_exp_plain(
        tables, _torch(ws), _torch(vs), torch.from_numpy(x))
    assert got.shape == (9, tables.num_new_rows, k)
    wj, vj, xj = ([jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in vs],
                  jnp.asarray(x))
    xla = ref_layers.gather_grouped_log_einsum_exp(tables, wj, vj, xj,
                                                   impl="xla")
    _check(got, np.asarray(xla)[:, tables.num_in_rows:])
    # Pallas, interpret, 4-row tiles: the reference's own kernel is off its
    # XLA path by float32 ulps, so the atol scales with the values
    pallas = np.asarray(ref_ops.gather_grouped_log_einsum_exp(
        _ref_tables(tables), 4, tuple(wj), tuple(vj), xj))
    fin = np.isfinite(pallas)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_array_equal(got.numpy()[~fin], pallas[~fin])
    np.testing.assert_allclose(
        got.numpy()[fin], pallas[fin], rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(pallas[fin]).max())))


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: c[0])
def test_gather_bwd_plain_matches_reference(case):
    _, tables, k = case
    rng = np.random.RandomState(50 + k)
    ws, vs = _gather_params(rng, tables, k)
    b = 7
    x = (rng.randn(b, tables.num_in_rows, k) * 3).astype(np.float32)
    x[1, 0] = NEG_INF  # a saturated leaf row: the circuit stays finite
    g = rng.randn(b, tables.num_new_rows, k).astype(np.float32)
    gws, gvs, gx = grouped.gather_grouped_log_einsum_exp_bwd_plain(
        tables, _torch(ws), _torch(vs), torch.from_numpy(x),
        torch.from_numpy(g))
    r_in = tables.num_in_rows

    def xla(w, v, xx):
        return ref_layers.gather_grouped_log_einsum_exp(
            tables, w, v, xx, impl="xla")[:, r_in:]

    _, vjp = jax.vjp(xla, [jnp.asarray(a) for a in ws],
                     [jnp.asarray(a) for a in vs], jnp.asarray(x))
    want_ws, want_vs, want_x = vjp(jnp.asarray(g))
    for a, want in zip(gws + gvs, list(want_ws) + list(want_vs)):
        _check_grad(a, want)
    _check_grad(gx, want_x)
    if "masked" in case[0]:  # the masked child: exact zero in gV
        assert torch.all(gvs[0][0, -1] == 0)
        assert float(np.abs(np.asarray(want_vs[0])[0, -1]).max()) == 0.0


def test_gather_bwd_plain_matches_the_pallas_vjp_on_saturated_rows():
    """-inf and NEG_INF rows through the reference's custom VJP (K6 in
    Pallas interpret mode): finite gradients, the reference's exact zeros
    kept."""
    tables = _pd_tables(4, 8, 2, 4)
    rng = np.random.RandomState(7)
    ws, vs = _gather_params(rng, tables, 4)
    x = _x(rng, 6, tables.num_in_rows, 4)
    g = rng.randn(6, tables.num_new_rows, 4).astype(np.float32)
    gws, gvs, gx = grouped.gather_grouped_log_einsum_exp_bwd_plain(
        tables, _torch(ws), _torch(vs), torch.from_numpy(x),
        torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda w, v, xx: ref_ops.gather_grouped_log_einsum_exp(
            _ref_tables(tables), 4, w, v, xx),
        tuple(jnp.asarray(a) for a in ws), tuple(jnp.asarray(a) for a in vs),
        jnp.asarray(x))
    want_ws, want_vs, want_x = vjp(jnp.asarray(g))
    for a, want in zip(gws + gvs + [gx],
                       list(want_ws) + list(want_vs) + [want_x]):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_array_equal(a.numpy()[want == 0], 0.0)
        np.testing.assert_allclose(a.numpy(), want, rtol=RTOL,
                                   atol=ATOL * scale)


def test_gather_plain_is_the_per_layer_chain():
    """The plain K5 computes each depth with the per-pair op and the mixing
    layer on the buffer's gathered rows: bit for bit the per-layer loop."""
    tables = _pd_tables(4, 8, 2, 4)
    rng = np.random.RandomState(1)
    ws, vs = (_torch(a) for a in _gather_params(rng, tables, 4))
    x = torch.from_numpy(_x(rng, 5, tables.num_in_rows, 4))
    buf, vi = x, 0
    for t in range(tables.num_depths):
        s = layers.log_einsum_exp(ws[t], buf[:, list(tables.left[t])],
                                  buf[:, list(tables.right[t])])
        if tables.mix_child[t] is not None:
            m = layers.log_mix_exp(
                vs[vi], s[:, torch.tensor(tables.mix_child[t])],
                torch.tensor(tables.mix_mask[t], dtype=torch.float32))
            s, vi = torch.cat([s, m], 1), vi + 1
        buf = torch.cat([buf, s], 1)
    got = grouped.gather_grouped_log_einsum_exp_plain(tables, ws, vs, x)
    assert torch.equal(got, buf[:, tables.num_in_rows:])


def test_gather_autograd_runs_the_plain_backward_on_the_cpu():
    tables = _pd_tables(2, 8, 2, 6)
    rng = np.random.RandomState(3)
    ws, vs = _gather_params(rng, tables, 6)
    ws = [w.requires_grad_(True) for w in _torch(ws)]
    vs = [v.requires_grad_(True) for v in _torch(vs)]
    x = torch.from_numpy((rng.randn(5, tables.num_in_rows, 6) * 2)
                         .astype(np.float32)).requires_grad_(True)
    ops.reset_counts()
    out = ops.gather_grouped_log_einsum_exp(tables, ws, vs, x)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, ws + vs + [x], g)
    want_ws, want_vs, want_x = grouped.gather_grouped_log_einsum_exp_bwd_plain(
        tables, [w.detach() for w in ws], [v.detach() for v in vs],
        x.detach(), g)
    for a, b in zip(grads, want_ws + want_vs + [want_x]):
        assert torch.equal(a, b)
    assert (ops.gather_grouped_log_einsum_exp.plain_calls,
            ops.gather_grouped_log_einsum_exp_bwd.plain_calls) == (1, 1)
    assert ops.gather_grouped_log_einsum_exp.launches == 0
    with torch.no_grad():  # without autograd the forward op runs directly
        again = ops.gather_grouped_log_einsum_exp(tables, ws, vs, x)
    assert torch.equal(again, out.detach())


def test_gather_tables_pack_and_cache():
    tables = build_einet(get_config("einet_pd"), device="meta").exec_plan[0].tables
    tab = grouped.pack_gather_tables(tables)
    assert tab.dtype == np.int32
    # header: 2 depths, 4 input rows, 13 rows in all, the first 7 children
    assert tab[:4].tolist() == [2, 4, 13, 7]
    d0, d1 = tab[4:12].tolist(), tab[12:20].tolist()
    assert d0[:4] == [3, 0, 0, 4] and d0[6:] == [-1, -1]
    assert d1[:4] == [4, 2, 2, 7] and d1[7] == 0
    assert tab[d1[4]: d1[4] + 4].tolist() == list(tables.left[1])
    assert tab[d1[5]: d1[5] + 4].tolist() == list(tables.right[1])
    assert tab[d1[6]: d1[6] + 4].tolist() == [2, 3, 0, 1]  # (M, C) children
    assert tab[d1[6] + 4: d1[6] + 8].tolist() == [1, 1, 1, 1]  # the mask
    assert len(tab) == 20 + 3 + 3 + 4 + 4 + 4 + 4
    a = grouped.gather_tables_tensor(tables, torch.device("cpu"))
    assert a is grouped.gather_tables_tensor(tables, "cpu")
    assert a.dtype == torch.int32 and a.tolist() == tab.tolist()
    bad = dataclasses.replace(tables, left=((0, 3, 9),) + tables.left[1:])
    with pytest.raises(ValueError, match="child row"):
        grouped.pack_gather_tables(bad)


def test_gather_geometry_rejects_bad_shapes():
    tables = _pd_tables(2, 8, 2, 6)
    ws = [torch.zeros(len(l), 6, 6, 6) for l in tables.left]
    vs = [torch.zeros(2, 2, 6)]
    x = torch.zeros(3, tables.num_in_rows, 6)
    assert grouped.gather_geometry(tables, ws, vs, x) == (9, 6)
    with pytest.raises(ValueError, match="rows"):
        grouped.gather_geometry(tables, ws, vs, x[:, :3])
    with pytest.raises(ValueError, match="interior"):
        grouped.gather_geometry(tables, [torch.zeros(3, 5, 6, 6)] + ws[1:],
                                vs, x)
    with pytest.raises(ValueError, match="mixing depths"):
        grouped.gather_geometry(tables, ws, [], x)
    with pytest.raises(ValueError, match="mix depth"):
        grouped.gather_geometry(tables, ws, [torch.zeros(2, 3, 6)], x)


def test_gather_tile_and_shared_memory_rules():
    tables = build_einet(get_config("einet_pd"), device="meta").exec_plan[0].tables
    limit = log_einsum_exp.SMEM_LIMIT_BYTES
    # einet_pd at B = 512: 4-row tiles (128 blocks) in both kernels; the
    # backward's 128 partials of the 1.79 MB of weights are 229 MB
    assert grouped.pick_gather_tile_b(tables, 40, 512) == 4
    assert grouped.pick_gather_tile_b(tables, 40, 512, backward=True) == 4
    for tb, bwd in ((4, False), (4, True)):
        w_f, total = grouped.gather_smem_layout(tables, 40, tb, bwd)
        assert total <= limit
        # a K = 40 cell (256 KB) goes in two K_out tiles of 20 rows, each
        # row padded to an odd stride against bank conflicts
        assert grouped.gather_row_stride(40) == 1601
        assert w_f == 20 * 1601
    assert grouped.gather_smem_layout(tables, 40, 4)[1] == 4 * (
        20 * 1601 + 4 * (13 * 40 + 7 * 41) + 42)
    # small batches take the smallest tile; a tiny K stages a whole depth
    assert grouped.pick_gather_tile_b(tables, 40, 37) == 1
    w_f, _ = grouped.gather_smem_layout(tables, 4, 32)
    assert w_f == 4 * 4 * 17
    # at B = 2048 the backward grows its tile until the partials fit
    tb = grouped.pick_gather_tile_b(tables, 40, 2048, backward=True)
    assert tb == 16 and 128 * 4 * 7 * 40 ** 3 <= grouped.GATHER_PART_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared"):
        grouped.pick_gather_tile_b(tables, 240, 512)
