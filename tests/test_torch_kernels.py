"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against the JAX reference (its XLA path and its Pallas kernels in interpret
mode), the CPU side of dispatch, and the launch-geometry rules the CUDA
wrappers apply.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these plain versions.

Tolerance: rtol=1e-5, atol=1e-5 on finite outputs.  The order of summation
differs between torch.einsum, XLA's einsum and the Pallas matmul (the
reference's own interpret path is off from its XLA path by up to 7.6e-6),
so bit equality is not expected; outputs at -inf, and at NEG_INF
saturation, must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as ref_layers
from repro.kernels import ops as ref_ops
from repro_torch.core import layers
from repro_torch.core.layers import NEG_INF
from repro_torch.kernels import build, grouped, log_einsum_exp, ops

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
    assert log_einsum_exp.k_out_tile(10, 10) == 10
    assert log_einsum_exp.k_out_tile(10, 1) == 1
    kt = log_einsum_exp.k_out_tile(40, 40)  # one K=40 cell is 256 KB
    assert 1 <= kt < 40
    assert log_einsum_exp.smem_bytes(40, kt) <= log_einsum_exp.SMEM_LIMIT_BYTES
    assert log_einsum_exp.smem_bytes(40, kt + 1) > log_einsum_exp.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError):
        log_einsum_exp.k_out_tile(300, 1)


def test_grouped_tile_and_shared_memory_rules():
    # einet_rat's fused run [0, 4): 32-row tiles, 8,000 weight floats
    tb = grouped.pick_tile_b(4, 10, [10, 10, 10, 1])
    w_f, a_f, b_f, total = grouped.smem_layout(4, 10, [10, 10, 10, 1], tb)
    assert tb == 32 and w_f == 8 * 10 * 100
    assert a_f == 32 * 16 * 10 and b_f == 32 * 8 * 10
    assert total <= log_einsum_exp.SMEM_LIMIT_BYTES
    # a K=64 cell (einet_rat_large) does not fit even for one row: refused
    with pytest.raises(ValueError, match="single row"):
        grouped.pick_tile_b(2, 64, [64, 64])


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
    assert build._library_path(build.SOURCES[0]) != build._library_path(
        build.SOURCES[1])
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build(force=True)
