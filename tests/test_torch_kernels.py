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
    lee = log_einsum_exp
    # einet_rat's pairs: 10-output tiles, blocks of 4 (K1) and 8 (K2) row
    # subtiles; einet_pd's K=40 pairs: 8-output tiles of one subtile; the
    # root pairs (K_out = 1): the one-output tile
    assert lee.launch_geometry(2048, 80, 10, 10) == (2, 4, 128, 10)
    assert lee.launch_geometry(2048, 80, 10, 10, backward=True) == (
        2, 4, 128, 10)
    assert lee.launch_geometry(512, 4, 40, 40) == (0, 1, 32, 8)
    assert lee.launch_geometry(512, 4, 40, 40, backward=True) == (
        0, 1, 16, 8)
    assert lee.launch_geometry(512, 3, 40, 1)[0] == 1
    assert lee.launch_geometry(2048, 10, 10, 1)[0] == 1
    for backward, size in ((False, lee.smem_bytes),
                           (True, lee.bwd_smem_bytes)):
        tile, nsub, tb, kt = lee.launch_geometry(512, 4, 40, 40, backward)
        assert size(40, kt, tb) <= lee.SMEM_LIMIT_BYTES
        # K = 100: 8 weight rows no longer fit, one does
        tile, nsub, tb, kt = lee.launch_geometry(64, 2, 100, 100, backward)
        assert tile == 1 and kt == 1
        assert size(100, kt, tb) <= lee.SMEM_LIMIT_BYTES
        assert size(100, 8, tb) > lee.SMEM_LIMIT_BYTES
        with pytest.raises(ValueError, match="no room"):
            lee.launch_geometry(1, 1, 300, 1, backward)


def _arch_pair_shapes(name):
    """(L, K_out, K) of every pair of an arch, and the batch sizes its main
    paths launch K1 and K2 at (the serve buckets and the config's batch)."""
    cfg = get_config(name)
    model = build_einet(cfg, device="meta")
    shapes = sorted({tuple(w.shape[:3]) for w in model.einsum})
    return shapes, (1, 2, 3, 8, 32, 37, 64, cfg.batch_size)


ARCHS = ("einet_rat", "einet_rat_large", "einet_pd", "einet_pd_mnist",
         "einet_celeba")


@pytest.mark.parametrize("name", ARCHS)
def test_pair_kernel_blocks_fit_shared_memory_at_every_arch_shape(name):
    lee = log_einsum_exp
    shapes, batches = _arch_pair_shapes(name)
    for l_cells, k_out, k in shapes:
        for b in batches:
            for backward, size in ((False, lee.smem_bytes),
                                   (True, lee.bwd_smem_bytes)):
                tile, nsub, tb, kt = lee.launch_geometry(b, l_cells, k, k_out,
                                                        backward)
                rows, tile_kt = lee.tile_shape(
                    (lee.BWD_TILES if backward else lee.FWD_TILES)[tile])
                assert (tb, kt) == (nsub * rows, tile_kt)
                assert size(k, kt, tb) <= lee.SMEM_LIMIT_BYTES
                assert -(-b // tb) <= lee.MAX_GRID_Y
                # the tile, and so every output's order of operations, does
                # not depend on the batch
                assert tile == lee.launch_geometry(1, l_cells, k, k_out,
                                                   backward)[0]
            jt, ktw = lee.dw_geometry(k, k_out)
            assert 4 * (2 * lee.DW_CHUNK * lee.pad(k)
                        + lee.DW_CHUNK * ktw) <= lee.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("k", [3, 4, 5, 10, 13, 17, 32, 40, 64])
def test_staged_row_strides_are_odd(k):
    lee = log_einsum_exp
    assert lee.row_stride(k) % 2 == 1 and lee.row_stride(k) >= k * k
    assert lee.pad(k) % 2 == 1 and lee.pad(k) >= k
    # odd strides put the 32 lanes' rows in 32 distinct banks
    assert len({r * lee.row_stride(k) % 32 for r in range(32)}) == 32
    assert len({r * lee.pad(k) % 32 for r in range(32)}) == 32


def test_staged_row_strides_match_the_cuda_source():
    text = (build.CSRC / "lee_common.cuh").read_text()
    assert "return (K * K) | 1;" in text and "return K | 1;" in text
    for name in ("gather_common.cuh", "gather_fwd.cu", "gather_bwd.cu"):
        src = (build.CSRC / name).read_text()
        assert "gather_stage_weights" not in src
        assert "gather_row_stride" not in src
    # the gather run's kernels stage through K1's kernel, the canonical
    # ones through the subtree's shared staging
    for name in ("lee_fwd.cuh", "grouped_common.cuh"):
        assert "lee_stage_weights" in (build.CSRC / name).read_text()
    assert "lee_fwd_ids_run" in (build.CSRC / "gather_fwd.cu").read_text()
    assert "return (K + 1) | 1;" in (build.CSRC / "grouped_fwd.cu").read_text()


@pytest.mark.parametrize("b,cells,k,k_out,splits", [
    (2048, 80, 10, 10, 14),   # einet_rat's first pair
    (2048, 10, 10, 1, 64),    # its root: one split a 32 rows at most
    (512, 4, 40, 40, 16),     # einet_pd's pairs
    (512, 3, 40, 1, 16),
    (32, 4, 40, 40, 1),       # a serve bucket: one split, no partials
    (37, 6, 17, 17, 2),
])
def test_dw_split_count_and_partial_bytes(b, cells, k, k_out, splits):
    lee = log_einsum_exp
    assert lee.dw_splits(b, cells, k, k_out) == splits
    jt, ktw = lee.dw_geometry(k, k_out)
    assert ktw % 4 == 0 and jt in (4, 8, 16)
    blocks = cells * -(-k_out // ktw)
    assert splits <= -(-b // lee.DW_CHUNK)
    assert splits == -(-b // lee.DW_CHUNK) or (
        blocks * splits >= lee.DW_TARGET_BLOCKS
        > blocks * (splits - 1))
    want = 0 if splits == 1 else 4 * splits * cells * k_out * k * k
    assert lee.dw_partial_bytes(b, cells, k, k_out) == want


@pytest.mark.parametrize("k,want", [(3, 4), (10, 4), (32, 4), (40, 8),
                                    (64, 16), (100, 16)])
def test_dw_columns_a_thread(k, want):
    jt, _ = log_einsum_exp.dw_geometry(k, k)
    assert jt == want


def _fused_runs(name):
    """(G, K, K_outs, L_out) of every fused run of an arch's plan."""
    model = build_einet(get_config(name), device="meta")
    runs = []
    for seg in model.exec_plan:
        if seg.kind == "fused":
            ws = model.einsum[seg.start: seg.stop]
            runs.append((len(ws), ws[0].shape[-1],
                         tuple(int(w.shape[1]) for w in ws), ws[-1].shape[0]))
    return runs


def test_grouped_tile_and_shared_memory_rules():
    lee = log_einsum_exp
    # einet_rat's fused run [0, 4) at B = 2048: 64-row tiles (320 blocks),
    # the 10-output register tile and the one-output tile for the root; a
    # block holds the 16 input slots and 8 next-depth slots of 64 rows at
    # fwd_row_stride(10) = 11 (a row's max in float 10) and a whole depth's
    # weights, 8 cells of 10 rows at lee_row_stride(10) = 101
    geo = grouped.fwd_geometry(4, 10, (10, 10, 10, 1), 2048, 10)
    assert (geo.ti, geo.tf, geo.tb) == (2, grouped.FWD_ONE_TILE, 64)
    assert geo.cells == (8, 4, 2, 1) and geo.kt == (10, 10, 10, 1)
    assert geo.u_floats == 8 * 10 * 101
    assert geo.smem_bytes == 4 * ((16 + 8) * 64 * 11 + 8 * 10 * 101)
    assert 2 * (geo.smem_bytes + 1024) <= 228 * 1024  # two blocks an SM
    assert grouped.fwd_items(geo, 2048) == 16
    # einet_rat_large's K = 64 run [0, 2) at B = 64: the whole batch in one
    # tile, so its 1.6 GB of weights are read once; 4 + 2 slots of 64 rows
    # at 65 floats leave room for 8 weight rows of 4,097 floats of a 1 MB
    # cell at a time, and the one-output tile gives the 8 warps one output
    # row each
    geo = grouped.fwd_geometry(2, 64, (64, 64), 64, 512)
    assert (geo.ti, geo.tf, geo.tb) == (1, 1, 64)
    assert geo.cells == (1, 1) and geo.kt == (8, 8)
    assert geo.smem_bytes == 4 * (6 * 64 * 65 + 8 * 4097)
    assert geo.smem_bytes <= lee.SMEM_LIMIT_BYTES
    assert grouped.fwd_items(geo, 64) == grouped.FWD_MIN_ITEMS
    # serve buckets take 32-row tiles, not smaller: a smaller tile would
    # only restage the weights for fewer rows
    for b in (1, 8, 64):
        assert grouped.fwd_geometry(4, 10, (10, 10, 10, 1), b, 10).tb == 32
    # every fused run of einet_rat and einet_rat_large, at every batch the
    # paths use, fits, fills its warps and stages whole weight rows
    for name in ("einet_rat", "einet_rat_large"):
        for g, k, k_outs, l_out in _fused_runs(name):
            for b in (1, 37, 64, 256, get_config(name).batch_size):
                geo = grouped.fwd_geometry(g, k, k_outs, b, l_out)
                assert geo.smem_bytes <= lee.SMEM_LIMIT_BYTES
                assert grouped.fwd_items(geo, b) >= grouped.FWD_MIN_ITEMS
                assert 32 <= geo.tb and -(-b // geo.tb) <= lee.MAX_GRID_Y
                for d, ko in enumerate(k_outs):
                    assert geo.cells[d] * geo.kt[d] * lee.row_stride(k) <= (
                        geo.u_floats)
                    assert geo.kt[d] == ko or geo.cells[d] == 1
    # refused only when one row and one weight row do not fit
    with pytest.raises(ValueError, match="single row"):
        grouped.fwd_geometry(2, 240, (240, 240), 64, 2)
    assert grouped.fwd_geometry(8, 64, (64,) * 8, 4, 2).tb == 1


def test_grouped_backward_shared_memory_rules():
    # einet_rat's [0, 4) at B = 2048: the 10-output tile for the interior
    # depths, the one-output tile for the root, 32-row tiles (640 blocks),
    # chunks of four cells.  A block holds every depth's 16+8+4+2
    # stabilised rows at lee_pad(10) = 11 and their maxes, every depth's s
    # (8, 4, 2 cells of 11, the root's 1), the output cotangents (8 cells of
    # 11) and input cotangents above depth 0 (4 slots of 11), and a chunk's
    # weight rows (10 at lee_row_stride(10) = 101) and sweep a cell
    geo = grouped.bwd_geometry(4, 10, (10, 10, 10, 1), 2048, 10)
    assert (geo.ti, geo.tf, geo.tb, geo.t_cells) == (2, 1, 32, 4)
    assert geo.c0 == 32 * 8 * 11 and geo.c1 == 32 * 4 * 11
    fixed = 30 * 32 * 12 + 32 * (88 + 44 + 22 + 1) + geo.c0 + geo.c1
    assert geo.smem_bytes == 4 * (fixed + 4 * (10 * 101 + 32 * 10 * 11))
    # per-tile partials: 64 tiles of the run's 141,000 weights
    assert not geo.split
    assert grouped.bwd_partial_bytes(4, 10, (10, 10, 10, 1), 2048, 10) == (
        64 * 4 * 141_000)
    # K = 64 (einet_rat_large's [0, 2)): 16-row tiles, one chunk cell of 8
    # weight rows, depth 0's input cotangent summed over its 8 K_out tiles
    # in shared memory; a partial would be 1.6 GB, so dW goes by K2's
    # batch-split kernel, which needs no partial at B = 64
    geo = grouped.bwd_geometry(2, 64, (64, 64), 64, 512)
    assert (geo.ti, geo.tf, geo.tb, geo.t_cells, geo.split) == (
        0, 0, 16, 1, True)
    assert (geo.c0, geo.c1) == (16 * 130, 16 * 260)
    assert geo.smem_bytes == 4 * (6 * 16 * 66 + 16 * 195 + geo.c0 + geo.c1
                                  + 8 * 4097 + 16 * 8 * 65)
    assert geo.smem_bytes <= log_einsum_exp.SMEM_LIMIT_BYTES
    assert grouped.bwd_partial_bytes(2, 64, (64, 64), 64, 512) == 0
    assert grouped.bwd_dw_geometry(2, 64, (64, 64), 64, 512) == [
        (16, 4, 1), (16, 4, 1)]
    with pytest.raises(ValueError, match="does not fit"):
        grouped.bwd_geometry(2, 240, (240, 240), 64, 2)


@pytest.mark.parametrize("name", ("einet_rat", "einet_rat_large"))
def test_grouped_backward_blocks_fit_at_every_fused_run(name):
    runs = _fused_runs(name)
    assert len(runs) == {"einet_rat": 1, "einet_rat_large": 3}[name]
    for g, k, k_outs, l_out in runs:
        tiles = set()
        for b in (1, 37, 64, get_config(name).batch_size):
            geo = grouped.bwd_geometry(g, k, k_outs, b, l_out)
            assert geo.smem_bytes <= log_einsum_exp.SMEM_LIMIT_BYTES
            rows = [log_einsum_exp.tile_shape(
                log_einsum_exp.BWD_TILES[t])[0] for t in (geo.ti, geo.tf)]
            assert all(geo.tb % r == 0 for r in rows)
            assert 1 <= geo.t_cells <= 2 ** (g - 1)
            assert -(-b // geo.tb) <= log_einsum_exp.MAX_GRID_Y
            # per-tile partials only where they are small
            if not geo.split:
                assert grouped.bwd_partial_bytes(g, k, k_outs, b, l_out) <= (
                    grouped.GROUPED_PART_LIMIT_BYTES)
            tiles.add((geo.ti, geo.tf))
        # the register tiles, and so a row's order of operations, do not
        # depend on the batch
        assert len(tiles) == 1


@pytest.mark.parametrize("cells,k_out,k,w_floats,kt_tile,want", [
    (8, 10, 10, 8080, 10, (8, 10)),    # the whole depth (rows of 101)
    (8, 10, 10, 2500, 10, (2, 10)),    # whole cells, two at a time
    (2, 64, 64, 45067, 1, (1, 11)),    # one cell's K_out rows (4,097 each)
    (2, 64, 64, 45067, 8, (1, 8)),     # ... a multiple of the tile's 8
    (2, 64, 64, 4096, 1, (1, 0)),      # not one weight row
])
def test_depth_chunks(cells, k_out, k, w_floats, kt_tile, want):
    assert grouped.depth_chunks(cells, k_out, k, w_floats, kt_tile) == want


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
    assert len({build._library_path(n) for n in build.SOURCES}) == 8
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
                      "gather_grouped_log_einsum_exp_bwd": (0, 0),
                      "leaf_rows": (0, 0), "leaf_stats": (0, 0)}


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
    lee = log_einsum_exp
    # K5 at einet_pd's B = 512 and the serve bucket B = 64: K1 at each
    # depth's pair (B, L_t, K, K) with the per-pair wrapper's geometry, the
    # same as K6's recompute (so both write the same bits): depth 0's 3
    # cells and depth 1's 4, then the mixing
    for b in (512, 64):
        geo = grouped.gather_fwd_geometry(tables, 40, b)
        assert geo == [lee.launch_geometry(b, cells, 40, 40)[:2]
                       for cells in (3, 4)]
        bwd = grouped.gather_bwd_geometry(tables, 40, b)
        assert geo == [g[:2] for g in bwd]
    assert [step[0] for step in grouped.gather_fwd_plan(tables, 40, 512)] == [
        "pair", "pair", "mix"]
    # every PD arch: each depth's K1 block fits, at every batch
    for name in ("einet_pd", "einet_pd_mnist", "einet_celeba"):
        cfg = get_config(name)
        model = build_einet(cfg, device="meta")
        tabs, k = model.exec_plan[0].tables, model.K
        for b in (1, 37, 64, cfg.batch_size):
            for (tile, nsub), left in zip(
                    grouped.gather_fwd_geometry(tabs, k, b), tabs.left):
                rows, kt = lee.tile_shape(lee.FWD_TILES[tile])
                assert lee.smem_bytes(k, kt, nsub * rows) <= (
                    lee.SMEM_LIMIT_BYTES)
                assert -(-b // (nsub * rows)) <= lee.MAX_GRID_Y
    with pytest.raises(ValueError, match="room"):
        grouped.gather_fwd_geometry(tables, 240, 512)
    # K6 launches K1 and K2 at each depth's pair (B, L_t, K, K), with the
    # per-pair wrappers' geometry: at B = 512 both depths' dW in 16 batch
    # splits, 28.7 MB of partials in all, an eighth of the 229 MB that one
    # partial of all the weights a 4-row tile would write
    geo = grouped.gather_bwd_geometry(tables, 40, 512)
    for (f_tile, f_nsub, b_tile, b_nsub, jt, ktw, splits), cells in zip(
            geo, (3, 4)):
        assert (f_tile, f_nsub) == log_einsum_exp.launch_geometry(
            512, cells, 40, 40)[:2]
        assert (b_tile, b_nsub) == log_einsum_exp.launch_geometry(
            512, cells, 40, 40, backward=True)[:2]
        assert (jt, ktw) == log_einsum_exp.dw_geometry(40, 40)
        assert splits == 16
    part = grouped.gather_bwd_partial_bytes(tables, 40, 512)
    assert part == 4 * 16 * 7 * 40 ** 3 == 28_672_000
    assert part * 8 <= 128 * 4 * 7 * 40 ** 3


def _pd_arch_tables(name):
    model = build_einet(get_config(name), device="meta")
    return model.exec_plan[0].tables, model.K


@pytest.mark.parametrize("case", [("einet_pd",) + _pd_arch_tables("einet_pd")]
                         + [(str(s), _pd_tables(*s), s[-1])
                            for s in PD_SMOKE_SHAPES], ids=lambda c: c[0])
def test_gather_forward_plan_is_the_plain_walk(case):
    """K5's launches (per depth: the pair through its row ids into the new
    rows, then the mixing), run with the plain per-pair op and
    log_mix_exp, give gather_grouped_log_einsum_exp_plain's rows bit for
    bit."""
    _, tables, k = case
    rng = np.random.RandomState(11)
    ws, vs = (_torch(a) for a in _gather_params(rng, tables, k))
    b = 6
    x = torch.from_numpy(_x(rng, b, tables.num_in_rows, k))
    r_in = tables.num_in_rows
    out = torch.full((b, tables.num_new_rows, k), float("nan"))

    def rows(ids):
        return torch.stack([x[:, i] if i < r_in else out[:, i - r_in]
                            for i in ids], 1)

    vi = 0
    for step in grouped.gather_fwd_plan(tables, k, b):
        if step[0] == "pair":
            _, t, left, right, first, _ = step
            out[:, first: first + len(left)] = layers.log_einsum_exp(
                ws[t], rows(left), rows(right))
        else:
            _, t, first, base = step
            child = torch.tensor(tables.mix_child[t]) + base
            out[:, first: first + len(tables.mix_child[t])] = (
                layers.log_mix_exp(
                    vs[vi], out[:, child],
                    torch.tensor(tables.mix_mask[t], dtype=torch.float32)))
            vi += 1
    want = grouped.gather_grouped_log_einsum_exp_plain(tables, ws, vs, x)
    assert torch.equal(out, want)


@pytest.mark.parametrize("name", ("einet_pd", "einet_pd_mnist", "einet_celeba"))
def test_gather_backward_blocks_fit_at_every_pd_arch(name):
    cfg = get_config(name)
    model = build_einet(cfg, device="meta")
    tables = model.exec_plan[0].tables
    k = model.K
    lee = log_einsum_exp
    for b in (1, 37, cfg.batch_size):
        geo = grouped.gather_bwd_geometry(tables, k, b)
        assert len(geo) == tables.num_depths
        for (f_tile, f_nsub, b_tile, b_nsub, jt, ktw, splits), left in zip(
                geo, tables.left):
            for tile, nsub, tiles, size in (
                    (f_tile, f_nsub, lee.FWD_TILES, lee.smem_bytes),
                    (b_tile, b_nsub, lee.BWD_TILES, lee.bwd_smem_bytes)):
                rows, kt = lee.tile_shape(tiles[tile])
                assert size(k, kt, nsub * rows) <= lee.SMEM_LIMIT_BYTES
                assert -(-b // (nsub * rows)) <= lee.MAX_GRID_Y
            assert 4 * (2 * lee.DW_CHUNK * lee.pad(k)
                        + lee.DW_CHUNK * ktw) <= lee.SMEM_LIMIT_BYTES
            assert splits == lee.dw_splits(b, len(left), k, k)
        # no partials at one split; never more than the per-pair kernels'
        assert grouped.gather_bwd_partial_bytes(tables, k, b) == sum(
            lee.dw_partial_bytes(b, len(l), k, k) for l in tables.left)


def _banks(words):
    """Whether 32 lanes' shared-memory words (one load) are free of bank
    conflicts: lanes reading one word share it; distinct words need
    distinct banks."""
    distinct = set(words)
    return len({w % 32 for w in distinct}) == len(distinct)


@pytest.mark.parametrize("k", [10, 40, 64])
def test_backward_sweep_and_dw_reads_hit_distinct_banks(k):
    """A warp's loads in K4's and K6's contractions, by the kernels'
    address arithmetic: the sweep's weight rows (lee_row_stride apart) and
    activation rows (lee_pad apart), transposed or not, for every register
    tile; K4's dW reads of el and er; its rows-fastest rescaling of the
    input cotangent by the stabilised rows."""
    lee = log_einsum_exp
    kkp, kp = lee.row_stride(k), lee.pad(k)
    for r_, ko, nkg in lee.BWD_TILES:
        nrg = 32 // nkg
        lanes = [(lane % nkg, lane // nkg) for lane in range(32)]
        for p in (0, k - 1):
            for q in (0, 1, k - 1):
                for trans in (False, True):
                    for u in range(ko):
                        w = [kg * kkp + u * nkg * kkp
                             + (p + q * k if trans else p * k + q)
                             for kg, _ in lanes]
                        assert _banks(w), (k, nkg, p, q, trans, u)
                for v in range(r_):
                    x = [(rg + v * nrg) * kp + q for _, rg in lanes]
                    assert _banks(x)
    # K4's dW: a thread's item is (k-quad, i, column group jg), jg fastest
    njg = -(-k // 4)
    items = [(it // njg % k, it % njg) for it in range(32)]
    for r in (0, 5):
        assert _banks([r * kp + i for i, _ in items])  # el
        for c in range(4):
            assert _banks([r * kp + jg + c * njg for _, jg in items
                           if jg + c * njg < k])  # er
    # gin *= e: rows fastest over a 32-row tile
    for i in (0, k - 1):
        assert _banks([r * kp + i for r in range(32)])


@pytest.mark.parametrize("k", [10, 40, 64])
def test_forward_sweep_reads_hit_distinct_banks(k):
    """A warp's loads in K3's sweep, by the kernel's address arithmetic
    (grouped_fwd.cu fwd_depth): weight rows lee_row_stride apart, row areas
    fwd_row_stride apart, for every register tile, with the lanes past the
    chunk's outputs or the tile's rows reading the last valid one."""
    lee = log_einsum_exp
    kkp, kq = lee.row_stride(k), grouped.fwd_row_stride(k)
    assert kq % 2 == 1 and kq > k
    tiles = list(lee.FWD_TILES) + [(1, 1, 1)]
    for r_, ko, nkg in tiles:
        nrg = 32 // nkg
        lanes = [(lane % nkg, lane // nkg) for lane in range(32)]
        for kn in (nkg * ko, 3, 1):  # a full K_out tile, ragged chunks
            for nb in (nrg * r_, 5, 1):  # a full row subtile, ragged tiles
                for i in (0, k - 1):
                    for j in (0, 1, k - 1):
                        for u in range(ko):
                            w = [min(kg + u * nkg, kn - 1) * kkp + i * k + j
                                 for kg, _ in lanes]
                            assert _banks(w), (k, nkg, kn, i, j, u)
                    for v in range(r_):
                        rows = [min(rg + v * nrg, nb - 1) for _, rg in lanes]
                        assert _banks([r * kq + i for r in rows])  # el
                        assert _banks([r * kq + k for r in rows])  # maxes


# ------------------------------------------------------- launch_cost
def _chip_smoke_costs(name, b):
    """The bytes and flops chip_smoke.py's bounds used inline before
    ``kernels.cost.launch_cost`` (K1 at every pair, K2's ``bwd_cost``, K3
    and K4 at a fused run, K5 and K6 at a gather run), each beside the
    launch's arguments, on the "meta" device at arch ``name``'s shapes."""
    model = build_einet(get_config(name), device="meta")
    m = torch.device("meta")
    out = []
    for i, sp in enumerate(model.pair_specs):
        w = model.einsum[i].detach()
        cells, k_out, k = w.shape[:3]
        lr = torch.empty(b, cells, k, device=m)
        g = torch.empty(b, cells, k_out, device=m)
        out.append(("log_einsum_exp", (w, lr, lr),
                    4 * (2 * b * cells * k + w.numel() + b * cells * k_out),
                    2 * b * cells * k_out * k * k))
        out.append(("log_einsum_exp_bwd", (w, lr, lr, g),
                    4 * (4 * b * cells * k + b * cells * k_out
                         + 2 * cells * k_out * k * k),
                    b * cells * (6 * k * k * k_out + 4 * k * k)))
    for seg in model.exec_plan:
        span = range(seg.start, seg.stop)
        ws = [model.einsum[t].detach() for t in span]
        if seg.kind == "fused":
            x = torch.empty(b, 2 * ws[0].shape[0], model.K, device=m)
            got = torch.empty(b, ws[-1].shape[0], ws[-1].shape[1], device=m)
            g = torch.empty_like(got)
            out.append(("grouped_log_einsum_exp", (ws, x),
                        4 * (x.numel() + sum(w.numel() for w in ws)
                             + got.numel()),
                        sum(2 * b * w.shape[0] * w.shape[1] * w.shape[2] ** 2
                            for w in ws)))
            out.append(("grouped_log_einsum_exp_bwd", (ws, x, g),
                        4 * (2 * x.numel() + g.numel()
                             + 2 * sum(w.numel() for w in ws)),
                        sum(b * w.shape[0] * (6 * w.shape[2] ** 2
                                              * w.shape[1]
                                              + 4 * w.shape[2] ** 2)
                            for w in ws)))
        elif seg.kind == "gather":
            tab, k = seg.tables, model.K
            vs = [model.mixing[t].detach() for t in span
                  if model.pair_specs[t].mix_global is not None]
            n_w = sum(w.numel() for w in ws) + sum(v.numel() for v in vs)
            x = torch.empty(b, tab.num_in_rows, k, device=m)
            g = torch.empty(b, tab.num_new_rows, k, device=m)
            out.append(("gather_grouped_log_einsum_exp", (tab, ws, vs, x),
                        4 * (x.numel() + n_w + b * tab.num_new_rows * k),
                        sum(2 * b * len(l) * k ** 3 for l in tab.left)))
            out.append(("gather_grouped_log_einsum_exp_bwd",
                        (tab, ws, vs, x, g),
                        4 * (2 * x.numel() + g.numel() + 2 * n_w),
                        sum(b * len(l) * (6 * k ** 3 + 4 * k ** 2)
                            for l in tab.left)))
    return out


@pytest.mark.parametrize("name, b", [("einet_rat", 2048), ("einet_rat", 64),
                                     ("einet_pd", 512), ("einet_pd", 64)])
def test_launch_cost_is_chip_smokes_formulas(name, b):
    from repro_torch.kernels.cost import launch_cost

    cases = _chip_smoke_costs(name, b)
    ops_seen = {op for op, *_ in cases}
    assert len(ops_seen) >= 4
    for op, args, n_bytes, flops in cases:
        assert launch_cost(op, *args) == (n_bytes, flops), op
    with pytest.raises(KeyError):
        launch_cost("no_such_op")
