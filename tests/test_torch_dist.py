"""The port's distributed EM on the CPU: gloo worlds of spawned processes
(``tests/_torch_dist_workers.py``) against the reference's single-device
step (``repro.train.make_em_step``, JAX on one CPU device, in this
process).

The sharded step sums the statistics over the data dim once, on the
totals; at a model dim above 1 each rank runs the M-step on its model
shard and the parameters are all-gathered.  Tolerances against the
reference: parameters rtol 1e-4, atol 1e-6; LL 1e-4.  Replicas agree bit
for bit; a world of 1 equals the port's ``make_em_step`` bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import random_binary_trees as ref_rbt
from repro.optim import compression as ref_compression
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_em_step as ref_make_em_step
from repro_torch import tree as tree_lib
from repro_torch.convert import params_from_jax
from repro_torch.core import em, poon_domingos
from repro_torch.core.einet import EiNet
from repro_torch.data import datasets as ds_lib
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.train import TrainConfig, make_em_step, make_sharded_em_step

STEPS, MICRO = 2, 2
P_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The reference's two single-device steps on all 64 rows."""
    net = RefEiNet(ref_rbt(12, 2, 2, seed=0), num_sums=4,
                   exponential_family=RefNormal())
    params = net.init(jax.random.PRNGKey(0))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.RandomState(1).randn(64, 12).astype(np.float32)
    step = ref_make_em_step(net, RefTrainConfig(
        mode="stochastic", num_microbatches=MICRO, donate=False))
    out, lls, p = [], [], params
    for _ in range(STEPS):
        p, ll = step(p, x)
        out.append(jax.tree_util.tree_map(np.asarray, p))
        lls.append(float(ll))
    state = params_from_jax(pnp, workers.small_einet())
    return {"x": x, "state": state, "params": out, "lls": lls}


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    return workers.run_world(
        2, tmp_path_factory.mktemp("w2"), workers.sharded_em_worker, 1,
        ref["state"], ref["x"], STEPS, MICRO)


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    return workers.run_world(
        4, tmp_path_factory.mktemp("w4"), workers.sharded_em_worker, 2,
        ref["state"], ref["x"], STEPS, MICRO)


def _assert_params_close(got, want, what):
    g_leaves = jax.tree_util.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for a, b in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(a, b, err_msg=what, **P_TOL)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_sharded_step_matches_reference_single_device(world, ref, request):
    results = request.getfixturevalue(world)
    for r in results:
        for s in range(STEPS):
            _assert_params_close(r["params"][s], ref["params"][s],
                                 f"{world} rank at {r['coord']} step {s}")
            assert abs(r["lls"][s] - ref["lls"][s]) < 1e-4


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_sharded_step_replicas_agree_bitwise(world, request):
    results = request.getfixturevalue(world)
    first = results[0]
    for r in results[1:]:
        assert r["lls"] == first["lls"]
        for s in range(STEPS):
            for a, b in zip(jax.tree_util.tree_leaves(r["params"][s]),
                            jax.tree_util.tree_leaves(first["params"][s])):
                np.testing.assert_array_equal(a, b)


def test_sharded_meshes(world2, world4):
    assert {r["mesh"] for r in world2} == {(2, 1)}
    assert {r["mesh"] for r in world4} == {(2, 2)}
    assert sorted(r["coord"] for r in world4) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_world_of_one_equals_make_em_step_bitwise(ref, microbatches):
    a, b = workers.small_einet(ref["state"]), workers.small_einet(ref["state"])
    mesh = make_mesh_for(model_parallel=16, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    cfg = TrainConfig(num_microbatches=microbatches)
    step_a, step_b = make_em_step(a, cfg), make_sharded_em_step(b, cfg, mesh)
    x = torch.from_numpy(ref["x"])
    for _ in range(3):
        assert step_a(x) == step_b(x)
    for u, v in zip(tree_lib.flatten(em.params_of(a))[1],
                    tree_lib.flatten(em.params_of(b))[1]):
        assert torch.equal(u, v)


def _pd_port():
    return EiNet(poon_domingos(4, 4, 2), num_sums=4, device="cpu",
                 seed=0)


@pytest.mark.parametrize("arch", ["rat", "pd"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_m_step_is_the_full_m_steps_slice_bitwise(ref, arch, shards):
    """Every M-step block is normalised along non-leading axes only, so a
    leading-axis block of the statistics gives that block of the full
    M-step, bit for bit (mixing masks cut alike)."""
    if arch == "rat":
        model = workers.small_einet(ref["state"])
        x = torch.from_numpy(ref["x"])
    else:
        model = _pd_port()
        x = torch.rand(32, model.num_vars, generator=torch.Generator()
                       .manual_seed(0))
    stats = em.em_statistics(model, x)
    full = em.m_step(model, stats, em.EMConfig())

    def cut(t, c):
        n = t.shape[0] if t.dim() else 0
        if t.dim() == 0 or n == 0 or n % shards:
            return t
        return t.chunk(shards, 0)[c]

    checked = 0
    for c in range(shards):
        block = tree_lib.unflatten_like(
            stats, [cut(t, c) for t in tree_lib.flatten(stats)[1]],
            lambda _, new: new)
        masks = [None if sp.mix_global is None
                 else cut(model._table(i, "mix_mask"), c)
                 for i, sp in enumerate(model.pair_specs)]
        part = em.m_step(model, block, em.EMConfig(), masks)
        for got, want in zip(tree_lib.flatten(part)[1],
                             tree_lib.flatten(full)[1]):
            w = cut(want, c)
            assert torch.equal(got, w)
            checked += int(w.shape != want.shape)
    assert checked > 0  # some leaf was cut


def test_sharded_step_refuses_health_and_meshes_without_data_dim(ref):
    model = workers.small_einet(ref["state"])
    mesh = make_mesh_for(device_type="cpu")
    with pytest.raises(ValueError, match="health"):
        make_sharded_em_step(model, TrainConfig(health=True), mesh)
    with pytest.raises(ValueError, match="axis_names"):
        make_em_step(model, TrainConfig(axis_names=("data",)))


# ------------------------------------------------------------ compressed sum
@pytest.fixture(scope="module")
def psum4(tmp_path_factory):
    return workers.run_world(4, tmp_path_factory.mktemp("psum"),
                             workers.compressed_psum_worker, 1000, 7)


def _ref_compressed(n, seed, world):
    g = np.stack([np.random.RandomState(seed + r).randn(n)
                  for r in range(world)]).astype(np.float32)
    res = np.stack([0.01 * np.random.RandomState(seed + 100 + r).randn(n)
                    for r in range(world)]).astype(np.float32)
    out, new_res = jax.vmap(
        lambda a, b: ref_compression.compressed_psum(a, "data", b),
        axis_name="data")(g, res)
    return g + res, np.asarray(out), np.asarray(new_res)


def test_compressed_psum_four_ranks_against_exact_sum(psum4):
    g, _, _ = _ref_compressed(1000, 7, 4)
    exact = g.sum(0)
    for r in psum4:
        rel = np.abs(r["out"] - exact).max() / (np.abs(exact).max() + 1e-9)
        assert rel < 0.05, rel


def test_compressed_psum_four_ranks_bitwise_reference(psum4):
    _, out, new_res = _ref_compressed(1000, 7, 4)
    for rank, r in enumerate(psum4):
        np.testing.assert_array_equal(r["out"], out[rank])
        np.testing.assert_array_equal(r["residual"], new_res[rank])


# ------------------------------------------------------------------ reshard
def _reshard_tree():
    rs = np.random.RandomState(3)
    model = _pd_port()
    tree = {k: v for k, v in em.params_of(model).items()}
    tree = jax.tree_util.tree_map(lambda t: t.numpy().copy(), tree)
    tree["blocks"] = [{"mlp": {"wu": rs.randn(2, 8, 32).astype(np.float32)}}]
    tree["head"] = rs.randn(8, 128).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def reshard4(tmp_path_factory):
    return workers.run_world(4, tmp_path_factory.mktemp("reshard"),
                             workers.reshard_worker, _reshard_tree())


def test_reshard_roundtrip_bitwise(reshard4):
    tree = _reshard_tree()
    want = tree_lib.flatten(tree)[1]
    for r in reshard4:
        for a, c in zip(r["a"], r["c"]):
            np.testing.assert_array_equal(a, c)
        for got, w in zip(r["b_full"], want):
            np.testing.assert_array_equal(got, w)
    # the (2, 2) placement sharded leaves over the model dim
    placed = reshard4[0]["placements"]
    assert any(p[1].startswith("S") for p in placed), placed
    sizes = {a.size for r in reshard4 for a in r["a"]}
    assert min(sizes) < max(w.size for w in want)


def test_make_mesh_for_drops_ranks_past_data_times_model(reshard4):
    assert {r["dropped_mesh"] for r in reshard4} == {(1, 3)}
    coords = [r["dropped_coord"] for r in reshard4]
    assert coords[:3] == [(0, 0), (0, 1), (0, 2)] and coords[3] is None


# -------------------------------------------------------------- checkpoints
def test_checkpoint_two_ranks_save_and_restore(tmp_path):
    out = workers.run_world(2, tmp_path, workers.checkpoint_worker,
                            [1, 2, 3])
    for rank, r in enumerate(out):
        assert (r["rank"], r["world"]) == (rank, 2)
        assert r["step"] == 3 and r["all_steps"] == [2, 3]
        np.testing.assert_array_equal(r["w"], np.full(3, 30.0 + rank))
    d = tmp_path / "ckpt" / "step_00000003"
    assert sorted(os.listdir(d)) == ["meta.json", "shard_0.npz",
                                     "shard_1.npz"]
    import json
    assert json.loads((d / "meta.json").read_text())["num_processes"] == 2


# ----------------------------------------------------------------- launcher
def test_launcher_shards_are_disjoint_and_cover_the_batch():
    data = np.arange(4096 * 3, dtype=np.float32).reshape(4096, 3)
    batch = 64
    for shards in (1, 2, 4):
        for step in (0, 5, 63, 64, 200):
            parts = [ds_lib.array_loader(data, batch, num_shards=shards,
                                         shard_id=s).batch_at(step)["x"]
                     for s in range(shards)]
            rows = np.concatenate(parts)
            assert len({tuple(r) for r in rows}) == batch  # disjoint
            want = launch_train.batch_at(torch.from_numpy(data), step, batch)
            np.testing.assert_array_equal(rows, want.numpy())


@pytest.mark.parametrize("mp_args", [[], ["--model-parallel", "2"]])
def test_launcher_dist_em_two_ranks(tmp_path, mp_args):
    argv = ["--smoke", "--dist-em", "--device", "cpu", "--steps", "4",
            "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path / "ck")
            ] + mp_args
    outs = workers.run_world(2, tmp_path / "w", workers.launcher_worker,
                             argv)
    single = launch_train.train_einet(
        "smoke", 4, device="cpu", ckpt_dir=str(tmp_path / "single"),
        health=False, cfg=launch_train.SMOKE_CONFIG)
    shards = 1 if mp_args else 2
    for text, report in outs:
        assert f"dp_shards={shards}" in text, text
        assert report["dp_shards"] == shards and report["dist"]
        assert len(report["lls"]) == 4
        np.testing.assert_allclose(report["lls"], single["lls"], rtol=0,
                                   atol=1e-4)
    assert outs[0][1]["lls"] == outs[1][1]["lls"]
    # both ranks' shards of the last step were committed together
    assert outs[0][1]["checkpoints"] == [2, 4]
    step_dir = tmp_path / "ck" / launch_train.SMOKE_CONFIG.name / "step_00000004"
    assert sorted(os.listdir(step_dir)) == ["meta.json", "shard_0.npz",
                                            "shard_1.npz"]


def test_launcher_refuses_mixture_with_dist(tmp_path):
    with pytest.raises(SystemExit, match="--mixture"):
        launch_train.main(["--arch", "einet_rat", "--mixture", "3",
                           "--dist-em", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
