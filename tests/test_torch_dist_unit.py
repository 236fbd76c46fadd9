"""Single-process unit tests of the port's distribution layer
(``repro_torch.dist.sharding``, ``repro_torch.dist.elastic``,
``repro_torch.launch.mesh``) against the reference's ``repro.dist``.

Rule resolution and path resolution are pure functions, so they are held
against the reference's over grids of logical axes, shapes, mesh sizes and
rule tables, and over einet_rat's and einet_pd's parameter and statistics
trees carried across with ``repro_torch.convert``.  The multi-process
semantics are in ``test_torch_dist.py``.
"""

import itertools
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.core import em as ref_em
from repro.dist import sharding as ref_sh
from repro.launch import cells as ref_cells
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import em
from repro_torch.dist import elastic
from repro_torch.dist import sharding as sh
from repro_torch.launch.cells import build_einet
from repro_torch.launch.mesh import (
    dp_index,
    dp_shards,
    make_mesh_for,
    make_production_mesh,
)

SIZES = [
    {"data": 2, "model": 4},
    {"data": 1, "model": 1},
    {"pod": 2, "data": 2, "model": 2},
    {"data": 4},
    {"model": 3},
    {"data": 2, "model": 5},
]
RULES = [(mp, fsdp) for mp in (False, True) for fsdp in (False, True)]
NAMES = ["batch", "seq", "heads", "mlp", "vocab", "expert", "expert_mlp",
         "einet_nodes", "fsdp", None, "unknown"]
DIMS = [0, 1, 2, 3, 4, 6, 8, 12, 40]


def _ref_spec(spec):
    return None if spec is None else tuple(spec)


# ===================================================================== rules
@pytest.mark.parametrize("multi_pod,fsdp", RULES)
def test_rule_tables_match_reference(multi_pod, fsdp):
    assert sh.default_rules(multi_pod, fsdp) == ref_sh.default_rules(
        multi_pod, fsdp)
    assert sh.serve_rules(multi_pod) == ref_sh.serve_rules(multi_pod)


def test_default_rules_tables():
    r = sh.default_rules(multi_pod=False, fsdp=False)
    assert r["batch"] == ("data",)
    assert r["expert"] == "model"
    assert r["fsdp"] is None
    r = sh.default_rules(multi_pod=True, fsdp=True)
    assert r["batch"] == ("pod", "data")
    assert r["fsdp"] == ("data",)


def test_use_rules_nesting_precedence():
    assert sh.get_rules() is None
    outer = sh.default_rules(False, False)
    with sh.use_rules(outer):
        assert sh.get_rules()["seq"] == "model"
        with sh.use_rules(dict(outer, seq=None)):
            assert sh.get_rules()["seq"] is None  # innermost wins
        assert sh.get_rules()["seq"] == "model"  # outer restored
    assert sh.get_rules() is None


def test_use_rules_copies_table():
    rules = sh.default_rules(False, False)
    with sh.use_rules(rules):
        rules["batch"] = None  # a caller's later mutation is invisible
        assert sh.get_rules()["batch"] == ("data",)


# ================================================================ resolution
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("multi_pod,fsdp", RULES)
def test_resolve_spec_matches_reference_over_a_grid(sizes, multi_pod, fsdp):
    rules = sh.default_rules(multi_pod, fsdp)
    rng = np.random.RandomState(len(sizes) * 7 + 2 * multi_pod + fsdp)
    for ndim in (1, 2, 3, 4):
        for _ in range(60):
            axes = tuple(NAMES[i] for i in rng.randint(len(NAMES), size=ndim))
            shape = tuple(DIMS[i] for i in rng.randint(len(DIMS), size=ndim))
            got = sh.resolve_spec(axes, shape, sizes, rules)
            want = _ref_spec(ref_sh.resolve_spec(axes, shape, sizes, rules))
            assert got == want, (axes, shape, sizes)


def test_resolve_spec_degradation_cases():
    rules = sh.default_rules(False, False)
    sizes = {"data": 2, "model": 4}
    assert sh.resolve_spec(("heads",), (7,), sizes, rules) is None
    assert sh.resolve_spec(("heads",), (8,), sizes, rules) == ("model",)
    assert sh.resolve_spec(("seq", "heads"), (8, 8), sizes, rules) == (
        "model",)
    pod = sh.default_rules(multi_pod=True, fsdp=False)
    assert sh.resolve_spec(("batch",), (8,), sizes, pod) is None
    assert sh.resolve_spec(("heads",), (0,), sizes, rules) is None
    assert sh.resolve_spec(("batch",), (8,), {"pod": 2, "data": 2}, pod) == (
        ("pod", "data"),)


def test_axes_for_path_matches_reference():
    paths = ["/phi", "/einsum/0", "/einsum/12", "/mixing/3", "/n_einsum/1",
             "/n_mixing/0", "/s_phi", "/s_den", "/class_prior", "/n_class",
             "/ll", "/count", "/blocks/0/mlp/wu", "/head", "/einsum/x",
             "/moments/phi/m", "/moe/wg", "/embed"]
    for p in paths:
        for ndim in range(5):
            assert sh._axes_for_path(p, ndim) == ref_sh._axes_for_path(
                p, ndim), (p, ndim)


@pytest.fixture(scope="module", params=["einet_rat", "einet_pd"])
def trees(request):
    """(reference params, port params, reference stats, port stats) of
    one architecture, the port's params carried across from the
    reference's."""
    arch = request.param
    ref_model = ref_cells.build_einet(ref_get_config(arch))
    ref_params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
    pnp = jax.tree_util.tree_map(np.asarray, ref_params)
    port = build_einet(get_config(arch), device="cpu")
    port.load_state_dict(params_from_jax(pnp, port))
    ref_stats = jax.eval_shape(
        lambda p: ref_em.zeros_like_statistics(ref_model, p), ref_params)
    return (pnp, em.params_of(port), ref_stats,
            em.zeros_like_statistics(port, "meta"))


def _ref_path_specs(tree, sizes, rules):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for path, x in flat:
        p = ref_sh._path_str(path)
        axes = ref_sh._axes_for_path(p, len(x.shape))
        spec = (None if axes is None else
                _ref_spec(ref_sh.resolve_spec(axes, x.shape, sizes, rules)))
        out.append((p, tuple(x.shape), spec))
    return out


def _port_path_specs(tree, sizes, rules):
    paths, leaves = sh.tree_paths(tree)
    return [(p, tuple(x.shape), sh.leaf_spec(p, tuple(x.shape), sizes, rules))
            for p, x in zip(paths, leaves)]


@pytest.mark.parametrize("sizes", SIZES[:3] + [{"data": 1, "model": 2}])
def test_path_resolution_matches_reference_on_einet_trees(trees, sizes):
    ref_params, params, ref_stats, stats = trees
    rules = sh.default_rules("pod" in sizes, False)
    for ref_tree, tree in ((ref_params, params), (ref_stats, stats)):
        want = _ref_path_specs(ref_tree, sizes, rules)
        got = _port_path_specs(tree, sizes, rules)
        assert got == want


def test_einet_leaves_that_do_not_divide_replicate(trees):
    _, params, _, _ = trees
    rules = sh.default_rules(False, False)
    specs = dict((p, s) for p, _, s in _port_path_specs(
        params, {"data": 1, "model": 2}, rules))
    assert specs["/class_prior"] is None
    for p, x in zip(*sh.tree_paths(params)):
        if x.numel() == 0:
            assert specs[p] is None  # the size-0 mixing leaf
    assert specs["/phi"] == ("model",)


# ===================================================== placements and shards
def _fake_mesh(names, shape, coord):
    return types.SimpleNamespace(
        ndim=len(names), mesh_dim_names=names, shape=shape,
        size=lambda j: shape[j], get_coordinate=lambda: coord)


def test_spec_placements():
    mesh = _fake_mesh(("pod", "data", "model"), (2, 2, 2), (0, 0, 0))
    assert sh.spec_placements(None, mesh) == (Replicate(),) * 3
    assert sh.spec_placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert sh.spec_placements((("pod", "data"),), mesh) == (
        Shard(0), Shard(0), Replicate())


def test_local_shard_is_the_dtensor_block():
    x = torch.arange(48.0).reshape(8, 6)
    placements = (Shard(0), Shard(1))
    blocks = {}
    for c in itertools.product(range(2), range(3)):
        mesh = _fake_mesh(("data", "model"), (2, 3), c)
        blocks[c] = sh.local_shard(x, placements, mesh)
        assert blocks[c].data_ptr() >= x.data_ptr()  # a view
    assert torch.equal(blocks[(1, 2)], x[4:8, 4:6])
    rows = [torch.cat([blocks[(i, j)] for j in range(3)], 1) for i in range(2)]
    assert torch.equal(torch.cat(rows, 0), x)


# ======================================================= one-process meshes
def test_make_mesh_for_degrades_to_one_rank():
    mesh = make_mesh_for(model_parallel=16, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert dp_shards(mesh) == 1 and dp_index(mesh) == 0
    mesh = make_mesh_for(1, model_parallel=1, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)


def test_make_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_tree_shardings_covers_lm_and_einet_paths():
    mesh = make_mesh_for(device_type="cpu")
    tree = {
        "blocks": ({"mlp": {"wu": torch.ones((2, 8, 32))}},),
        "head": torch.ones((8, 128)),
        "phi": torch.ones((12, 4, 2, 2)),
        "einsum": [torch.ones((4, 4, 4, 4))],
        "mixing": [torch.zeros((0, 0, 4))],
        "class_prior": torch.ones((1,)),
    }
    with sh.use_rules(sh.default_rules(False, False)):
        placed = tree_lib.leaves_like(tree, sh.tree_shardings(mesh, tree))
    assert len(placed) == len(tree_lib.flatten(tree)[1])
    assert all(p == (Replicate(), Replicate()) for p in placed)


def test_batch_shardings_leading_dim():
    mesh = make_mesh_for(device_type="cpu")
    batch = {"x": torch.ones((8, 16)), "scalar": torch.ones(())}
    out = sh.batch_shardings(mesh, batch)
    assert out["x"] == (Replicate(), Replicate())
    assert out["scalar"] == (Replicate(), Replicate())


def test_reshard_one_rank_roundtrip_bitwise():
    mesh = make_mesh_for(device_type="cpu")
    tree = {
        "blocks": [{"mlp": {"wu": np.random.RandomState(0).randn(
            2, 8, 32).astype(np.float32)}}],
        "head": np.random.RandomState(1).randn(8, 128).astype(np.float32),
    }
    with sh.use_rules(sh.default_rules(False, False)):
        placed = elastic.reshard(tree, mesh)
        moved = elastic.reshard(placed, mesh)
    for a, b in zip(tree_lib.flatten(tree)[1], tree_lib.flatten(moved)[1]):
        np.testing.assert_array_equal(a, b.to_local().numpy())
    tree["head"][0, 0] = 123.0  # the placed copy does not alias the input
    assert placed["head"].to_local()[0, 0] != 123.0


def test_reduce_like_params_one_rank_is_the_identity():
    mesh = make_mesh_for(device_type="cpu")
    stats = {"n_einsum": [torch.rand(4, 2, 3, 3)], "s_phi": torch.rand(6, 2, 1, 2),
             "ll": torch.tensor(-3.5), "count": torch.tensor(7.0)}
    out = sh.reduce_like_params(stats, mesh)
    for a, b in zip(tree_lib.flatten(stats)[1], tree_lib.flatten(out)[1]):
        assert torch.equal(a, b)
    # every leaf is a view of one packed buffer: one collective a data dim
    bases = {t.untyped_storage().data_ptr() for t in tree_lib.flatten(out)[1]}
    assert len(bases) == 1
