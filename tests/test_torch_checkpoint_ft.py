"""The port's checkpoints (``repro_torch.checkpoint``) and fault-tolerant
loop (``repro_torch.dist.fault_tolerance``) on the CPU, case for case the
contracts of ``tests/test_checkpoint_ft.py``, on trees of tensors and on
an EiNet whose training step writes its parameters in place; and the
on-disk layout shared with the reference: a checkpoint the reference's
``CheckpointManager`` writes restores into the port (its LL then equals
the reference's, rtol 1e-5, atol 1e-4 -- sums in other orders than
XLA's), and one the port writes restores into the reference bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.core import EiNet as RefEiNet
from repro.core import Normal as RefNormal
from repro.core import random_binary_trees as ref_rbt
from repro_torch import compile as compile_lib
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import em, random_binary_trees
from repro_torch.core.einet import EiNet
from repro_torch.dist import fault_tolerance as ft
from repro_torch.train import TrainConfig, make_em_step

NV = 16


def _tree(step):
    return {
        "a": torch.arange(6, dtype=torch.float32) + step,
        "nested": {"b": torch.ones((3, 2)) * step,
                   "c": torch.tensor(step)},
    }


def _leaves(tree):
    return tree_lib.flatten(tree)[1]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(7, _tree(7))
    step, restored = mgr.restore(_tree(0))
    assert step == 7
    for a, b in zip(_leaves(restored), _leaves(_tree(7))):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_save_copies_before_the_write(tmp_path):
    """An async save holds a copy: writing the tensor in place afterwards
    (as the next training step does) does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    t = _tree(1)
    mgr.save(1, t)
    t["a"].add_(100.0)
    mgr.wait()
    _, restored = mgr.restore(_tree(0))
    assert torch.equal(restored["a"], _tree(1)["a"])


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert mgr.latest_step() == 3


def test_gc_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_tmp_debris_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed write
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(_tree(0))
    assert step == 1


def test_tree_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree(1))
    with pytest.raises(AssertionError, match="tree mismatch"):
        mgr.restore({"different": torch.zeros(3)})


def test_paths_follow_the_reference_order():
    tree = {"b": [torch.zeros(1), None, {"y": 1.0, "x": 2.0}],
            "a": torch.zeros(2)}
    paths, leaves = tree_lib.flatten(tree)
    want = jax.tree_util.tree_flatten_with_path(
        {"b": [jnp.zeros(1), None, {"y": 1.0, "x": 2.0}], "a": jnp.zeros(2)})
    assert paths == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in p) for p, _ in want[0]]
    assert tree_lib.structure(tree) == str(
        jax.tree_util.tree_structure(
            {"b": [0, None, {"y": 0, "x": 0}], "a": 0}))


# ------------------------------------------------------------ fault tolerance
def test_run_training_with_failures(tmp_path):
    """Failures at steps 7 and 13 do not change the final result."""
    mgr = CheckpointManager(str(tmp_path / "a"), async_write=False)

    def step_fn(state, batch):
        return {"x": state["x"] + batch["v"].sum(), "step": state["step"] + 1}

    def batch_at(step):
        return {"v": torch.tensor([step, step], dtype=torch.float32)}

    crashed = set()

    def injector(step):
        if step in (7, 13) and step not in crashed:
            crashed.add(step)
            raise RuntimeError(f"simulated node failure at {step}")

    init = {"x": torch.zeros(()), "step": torch.zeros((), dtype=torch.int32)}
    cfg = ft.LoopConfig(checkpoint_every=5, max_restarts=5)
    final, stats = ft.run_training(step_fn, init, batch_at, mgr, 20, cfg,
                                   fail_injector=injector)
    assert stats["restarts"] == 2
    ref, _ = ft.run_training(
        step_fn, init, batch_at,
        CheckpointManager(str(tmp_path / "b"), async_write=False), 20, cfg)
    assert float(final["x"]) == float(ref["x"])
    assert int(final["step"]) == int(ref["step"]) == 20


def _net(seed=0):
    return EiNet(random_binary_trees(NV, 2, 2, seed=0), num_sums=4,
                 device="cpu", seed=seed)


def _capture_nothing(run, device, pool):
    return run, None


def _einet_loop(net, step, directory, injector=None, checkpoint_every=4,
                steps=12, async_write=True):
    """The launcher's pattern: the state holds views of the module's
    parameters, ``init`` a snapshot, and ``load_state`` writes a state back
    into the module in place."""
    data = torch.from_numpy(np.random.RandomState(1).randn(
        steps * 8, NV).astype(np.float32))

    def load_state(s):
        em.load_params(net, s["params"])
        return {"last_ll": float(s["last_ll"]),
                "params": em.params_of(net), "step": int(s["step"])}

    def step_fn(s, x):
        return {"last_ll": step(x), "params": em.params_of(net),
                "step": s["step"] + 1}

    init = {"last_ll": 0.0, "step": 0, "params": {
        k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
        for k, v in em.params_of(net).items()}}
    return ft.run_training(
        step_fn, init, lambda i: data[8 * i: 8 * i + 8],
        CheckpointManager(directory, async_write=async_write), steps,
        ft.LoopConfig(checkpoint_every=checkpoint_every, max_restarts=5),
        fail_injector=injector, load_state=load_state)


@pytest.mark.parametrize("fail_at", [(2, 9), (5, 9)],
                         ids=["before_first_checkpoint", "after"])
def test_run_training_in_place_model_bit_identical(tmp_path, fail_at):
    """An EiNet trained by its graph step program (injected capture) in
    place: failures at two steps give the parameters of an uninterrupted
    run bit for bit -- a failure before the first checkpoint replays from
    the snapshot of the initial parameters -- and no restore recaptures."""
    crashed = set()

    def injector(i):
        if i in fail_at and i not in crashed:
            crashed.add(i)
            raise RuntimeError(f"node lost at {i}")

    reg = compile_lib.ProgramRegistry(capture_fn=_capture_nothing)
    a, b = _net(), _net()
    step_a = make_em_step(a, TrainConfig(), registry=reg)
    _, stats = _einet_loop(a, step_a, str(tmp_path / "a"), injector)
    _, stats_b = _einet_loop(b, make_em_step(b, TrainConfig()),
                             str(tmp_path / "b"))
    assert stats["restarts"] == 2 and stats_b["restarts"] == 0
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert reg.stats["compiles"] == 1 and len(step_a.graphs) == 1


def test_run_training_resumes_a_preempted_run(tmp_path):
    a, b = _net(), _net()
    _einet_loop(a, make_em_step(a, TrainConfig()), str(tmp_path / "a"),
                steps=8)
    _, stats = _einet_loop(a, make_em_step(a, TrainConfig()),
                           str(tmp_path / "a"), steps=12)
    assert stats["final_step"] == 12
    _einet_loop(b, make_em_step(b, TrainConfig()), str(tmp_path / "b"),
                steps=12)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_restart_budget_exceeded(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)

    def injector(step):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError, match="restart budget"):
        ft.run_training(lambda s, b: s, {"x": torch.zeros(())},
                        lambda s: {}, mgr, 5, ft.LoopConfig(max_restarts=2),
                        fail_injector=injector)


def test_straggler_monitor_remaps():
    cfg = ft.LoopConfig(straggler_factor=2.0, straggler_window=8)
    mon = ft.StragglerMonitor(num_shards=4, cfg=cfg)
    mon.spares = [99]
    for _ in range(8):
        for shard in range(4):
            mon.record(shard, 10.0 if shard == 2 else 1.0)
    assert mon.stragglers() == [2]
    assert mon.mitigate() == {2: 99}
    assert mon.stragglers() == []


# -------------------------------------------------- the reference's layout
def _ref_state():
    ref = RefEiNet(ref_rbt(NV, 2, 2, seed=0), num_sums=4,
                   exponential_family=RefNormal())
    params = jax.jit(ref.init)(jax.random.PRNGKey(2))
    return ref, {"params": params, "step": jnp.asarray(5, jnp.int32),
                 "last_ll": -12.5}


def _port_template(net):
    return {"last_ll": 0.0, "params": em.params_of(net), "step": 0}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref, state = _ref_state()
    RefCheckpointManager(str(tmp_path), async_write=False).save(5, state)
    net = _net(seed=9)
    step, back = CheckpointManager(str(tmp_path)).restore(
        _port_template(net))
    assert step == 5 and int(back["step"]) == 5
    assert float(back["last_ll"]) == -12.5
    ids = [p.data_ptr() for p in net.parameters()]
    em.load_params(net, back["params"])
    assert [p.data_ptr() for p in net.parameters()] == ids  # in place
    want = jax.tree_util.tree_leaves(state["params"])
    got = tree_lib.flatten(em.params_of(net))[1]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    x = np.random.RandomState(3).randn(12, NV).astype(np.float32)
    with torch.no_grad():
        ll = net.log_likelihood(torch.from_numpy(x)).numpy()
    want_ll = np.asarray(ref.log_likelihood(state["params"], jnp.asarray(x)))
    np.testing.assert_allclose(ll, want_ll, rtol=1e-5, atol=1e-4)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ref, state = _ref_state()
    net = _net(seed=4)
    CheckpointManager(str(tmp_path), async_write=False).save(
        3, {"last_ll": -1.0, "params": em.params_of(net), "step": 3})
    step, back = RefCheckpointManager(str(tmp_path)).restore(
        {"last_ll": 0.0, "params": state["params"], "step": 0})
    assert step == 3
    got = jax.tree_util.tree_leaves(back["params"])
    want = tree_lib.flatten(em.params_of(net))[1]
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w.numpy())
