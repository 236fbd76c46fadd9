"""Multi-process helpers for the port's distribution tests.

Each test world is a set of spawned processes joined by gloo through a
``FileStore`` under the test's ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), with a timeout on the process group and on the
join.  A worker writes what it found to ``out_<rank>.pt`` and the test
reads the files.  This module imports torch and the port only, so a
spawned process starts without JAX.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

INIT_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 180


def _entry(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        out = fn(rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(world: int, tmp, fn, *args):
    """Run ``fn(rank, world, tmp, *args)`` in ``world`` spawned processes
    of one gloo group; returns their results in rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, tmp, fn, args),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- workers
def small_einet(state=None):
    """The tests' EiNet: ``random_binary_trees(12, 2, 2)``, K=4, Normal
    leaves, on the CPU, with ``state`` (a state dict) loaded."""
    from repro_torch.core import random_binary_trees
    from repro_torch.core.einet import EiNet

    model = EiNet(random_binary_trees(12, 2, 2, seed=0), num_sums=4,
                  device="cpu")
    if state is not None:
        model.load_state_dict(state)
    return model


def sharded_em_worker(rank, world, tmp, model_parallel, state, x, steps,
                      microbatches):
    """``steps`` sharded EM steps on a (world // model_parallel,
    model_parallel) mesh, each rank on its data shard's rows of ``x``."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.mesh import dp_index, dp_shards, make_mesh_for
    from repro_torch.train import TrainConfig, make_sharded_em_step

    mesh = make_mesh_for(world, model_parallel, device_type="cpu")
    model = small_einet(state)
    rows = x.shape[0] // dp_shards(mesh)
    i = dp_index(mesh)
    xb = torch.from_numpy(x[i * rows: (i + 1) * rows])
    step = make_sharded_em_step(
        model, TrainConfig(num_microbatches=microbatches), mesh)
    lls, params = [], []
    for _ in range(steps):
        lls.append(step(xb))
        params.append(params_to_numpy(model))
    return {"lls": lls, "params": params, "coord": mesh.get_coordinate(),
            "mesh": tuple(mesh.shape)}


def compressed_psum_worker(rank, world, tmp, n, seed):
    """``compressed_psum`` of a seeded tensor a rank (rank r's is
    ``RandomState(seed + r).randn(n)``), with a seeded residual."""
    from repro_torch.optim.compression import compressed_psum

    g = torch.from_numpy(np.random.RandomState(seed + rank).randn(n)
                         .astype(np.float32))
    res = torch.from_numpy((0.01 * np.random.RandomState(seed + 100 + rank)
                            .randn(n)).astype(np.float32))
    out, new_res = compressed_psum(g, None, res)
    return {"out": out.numpy(), "residual": new_res.numpy()}


def reshard_worker(rank, world, tmp, tree):
    """``tree`` placed on a (2, 2) mesh, moved to (4, 1) and back; returns
    each placement's local blocks and the gathered values."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist import elastic, sharding
    from repro_torch.launch.mesh import make_mesh_for

    m22 = make_mesh_for(world, 2, device_type="cpu")
    m41 = make_mesh_for(world, 1, device_type="cpu")
    dropped = make_mesh_for(world, 3, device_type="cpu")
    with sharding.use_rules(sharding.default_rules(False, False)):
        a = elastic.reshard(tree, m22)
        b = elastic.reshard(a, m41)
        c = elastic.reshard(b, m22)

    def local(t):
        return [x.to_local().numpy().copy() for x in tree_lib.flatten(t)[1]]

    def full(t):
        return [sharding.gather_full(x.to_local(), x.placements,
                                     x.device_mesh).numpy()
                for x in tree_lib.flatten(t)[1]]

    return {"a": local(a), "c": local(c), "b_full": full(b),
            "placements": [tuple(map(str, x.placements))
                           for x in tree_lib.flatten(a)[1]],
            "dropped_mesh": tuple(dropped.shape),
            "dropped_coord": dropped.get_coordinate()}


def checkpoint_worker(rank, world, tmp, steps):
    """Each rank saves ``steps`` rank-valued states (async) and restores
    the newest."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=2)
    for s in steps:
        mgr.save(s, {"params": {"w": torch.full((3,), float(10 * s + rank))},
                     "step": s})
    mgr.wait()
    step, state = mgr.restore({"params": {"w": torch.zeros(3)}, "step": 0})
    return {"step": step, "w": state["params"]["w"].numpy(),
            "all_steps": mgr.all_steps(), "rank": mgr.rank,
            "world": mgr.world}


def launcher_worker(rank, world, tmp, argv):
    """The training CLI's ``main(argv)`` on this rank; returns (its
    standard output, its report)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = train.main(argv)
    return buf.getvalue(), report


def serve_worker(rank, world, tmp, state, n_requests, max_batch, seed):
    """The mixed stream of ``n_requests`` through ``ServeEngine(rules=
    serve_rules())``: every rank runs the same engine over the same stream;
    returns each request's value, the engine's mesh and stats and which
    buckets the engine split."""
    from repro_torch.dist.sharding import serve_rules
    from repro_torch.serve import ServeEngine, mixed_requests

    model = small_einet(state)
    engine = ServeEngine(model, max_batch=max_batch, rules=serve_rules())
    reqs = mixed_requests(model.num_vars, n_requests, seed=seed)
    out = engine.run(reqs)
    return {"values": {i: np.asarray(r.value) for i, r in out.items()},
            "split": sorted(b for b in engine.buckets
                            if engine._split(b) is not None),
            "mesh": tuple(engine.mesh.shape),
            "requests": engine.stats["requests"]}
