"""Device meshes over the ranks of a ``torch.distributed`` job.

The port's counterpart of the reference's ``repro/launch/mesh.py``.  A
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims: ``("data", "model")``, or ``("pod", "data", "model")`` for two
pods.  Functions, not module-level constants, so importing this module
touches no process group.

``init_distributed`` joins the job that ``torchrun`` describes (the
reference's ``jax.distributed.initialize``): it reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` from
the environment.  Without them the job is one process, and no process
group is made: a world of 1 needs no collective.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.einet import resolve_device

DATA_DIMS = ("pod", "data")  # the mesh dims that split the batch


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(device=None) -> Tuple[int, int, torch.device]:
    """Join the job and return (rank, world size, this rank's device).

    A process group that is already initialised (a test's, or a caller's
    own) is used as it is.  Otherwise, with ``WORLD_SIZE`` > 1 in the
    environment, one is made from torchrun's variables: ``nccl`` on a CUDA
    device, ``gloo`` on the CPU.  A CUDA rank runs on ``cuda:LOCAL_RANK``;
    asking for CUDA without a card raises (``resolve_device``)."""
    device = resolve_device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        if world > 1:
            backend = "nccl" if device.type == "cuda" else "gloo"
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=world)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    return rank, world, device


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device_type: Optional[str]) -> DeviceMesh:
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    if dist.is_initialized():
        return DeviceMesh(device_type, ranks, mesh_dim_names=names)
    # one process and no process group: a mesh of one rank, with no
    # communicator behind its dims (nothing to communicate)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names,
                      _init_backend=False, _rank=0)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh.

    Dims ("data", "model") resp. ("pod", "data", "model").  The "pod" dim
    is the slow one between hosts: only data-parallel reductions of
    statistics cross it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world()
    if world < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}, found {world}")
    return _mesh(shape, names, device_type)


def make_mesh_for(world: Optional[int] = None, model_parallel: int = 16,
                  device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh over the first ranks of the job (``world``
    defaults to the process group's size, 1 without one).  As in the
    reference, a world smaller than ``model_parallel`` gives ``data = 1,
    model = world``, and the ranks past ``data * model`` are left out: their
    ``get_coordinate()`` is None."""
    world = _world() if world is None else world
    data = world // model_parallel
    if data < 1:
        data, model_parallel = 1, world
    return _mesh((data, model_parallel), ("data", "model"), device_type)


def mesh_sizes(mesh: DeviceMesh) -> dict:
    """{dim name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_shards(mesh: DeviceMesh) -> int:
    """Number of data-parallel shards (pod x data)."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes.get(name, 1) for name in DATA_DIMS)


def dp_index(mesh: DeviceMesh) -> int:
    """This rank's data-parallel shard (its pod and data coordinates, pod
    major), the ``shard_id`` its loader reads."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_sizes(mesh)
    index = 0
    for name in DATA_DIMS:
        if name in sizes:
            index = index * sizes[name] + coord[name]
    return index
