"""Elastic resharding: re-place a tree on a grown or shrunk mesh.

The port's counterpart of the reference's ``repro/dist/elastic.py``.  The
mesh is a function of the ranks alive (``repro_torch.launch.mesh
.make_mesh_for``), placement a function of the tree and the rules
(``repro_torch.dist.sharding.tree_shardings``), and the data pipeline is
stateless.  So surviving a lost (or gained) rank is: build the new mesh,
:func:`reshard` the state onto it, continue, with values bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree as tree_lib
from repro_torch.dist import sharding as sharding_lib


def reshard(tree: Any, mesh) -> Any:
    """``tree``'s leaves as DTensors on ``mesh``, each with the placements
    :func:`repro_torch.dist.sharding.tree_shardings` gives its path.

    A leaf may be a numpy array or a tensor on any device (the same full
    value on every rank), or a DTensor of another mesh: that one is first
    gathered over its own mesh (``all_gather``) and copied to the host.
    Each rank then keeps its block of the full value, so the move is data
    movement only and the values stay bit for bit."""
    shardings = sharding_lib.tree_shardings(mesh, tree)
    placed = tree_lib.leaves_like(tree, shardings)

    def move(x, placements):
        if isinstance(x, DTensor):
            x = sharding_lib.gather_full(x.to_local(), x.placements,
                                         x.device_mesh).cpu()
        full = torch.as_tensor(x).to(mesh.device_type, copy=True)
        return distribute_tensor(full, mesh, placements, src_data_rank=None)

    _, leaves = tree_lib.flatten(tree)
    moved = [move(x, p) for x, p in zip(leaves, placed)]
    return tree_lib.unflatten_like(tree, moved, lambda _, new: new)
