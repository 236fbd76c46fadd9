"""Rule-based placement of parameter, statistic and batch trees on a mesh.

The port's counterpart of the reference's ``repro/dist/sharding.py``.  A
leaf's placement is derived from its *tree path*: the path names its
logical axes (``_PARAM_AXES``, e.g. ``/einsum/0`` -> ``("einet_nodes",
None, None, None)``), and a rule table -- installed with :func:`use_rules`
-- maps each logical axis to a mesh dim (or a tuple of dims, or None for
replicated).  Swapping the table re-targets the whole tree.

Resolution of one tensor dim (kept verbatim from the reference): logical
name -> rules[name] -> mesh dims; the dims are kept only if they all exist
in the mesh, none was already used by an earlier dim of the same tensor,
their product is above 1 and the dim size is positive and divides evenly --
otherwise that dim degrades to replicated (never an error: rules are
preferences, not requirements).

Where the reference returns a ``PartitionSpec``, :func:`resolve_spec`
returns a tuple of entries, and :func:`tree_shardings` gives each leaf a
tuple of ``torch.distributed.tensor`` placements, one per mesh dim
(``Shard(d)`` or ``Replicate()``).  The reference's ``constraint`` (a
GSPMD layout hint inside a traced program) has no counterpart: eager
PyTorch has no layout to pin.  Its ``constrain_like_params`` becomes
:func:`reduce_like_params`, which performs the reduction the hint shaped:
the statistics summed over the data dims, each rank keeping its model shard.

Collectives run over ``mesh.get_group(dim)``, and only while a process
group exists: a job of one process has none, and its reductions are the
identity.  Only ``all_reduce`` and ``all_gather`` are used, which both
NCCL and gloo implement for CUDA tensors.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import DATA_DIMS, mesh_sizes

Rules = Dict[str, Any]  # logical axis -> mesh dim | tuple of dims | None
Spec = Tuple[Any, ...]  # one entry a tensor dim: a dim name, a tuple, None
Placements = Tuple[Any, ...]  # one Shard / Replicate a mesh dim

_state = threading.local()


# ===========================================================================
# rule tables
# ===========================================================================
def default_rules(multi_pod: bool, fsdp: bool) -> Rules:
    """The production rule table (the reference's, entry for entry).

    * ``batch`` -- data parallelism over ("pod", "data") / ("data",).
    * ``seq`` / ``heads`` / ``mlp`` / ``vocab`` / ``expert`` -- the
      reference's tensor-parallel axes, kept so the table matches it.
    * ``einet_nodes`` -- the EiNet layer-node axis (paper Eq. 5's L dim):
      einsum weights, EM statistics and leaf parameters shard over "model"
      along it.
    * ``fsdp`` -- parameter sharding over the data dim; None keeps
      parameters replicated over it.
    """
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": "model",
        "heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "einet_nodes": "model",
        "fsdp": ("data",) if fsdp else None,
    }


def serve_rules(multi_pod: bool = False) -> Rules:
    """Rule table for serving: data parallelism over the batch, layer-node
    sharding over "model", no FSDP (serving keeps parameters resident)."""
    return default_rules(multi_pod, fsdp=False)


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Install (a copy of) ``rules`` for the block; re-entrant: the
    innermost table wins and the outer one is back on exit.  The stack is
    per thread."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(dict(rules))
    try:
        yield rules
    finally:
        stack.pop()


def get_rules() -> Optional[Rules]:
    """The innermost active rule table, or None outside any use_rules."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


# ===========================================================================
# resolution
# ===========================================================================
def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 axis_sizes: Dict[str, int], rules: Rules) -> Optional[Spec]:
    """Pure resolution: logical axes + rules + mesh dim sizes -> a tuple
    with one entry a tensor dim (a mesh dim name, a tuple of names, or
    None; trailing Nones dropped), or None when nothing ended up sharded."""
    used = set()
    entries: List[Any] = []
    for i, name in enumerate(axes):
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        else:
            mesh_axes = tuple(mesh_axes)
        prod = 1
        ok = True
        for ax in mesh_axes:
            if ax not in axis_sizes or ax in used:
                ok = False
                break
            prod *= axis_sizes[ax]
        dim = shape[i] if i < len(shape) else 0
        if not ok or prod <= 1 or dim <= 0 or dim % prod != 0:
            entries.append(None)
            continue
        used.update(mesh_axes)
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    if not used:
        return None
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# (path suffix -> logical axes per dim), first match wins: the reference's
# table verbatim.  Matched with str.endswith / containment on the
# "/key/0/leaf" path form, so one table covers parameters, EM statistics
# and AdamW moment trees.  Only the EiNet rows match a tree of this repo.
_PARAM_AXES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # -- EiNet (phi: (D, K, R, |T|); einsum: (L, k_out, K, K); mixing: (M, C, k))
    ("/phi", ("einet_nodes", None, None, None)),
    ("/einsum/*", ("einet_nodes", None, None, None)),
    ("/mixing/*", ("einet_nodes", None, None)),
    ("/n_einsum/*", ("einet_nodes", None, None, None)),
    ("/n_mixing/*", ("einet_nodes", None, None)),
    ("/s_phi", ("einet_nodes", None, None, None)),
    ("/s_den", ("einet_nodes", None, None)),
    ("/class_prior", (None,)),
    # -- attention (stacked over periods: leading np dim)
    ("/wq", (None, "fsdp", "heads")),
    ("/wk", (None, "fsdp", "heads")),
    ("/wv", (None, "fsdp", "heads")),
    ("/wo", (None, "heads", "fsdp")),
    ("/bq", (None, "heads")),
    ("/bk", (None, "heads")),
    ("/bv", (None, "heads")),
    # -- MoE (router replicated: every token needs every expert's logit)
    ("/moe/router", (None, None, None)),
    ("/moe/wg", (None, "expert", "fsdp", None)),
    ("/moe/wu", (None, "expert", "fsdp", None)),
    ("/moe/wd", (None, "expert", None, "fsdp")),
    # -- dense FFN
    ("/mlp/wg", (None, "fsdp", "mlp")),
    ("/mlp/wu", (None, "fsdp", "mlp")),
    ("/mlp/wd", (None, "mlp", "fsdp")),
    # -- mamba
    ("/in_proj", (None, "fsdp", "mlp")),
    ("/conv_w", (None, None, "mlp")),
    ("/x_proj", (None, "mlp", None)),
    ("/dt_proj", (None, None, "mlp")),
    ("/dt_bias", (None, "mlp")),
    ("/a_log", (None, "mlp", None)),
    ("/d_skip", (None, "mlp")),
    ("/out_proj", (None, "mlp", "fsdp")),
    # -- xLSTM
    ("/up", (None, "fsdp", "mlp")),
    ("/wq_l", (None, None, "mlp")),
    ("/wk_l", (None, None, "mlp")),
    ("/wi", (None, "mlp", None)),
    ("/wf", (None, "mlp", None)),
    ("/down", (None, "mlp", "fsdp")),
    ("/wx", (None, "fsdp", "mlp")),
    ("/bx", (None, "mlp")),
    # -- embedding / unembedding
    ("/embed", ("vocab", "fsdp")),
    ("/head", ("fsdp", "vocab")),
)


def _axes_for_path(p: str, ndim: int) -> Optional[Tuple[Optional[str], ...]]:
    for suffix, axes in _PARAM_AXES:
        if suffix.endswith("/*"):
            stem = suffix[:-2]
            i = p.rfind("/")
            hit = i > 0 and p[:i].endswith(stem) and p[i + 1:].isdigit()
        else:
            hit = p.endswith(suffix)
        if hit:
            return axes if len(axes) == ndim else None
    return None


def tree_paths(tree: Any) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) of ``tree`` in flatten order, each path in the
    reference's "/key/0/leaf" form (``/einsum/0``, ``/s_phi``)."""
    paths, leaves = tree_lib.flatten(tree)
    return ["/" + p for p in paths], leaves


def leaf_spec(path: str, shape: Sequence[int], axis_sizes: Dict[str, int],
              rules: Rules) -> Optional[Spec]:
    """The resolved spec of the leaf at ``path`` (None: replicated)."""
    axes = _axes_for_path(path, len(shape))
    if axes is None:
        return None
    return resolve_spec(axes, shape, axis_sizes, rules)


def _rules_for(mesh) -> Rules:
    rules = get_rules()
    if rules is None:
        rules = default_rules("pod" in mesh_sizes(mesh), fsdp=False)
    return rules


def spec_placements(spec: Optional[Spec], mesh) -> Placements:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim ``d``'s spec
    entry names (or holds) the mesh dim, ``Replicate()`` elsewhere."""
    out: List[Any] = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec or ()):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for name in names:
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


def tree_shardings(mesh, tree: Any) -> Any:
    """A tree shaped like ``tree`` whose leaves are placement tuples,
    derived from each leaf's path under the active rules (the default
    table outside any ``use_rules``).  Unmatched leaves, and leaves whose
    shape no longer lines up with their pattern (int8 moments), replicate."""
    rules, sizes = _rules_for(mesh), mesh_sizes(mesh)
    paths, leaves = tree_paths(tree)
    placed = [spec_placements(leaf_spec(p, tuple(getattr(x, "shape", ())),
                                        sizes, rules), mesh)
              for p, x in zip(paths, leaves)]
    return tree_lib.unflatten_like(tree, placed, lambda _, new: new)


def batch_shardings(mesh, batch: Any) -> Any:
    """Every batch leaf's leading dim sharded over the data dims (leaves
    whose leading dim does not divide replicate)."""
    rules, sizes = _rules_for(mesh), mesh_sizes(mesh)

    def leaf(_, x):
        shape = tuple(getattr(x, "shape", ()))
        axes = ("batch",) + (None,) * (len(shape) - 1) if shape else (None,)
        return spec_placements(resolve_spec(axes, shape, sizes, rules), mesh)

    return tree_lib.unflatten_like(batch, tree_lib.flatten(batch)[1], leaf)


def is_sharded(placements: Placements) -> bool:
    return any(isinstance(p, Shard) for p in placements)


# ===========================================================================
# local shards and collectives
# ===========================================================================
def local_shard(x: torch.Tensor, placements: Placements, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` (a view): chunked along
    each ``Shard(d)`` mesh dim in mesh-dim order, as a DTensor's local
    tensor is."""
    coord = mesh.get_coordinate()
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(j), dim=p.dim)[coord[j]]
    return x


def gather_full(local: torch.Tensor, placements: Placements,
                mesh) -> torch.Tensor:
    """The full tensor whose block on each rank is its ``local``: an
    ``all_gather`` over each sharded mesh dim, innermost first."""
    x = local
    for j in reversed(range(mesh.ndim)):
        p = placements[j]
        if isinstance(p, Shard) and mesh.size(j) > 1:
            parts = [torch.empty_like(x) for _ in range(mesh.size(j))]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(j))
            x = torch.cat(parts, dim=p.dim)
    return x


def data_dims(mesh, axes: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """The mesh dims the batch is split over: ``axes``, or every data dim
    ("pod", "data") the mesh has."""
    if axes:
        return tuple(axes)
    return tuple(a for a in DATA_DIMS if a in mesh.mesh_dim_names)


def reduce_like_params(stats: Any, mesh, shardings: Any = None,
                       axes: Optional[Sequence[str]] = None) -> Any:
    """``stats`` summed over the data dims (``axes``, default every data
    dim of the mesh), each leaf cut to this rank's block under its
    parameter placement (``shardings``, default ``tree_shardings(mesh,
    stats)``).  This is the reduce-scatter-shaped sum the reference's
    ``constrain_like_params`` lays out: a rank moves only its model shard of
    each sharded leaf, and all of each replicated leaf.

    The blocks are packed into one float32 buffer, so the sum is one
    ``all_reduce`` a data dim, outermost first; the returned leaves are
    views of that buffer."""
    if shardings is None:
        shardings = tree_shardings(mesh, stats)
    _, leaves = tree_lib.flatten(stats)
    placed = tree_lib.leaves_like(stats, shardings)
    blocks = [local_shard(x, p, mesh) for x, p in zip(leaves, placed)]
    if any(b.dtype != torch.float32 for b in blocks):
        raise TypeError("reduce_like_params packs float32 statistics only")
    buf = torch.cat([b.reshape(-1) for b in blocks])
    if dist.is_initialized():  # else one process: the sum is buf itself
        for name in data_dims(mesh, axes):
            dist.all_reduce(buf, group=mesh.get_group(name))
    out, offset = [], 0
    for b in blocks:
        out.append(buf[offset: offset + b.numel()].view(b.shape))
        offset += b.numel()
    return tree_lib.unflatten_like(stats, out, lambda _, new: new)
