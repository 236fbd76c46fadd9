"""Region graphs: the structural skeleton of vectorized PCs (§3.1).

A region graph is a bipartite DAG of *regions* (variable scopes -> vectorized
sum/leaf nodes) and *partitions* (binary scope splits -> vectorized product
nodes).  Two constructions from the paper:

  * ``random_binary_trees``  -- the RAT-SPN structure (Peharz et al., 2019)
    used in the efficiency study (Fig. 3/6) and Table 1: R replica of randomized
    balanced binary splits down to depth D, mixed at the root.
  * ``poon_domingos``        -- the image-tailored PD structure (Poon &
    Domingos, 2011) used for SVHN/CelebA (§4.2): recursive axis-aligned
    rectangle splits at absolute multiples of a step size Delta.

``topological_layers`` implements Algorithm 1 of the paper verbatim: a
top-down sweep that emits alternating (product-layer, sum-layer) pairs such
that every node's parents live in strictly higher layers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

Scope = Tuple[int, ...]  # sorted variable indices


@dataclasses.dataclass
class RegionGraph:
    num_vars: int
    regions: List[Scope]  # region id -> scope
    partitions: List[Tuple[int, int, int]]  # partition id -> (parent, left, right)
    root: int

    # derived
    def __post_init__(self):
        self.region_children: Dict[int, List[int]] = {
            i: [] for i in range(len(self.regions))
        }
        for pid, (parent, _, _) in enumerate(self.partitions):
            self.region_children[parent].append(pid)
        # parents of a region = partitions that reference it as a child
        self.region_parents: Dict[int, List[int]] = {
            i: [] for i in range(len(self.regions))
        }
        for pid, (_, left, right) in enumerate(self.partitions):
            self.region_parents[left].append(pid)
            self.region_parents[right].append(pid)

    @property
    def leaf_ids(self) -> List[int]:
        return [i for i in range(len(self.regions)) if not self.region_children[i]]

    @property
    def internal_ids(self) -> List[int]:
        return [i for i in range(len(self.regions)) if self.region_children[i]]

    def validate(self) -> None:
        """Check smoothness + decomposability structurally (Definition 1)."""
        for parent, left, right in self.partitions:
            sl, sr, sp = (
                set(self.regions[left]),
                set(self.regions[right]),
                set(self.regions[parent]),
            )
            assert sl and sr, "empty child scope"
            assert not (sl & sr), f"decomposability violated: {sl & sr}"
            assert sl | sr == sp, "partition children must cover the parent scope"
        assert set(self.regions[self.root]) == set(range(self.num_vars))


class _Builder:
    def __init__(self, num_vars: int):
        self.num_vars = num_vars
        self._scope_to_id: Dict[Scope, int] = {}
        self.regions: List[Scope] = []
        self.partitions: List[Tuple[int, int, int]] = []
        self._seen_partitions = set()

    def region(self, scope: Sequence[int]) -> int:
        scope = tuple(sorted(scope))
        if scope not in self._scope_to_id:
            self._scope_to_id[scope] = len(self.regions)
            self.regions.append(scope)
        return self._scope_to_id[scope]

    def partition(self, parent: int, left: int, right: int) -> None:
        key = (parent, left, right)
        if key in self._seen_partitions or (parent, right, left) in self._seen_partitions:
            return
        self._seen_partitions.add(key)
        self.partitions.append(key)

    def build(self) -> RegionGraph:
        root = self.region(tuple(range(self.num_vars)))
        rg = RegionGraph(self.num_vars, self.regions, self.partitions, root)
        rg.validate()
        return rg


def random_binary_trees(
    num_vars: int, depth: int, num_repetitions: int, seed: int = 0
) -> RegionGraph:
    """RAT-SPN structure: R randomized balanced binary trees mixed at the root."""
    if 2**depth > num_vars:
        raise ValueError(f"depth {depth} too large for {num_vars} variables")
    rng = np.random.RandomState(seed)
    b = _Builder(num_vars)
    root = b.region(range(num_vars))

    def split(region_id: int, scope: Scope, d: int) -> None:
        if d == 0 or len(scope) <= 1:
            return
        perm = rng.permutation(len(scope))
        half = len(scope) // 2
        left_scope = tuple(sorted(scope[i] for i in perm[:half]))
        right_scope = tuple(sorted(scope[i] for i in perm[half:]))
        left, right = b.region(left_scope), b.region(right_scope)
        b.partition(region_id, left, right)
        split(left, left_scope, d - 1)
        split(right, right_scope, d - 1)

    for _ in range(num_repetitions):
        split(root, tuple(range(num_vars)), depth)
    return b.build()


def poon_domingos(
    height: int,
    width: int,
    delta: float | Sequence[float],
    num_channels: int = 1,
    axes: Sequence[str] = ("h", "w"),
    max_cuts_per_rect: int | None = None,
) -> RegionGraph:
    """Poon-Domingos image structure.

    Variables are pixels x channels, id = (r * width + c) * num_channels + ch.
    A rectangle's scope contains all channel variables of its pixels.  Cuts are
    placed at absolute coordinates that are multiples of any value in ``delta``;
    the recursion stops when a rectangle admits no cut (the paper's stopping
    rule).  ``axes=('w',)`` reproduces the paper's vertical-splits-only choice
    for SVHN/CelebA.
    """
    deltas = [delta] if np.isscalar(delta) else list(delta)
    b = _Builder(height * width * num_channels)

    def rect_scope(r0, r1, c0, c1) -> Scope:
        return tuple(
            (r * width + c) * num_channels + ch
            for r in range(r0, r1)
            for c in range(c0, c1)
            for ch in range(num_channels)
        )

    def cut_positions(lo: int, hi: int) -> List[int]:
        pos = set()
        for d in deltas:
            k = int(np.ceil(lo / d)) * d
            # absolute multiples of d strictly inside (lo, hi)
            vals = np.arange(k if k > lo else k + d, hi, d)
            pos.update(int(v) for v in vals if lo < v < hi)
        return sorted(pos)

    root_rect = (0, height, 0, width)
    rect_ids: Dict[Tuple[int, int, int, int], int] = {}
    stack = [root_rect]
    while stack:
        rect = stack.pop()
        if rect in rect_ids:
            continue
        r0, r1, c0, c1 = rect
        rid = b.region(rect_scope(*rect))
        rect_ids[rect] = rid
        cuts = []
        if "h" in axes:
            cuts += [("h", p) for p in cut_positions(r0, r1)]
        if "w" in axes:
            cuts += [("w", p) for p in cut_positions(c0, c1)]
        if max_cuts_per_rect is not None:
            cuts = cuts[:max_cuts_per_rect]
        for axis, p in cuts:
            if axis == "h":
                top, bot = (r0, p, c0, c1), (p, r1, c0, c1)
            else:
                top, bot = (r0, r1, c0, p), (r0, r1, p, c1)
            lid = b.region(rect_scope(*top))
            rid2 = b.region(rect_scope(*bot))
            b.partition(rid, lid, rid2)
            stack.append(top)
            stack.append(bot)
    return b.build()


def topological_layers(
    rg: RegionGraph,
) -> Tuple[List[int], List[Tuple[List[int], List[int]]]]:
    """Algorithm 1: layer the graph top-down, return it bottom-up.

    Returns ``(leaf_region_ids, pairs)`` where ``pairs`` is a bottom-up list of
    (partition_layer, sum_region_layer): the partition layer contains exactly
    the product inputs of the sum layer above it (paper §3.3 / Appendix A).
    """
    leaf_set = set(rg.leaf_ids)
    sums = [r for r in rg.internal_ids]
    visited = set()
    pairs_top_down: List[Tuple[List[int], List[int]]] = []
    remaining_sums = set(sums)
    remaining_parts = set(range(len(rg.partitions)))
    guard = 0
    while remaining_sums or remaining_parts:
        guard += 1
        if guard > len(rg.regions) + len(rg.partitions) + 2:
            raise RuntimeError("topological layering did not converge (cycle?)")
        l_s = [
            s
            for s in sorted(remaining_sums)
            if all(("P", p) in visited for p in rg.region_parents[s])
        ]
        for s in l_s:
            visited.add(("S", s))
        remaining_sums -= set(l_s)
        l_p = [
            p
            for p in sorted(remaining_parts)
            if ("S", rg.partitions[p][0]) in visited
        ]
        for p in l_p:
            visited.add(("P", p))
        remaining_parts -= set(l_p)
        if not l_s and not l_p:
            raise RuntimeError("stuck: graph is not layerable")
        pairs_top_down.append((l_p, l_s))
    pairs = list(reversed(pairs_top_down))
    leaves = sorted(leaf_set)
    return leaves, pairs


def assign_replicas(leaf_scopes: Sequence[Scope]) -> Tuple[np.ndarray, int]:
    """Greedy colouring: leaves sharing a replica must have disjoint scopes (§3.4)."""
    replica_vars: List[set] = []
    out = np.zeros(len(leaf_scopes), dtype=np.int32)
    for i, scope in enumerate(leaf_scopes):
        s = set(scope)
        for r, used in enumerate(replica_vars):
            if not (s & used):
                used |= s
                out[i] = r
                break
        else:
            replica_vars.append(set(s))
            out[i] = len(replica_vars) - 1
    return out, len(replica_vars)
