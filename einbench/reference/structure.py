"""The circuit's structure, worked out again from a configuration's sizes.

A frozen copy of the region-graph constructions (RAT random binary trees,
Poon-Domingos rectangles), of Algorithm 1's layering and of the replica
colouring, followed by the layout the parameters and the sampling noise
are stored in: leaf rows, each layer pair's child rows in one global row
buffer (leaves first, then each pair's einsum rows and its mixing rows),
the reordering that makes a pair's children two contiguous halves of the
layer below ("canonical" pairs), and the offsets of each random choice in a
row's noise vector.  Numpy only; nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Scope = Tuple[int, ...]


@dataclasses.dataclass
class RegionGraph:
    num_vars: int
    regions: List[Scope]
    partitions: List[Tuple[int, int, int]]  # (parent, left, right)
    root: int

    def __post_init__(self):
        self.children: Dict[int, List[int]] = {i: [] for i in range(len(self.regions))}
        self.parents: Dict[int, List[int]] = {i: [] for i in range(len(self.regions))}
        for pid, (parent, left, right) in enumerate(self.partitions):
            self.children[parent].append(pid)
            self.parents[left].append(pid)
            self.parents[right].append(pid)


class _Regions:
    def __init__(self, num_vars: int):
        self.num_vars = num_vars
        self.ids: Dict[Scope, int] = {}
        self.regions: List[Scope] = []
        self.partitions: List[Tuple[int, int, int]] = []
        self.seen = set()

    def region(self, scope) -> int:
        scope = tuple(sorted(scope))
        if scope not in self.ids:
            self.ids[scope] = len(self.regions)
            self.regions.append(scope)
        return self.ids[scope]

    def partition(self, parent: int, left: int, right: int) -> None:
        if (parent, left, right) in self.seen or (parent, right, left) in self.seen:
            return
        self.seen.add((parent, left, right))
        self.partitions.append((parent, left, right))

    def build(self) -> RegionGraph:
        root = self.region(range(self.num_vars))
        return RegionGraph(self.num_vars, self.regions, self.partitions, root)


def random_binary_trees(num_vars: int, depth: int, repetitions: int,
                        seed: int = 0) -> RegionGraph:
    """R randomised balanced binary splits of all variables, depth D each."""
    rng = np.random.RandomState(seed)
    b = _Regions(num_vars)
    root = b.region(range(num_vars))

    def split(rid: int, scope: Scope, d: int) -> None:
        if d == 0 or len(scope) <= 1:
            return
        perm = rng.permutation(len(scope))
        half = len(scope) // 2
        ls = tuple(sorted(scope[i] for i in perm[:half]))
        rs = tuple(sorted(scope[i] for i in perm[half:]))
        left, right = b.region(ls), b.region(rs)
        b.partition(rid, left, right)
        split(left, ls, d - 1)
        split(right, rs, d - 1)

    for _ in range(repetitions):
        split(root, tuple(range(num_vars)), depth)
    return b.build()


def poon_domingos(height: int, width: int, delta, channels: int,
                  axes: Sequence[str]) -> RegionGraph:
    """Rectangles cut at absolute multiples of delta, all channels of a
    pixel in one scope; variable id (row * width + col) * channels + ch."""
    deltas = [delta] if np.isscalar(delta) else list(delta)
    b = _Regions(height * width * channels)

    def scope(r0, r1, c0, c1) -> Scope:
        return tuple((r * width + c) * channels + ch for r in range(r0, r1)
                     for c in range(c0, c1) for ch in range(channels))

    def cuts(lo: int, hi: int) -> List[int]:
        pos = set()
        for d in deltas:
            k = int(np.ceil(lo / d)) * d
            vals = np.arange(k if k > lo else k + d, hi, d)
            pos.update(int(v) for v in vals if lo < v < hi)
        return sorted(pos)

    done: Dict[Tuple[int, int, int, int], int] = {}
    stack = [(0, height, 0, width)]
    while stack:
        rect = stack.pop()
        if rect in done:
            continue
        r0, r1, c0, c1 = rect
        rid = b.region(scope(*rect))
        done[rect] = rid
        todo = []
        if "h" in axes:
            todo += [("h", p) for p in cuts(r0, r1)]
        if "w" in axes:
            todo += [("w", p) for p in cuts(c0, c1)]
        for axis, p in todo:
            if axis == "h":
                one, two = (r0, p, c0, c1), (p, r1, c0, c1)
            else:
                one, two = (r0, r1, c0, p), (r0, r1, p, c1)
            b.partition(rid, b.region(scope(*one)), b.region(scope(*two)))
            stack.append(one)
            stack.append(two)
    return b.build()


def layers(rg: RegionGraph):
    """Algorithm 1: (leaf regions, bottom-up list of (partitions, sums))."""
    remaining_s = {r for r in range(len(rg.regions)) if rg.children[r]}
    remaining_p = set(range(len(rg.partitions)))
    visited = set()
    top_down = []
    while remaining_s or remaining_p:
        l_s = [s for s in sorted(remaining_s)
               if all(("P", p) in visited for p in rg.parents[s])]
        visited.update(("S", s) for s in l_s)
        remaining_s -= set(l_s)
        l_p = [p for p in sorted(remaining_p)
               if ("S", rg.partitions[p][0]) in visited]
        visited.update(("P", p) for p in l_p)
        remaining_p -= set(l_p)
        if not l_s and not l_p:
            raise RuntimeError("region graph is not layerable")
        top_down.append((l_p, l_s))
    leaves = sorted(r for r in range(len(rg.regions)) if not rg.children[r])
    return leaves, list(reversed(top_down))


def replicas(scopes: Sequence[Scope]) -> Tuple[np.ndarray, int]:
    """Greedy colouring: leaves of one replica have disjoint scopes."""
    used: List[set] = []
    out = np.zeros(len(scopes), np.int64)
    for i, sc in enumerate(scopes):
        s = set(sc)
        for r, u in enumerate(used):
            if not (s & u):
                u |= s
                out[i] = r
                break
        else:
            used.append(set(s))
            out[i] = len(used) - 1
    return out, len(used)


@dataclasses.dataclass
class Pair:
    left: np.ndarray            # (L,) buffer rows of the left children
    right: np.ndarray           # (L,) buffer rows of the right children
    first_row: int              # buffer row of the first einsum output
    k_out: int
    mix_child: Optional[np.ndarray] = None  # (M, C) local child ids
    mix_mask: Optional[np.ndarray] = None   # (M, C) 1/0
    mix_first_row: int = -1
    final: bool = False

    @property
    def cells(self) -> int:
        return len(self.left)

    @property
    def mixed(self) -> int:
        return 0 if self.mix_child is None else len(self.mix_child)


class Layout:
    """Parameter, buffer and noise layout of one configuration's circuit."""

    def __init__(self, rg: RegionGraph, k: int, classes: int = 1,
                 draw_noise: int = 1):
        self.num_vars = rg.num_vars
        self.k = k
        leaves, pairs = layers(rg)
        scopes = [rg.regions[i] for i in leaves]
        rep, self.num_replica = replicas(scopes)
        row = {r: i for i, r in enumerate(leaves)}
        nxt = len(leaves)
        self.pairs: List[Pair] = []
        for t, (l_p, l_s) in enumerate(pairs):
            final = t == len(pairs) - 1
            local = {p: i for i, p in enumerate(l_p)}
            pair = Pair(
                left=np.array([row[rg.partitions[p][1]] for p in l_p], np.int64),
                right=np.array([row[rg.partitions[p][2]] for p in l_p], np.int64),
                first_row=nxt, k_out=classes if final else k, final=final)
            einsum_rows = np.arange(nxt, nxt + len(l_p))
            nxt += len(l_p)
            mixed = [s for s in l_s if len(rg.children[s]) > 1]
            if mixed:
                c = max(len(rg.children[s]) for s in mixed)
                pair.mix_child = np.zeros((len(mixed), c), np.int64)
                pair.mix_mask = np.zeros((len(mixed), c), np.float32)
                for m, s in enumerate(mixed):
                    kids = [local[p] for p in rg.children[s]]
                    pair.mix_child[m, :len(kids)] = kids
                    pair.mix_mask[m, :len(kids)] = 1.0
                pair.mix_first_row = nxt
                for m, s in enumerate(mixed):
                    row[s] = nxt + m
                nxt += len(mixed)
            for s in l_s:
                if len(rg.children[s]) == 1:
                    row[s] = int(einsum_rows[local[rg.children[s][0]]])
            self.pairs.append(pair)
        self.total_rows = nxt
        self.root_row = row[rg.root]
        self.scopes, self.leaf_replica = scopes, rep
        self._canonical()
        self.num_leaves = len(self.scopes)
        self.pair_var = np.concatenate([np.asarray(s, np.int64) for s in self.scopes])
        self.pair_rep = np.concatenate(
            [np.full(len(s), self.leaf_replica[j], np.int64)
             for j, s in enumerate(self.scopes)])
        self.pair_leaf = np.concatenate(
            [np.full(len(s), j, np.int64) for j, s in enumerate(self.scopes)])
        self._noise(classes, draw_noise)

    def _canonical(self) -> None:
        """Where a pair's children are exactly the layer below's outputs,
        each used once, reorder that layer so the children are rows [0, L)
        (left) and [L, 2L) (right) of it."""
        pairs = self.pairs
        for i in range(len(pairs) - 1, -1, -1):
            cur = pairs[i]
            child = np.concatenate([cur.left, cur.right])
            half = cur.cells
            if i == 0:
                n = len(self.scopes)
                if len(child) != n or sorted(child.tolist()) != list(range(n)):
                    continue
                order = child.tolist()
                self.scopes = [self.scopes[j] for j in order]
                self.leaf_replica = self.leaf_replica[order]
                cur.left = np.arange(half)
                cur.right = np.arange(half, 2 * half)
                continue
            prev = pairs[i - 1]
            if prev.mix_child is not None:
                continue
            rows = list(range(prev.first_row, prev.first_row + prev.cells))
            if sorted(child.tolist()) != rows:
                continue
            order = [int(r) - prev.first_row for r in child]
            prev.left, prev.right = prev.left[order], prev.right[order]
            cur.left = np.arange(prev.first_row, prev.first_row + half)
            cur.right = np.arange(prev.first_row + half, prev.first_row + 2 * half)

    def _noise(self, classes: int, draw_noise: int) -> None:
        """Offsets of each choice's uniforms in a row's noise vector: the
        root's class, then from the top pair down each pair's mixing
        choices and its einsum cells' K*K choices, then the leaf draws."""
        off = 0
        self.noise: Dict = {}

        def take(key, shape):
            nonlocal off
            self.noise[key] = (off, shape)
            off += int(np.prod(shape))

        take("root", (classes,))
        for i in reversed(range(len(self.pairs))):
            p = self.pairs[i]
            if p.mix_child is not None:
                take(("mix", i), p.mix_child.shape)
            take(("einsum", i), (p.cells, self.k * self.k))
        take("leaves", (len(self.pair_var), draw_noise))
        self.noise_size = off

    def shapes(self) -> Dict:
        """Parameter shapes: phi (D, K, R, 2), one einsum (L, K_out, K, K)
        and one mixing (M, C, K_out) a pair, class prior (classes,)."""
        return {
            "phi": (self.num_vars, self.k, self.num_replica, 2),
            "einsum": [(p.cells, p.k_out, self.k, self.k) for p in self.pairs],
            "mixing": [(p.mixed, p.mix_child.shape[1], p.k_out)
                       if p.mix_child is not None else (0, 0, p.k_out)
                       for p in self.pairs],
            "class_prior": (self.pairs[-1].k_out,),
        }


def layout_of(cfg: Dict) -> Layout:
    """The layout of a configuration file's model (``structure`` "rat" or
    "pd", Gaussian leaves)."""
    if cfg["structure"] == "rat":
        rg = random_binary_trees(cfg["num_vars"], cfg["depth"],
                                 cfg["num_repetitions"])
    else:
        rg = poon_domingos(cfg["height"], cfg["width"], cfg["delta"],
                           cfg["num_channels"], cfg["pd_axes"])
    return Layout(rg, cfg["num_sums"], cfg.get("num_classes", 1))
