"""Deterministic (minibatch) k-means for mixture-of-EiNets training (§4.2).

The paper's CelebA model is a *mixture* of EiNets trained over image
clusters; this module produces those clusters.  Two contracts matter more
than clustering quality:

  * **Cross-process and cross-device determinism.**  Seeding follows the
    datasets module's crc32 idiom (``zlib.crc32``, NOT ``hash()``, whose str
    salt varies per process via PYTHONHASHSEED): a restarted trainer,
    another host, or a train-then-eval pair must derive the SAME partition,
    because cluster identity is baked into the per-component parameters.
    The port goes further: the CPU and a CUDA card derive the same
    partition too.  Every sum in an iteration is a fixed tree of
    elementwise adds (``_tree_sum``): IEEE adds and multiplies round the
    same on every device, while ``torch.sum``, a matmul or ``index_add_``
    order their adds by the device (on CUDA ``index_add_`` uses atomics in
    no fixed order).
  * **Device iterations.**  k-means++ initialization runs on the host in
    numpy (a copy of the reference's ``_plusplus_init`` and ``_rng``); the
    Lloyd and minibatch iterations run in torch on the caller's device.

Minibatches are *contiguous deterministic blocks* (``[(i * b) % N, ...)``,
the same mod-N tiling as ``repro_torch.data.datasets.array_loader``) rather
than random subsamples -- no RNG in the iteration path at all.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.einet import resolve_device

_SEED_SALT = zlib.crc32(b"repro.mixture.kmeans")


@dataclasses.dataclass
class KMeansResult:
    """Cluster assignment of a dataset.

    centers:      (C, D) float32 cluster centroids.
    assignments:  (N,) int32 cluster id per row.
    counts:       (C,) int64 rows per cluster.
    inertia:      mean squared distance of rows to their centroid.
    """

    centers: np.ndarray
    assignments: np.ndarray
    counts: np.ndarray
    inertia: float

    @property
    def num_clusters(self) -> int:
        return len(self.centers)

    def weights(self, alpha: float = 0.0) -> np.ndarray:
        """Cluster proportions (the mixture's initial component weights),
        optionally Laplace-smoothed so empty clusters keep nonzero mass."""
        c = self.counts.astype(np.float64) + alpha
        return (c / c.sum()).astype(np.float32)


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState((_SEED_SALT + seed * 7919) % 2**31)


def _plusplus_init(
    data: np.ndarray, num_clusters: int, rng: np.random.RandomState,
    sample_cap: int = 16_384,
) -> np.ndarray:
    """k-means++ seeding on a deterministic row subsample (host, numpy)."""
    n = len(data)
    sub = data if n <= sample_cap else data[:: max(n // sample_cap, 1)]
    sub = np.asarray(sub, np.float64)
    centers = [sub[rng.randint(len(sub))]]
    d2 = np.sum((sub - centers[0]) ** 2, axis=1)
    for _ in range(num_clusters - 1):
        total = d2.sum()
        if total <= 0:  # degenerate data: duplicate rows are fine
            centers.append(sub[rng.randint(len(sub))])
            continue
        r = rng.rand() * total
        idx = int(np.searchsorted(np.cumsum(d2), r))
        idx = min(idx, len(sub) - 1)
        centers.append(sub[idx])
        d2 = np.minimum(d2, np.sum((sub - centers[-1]) ** 2, axis=1))
    return np.stack(centers).astype(np.float32)


def _tree_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed binary tree of elementwise adds: zero-pad
    the axis to a power of two (adding 0.0 is exact), then add its halves
    until one entry is left.  The result depends on the values and the
    axis length alone, never on the device."""
    t = t.movedim(dim, 0)
    n = t.shape[0]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        t = torch.cat([t, t.new_zeros((width - n,) + t.shape[1:])])
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = t[:half] + t[half:]
    return t[0]


def _assign(data: torch.Tensor, centers: torch.Tensor,
            chunk: int = 1024) -> torch.Tensor:
    """Nearest-centroid assignment: (N,) int64, the first of equal minima
    (as ``jnp.argmin``).  Squared distances are differences squared and
    tree-summed over D, in row chunks to bound the working set."""
    out = []
    for rows in data.split(chunk):
        d2 = torch.stack([_tree_sum((rows - c) * (rows - c), 1)
                          for c in centers], dim=1)  # (n, C)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def _cluster_sums(data: torch.Tensor, assign: torch.Tensor, num_clusters: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, D) per-cluster row sums and (C,) counts: each cluster's rows in
    dataset order (a stable sort), tree-summed."""
    order, offsets = cluster_order(assign.cpu().numpy(), num_clusters)
    order_t = torch.from_numpy(order).to(data.device)
    sums = data.new_zeros((num_clusters, data.shape[1]))
    for c in range(num_clusters):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        if hi > lo:
            sums[c] = _tree_sum(data[order_t[lo:hi]], 0)
    counts = torch.from_numpy(np.diff(offsets).astype(np.float32)).to(
        data.device)
    return sums, counts


def _update(data, centers, assign):
    """One Lloyd update: the mean of each cluster's rows; empty clusters
    keep their previous centroid."""
    sums, counts = _cluster_sums(data, assign, centers.shape[0])
    safe = torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centers)


def kmeans(
    data: np.ndarray,
    num_clusters: int,
    num_iters: int = 25,
    batch: Optional[int] = None,
    seed: int = 0,
    tol: float = 1e-6,
    device=None,
) -> KMeansResult:
    """Deterministic (minibatch) k-means.

    Args:
      data: (N, D) rows (any float dtype; clustered in float32).
      num_clusters: C.
      num_iters: Lloyd / minibatch iterations (early exit on center
        movement < ``tol``).
      batch: rows per iteration.  None = full-batch Lloyd; otherwise each
        iteration i uses the contiguous block ``[(i * batch) % N, ...)``
        (deterministic, RNG-free) and applies the standard minibatch k-means
        per-center running-count update (Sculley, 2010).
      seed: initialization seed (crc32-salted; process-independent).
      device: where the iterations run: CUDA unless ``"cpu"`` is asked for.

    Returns:
      :class:`KMeansResult` with final centers and FULL-data assignments.
    """
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    n = len(data)
    if not 1 <= num_clusters <= n:
        raise ValueError(
            f"num_clusters must be in [1, {n} rows]; got {num_clusters}"
        )
    dev = resolve_device(device)
    centers_np = _plusplus_init(data, num_clusters, _rng(seed))
    data_t = torch.from_numpy(data).to(dev)
    centers = torch.from_numpy(centers_np).to(dev)
    if batch is None or batch >= n:
        for _ in range(num_iters):
            new_centers = _update(data_t, centers, _assign(data_t, centers))
            moved = float(torch.max(torch.abs(new_centers - centers)))
            centers = new_centers
            if moved < tol:
                break
    else:
        # minibatch: per-center running counts weight each step (a new
        # center moves fast, a mature one is stable)
        run_counts = torch.zeros((num_clusters,), device=dev)
        for i in range(num_iters):
            base = (i * batch) % n
            rows = torch.from_numpy((np.arange(batch) + base) % n).to(dev)
            xb = data_t[rows]
            sums, cnt = _cluster_sums(xb, _assign(xb, centers), num_clusters)
            run_counts = run_counts + cnt
            lr = cnt / torch.clamp(run_counts, min=1.0)
            target = sums / torch.clamp(cnt, min=1.0)[:, None]
            centers = torch.where(
                cnt[:, None] > 0,
                centers + lr[:, None] * (target - centers),
                centers,
            )
    final_assign = _assign(data_t, centers).cpu().numpy().astype(np.int32)
    centers_np = centers.cpu().numpy()
    counts = np.bincount(final_assign, minlength=num_clusters).astype(np.int64)
    d = data - centers_np[final_assign]
    inertia = float(np.mean(np.sum(d * d, axis=1)))
    return KMeansResult(
        centers=centers_np,
        assignments=final_assign,
        counts=counts,
        inertia=inertia,
    )


def cluster_order(
    assignments: np.ndarray, num_clusters: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Row indices grouped by cluster: (order, offsets) where
    ``order[offsets[c]:offsets[c+1]]`` are cluster c's rows in dataset
    order.  Deterministic (stable sort)."""
    order = np.argsort(assignments, kind="stable").astype(np.int64)
    counts = np.bincount(assignments, minlength=num_clusters)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return order, offsets
