"""Sharded host data pipeline with deterministic skip-ahead (a numpy and
threading copy of the reference's ``repro/data/pipeline.py``).

Each host derives its shard of every global batch purely from
``(step, host_id)`` -- no pipeline state to checkpoint, no coordination on
restart, and a straggler's shard can be re-assigned by remapping host ids
(the reference's ``repro.dist.fault_tolerance``).  A small
background-thread prefetcher overlaps host-side generation with device
steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class ShardedLoader:
    """Deterministic per-host loader.

    Args:
      make_batch: (step, shard, per_host_batch) -> dict of np arrays.
      global_batch: total batch across all hosts.
      num_shards / shard_id: data-parallel host grid.
      start_step: resume point (skip-ahead is O(1): nothing to replay).
    """

    def __init__(
        self,
        make_batch: Callable[[int, int, int], Dict[str, np.ndarray]],
        global_batch: int,
        num_shards: int = 1,
        shard_id: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        assert global_batch % num_shards == 0
        self.make_batch = make_batch
        self.per_host = global_batch // num_shards
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.step = start_step
        self._q: Optional[queue.Queue] = None
        self._prefetch = prefetch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- synchronous API ------------------------------------------------
    def batch_at(self, step: int, shard: Optional[int] = None) -> Dict[str, np.ndarray]:
        shard = self.shard_id if shard is None else shard
        return self.make_batch(step, shard, self.per_host)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- prefetching ------------------------------------------------------
    def start_prefetch(self) -> "ShardedLoader":
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()

        def worker():
            step = self.step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self.batch_at(step)), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next_prefetched(self) -> Dict[str, np.ndarray]:
        assert self._q is not None, "call start_prefetch() first"
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
