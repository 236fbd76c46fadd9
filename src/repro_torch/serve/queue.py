"""Request queue + slot manager for the exact-inference serving engine.

Requests enter a FIFO; each scheduling step the engine leases up to
``capacity`` slots, builds one micro-batch, and releases the slots when the
micro-batch retires.  The EiNet has no persistent per-request state, so a
slot is an admission token rather than a cache row -- it bounds the number
of in-flight rows per step, which keeps every padded micro-batch inside the
bucket range.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Deque, List, Optional


class SlotManager:
    """Fixed pool of admission slots (continuous-batching row leases)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._held = set()

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def held(self) -> int:
        return len(self._held)

    def acquire(self) -> Optional[int]:
        """Lease one slot; None when the pool is exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._held.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._held:
            raise ValueError(f"slot {slot} is not held")
        self._held.remove(slot)
        self._free.append(slot)


class RequestQueue:
    """FIFO of heterogeneous requests with per-group draining.

    ``pop_kind`` removes up to ``limit`` requests of one coalescing group
    while preserving the arrival order of everything else -- the coalescing
    primitive: the engine always serves the oldest request's group first, and
    rides along every queued request of the same group that fits the batch.

    The group of a request defaults to its query ``kind``; ``key_fn`` lets
    the engine refine it (the mixture path groups by ``(kind, component)`` so
    component-pinned queries to different components never share a
    micro-batch -- the component index is folded into the program key).
    """

    def __init__(self, key_fn: Optional[Callable[[Any], Any]] = None):
        self._q: Deque = collections.deque()
        self._key = key_fn or (lambda r: r.kind)

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, request) -> None:
        self._q.append(request)

    def oldest_kind(self) -> Optional[Any]:
        return self._key(self._q[0]) if self._q else None

    def pending_kinds(self) -> List[Any]:
        """Distinct groups in arrival order of their oldest request."""
        seen: List[Any] = []
        for r in self._q:
            k = self._key(r)
            if k not in seen:
                seen.append(k)
        return seen

    def pop_kind(self, kind: Any, limit: int) -> List:
        """Remove and return up to ``limit`` requests of group ``kind``
        (FIFO)."""
        taken: List = []
        rest: List = []
        for r in self._q:
            if self._key(r) == kind and len(taken) < limit:
                taken.append(r)
            else:
                rest.append(r)
        self._q = collections.deque(rest)
        return taken
