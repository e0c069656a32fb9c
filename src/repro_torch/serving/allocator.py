"""Free-list page allocator for the paged KV cache (a copy of
``repro/serving/allocator.py``, which is pure Python).

Physical pages are small fixed-size chunks of the cache's sequence axis.
A slot's logical positions ``[0, len)`` map onto an ordered list of pages
through its page table; on completion the pages return to the free list and
are handed to later requests (FIFO, so reuse order is deterministic).

Page 0 is *reserved* as the null page: idle batch rows point their page
table at it, so their (masked, garbage) decode writes can never land inside
a live slot's allocation — the cross-slot cache-corruption class of bug is
structurally impossible rather than merely avoided.

Eviction: under memory pressure the engine preempts a victim request and
reclaims its pages through ``evict`` — same free-list return and the same
double-free / reserved-page guards as ``free`` (a reserved page can never
be evicted), but counted separately (``n_evicted``) so preemption pressure
is observable.  Evicted pages re-enter the FIFO free list, so page reuse
stays deterministic under preemption too.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

NULL_PAGE = 0


class PageAllocator:
    """FIFO free-list over page ids ``[0, num_pages)`` minus the reserved
    set.  ``alloc`` is atomic (all-or-nothing); ``free`` rejects double
    frees and foreign pages."""

    def __init__(self, num_pages: int, reserved: Sequence[int] = (NULL_PAGE,)):
        if num_pages <= len(set(reserved)):
            raise ValueError(f"num_pages={num_pages} leaves no allocatable "
                             f"pages beyond reserved={sorted(set(reserved))}")
        self.num_pages = num_pages
        self.reserved = frozenset(reserved)
        self._free = deque(p for p in range(num_pages)
                           if p not in self.reserved)
        self._held: set = set()
        self.n_evicted = 0

    @property
    def capacity(self) -> int:
        """Total allocatable pages (reserved pages excluded)."""
        return self.num_pages - len(self.reserved)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> List[int]:
        """Snapshot of the free list (reuse order) — for tests/telemetry."""
        return list(self._free)

    @property
    def held_pages(self) -> List[int]:
        return sorted(self._held)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages off the free list, or ``None`` (and no state
        change) if fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._held.update(pages)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list.  Raises on a double free, a
        reserved page, or a page that was never allocated."""
        for p in pages:
            if p in self.reserved:
                raise ValueError(f"page {p} is reserved")
            if p not in self._held:
                raise ValueError(f"page {p} is not held (double free?)")
        for p in pages:
            self._held.discard(p)
            self._free.append(p)

    def evict(self, pages: Sequence[int]) -> None:
        """Reclaim a preempted request's pages.  Identical guards and
        free-list return as ``free`` (a reserved page can never be
        evicted), counted in ``n_evicted``."""
        self.free(pages)
        self.n_evicted += len(pages)
