"""Bottom-level LCM large-page allocator (Jenga §4.1, §4.4, §5.4).

The entire KV memory is partitioned into ``num_large_pages`` pages of
``large_page_units`` (the LCM of all small-page sizes).  Large pages are
either FREE, or owned by exactly one typed small-page pool.  Eviction of
*evictable* large pages (step 3 of the §5.4 allocation algorithm) is
coordinated here via a lazy min-heap keyed by
``(max last-access over the page's small pages, insertion order)``.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Optional

from .spec import PageGeometry


@dataclasses.dataclass
class LargePage:
    page_id: int
    owner_type: Optional[str] = None     # typed pool currently owning this page
    # Timestamp used for LRU eviction of evictable large pages: the latest
    # last-access among its small pages (paper §5.4 step 3).
    evictable_ts: int = -1
    evictable_seq: int = 0               # tie-break / lazy-heap validation


class LargePageAllocator:
    """Tracks free large pages and the cross-type evictable-page LRU heap."""

    def __init__(self, geometry: PageGeometry):
        self.geometry = geometry
        self.num_pages = geometry.num_large_pages
        self.pages = [LargePage(i) for i in range(self.num_pages)]
        self._free: deque[int] = deque(range(self.num_pages))
        self._free_set: set[int] = set(range(self.num_pages))
        # Lazy heap of (ts, seq, page_id); entries validated on pop.
        self._evictable_heap: list[tuple[int, int, int]] = []
        self._evictable: set[int] = set()
        self._seq = 0

    # ---------------------------------------------------------------- alloc
    @property
    def num_free(self) -> int:
        return len(self._free_set)

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    def alloc(self, owner_type: str) -> Optional[int]:
        """Grab a FREE large page for a typed pool; None if exhausted."""
        while self._free:
            pid = self._free.popleft()
            if pid in self._free_set:
                self._free_set.discard(pid)
                page = self.pages[pid]
                page.owner_type = owner_type
                return pid
        return None

    def free(self, page_id: int) -> None:
        """Return a large page to the free pool (all small pages empty)."""
        page = self.pages[page_id]
        if page_id in self._free_set:
            raise ValueError(f"double free of large page {page_id}")
        page.owner_type = None
        self._evictable.discard(page_id)
        self._free_set.add(page_id)
        self._free.append(page_id)

    # ------------------------------------------------------------- eviction
    def mark_evictable(self, page_id: int, ts: int) -> None:
        """All small pages of ``page_id`` are evictable; register for LRU."""
        page = self.pages[page_id]
        self._seq += 1
        page.evictable_ts = ts
        page.evictable_seq = self._seq
        self._evictable.add(page_id)
        heapq.heappush(self._evictable_heap, (ts, self._seq, page_id))

    def unmark_evictable(self, page_id: int) -> None:
        """A small page inside became used/empty; no longer whole-page evictable."""
        self._evictable.discard(page_id)

    def pop_evictable_lru(self) -> Optional[int]:
        """Pop the least-recently-used evictable large page (lazy heap)."""
        while self._evictable_heap:
            ts, seq, pid = heapq.heappop(self._evictable_heap)
            page = self.pages[pid]
            if (
                pid in self._evictable
                and page.evictable_ts == ts
                and page.evictable_seq == seq
            ):
                self._evictable.discard(pid)
                return pid
        return None

    # ------------------------------------------------------------- queries
    def owner_of(self, page_id: int) -> Optional[str]:
        return self.pages[page_id].owner_type

    def check_invariants(self) -> None:
        """Debug/property-test helper."""
        assert len(self._free_set) <= self.num_pages
        for pid in self._free_set:
            assert self.pages[pid].owner_type is None, pid
        for pid in self._evictable:
            assert self.pages[pid].owner_type is not None, pid
            assert pid not in self._free_set, pid
