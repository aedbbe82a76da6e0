"""Per-layer-type small-page pools with request-aware allocation (Jenga §4.3, §5.4).

Each layer type owns a ``TypedPool`` that carves LCM large pages into
type-sized small pages.  Small pages live in one of three states (§5.4):

  EMPTY      — no valid KV, not referenced by any request
  USED       — referenced by >=1 running request (unevictable)
  EVICTABLE  — holds valid KV of a finished request (prefix cache), refcount 0

Exec-page-id arithmetic (paper Fig. 7c): a type-t small page in slot ``s`` of
large page ``L`` sits at unit offset ``L*LCM + s*S_t``, which is
``(L*spp_t + s) * S_t`` — i.e. exec id ``L*spp_t + s`` in a
``(total_units // S_t, ...)`` reshape view of the unified buffer.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .lcm_allocator import LargePageAllocator
from .spec import KVCacheSpec, PageGeometry


class PageState(enum.Enum):
    EMPTY = 0
    USED = 1
    EVICTABLE = 2


@dataclasses.dataclass
class SmallPage:
    exec_id: int
    large_id: int
    slot: int
    state: PageState = PageState.EMPTY
    owner_rid: Optional[str] = None       # request association (§4.3)
    ref_count: int = 0
    last_access: int = 0
    prefix_length: int = 0                # fine-grained eviction priority (§5.1)
    content_hash: Optional[int] = None    # prefix-cache key when EVICTABLE
    seq: int = 0                          # lazy-heap validation counter


class TypedPool:
    """Small-page allocator for one layer type, backed by the LCM pool."""

    def __init__(
        self,
        spec: KVCacheSpec,
        geometry: PageGeometry,
        large_alloc: LargePageAllocator,
    ):
        self.spec = spec
        self.geometry = geometry
        self.large_alloc = large_alloc
        self.spp = geometry.small_pages_per_large(spec)  # small pages / large page
        if self.spp < 1:
            raise ValueError(
                f"{spec.name}: small page ({spec.page_units}u) larger than "
                f"large page ({geometry.large_page_units}u)"
            )
        # exec id -> SmallPage, only for pages of large pages we currently own.
        self.pages: Dict[int, SmallPage] = {}
        self.owned_large: Set[int] = set()
        # Free (EMPTY) pages: per-request association lists + global set.
        self._free_by_rid: Dict[str, Set[int]] = {}
        self._free_global: Set[int] = set()
        # Evictable small pages: lazy heap by (last_access, -prefix_length).
        self._evict_heap: List[Tuple[int, int, int, int]] = []
        self._evictable: Set[int] = set()
        self._seq = 0
        # prefix-cache registry: content_hash -> exec_id
        self.cached: Dict[int, int] = {}
        # Optional PageSan shadow tracker (installed by the manager when
        # REPRO_PAGE_SANITIZER=1); every event below costs one None-check.
        self.san = None

    # ----------------------------------------------------------- id math
    def exec_id(self, large_id: int, slot: int) -> int:
        return large_id * self.spp + slot

    def large_of(self, exec_id: int) -> Tuple[int, int]:
        return divmod(exec_id, self.spp)

    # ------------------------------------------------------- bookkeeping
    def _adopt_large(self, large_id: int, rid: Optional[str]) -> None:
        """Partition a newly granted large page into EMPTY small pages
        associated with ``rid`` (§5.4 step 2)."""
        self.owned_large.add(large_id)
        if self.san is not None:
            self.san.on_adopt(
                self.spec.name,
                [self.exec_id(large_id, s) for s in range(self.spp)])
        for slot in range(self.spp):
            eid = self.exec_id(large_id, slot)
            self.pages[eid] = SmallPage(eid, large_id, slot, owner_rid=rid)
            self._free_add(eid, rid)

    def _free_add(self, eid: int, rid: Optional[str]) -> None:
        if rid is not None:
            self._free_by_rid.setdefault(rid, set()).add(eid)
        self._free_global.add(eid)

    def _free_remove(self, eid: int) -> None:
        page = self.pages[eid]
        self._free_global.discard(eid)
        if page.owner_rid is not None:
            s = self._free_by_rid.get(page.owner_rid)
            if s is not None:
                s.discard(eid)
                if not s:
                    del self._free_by_rid[page.owner_rid]

    def _large_all_state(self, large_id: int, state: PageState) -> bool:
        return all(
            self.pages[self.exec_id(large_id, s)].state == state
            for s in range(self.spp)
        )

    def _large_no_used(self, large_id: int) -> bool:
        return all(
            self.pages[self.exec_id(large_id, s)].state != PageState.USED
            for s in range(self.spp)
        )

    def _maybe_release_large(self, large_id: int) -> None:
        """If every small page in ``large_id`` is EMPTY, return it (§4.1 free)."""
        if not self._large_all_state(large_id, PageState.EMPTY):
            return
        for slot in range(self.spp):
            eid = self.exec_id(large_id, slot)
            if self.san is not None:
                self.san.on_retire(self.spec.name, eid)
            self._free_remove(eid)
            del self.pages[eid]
        self.owned_large.discard(large_id)
        self.large_alloc.unmark_evictable(large_id)
        self.large_alloc.free(large_id)

    def _maybe_mark_large_evictable(self, large_id: int) -> None:
        """If no small page is USED (and >=1 EVICTABLE), the large page joins
        the cross-type LRU (§5.4 step 3) keyed by the max small-page ts."""
        if not self._large_no_used(large_id):
            return
        sps = [self.pages[self.exec_id(large_id, s)] for s in range(self.spp)]
        if not any(p.state == PageState.EVICTABLE for p in sps):
            return
        ts = max(p.last_access for p in sps)
        self.large_alloc.mark_evictable(large_id, ts)

    # --------------------------------------------------------- allocation
    def allocate(self, rid: str) -> Optional[int]:
        """The §5.4 five-step allocation. Returns an exec page id or None."""
        # Step 1: request-associated EMPTY page.
        assoc = self._free_by_rid.get(rid)
        if assoc:
            eid = next(iter(assoc))
            return self._take(eid, rid)
        # Step 2: fresh large page from the LCM allocator.
        large_id = self.large_alloc.alloc(self.spec.name)
        if large_id is not None:
            self._adopt_large(large_id, rid)
            eid = self.exec_id(large_id, 0)
            return self._take(eid, rid)
        # Step 3: evict an evictable large page (cross-type LRU). The manager
        # resolves which pool owns the victim; see JengaKVCacheManager.
        eid = self._evict_large_via_manager(rid)
        if eid is not None:
            return eid
        # Step 4: any EMPTY page of this type (other request's association).
        if self._free_global:
            eid = next(iter(self._free_global))
            return self._take(eid, rid)
        # Step 5: evict an evictable small page of this type (LRU).
        eid = self._pop_small_evictable()
        if eid is not None:
            return self._take(eid, rid)
        return None

    # Hook installed by the manager (needs cross-pool coordination).
    _manager_evict_large = None

    def _evict_large_via_manager(self, rid: str) -> Optional[int]:
        if self._manager_evict_large is None:
            return None
        return self._manager_evict_large(self, rid)

    def _take(self, eid: int, rid: str) -> int:
        page = self.pages[eid]
        if self.san is not None:
            self.san.on_take(self.spec.name, eid, rid)
        self._free_remove(eid)
        page.state = PageState.USED
        page.ref_count = 1
        page.owner_rid = rid
        page.content_hash = None
        page.prefix_length = 0
        self.large_alloc.unmark_evictable(page.large_id)
        return eid

    # ----------------------------------------------------------- freeing
    def free(self, eid: int) -> None:
        """Drop one reference; page becomes EMPTY at refcount 0 (no caching)."""
        page = self.pages[eid]
        if self.san is not None:
            # Pre-mutation so double-free / free-while-cached are reported
            # before the refcount goes negative and corrupts state.
            self.san.on_free(self.spec.name, eid, page.ref_count)
        page.ref_count -= 1
        if page.ref_count > 0:
            return
        self._uncache(page)
        self._evictable.discard(eid)
        page.state = PageState.EMPTY
        self._free_add(eid, page.owner_rid)
        self._maybe_release_large(page.large_id)

    def release_to_cache(self, eid: int, content_hash: Optional[int]) -> None:
        """Drop one reference; at refcount 0 the page becomes EVICTABLE and is
        registered in the prefix cache under ``content_hash``."""
        page = self.pages[eid]
        page.ref_count -= 1
        if page.ref_count > 0:
            return
        if content_hash is None:
            # Nothing reusable (e.g. partially filled page): plain free.
            page.ref_count += 1
            self.free(eid)
            return
        # Dedup: if another live page already serves this hash, keep that one
        # and plain-free ours.
        old = self.cached.get(content_hash)
        if old is not None and old != eid and old in self.pages:
            old_page = self.pages[old]
            if old_page.state != PageState.EMPTY:
                page.content_hash = None
                page.ref_count += 1
                self.free(eid)
                return
        if self.san is not None:
            self.san.on_cache(self.spec.name, eid, content_hash,
                              page.owner_rid)
        page.state = PageState.EVICTABLE
        page.content_hash = content_hash
        self.cached[content_hash] = eid
        self._push_evictable(page)
        self._maybe_mark_large_evictable(page.large_id)

    def register_hash(self, eid: int, content_hash: int) -> None:
        """Register a *running* request's full page in the prefix cache so
        concurrent requests can share it (cache-while-running)."""
        page = self.pages[eid]
        if self.san is not None:
            self.san.on_register(self.spec.name, eid, content_hash,
                                 page.owner_rid)
        page.content_hash = content_hash
        self.cached.setdefault(content_hash, eid)

    def mark_exported(self, eid: int, rid: str) -> None:
        """Flag a USED page as exported for a prefill->decode handoff. The
        pool state is unchanged — the page stays USED and refcounted by its
        owner (the copy stream still reads it) — but the sanitizer's shadow
        moves to IN_TRANSIT so free/cache/re-export while the handoff is
        pending are caught, and an abandoned export is reported at drain."""
        page = self.pages[eid]
        assert page.state == PageState.USED, (eid, page.state)
        if self.san is not None:
            self.san.on_export(self.spec.name, eid, rid)

    def mark_export_done(self, eid: int) -> None:
        """Handoff adopted (or cancelled): return the exported page to
        plain USED ownership so the exporter can free/cache it normally."""
        page = self.pages[eid]
        assert page.state == PageState.USED, (eid, page.state)
        if self.san is not None:
            self.san.on_export_done(self.spec.name, eid)

    def _uncache(self, page: SmallPage) -> None:
        if page.content_hash is not None:
            if self.cached.get(page.content_hash) == page.exec_id:
                del self.cached[page.content_hash]
            page.content_hash = None

    # ----------------------------------------------------- cache lookups
    def lookup(self, content_hash: int) -> Optional[int]:
        return self.cached.get(content_hash)

    def acquire_cached(self, eid: int, rid: str) -> int:
        """Re-reference a cached EVICTABLE page for a prefix hit (→ USED)."""
        page = self.pages[eid]
        if self.san is not None:
            self.san.on_acquire(self.spec.name, eid, rid,
                                page.state == PageState.EVICTABLE)
        if page.state == PageState.EVICTABLE:
            self._evictable.discard(eid)
            page.state = PageState.USED
            page.ref_count = 1
            page.owner_rid = rid
            self.large_alloc.unmark_evictable(page.large_id)
        elif page.state == PageState.USED:
            page.ref_count += 1
        else:
            raise ValueError(f"page {eid} is EMPTY; cannot acquire")
        return eid

    # ----------------------------------------------------------- eviction
    def _push_evictable(self, page: SmallPage) -> None:
        self._seq += 1
        page.seq = self._seq
        self._evictable.add(page.exec_id)
        heapq.heappush(
            self._evict_heap,
            (page.last_access, -page.prefix_length, self._seq, page.exec_id),
        )

    def reprioritize(self, eid: int) -> None:
        """Re-key an evictable page after ts / prefix_length changed."""
        page = self.pages.get(eid)
        if page is not None and page.state == PageState.EVICTABLE:
            self._push_evictable(page)

    def _pop_small_evictable(self) -> Optional[int]:
        while self._evict_heap:
            ts, negplen, seq, eid = heapq.heappop(self._evict_heap)
            page = self.pages.get(eid)
            if (
                page is not None
                and eid in self._evictable
                and page.seq == seq
                and page.state == PageState.EVICTABLE
            ):
                if self.san is not None:
                    self.san.on_evict(self.spec.name, eid)
                self._evictable.discard(eid)
                self._uncache(page)
                page.state = PageState.EMPTY
                self._free_add(eid, page.owner_rid)
                self.large_alloc.unmark_evictable(page.large_id)
                return eid
        return None

    def _evict_small(self, eid: int) -> None:
        """Force-evict a specific EVICTABLE page to EMPTY."""
        page = self.pages[eid]
        assert page.state == PageState.EVICTABLE, page
        if self.san is not None:
            self.san.on_evict(self.spec.name, eid)
        self._evictable.discard(eid)
        self._uncache(page)
        page.state = PageState.EMPTY
        self._free_add(eid, page.owner_rid)
        self.large_alloc.unmark_evictable(page.large_id)

    def evict_whole_large(self, large_id: int) -> None:
        """Evict every EVICTABLE small page of one of our large pages, then
        release it to the LCM allocator (§5.4 step 3 completion)."""
        assert large_id in self.owned_large
        for slot in range(self.spp):
            eid = self.exec_id(large_id, slot)
            page = self.pages[eid]
            if page.state == PageState.EVICTABLE:
                self._evict_small(eid)
            elif page.state == PageState.USED:
                raise ValueError(f"large page {large_id} has USED page {eid}")
        self._maybe_release_large(large_id)

    # ------------------------------------------------------------- stats
    def counts(self) -> Dict[str, int]:
        c = {"empty": len(self._free_global), "used": 0, "evictable": 0}
        n = len(self.pages)
        # evictable set may hold stale ids only transiently; count by state
        ev = sum(1 for e in self._evictable
                 if e in self.pages
                 and self.pages[e].state == PageState.EVICTABLE)
        c["evictable"] = ev
        c["used"] = n - c["empty"] - ev
        c["owned_large"] = len(self.owned_large)
        return c

    def iter_pages(self) -> Iterable[SmallPage]:
        return self.pages.values()

    def check_invariants(self) -> None:
        for eid, p in self.pages.items():
            assert p.exec_id == eid
            if p.state == PageState.EMPTY:
                assert eid in self._free_global, eid
                assert p.ref_count == 0
            elif p.state == PageState.USED:
                assert p.ref_count >= 1, eid
                assert eid not in self._free_global
            else:
                assert p.ref_count == 0
                assert eid not in self._free_global
                assert p.content_hash is not None
        for h, eid in self.cached.items():
            assert self.pages[eid].content_hash == h
