"""PageSan — a runtime page-lifecycle sanitizer for the Jenga allocator.

A shadow state machine over every small-page handle, recording the owner
request and the allocation site, so allocator misuse fails LOUDLY at the
faulty call instead of corrupting device KV three requests later:

    FREE --take--> ALLOCATED --release_to_cache--> CACHED --evict--> FREE
                       |   \\--free--> FREE            \\--acquire--> ALLOCATED
                       \\--(poisoning release)--> POISONED (error)

Detected bug classes:

* double-free            — ``free`` of a page already FREE
* free-while-cached      — ``free`` of a page sitting in the prefix cache
* gather-from-freed      — a dispatch reads/writes a page no request owns
  (``ModelRunner.dispatch`` calls ``check_dispatch`` on the host arrays)
* cache-poisoning        — re-caching a STATE page whose device content has
  run ahead of its boundary hash: the owner request still has dispatched
  steps in flight mutating the live page (the PR-3 uncached-preemption
  rule, extended to EOS-kill reconciliation and checkpoint copies)
* leaks at drain         — ``assert_drained`` lists every ALLOCATED page
  with its owner and allocation site
* lost in transit        — a page exported for a prefill->decode handoff
  (IN_TRANSIT) that was never released or cancelled: ``assert_drained``
  reports it separately from plain leaks, and freeing/caching/double-
  exporting an IN_TRANSIT page errors at the call site

Cost model: the pool guards every event call with ``if self.san is not
None`` — a single attribute test when disabled (``REPRO_PAGE_SANITIZER``
unset), full shadow tracking when enabled. ``verify`` cross-checks the
shadow against the pools' real ``PageState`` and is layered on the
existing ``check_invariants()`` chain.

The in-flight request set that powers the poisoning check is pushed by
the async engine (``set_inflight``) at every ring transition: rids with
dispatched-but-uncompleted segments. Releasing a state-kind page owned by
such a rid to the prefix cache is exactly the §5.3 poisoning hazard —
its boundary hash describes a shorter prefix than the device has already
written.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

# Page kinds whose content advances with EVERY computed token (recurrent
# state): caching one while its owner still has device work in flight is
# the poisoning hazard. Token-kind (KV) pages are append-only — a FULL
# page's content never changes after its hash is computed, so
# cache-while-running is safe for them.
STATE_KINDS = ("mamba", "rwkv")

FREE = "FREE"
ALLOCATED = "ALLOCATED"
CACHED = "CACHED"
POISONED = "POISONED"
# Exported for a prefill->decode handoff: the pool still counts the page
# USED (the copy stream reads it), but no further lifecycle event is legal
# until the export is released (on_export_done) or cancelled.
IN_TRANSIT = "IN_TRANSIT"


class PageSanError(RuntimeError):
    """An allocator-misuse bug caught by the sanitizer."""


def sanitizer_enabled() -> bool:
    return os.environ.get("REPRO_PAGE_SANITIZER", "") not in ("", "0")


def _call_site(skip_files: Tuple[str, ...] = ("pagesan.py", "typed_pool.py",
                                              "lcm_allocator.py")) -> str:
    """First stack frame outside the allocator/sanitizer — where the
    lifecycle call actually came from."""
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        if not fname.endswith(skip_files):
            return f"{os.path.basename(fname)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class _Shadow:
    __slots__ = ("state", "owner_rid", "site", "content_hash")

    def __init__(self) -> None:
        self.state = FREE
        self.owner_rid: Optional[str] = None
        self.site = "<never allocated>"
        self.content_hash: Optional[int] = None


class PageSanitizer:
    def __init__(self, specs) -> None:
        self.kinds: Dict[str, str] = {s.name: s.kind for s in specs}
        # Sliding-window specs retire out-of-window pages to the prefix
        # cache MID-REQUEST; an async dispatch prepared before that
        # retirement may still carry the eid in its table (the gather is
        # window-masked), so CACHED table entries are legal for them.
        self.windowed: Set[str] = {
            s.name for s in specs
            if getattr(s, "sliding_window", None)}
        self.shadow: Dict[str, Dict[int, _Shadow]] = {
            s.name: {} for s in specs}
        self._inflight: Set[str] = set()
        self.errors_raised = 0

    # ------------------------------------------------------------- helpers
    def _rec(self, name: str, eid: int) -> _Shadow:
        rec = self.shadow[name].get(eid)
        if rec is None:
            raise self._fail(
                name, eid, None,
                "event for a page this pool does not own (large page "
                "already released, or foreign exec id)")
        return rec

    def _fail(self, name: str, eid: int, rec: Optional[_Shadow],
              msg: str) -> PageSanError:
        self.errors_raised += 1
        ctx = ""
        if rec is not None:
            ctx = (f" [shadow={rec.state} owner={rec.owner_rid!r} "
                   f"allocated_at={rec.site} hash={rec.content_hash}]")
        return PageSanError(
            f"PageSan: {msg}: type={name} page={eid} at "
            f"{_call_site()}{ctx}")

    # -------------------------------------------------- engine-pushed state
    def set_inflight(self, rids: Iterable[str]) -> None:
        """Rids with dispatched-but-uncompleted device work; their state
        pages' device content runs ahead of the host hash chains."""
        self._inflight = set(rids)

    def clear_inflight(self, rid: str) -> None:
        self._inflight.discard(rid)

    # ------------------------------------------------------ pool-side events
    def on_adopt(self, name: str, eids: Iterable[int]) -> None:
        for eid in eids:
            self.shadow[name][eid] = _Shadow()

    def on_retire(self, name: str, eid: int) -> None:
        rec = self._rec(name, eid)
        if rec.state != FREE:
            raise self._fail(
                name, eid, rec,
                "large page released to the LCM allocator while a small "
                "page is still live")
        del self.shadow[name][eid]

    def on_take(self, name: str, eid: int, rid: str) -> None:
        rec = self._rec(name, eid)
        if rec.state != FREE:
            raise self._fail(name, eid, rec,
                             f"allocate of a page in state {rec.state}")
        rec.state = ALLOCATED
        rec.owner_rid = rid
        rec.site = _call_site()
        rec.content_hash = None

    def on_free(self, name: str, eid: int, ref_count: int) -> None:
        """``ref_count`` is the pool refcount BEFORE this free."""
        rec = self._rec(name, eid)
        if rec.state == FREE:
            raise self._fail(name, eid, rec, "double free")
        if rec.state == CACHED:
            raise self._fail(
                name, eid, rec,
                "free of a page sitting in the prefix cache (must be "
                "evicted or acquired first)")
        if rec.state == IN_TRANSIT:
            raise self._fail(
                name, eid, rec,
                "free of a page exported for handoff (the export must be "
                "released or cancelled first)")
        if ref_count <= 0:
            raise self._fail(name, eid, rec,
                             f"free with non-positive refcount {ref_count}")
        if ref_count == 1:
            rec.state = FREE
            rec.owner_rid = None
            rec.content_hash = None

    def on_cache(self, name: str, eid: int, content_hash: int,
                 owner_rid: Optional[str]) -> None:
        rec = self._rec(name, eid)
        if rec.state != ALLOCATED:
            raise self._fail(
                name, eid, rec,
                f"release_to_cache of a page in state {rec.state}")
        if self.kinds.get(name) in STATE_KINDS \
                and owner_rid in self._inflight:
            rec.state = POISONED
            raise self._fail(
                name, eid, rec,
                f"cache-poisoning: state page cached while owner "
                f"{owner_rid!r} has dispatched steps in flight — device "
                f"content runs ahead of the boundary hash "
                f"{content_hash}")
        rec.state = CACHED
        rec.content_hash = content_hash

    def on_register(self, name: str, eid: int, content_hash: int,
                    owner_rid: Optional[str]) -> None:
        """cache-while-running registration (page stays ALLOCATED)."""
        rec = self._rec(name, eid)
        if rec.state != ALLOCATED:
            raise self._fail(
                name, eid, rec,
                f"register_hash of a page in state {rec.state}")
        if self.kinds.get(name) in STATE_KINDS \
                and owner_rid in self._inflight:
            rec.state = POISONED
            raise self._fail(
                name, eid, rec,
                f"cache-poisoning: state checkpoint registered while owner "
                f"{owner_rid!r} has dispatched steps in flight — the "
                f"checkpoint copy will capture over-advanced state for "
                f"hash {content_hash}")
        rec.content_hash = content_hash

    def on_acquire(self, name: str, eid: int, rid: str,
                   was_cached: bool) -> None:
        rec = self._rec(name, eid)
        if was_cached:
            if rec.state != CACHED:
                raise self._fail(
                    name, eid, rec,
                    f"acquire_cached of a page in state {rec.state}")
            rec.state = ALLOCATED
            rec.site = _call_site()
        elif rec.state != ALLOCATED:
            raise self._fail(
                name, eid, rec,
                f"shared re-acquire of a page in state {rec.state}")
        rec.owner_rid = rid

    def on_export(self, name: str, eid: int, rid: str) -> None:
        """Page set exported for a prefill->decode handoff: the page stays
        USED in the pool (the cross-shard copy stream still reads it) but
        enters the explicit IN_TRANSIT shadow state — free/cache/re-export
        while in transit are bugs, and an export never released shows up
        at drain as lost-in-transit rather than a generic leak."""
        rec = self._rec(name, eid)
        if rec.state == IN_TRANSIT:
            raise self._fail(name, eid, rec,
                             "double export of a page already in transit")
        if rec.state != ALLOCATED:
            raise self._fail(name, eid, rec,
                             f"export of a page in state {rec.state}")
        rec.state = IN_TRANSIT
        rec.owner_rid = rid
        rec.site = _call_site()

    def on_export_done(self, name: str, eid: int) -> None:
        """Handoff finished (adopted on the destination) or cancelled: the
        source page returns to plain ALLOCATED ownership so the exporter
        can free/cache it normally. A page NOT in transit here means the
        same export was completed twice (double adopt)."""
        rec = self._rec(name, eid)
        if rec.state != IN_TRANSIT:
            raise self._fail(
                name, eid, rec,
                f"export completion of a page in state {rec.state} "
                f"(double adopt of the same export?)")
        rec.state = ALLOCATED

    def on_evict(self, name: str, eid: int) -> None:
        rec = self._rec(name, eid)
        if rec.state != CACHED:
            raise self._fail(name, eid, rec,
                             f"evict of a page in state {rec.state}")
        rec.state = FREE
        rec.owner_rid = None
        rec.content_hash = None

    # ---------------------------------------------------------- deep checks
    def check_dispatch(self, arrs: Dict[str, object]) -> None:
        """gather-from-freed: every page a dispatch reads (tables), writes
        (write_eids) or scans (state_eids) must be ALLOCATED right now.
        Killed packed segments keep their (freed) gather pages in the
        stream but are excluded via ``page_seg < 0``; padded layouts null
        dead rows to -1 outright.  Sliding-window table entries may also
        be CACHED: in-flight retirement releases slid-out pages to the
        prefix cache while an already-prepared dispatch still carries the
        eid, and the gather of those positions is window-masked."""
        page_seg = arrs.get("page_seg") or {}
        for field in ("tables", "write_eids", "state_eids"):
            coll = arrs.get(field)
            if not coll:
                continue
            for name, arr in coll.items():
                if arr is None or name not in self.shadow:
                    continue
                flat = np.asarray(arr).ravel()
                mask = flat >= 0
                if field == "tables":
                    seg = page_seg.get(name)
                    if seg is not None:
                        mask &= np.asarray(seg).ravel() >= 0
                windowed_table = (field == "tables"
                                  and name in self.windowed)
                for eid in np.unique(flat[mask]):
                    rec = self.shadow[name].get(int(eid))
                    ok = rec is not None and (
                        rec.state == ALLOCATED
                        or (windowed_table and rec.state == CACHED))
                    if not ok:
                        raise self._fail(
                            name, int(eid), rec,
                            f"gather-from-freed: dispatch {field} "
                            f"references a page no request owns")

    def live_pages(self) -> List[Tuple[str, int, _Shadow]]:
        return [(name, eid, rec)
                for name, pages in sorted(self.shadow.items())
                for eid, rec in sorted(pages.items())
                if rec.state == ALLOCATED]

    def assert_drained(self) -> None:
        """Leak check once every request finished: nothing may still be
        ALLOCATED (CACHED pages are fine — that is the prefix cache), and
        no export may still be IN_TRANSIT (a handoff that never completed
        nor cancelled lost its pages in transit)."""
        leaks = self.live_pages()
        transit = [(name, eid, rec)
                   for name, pages in sorted(self.shadow.items())
                   for eid, rec in sorted(pages.items())
                   if rec.state == IN_TRANSIT]
        if leaks or transit:
            lines = [f"  type={n} page={e} owner={r.owner_rid!r} "
                     f"allocated_at={r.site}" for n, e, r in leaks]
            lines += [f"  type={n} page={e} owner={r.owner_rid!r} "
                      f"LOST IN TRANSIT exported_at={r.site}"
                      for n, e, r in transit]
            self.errors_raised += 1
            raise PageSanError(
                "PageSan: %d leaked / %d lost-in-transit page(s) at "
                "drain:\n%s"
                % (len(leaks), len(transit), "\n".join(lines)))

    def verify(self, pools) -> None:
        """Cross-check shadow vs the pools' real PageState — called from
        ``JengaKVCacheManager.check_invariants`` when enabled."""
        from ..core.typed_pool import PageState
        expect = {PageState.EMPTY: FREE, PageState.USED: ALLOCATED,
                  PageState.EVICTABLE: CACHED}
        for name, pool in pools.items():
            shadow = self.shadow[name]
            if set(shadow) != set(pool.pages):
                extra = set(shadow) - set(pool.pages)
                missing = set(pool.pages) - set(shadow)
                raise PageSanError(
                    f"PageSan: shadow/pool page-set mismatch for {name}: "
                    f"shadow-only={sorted(extra)} pool-only="
                    f"{sorted(missing)}")
            for eid, page in pool.pages.items():
                rec = shadow[eid]
                if rec.state == POISONED:
                    continue    # already reported; state is post-mortem
                if rec.state == IN_TRANSIT:
                    # exported pages stay USED in the pool until the
                    # handoff is released or cancelled
                    if page.state == PageState.USED:
                        continue
                if rec.state != expect[page.state]:
                    raise PageSanError(
                        f"PageSan: shadow diverged for {name} page {eid}: "
                        f"shadow={rec.state} pool={page.state} "
                        f"owner={rec.owner_rid!r} site={rec.site}")
