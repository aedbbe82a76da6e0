"""JengaKVCacheManager — the paper's full system glued together (§4 + §5).

Responsibilities:
  * builds the two-level geometry (LCM large pages, per-type small pools);
  * computes model-wide prefix-cache hits (intersection of per-type
    ``get_possible_prefix`` sets, §5.2);
  * transactional page allocation for scheduled tokens (chunked prefill /
    decode), with the §5.4 five-step algorithm inside each pool and the
    cross-type large-page LRU eviction hook (step 3);
  * page lifecycle: fill → register hash (cache-while-running) → retire
    (sliding-window early free, vision free-on-consume §6.2) → release to
    cache on request completion → evict;
  * balanced/aligned eviction via the per-type policies (§5.1);
  * memory accounting for the fragmentation/utilization benchmarks.

The manager is host-side and device-agnostic: the serving engine maps exec
page ids onto reshape views of the unified device buffer (see layout.py).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import prefix_cache as pc
from .lcm_allocator import LargePageAllocator
from .policies import LayerPolicy, make_policy
from .request import SequenceState
from .spec import KVCacheSpec, PageGeometry, make_geometry
from .typed_pool import TypedPool

STATE_KINDS = ("mamba", "rwkv")
TOKEN_KINDS = ("full_attn", "swa")
MM_KINDS = ("vision_embed", "cross_attn")


@dataclasses.dataclass
class StateCopyOp:
    """Device-side copy the engine must perform (state checkpointing §5.3)."""

    type_name: str
    src_page: int
    dst_page: int
    position: int      # prefix length the snapshot represents
    kind: str          # "checkpoint" (live->ckpt) or "restore" (ckpt->live)


@dataclasses.dataclass
class PageSetExport:
    """Snapshot of one request's typed page set for a prefill->decode
    handoff (§5.2 whole-prompt transfer unit): the per-type page tables
    with their boundary-chain hashes — the exact keys
    ``router.prefix_match_tokens`` probes — plus the live/checkpoint state
    pages and the hash-chain continuations the destination needs to keep
    extending the chains. The exported pages stay USED on the source
    (marked IN_TRANSIT in the sanitizer) until the handoff is released or
    cancelled; the destination allocates its own pages and the caller
    performs the device copies the returned (src, dst) pairs describe."""

    rid: str
    num_tokens: int                    # == num_computed == len(prompt)
    page_tables: Dict[str, List[int]]
    page_hashes: Dict[str, List[Optional[int]]]
    num_cached_pages: Dict[str, int]
    state_pages: Dict[str, int]
    ckpt_pages: Dict[str, Dict[int, int]]
    # hash-chain continuations (aux state), copied verbatim
    token_chain: Dict[str, List[int]]
    mm_chain: Dict[str, List[int]]
    state_chain: Dict[str, List[int]]
    state_boundary_hash: Dict[str, Dict[int, int]]


@dataclasses.dataclass
class TypeStats:
    page_units: int
    used: int
    evictable: int
    empty: int
    owned_large: int


@dataclasses.dataclass
class MemoryStats:
    total_units: int
    large_page_units: int
    free_large: int
    evictable_large: int
    per_type: Dict[str, TypeStats]

    @property
    def used_units(self) -> int:
        return sum(t.used * t.page_units for t in self.per_type.values())

    @property
    def evictable_units(self) -> int:
        return sum(t.evictable * t.page_units for t in self.per_type.values())

    @property
    def empty_units(self) -> int:
        """Internal fragmentation: reserved inside owned large pages, unused."""
        return sum(t.empty * t.page_units for t in self.per_type.values())

    @property
    def free_units(self) -> int:
        return self.free_large * self.large_page_units

    @property
    def utilization(self) -> float:
        return self.used_units / max(1, self.total_units)


class _ReqAux:
    """Incremental hash-chain state for one request."""

    __slots__ = (
        "keys", "mm_keys", "enc_keys", "token_chain", "mm_chain",
        "state_chain", "state_boundary_hash", "suppressed_ckpts",
    )

    def __init__(self) -> None:
        self.keys: List[int] = []
        self.mm_keys: List[int] = []
        self.enc_keys: List[int] = []
        # type -> [num_pages_hashed, chain_hash]
        self.token_chain: Dict[str, List[int]] = {}
        self.mm_chain: Dict[str, List[int]] = {}
        # type -> [position, chain_hash]
        self.state_chain: Dict[str, List[int]] = {}
        # type -> {boundary_pos: hash}
        self.state_boundary_hash: Dict[str, Dict[int, int]] = {}
        # type -> boundary positions whose checkpoint was suppressed
        # (allow_checkpoints=False) and awaits a catch-up snapshot
        self.suppressed_ckpts: Dict[str, List[int]] = {}


class JengaKVCacheManager:
    def __init__(
        self,
        specs: Sequence[KVCacheSpec],
        *,
        total_memory_bytes: int,
        mode: str = "lcm",
        enable_prefix_caching: bool = True,
        enable_inflight_retirement: bool = True,
        seed: int = 0,
        page_sanitizer: Optional[bool] = None,
    ):
        self.geometry: PageGeometry = make_geometry(
            specs, total_memory_bytes=total_memory_bytes, mode=mode
        )
        self.large_alloc = LargePageAllocator(self.geometry)
        self.pools: Dict[str, TypedPool] = {
            s.name: TypedPool(s, self.geometry, self.large_alloc) for s in specs
        }
        self.policies: Dict[str, LayerPolicy] = {
            s.name: make_policy(s) for s in specs
        }
        self.salts = {s.name: pc.salt_of(s.name) for s in specs}
        self.enable_prefix_caching = enable_prefix_caching
        self.enable_inflight_retirement = enable_inflight_retirement
        self.rng = random.Random(seed)
        self.clock = 0
        self._aux: Dict[str, _ReqAux] = {}
        # pages handed out by committed allocations since the last drain;
        # the runner zeroes them before their first dispatch (a recycled
        # large page can hold another type's stale bytes — e.g. fp32 state
        # pairs that decode as NaN when read as bf16 K/V)
        self._fresh_pages: List[Tuple[str, int]] = []
        # install the §5.4-step-3 cross-pool hook
        for pool in self.pools.values():
            pool._manager_evict_large = self._evict_large_for
        # optional PageSan shadow tracker (default: REPRO_PAGE_SANITIZER=1)
        self.sanitizer = None
        if page_sanitizer is None:
            from ..analysis.pagesan import sanitizer_enabled
            page_sanitizer = sanitizer_enabled()
        if page_sanitizer:
            from ..analysis.pagesan import PageSanitizer
            self.sanitizer = PageSanitizer(self.geometry.specs)
            for pool in self.pools.values():
                pool.san = self.sanitizer
        # running stats
        self.prefix_hit_tokens_total = 0
        self.prefix_query_tokens_total = 0
        # deferred-checkpoint + handoff accounting
        self.suppressed_checkpoints = 0
        self.catchup_checkpoints = 0
        self.handoff_exports = 0
        self.handoff_adopted = 0
        self.handoff_pages_adopted = 0

    # ------------------------------------------------------------------ util
    @property
    def specs(self) -> Tuple[KVCacheSpec, ...]:
        return self.geometry.specs

    def spec(self, name: str) -> KVCacheSpec:
        return self.geometry.spec_by_name(name)

    def tick(self) -> int:
        self.clock += 1
        return self.clock

    def _evict_large_for(self, pool: TypedPool, rid: str) -> Optional[int]:
        """§5.4 step 3: evict the LRU evictable large page (any type), then
        hand a fresh large page to the requesting pool."""
        victim = self.large_alloc.pop_evictable_lru()
        if victim is None:
            return None
        owner = self.large_alloc.owner_of(victim)
        self.pools[owner].evict_whole_large(victim)
        fresh = self.large_alloc.alloc(pool.spec.name)
        if fresh is None:  # pragma: no cover - freed page must be available
            return None
        pool._adopt_large(fresh, rid)
        return pool._take(pool.exec_id(fresh, 0), rid)

    # --------------------------------------------------------- key streams
    def _ensure_aux(self, req: SequenceState) -> _ReqAux:
        aux = self._aux.get(req.rid)
        if aux is None:
            aux = _ReqAux()
            self._aux[req.rid] = aux
            if req.encoder_items:
                aux.enc_keys = [
                    pc.combine(it.mm_hash, off)
                    for it in req.encoder_items
                    for off in range(it.length)
                ]
            if req.mm_items:
                aux.mm_keys = [
                    pc.combine(it.mm_hash, off)
                    for it in req.mm_items
                    for off in range(it.length)
                ]
        # extend main-stream keys for newly appended tokens (appends are
        # always text -> incremental extend, O(new))
        if len(aux.keys) < len(req.tokens):
            if not aux.keys:
                aux.keys = pc.key_stream(req.tokens, req.mm_items)
            else:
                aux.keys.extend(
                    int(t) for t in req.tokens[len(aux.keys):])
        return aux

    def _mm_storage_keys(self, req: SequenceState, spec: KVCacheSpec,
                         aux: _ReqAux) -> List[int]:
        if spec.kind == "cross_attn" and req.encoder_items:
            return aux.enc_keys
        return aux.mm_keys

    def _mm_storage_upto(self, req: SequenceState, spec: KVCacheSpec,
                         main_pos: int) -> int:
        """Number of storage-stream tokens needed once ``main_pos`` main
        tokens are being computed."""
        if spec.kind == "cross_attn" and req.encoder_items:
            # whole encoder stream is needed as soon as anything runs
            return sum(it.length for it in req.encoder_items) if main_pos > 0 else 0
        n = 0
        for it in req.mm_items:
            n += max(0, min(main_pos, it.start + it.length) - it.start)
        return n

    # ------------------------------------------------------------ hit logic
    def _possible_prefixes(self, req: SequenceState) -> Dict[str, Set[int]]:
        aux = self._ensure_aux(req)
        n = len(req.tokens)
        out: Dict[str, Set[int]] = {}
        for name, spec in ((s.name, s) for s in self.specs):
            pool = self.pools[name]
            policy = self.policies[name]
            salt = self.salts[name]
            if spec.kind in TOKEN_KINDS:
                hashes = pc.page_chain_hashes(aux.keys, spec.tokens_per_page, salt)
                is_hit = [False] * n
                for pi, h in enumerate(hashes):
                    if pool.lookup(h) is not None:
                        lo = pi * spec.tokens_per_page
                        hi = min(n, lo + spec.tokens_per_page)
                        for i in range(lo, hi):
                            is_hit[i] = True
                    elif spec.kind == "full_attn":
                        break  # chain broken; later pages can't hit anyway
            elif spec.kind in STATE_KINDS:
                is_hit = [False] * n
                interval = spec.state_checkpoint_interval
                h = salt
                for i, k in enumerate(aux.keys):
                    h = pc.combine(h, k)
                    p = i + 1
                    if p % interval == 0 and pool.lookup(h) is not None:
                        is_hit[i] = True
            else:  # mm kinds
                skeys = self._mm_storage_keys(req, spec, aux)
                hashes = pc.page_chain_hashes(skeys, spec.tokens_per_page, salt)
                is_hit = [False] * len(skeys)
                for pi, h in enumerate(hashes):
                    if pool.lookup(h) is not None:
                        lo = pi * spec.tokens_per_page
                        hi = min(len(skeys), lo + spec.tokens_per_page)
                        for i in range(lo, hi):
                            is_hit[i] = True
                # trailing partial storage page can never be cached
            out[name] = policy.get_possible_prefix(is_hit, req)
        return out

    def lookup_prefix(self, req: SequenceState) -> int:
        """Longest model-wide cache-hit prefix (§5.2), capped at n-1 so at
        least one token remains to compute."""
        if not self.enable_prefix_caching:
            return 0
        sets = self._possible_prefixes(req)
        common = set.intersection(*sets.values()) if sets else {0}
        n = len(req.tokens)
        valid = [p for p in common if 0 <= p <= n - 1]
        return max(valid) if valid else 0

    # ------------------------------------------------------- request begin
    def begin_request(self, req: SequenceState) -> Tuple[bool, List[StateCopyOp]]:
        """Acquire prefix-hit pages and set up hash chains. Returns
        (ok, copy_ops). On failure nothing is held."""
        aux = self._ensure_aux(req)
        now = self.tick()
        hit = self.lookup_prefix(req)
        self.prefix_query_tokens_total += len(req.tokens)
        copy_ops: List[StateCopyOp] = []
        acquired: List[Tuple[TypedPool, int]] = []
        fresh: List[Tuple[TypedPool, int]] = []

        def rollback() -> None:
            for pool, eid in acquired:
                page = pool.pages[eid]
                pool.release_to_cache(eid, page.content_hash)
            for pool, eid in fresh:
                pool.free(eid)

        try:
            for spec in self.specs:
                name, pool = spec.name, self.pools[spec.name]
                salt = self.salts[name]
                tpp = spec.tokens_per_page
                if spec.kind in TOKEN_KINDS:
                    n_hit_pages = hit // tpp
                    hashes = (pc.page_chain_hashes(aux.keys, tpp, salt)
                              if self.enable_prefix_caching else [])
                    table: List[int] = []
                    hlist: List[Optional[int]] = []
                    lo_page = 0
                    if spec.kind == "swa" and hit > 0:
                        lo_tok = max(0, hit - spec.sliding_window)
                        lo_page = lo_tok // tpp
                    for pi in range(n_hit_pages):
                        if pi < lo_page:
                            table.append(SequenceState.FREED)
                            hlist.append(hashes[pi])
                            continue
                        eid = pool.lookup(hashes[pi])
                        assert eid is not None, (name, pi, hit)
                        pool.acquire_cached(eid, req.rid)
                        pool.pages[eid].last_access = now
                        acquired.append((pool, eid))
                        table.append(eid)
                        hlist.append(hashes[pi])
                    req.page_tables[name] = table
                    req.page_hashes[name] = hlist
                    req.num_cached_pages[name] = n_hit_pages
                    aux.token_chain[name] = [
                        n_hit_pages,
                        hashes[n_hit_pages - 1] if n_hit_pages else salt,
                    ]
                elif spec.kind in STATE_KINDS and not self.enable_prefix_caching:
                    live = pool.allocate(req.rid)
                    if live is None:
                        rollback()
                        return False, []
                    fresh.append((pool, live))
                    req.state_pages[name] = live
                    req.ckpt_pages.setdefault(name, {})
                    aux.state_chain[name] = [0, salt]
                    aux.state_boundary_hash[name] = {}
                elif spec.kind in STATE_KINDS:   # caching on
                    interval = spec.state_checkpoint_interval
                    aux.state_chain[name] = [0, salt]
                    aux.state_boundary_hash[name] = {}
                    req.ckpt_pages.setdefault(name, {})
                    # live state page (one per request)
                    live = pool.allocate(req.rid)
                    if live is None:
                        rollback()
                        return False, []
                    fresh.append((pool, live))
                    req.state_pages[name] = live
                    pool.pages[live].last_access = now
                    if hit > 0:
                        assert hit % interval == 0, (hit, interval)
                        h = pc.prefix_hash(aux.keys, hit, salt)
                        ck = pool.lookup(h)
                        assert ck is not None
                        pool.acquire_cached(ck, req.rid)
                        pool.pages[ck].last_access = now
                        acquired.append((pool, ck))
                        req.ckpt_pages[name][hit] = ck
                        aux.state_chain[name] = [hit, h]
                        aux.state_boundary_hash[name][hit] = h
                        copy_ops.append(
                            StateCopyOp(name, ck, live, hit, "restore")
                        )
                else:  # mm kinds
                    skeys = self._mm_storage_keys(req, spec, aux)
                    hashes = (pc.page_chain_hashes(skeys, tpp, salt)
                              if self.enable_prefix_caching else [])
                    s_hit = self._mm_storage_upto(req, spec, hit)
                    n_hit_pages = s_hit // tpp
                    table, hlist = [], []
                    for pi in range(n_hit_pages):
                        eid = pool.lookup(hashes[pi])
                        if eid is None:
                            # storage beyond items fully inside the hit may be
                            # uncached only if the hit never required it
                            table.append(SequenceState.FREED)
                            hlist.append(hashes[pi])
                            continue
                        pool.acquire_cached(eid, req.rid)
                        pool.pages[eid].last_access = now
                        acquired.append((pool, eid))
                        table.append(eid)
                        hlist.append(hashes[pi])
                    req.page_tables[name] = table
                    req.page_hashes[name] = hlist
                    req.num_cached_pages[name] = n_hit_pages
                    aux.mm_chain[name] = [
                        n_hit_pages,
                        hashes[n_hit_pages - 1] if n_hit_pages else salt,
                    ]
        except Exception:
            rollback()
            raise
        req.num_computed = hit
        req.prefix_hit_tokens = hit
        self.prefix_hit_tokens_total += hit
        req.last_access = now
        return True, copy_ops

    # --------------------------------------------------------- allocation
    # The §5.4 transactional property is implemented with an undo journal so
    # it composes across a whole step plan: ``allocate_for_batch`` commits
    # page capacity for EVERY scheduled request of a step or rolls the whole
    # plan back as one unit; ``allocate_for_tokens`` is the one-request case.

    def _rollback_journal(self, journal: List[Tuple[str, SequenceState,
                                                    str, TypedPool, int]]):
        for kind, req, name, pool, eid in reversed(journal):
            if kind == "table":
                popped = req.page_tables[name].pop()
                assert popped == eid, (name, popped, eid)
            else:  # "state"
                del req.state_pages[name]
            pool.free(eid)

    def _allocate_into(self, req: SequenceState, target: int,
                       journal: List) -> bool:
        """Grow ``req``'s tables so tokens [num_computed, target) can be
        computed, recording every fresh page in ``journal``. Returns False
        (without rolling back — the caller owns the journal) on exhaustion.

        ``target`` may exceed ``len(req.tokens)``: the async scheduler
        commits pages for a decode token whose id is only sampled when the
        in-flight step's logits land (speculative +1 scheduling)."""
        self._ensure_aux(req)
        for spec in self.specs:
            name, pool = spec.name, self.pools[spec.name]
            tpp = spec.tokens_per_page
            if spec.kind in STATE_KINDS:
                if name not in req.state_pages:
                    eid = pool.allocate(req.rid)
                    if eid is None:
                        return False
                    req.state_pages[name] = eid
                    journal.append(("state", req, name, pool, eid))
                continue
            if spec.kind in TOKEN_KINDS:
                need_pages = -(-target // tpp)
            else:  # mm kinds
                s_need = self._mm_storage_upto(req, spec, target)
                need_pages = -(-s_need // tpp)
            table = req.page_tables.setdefault(name, [])
            for _ in range(max(0, need_pages - len(table))):
                eid = pool.allocate(req.rid)
                if eid is None:
                    return False
                table.append(eid)
                journal.append(("table", req, name, pool, eid))
        return True

    def allocate_for_batch(self, reqs: Sequence[SequenceState],
                           targets: Sequence[int]) -> bool:
        """Batch-transactional allocation for one step plan: ensure capacity
        so each ``reqs[i]`` can compute tokens [num_computed, targets[i]).
        Either every request's allocation commits or nothing changes."""
        assert len(reqs) == len(targets)
        journal: List = []
        for req, target in zip(reqs, targets):
            if not self._allocate_into(req, target, journal):
                self._rollback_journal(journal)
                return False
        self._fresh_pages.extend((name, eid)
                                 for _, _, name, _, eid in journal)
        return True

    def drain_fresh_pages(self) -> List[Tuple[str, int]]:
        """Pages allocated (committed) since the last drain, for device-side
        zero-initialisation before their first use."""
        out, self._fresh_pages = self._fresh_pages, []
        return out

    def allocate_for_tokens(self, req: SequenceState, target: int) -> bool:
        """Ensure page capacity so tokens [num_computed, target) can be
        computed. Transactional: on failure nothing changes."""
        return self.allocate_for_batch([req], [target])

    def rollback_tokens(self, req: SequenceState, target: int) -> int:
        """Undo trailing page allocations beyond what ``target`` computed
        tokens need — the async scheduler's speculative-decode rollback: a
        plan pre-commits a +1 decode page for every running request via
        ``allocate_for_batch``; when the in-flight step's logits reveal the
        request actually finished (EOS / token budget), the page committed
        for the never-computed token is popped here before the request is
        released.

        Pops trailing table entries (runner mirrors resync by table LENGTH,
        so the epoch is deliberately NOT bumped — a bump would force a full
        mirror rebuild and drop the freed-events cursor) and frees the
        non-FREED ones; popped pages are also purged from the fresh-page
        (zero-on-first-use) queue. State pages and ``num_computed`` are
        untouched. Returns the number of pages freed."""
        freed = 0
        popped: Set[Tuple[str, int]] = set()
        for spec in self.specs:
            if spec.kind in STATE_KINDS:
                continue
            name, pool = spec.name, self.pools[spec.name]
            tpp = spec.tokens_per_page
            if spec.kind in TOKEN_KINDS:
                need = -(-target // tpp)
            else:  # mm kinds
                need = -(-self._mm_storage_upto(req, spec, target) // tpp)
            table = req.page_tables.get(name)
            if not table or len(table) <= need:
                continue
            hlist = req.page_hashes.get(name, [])
            while len(table) > need:
                eid = table.pop()
                if len(hlist) > len(table):
                    hlist.pop()
                if eid == SequenceState.FREED:
                    continue
                pool.free(eid)
                popped.add((name, eid))
                freed += 1
            req.mark_trimmed(name)
        if popped:
            self._fresh_pages = [p for p in self._fresh_pages
                                 if p not in popped]
        return freed

    # --------------------------------------------------------------- advance
    def advance(self, req: SequenceState, num_new: int,
                allow_checkpoints: bool = True) -> List[StateCopyOp]:
        """Record that ``num_new`` more tokens were computed. Updates hash
        chains, registers newly full pages, retires out-of-window pages, and
        returns state-checkpoint copy ops for the engine.

        ``allow_checkpoints=False`` suppresses new state-checkpoint copies:
        required when deeper in-flight steps will keep mutating the live
        state page AFTER this copy op would execute — the snapshot would
        capture over-advanced state under a too-early boundary hash.
        Suppressed boundaries are recorded, not dropped: the next advance
        with ``allow_checkpoints=True`` (the rid has no deeper in-flight
        steps — at the latest its final ring completion) emits catch-up
        checkpoint copies for them, so depth >= 3 pipelines keep the same
        restart/prefix granularity as the sync path. At depth <= 2 every
        completion runs with ``allow_checkpoints=True``, so the deferral
        machinery is a provable no-op there."""
        aux = self._ensure_aux(req)
        old = req.num_computed
        req.num_computed = min(old + num_new, len(req.tokens))
        now = self.tick()
        req.last_access = now
        copy_ops: List[StateCopyOp] = []
        caching = self.enable_prefix_caching
        for spec in self.specs:
            name, pool = spec.name, self.pools[spec.name]
            tpp = spec.tokens_per_page
            salt = self.salts[name]
            if spec.kind in TOKEN_KINDS:
                chain = aux.token_chain.setdefault(name, [0, salt])
                table = req.page_tables.get(name, [])
                hlist = req.page_hashes.setdefault(name, [])
                while caching and (chain[0] + 1) * tpp <= req.num_computed:
                    h = chain[1]
                    for k in aux.keys[chain[0] * tpp : (chain[0] + 1) * tpp]:
                        h = pc.combine(h, k)
                    chain[0] += 1
                    chain[1] = h
                    while len(hlist) < chain[0]:
                        hlist.append(None)
                    hlist[chain[0] - 1] = h
                    if self.enable_prefix_caching and chain[0] - 1 < len(table):
                        eid = table[chain[0] - 1]
                        if eid != SequenceState.FREED:
                            pool.register_hash(eid, h)
                # sliding-window retirement (mid-request free, Fig. 16)
                if self.enable_inflight_retirement:
                    policy = self.policies[name]
                    for idx in policy.retire_pages(req):
                        eid = table[idx]
                        if eid == SequenceState.FREED:
                            continue
                        h = hlist[idx] if idx < len(hlist) else None
                        if self.enable_prefix_caching and h is not None:
                            pool.release_to_cache(eid, h)
                        else:
                            pool.free(eid)
                        req.mark_freed(name, idx)
            elif spec.kind in STATE_KINDS:
                interval = spec.state_checkpoint_interval
                chain = aux.state_chain.setdefault(name, [0, salt])
                bh = aux.state_boundary_hash.setdefault(name, {})
                pending = aux.suppressed_ckpts.setdefault(name, [])
                if (pending and allow_checkpoints and caching
                        and name in req.state_pages):
                    # catch-up: snapshot boundaries whose checkpoint was
                    # suppressed while deeper steps were in flight. The live
                    # page is now a few tokens past the boundary — the same
                    # approximation the sync path makes when one chunk
                    # crosses several boundaries before its copy ops run.
                    still: List[int] = []
                    for pos in pending:
                        if pos in req.ckpt_pages.get(name, {}):
                            continue
                        ck = pool.allocate(req.rid)
                        if ck is None:  # best-effort: retry next quiet advance
                            still.append(pos)
                            continue
                        req.ckpt_pages.setdefault(name, {})[pos] = ck
                        pool.register_hash(ck, bh[pos])
                        pool.pages[ck].last_access = now
                        copy_ops.append(StateCopyOp(
                            name, req.state_pages[name], ck,
                            pos, "checkpoint",
                        ))
                        self.catchup_checkpoints += 1
                    pending[:] = still
                while caching and chain[0] < req.num_computed:
                    chain[1] = pc.combine(chain[1], aux.keys[chain[0]])
                    chain[0] += 1
                    if chain[0] % interval == 0:
                        bh[chain[0]] = chain[1]
                        if (self.enable_prefix_caching
                                and name in req.state_pages):
                            if not allow_checkpoints:
                                pending.append(chain[0])
                                self.suppressed_checkpoints += 1
                                continue
                            ck = pool.allocate(req.rid)
                            if ck is not None:  # best-effort checkpointing
                                req.ckpt_pages.setdefault(name, {})[chain[0]] = ck
                                pool.register_hash(ck, chain[1])
                                pool.pages[ck].last_access = now
                                copy_ops.append(StateCopyOp(
                                    name, req.state_pages[name], ck,
                                    chain[0], "checkpoint",
                                ))
            else:  # mm kinds
                chain = aux.mm_chain.setdefault(name, [0, salt])
                skeys = self._mm_storage_keys(req, spec, aux)
                s_done = self._mm_storage_upto(req, spec, req.num_computed)
                table = req.page_tables.get(name, [])
                hlist = req.page_hashes.setdefault(name, [])
                while caching and (chain[0] + 1) * tpp <= s_done:
                    h = chain[1]
                    for k in skeys[chain[0] * tpp : (chain[0] + 1) * tpp]:
                        h = pc.combine(h, k)
                    chain[0] += 1
                    chain[1] = h
                    while len(hlist) < chain[0]:
                        hlist.append(None)
                    hlist[chain[0] - 1] = h
                    if self.enable_prefix_caching and chain[0] - 1 < len(table):
                        eid = table[chain[0] - 1]
                        if eid != SequenceState.FREED:
                            pool.register_hash(eid, h)
        return copy_ops

    # ------------------------------------------------- vision free-on-consume
    def consume_mm(self, req: SequenceState, upto_token: int) -> int:
        """§6.2: free vision-embedding pages whose storage tokens were all
        consumed by chunked prefill. Returns number of pages released."""
        released = 0
        for spec in self.specs:
            if spec.kind != "vision_embed":
                continue
            pool = self.pools[spec.name]
            tpp = spec.tokens_per_page
            s_done = self._mm_storage_upto(req, spec, upto_token)
            full = s_done // tpp
            table = req.page_tables.get(spec.name, [])
            hlist = req.page_hashes.get(spec.name, [])
            for idx in range(min(full, len(table))):
                eid = table[idx]
                if eid == SequenceState.FREED:
                    continue
                h = hlist[idx] if idx < len(hlist) else None
                if self.enable_prefix_caching and h is not None:
                    pool.release_to_cache(eid, h)
                else:
                    pool.free(eid)
                req.mark_freed(spec.name, idx)
                released += 1
        return released

    # ------------------------------------------------------------- touching
    def touch(self, req: SequenceState) -> None:
        """Balanced eviction: unified last-access stamping via policies (§5.1)."""
        now = self.tick()
        req.last_access = now
        for name, policy in self.policies.items():
            policy.update_last_access(self.pools[name], req, now)

    # ------------------------------------------------------------ request end
    def free_request(self, req: SequenceState, cache: bool = True,
                     cache_state: bool = True) -> None:
        """``cache_state=False`` keeps token-kind caching but plain-frees
        state pages: needed when the request finishes while deeper killed
        steps are still dispatched — the device keeps advancing the live
        state page past the boundary hash (see preempt_request)."""
        cache = cache and self.enable_prefix_caching
        cache_state = cache and cache_state
        now = self.tick()
        if cache:
            # aligned eviction: consistent fine-grained priorities (§5.1)
            for name, policy in self.policies.items():
                policy.set_prefix_length(self.pools[name], req, self.rng)
        aux = self._aux.get(req.rid)
        for spec in self.specs:
            name, pool = spec.name, self.pools[spec.name]
            table = req.page_tables.get(name, [])
            hlist = req.page_hashes.get(name, [])
            for idx, eid in enumerate(table):
                if eid == SequenceState.FREED:
                    continue
                h = hlist[idx] if idx < len(hlist) else None
                page = pool.pages[eid]
                page.last_access = max(page.last_access, req.last_access)
                if cache and h is not None:
                    pool.release_to_cache(eid, h)
                else:
                    pool.free(eid)
            req.page_tables[name] = []
            if spec.kind in STATE_KINDS:
                live = req.state_pages.pop(name, None)
                bh = (aux.state_boundary_hash.get(name, {}) if aux else {})
                if live is not None:
                    h = bh.get(req.num_computed)
                    if cache_state and h is not None:
                        pool.release_to_cache(live, h)
                    else:
                        pool.free(live)
                for pos, ck in req.ckpt_pages.get(name, {}).items():
                    h = bh.get(pos)
                    page = pool.pages[ck]
                    if cache_state and (h is not None or page.content_hash is not None):
                        pool.release_to_cache(ck, h if h is not None else page.content_hash)
                    else:
                        pool.free(ck)
                req.ckpt_pages[name] = {}
        req.bump_epoch()
        self._aux.pop(req.rid, None)

    def rollback(self, req: SequenceState, num_computed: int,
                 tokens: List[int]) -> None:
        """Speculative-decoding rollback (§6.1): rejected proposal tokens
        are discarded; their pages stay allocated and are overwritten by
        later tokens. Only valid with prefix caching disabled (hash chains
        would otherwise cover rejected content)."""
        assert not self.enable_prefix_caching
        req.tokens = list(tokens)
        req.num_computed = min(num_computed, len(req.tokens))
        aux = self._aux.get(req.rid)
        if aux is not None:
            aux.keys = aux.keys[: len(req.tokens)]

    def preempt_request(self, req: SequenceState, cache: bool = True) -> None:
        """Recompute-style preemption: release everything (cacheable pages go
        to the prefix cache), reset progress; the scheduler re-queues.

        ``cache=False`` is required when the victim has a step IN FLIGHT on
        the device (async scheduling): the dispatch is still mutating the
        victim's live state page past the position its boundary hash
        describes, so releasing it to the prefix cache would poison later
        hits with content from a longer prefix than the hash claims."""
        self.free_request(req, cache=cache)
        req.num_computed = 0
        req.prefix_hit_tokens = 0
        req.page_tables.clear()
        req.page_hashes.clear()
        req.state_pages.clear()
        req.ckpt_pages.clear()
        req.num_cached_pages.clear()

    # ------------------------------------------- prefill->decode handoff
    def _export_pages(self, export: PageSetExport):
        """Yield (type, eid) for every live page an export references, in a
        deterministic order."""
        for name in sorted(export.page_tables):
            for eid in export.page_tables[name]:
                if eid != SequenceState.FREED:
                    yield name, eid
        for name in sorted(export.state_pages):
            yield name, export.state_pages[name]
        for name in sorted(export.ckpt_pages):
            cks = export.ckpt_pages[name]
            for pos in sorted(cks):
                yield name, cks[pos]

    def export_request(self, req: SequenceState) -> PageSetExport:
        """Snapshot ``req``'s typed page set for a prefill->decode handoff.

        The request must be quiet (no in-flight steps). Pages stay USED and
        owned by ``req`` on this manager — the copy stream still reads them
        — but the sanitizer moves them to IN_TRANSIT so freeing, caching or
        re-exporting before ``release_export``/``cancel_export`` is caught,
        and an abandoned export shows up as lost-in-transit at drain."""
        aux = self._ensure_aux(req)
        export = PageSetExport(
            rid=req.rid,
            num_tokens=req.num_computed,
            page_tables={k: list(v) for k, v in req.page_tables.items()},
            page_hashes={k: list(v) for k, v in req.page_hashes.items()},
            num_cached_pages=dict(req.num_cached_pages),
            state_pages=dict(req.state_pages),
            ckpt_pages={k: dict(v) for k, v in req.ckpt_pages.items()},
            token_chain={k: list(v) for k, v in aux.token_chain.items()},
            mm_chain={k: list(v) for k, v in aux.mm_chain.items()},
            state_chain={k: list(v) for k, v in aux.state_chain.items()},
            state_boundary_hash={
                k: dict(v) for k, v in aux.state_boundary_hash.items()},
        )
        for name, eid in self._export_pages(export):
            self.pools[name].mark_exported(eid, req.rid)
        self.handoff_exports += 1
        return export

    def adopt_request(self, req: SequenceState,
                      export: PageSetExport) -> Tuple[bool, List[Tuple[str, int, int]]]:
        """Install an exported page set into THIS manager's pools so ``req``
        resumes as a whole-prompt prefix hit (§5.2): fresh pages are
        allocated mirroring the export's tables, full-page / boundary hashes
        are registered in this manager's prefix cache, and the hash-chain
        aux is rebuilt from the export so decode keeps extending the chains
        exactly where the source stopped.

        Returns ``(ok, pairs)`` where ``pairs`` lists ``(type, src_eid,
        dst_eid)`` device copies the caller must perform against the SOURCE
        engine's buffers. Transactional: on pool exhaustion every allocation
        is rolled back, ``req`` is cleared, and ``(False, [])`` returns.

        Deliberately bypasses the fresh-page zeroing queue: the handoff copy
        fills each page before its first dispatch, and a later zeroing pass
        would destroy the adopted content."""
        assert req.rid == export.rid
        now = self.tick()
        journal: List[Tuple[TypedPool, int]] = []
        pairs: List[Tuple[str, int, int]] = []

        def rollback() -> Tuple[bool, List[Tuple[str, int, int]]]:
            for pool, eid in reversed(journal):
                pool.free(eid)
            req.page_tables.clear()
            req.page_hashes.clear()
            req.state_pages.clear()
            req.ckpt_pages.clear()
            req.num_cached_pages.clear()
            self._aux.pop(req.rid, None)
            return False, []

        caching = self.enable_prefix_caching
        for spec in self.specs:
            name, pool = spec.name, self.pools[spec.name]
            if spec.kind in STATE_KINDS:
                src_live = export.state_pages.get(name)
                if src_live is None:
                    continue
                live = pool.allocate(req.rid)
                if live is None:
                    return rollback()
                journal.append((pool, live))
                req.state_pages[name] = live
                pool.pages[live].last_access = now
                pairs.append((name, src_live, live))
                bh = export.state_boundary_hash.get(name, {})
                req.ckpt_pages.setdefault(name, {})
                cks = export.ckpt_pages.get(name, {})
                for pos in sorted(cks):
                    ck = pool.allocate(req.rid)
                    if ck is None:
                        return rollback()
                    journal.append((pool, ck))
                    req.ckpt_pages[name][pos] = ck
                    pool.pages[ck].last_access = now
                    h = bh.get(pos)
                    if caching and h is not None:
                        pool.register_hash(ck, h)
                    pairs.append((name, cks[pos], ck))
            else:  # token + mm kinds
                table = export.page_tables.get(name, [])
                hlist = export.page_hashes.get(name, [])
                new_table: List[int] = []
                for i, src_eid in enumerate(table):
                    if src_eid == SequenceState.FREED:
                        new_table.append(SequenceState.FREED)
                        continue
                    eid = pool.allocate(req.rid)
                    if eid is None:
                        return rollback()
                    journal.append((pool, eid))
                    new_table.append(eid)
                    pool.pages[eid].last_access = now
                    h = hlist[i] if i < len(hlist) else None
                    if caching and h is not None:
                        pool.register_hash(eid, h)
                    pairs.append((name, src_eid, eid))
                req.page_tables[name] = new_table
                req.page_hashes[name] = list(hlist)
                req.num_cached_pages[name] = export.num_cached_pages.get(name, 0)
        # rebuild hash-chain aux so decode continues the chains verbatim
        self._aux.pop(req.rid, None)
        aux = self._ensure_aux(req)
        aux.token_chain = {k: list(v) for k, v in export.token_chain.items()}
        aux.mm_chain = {k: list(v) for k, v in export.mm_chain.items()}
        aux.state_chain = {k: list(v) for k, v in export.state_chain.items()}
        aux.state_boundary_hash = {
            k: dict(v) for k, v in export.state_boundary_hash.items()}
        req.num_computed = export.num_tokens
        req.prefix_hit_tokens = export.num_tokens
        req.last_access = now
        self.handoff_adopted += 1
        self.handoff_pages_adopted += len(pairs)
        return True, pairs

    def release_export(self, req: SequenceState, export: PageSetExport) -> None:
        """Destination adopted the page set: return the exported pages to
        plain USED ownership, then retire the source copy of the request —
        token and state pages enter THIS manager's prefix cache exactly as
        a normal completion would, so future shared-prompt arrivals still
        hit on the prefill shard."""
        for name, eid in self._export_pages(export):
            self.pools[name].mark_export_done(eid)
        self.free_request(req, cache=True, cache_state=True)

    def cancel_export(self, export: PageSetExport) -> None:
        """Adoption failed (destination pool pressure) or the destination
        died mid-handoff: lift the IN_TRANSIT marks; the source keeps owning
        and running the request as if the export never happened."""
        for name, eid in self._export_pages(export):
            self.pools[name].mark_export_done(eid)

    # --------------------------------------------------------------- queries
    def block_table(self, req: SequenceState, type_name: str) -> List[int]:
        return req.page_tables.get(type_name, [])

    def memory_stats(self) -> MemoryStats:
        per_type = {}
        for name, pool in self.pools.items():
            c = pool.counts()
            per_type[name] = TypeStats(
                page_units=pool.spec.page_units,
                used=c["used"],
                evictable=c["evictable"],
                empty=c["empty"],
                owned_large=c["owned_large"],
            )
        return MemoryStats(
            total_units=self.geometry.total_units,
            large_page_units=self.geometry.large_page_units,
            free_large=self.large_alloc.num_free,
            evictable_large=self.large_alloc.num_evictable,
            per_type=per_type,
        )

    def check_invariants(self) -> None:
        self.large_alloc.check_invariants()
        owned = set()
        for pool in self.pools.values():
            pool.check_invariants()
            assert not (owned & pool.owned_large)
            owned |= pool.owned_large
        free = self.large_alloc._free_set
        assert not (owned & free)
        assert len(owned) + len(free) == self.geometry.num_large_pages
        if self.sanitizer is not None:
            self.sanitizer.verify(self.pools)
