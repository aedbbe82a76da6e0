"""Layer-type prefix-caching policies — the paper's ``LayerSupportsPrefixCache``
interface (Fig. 9) with the §5.3 customizations.

Each policy expresses, for its layer type:
  * ``update_last_access``   — which pages count as "accessed" this step
                               (balanced eviction, §5.1);
  * ``set_prefix_length``    — fine-grained eviction priority among pages with
                               equal timestamps (aligned eviction, §5.1);
  * ``get_possible_prefix``  — which main-sequence prefix lengths are valid
                               cache hits given per-token availability (§5.2).

``is_hit[i]`` means: the KV/state this type needs *for token i* is present in
this type's cache. Types that store nothing for a position (e.g. text tokens
in a vision-embedding cache) report ``True`` there vacuously.
"""
from __future__ import annotations

import random
from typing import TYPE_CHECKING, List, Optional, Set

from .request import SequenceState
from .spec import KVCacheSpec

if TYPE_CHECKING:  # pragma: no cover
    from .typed_pool import TypedPool


def _aligned_prefixes(n: int, align: int) -> List[int]:
    """Candidate page-aligned prefix lengths 0, align, 2*align, ... <= n."""
    return list(range(0, n + 1, align))


class LayerPolicy:
    """Base: full-prefix dependency (standard self-attention)."""

    def __init__(self, spec: KVCacheSpec):
        self.spec = spec

    # ------------------------------------------------------------- eviction
    def update_last_access(self, pool: "TypedPool", req: SequenceState, time: int) -> None:
        """Default: every live page of the request is accessed every step."""
        for eid in req.live_pages(self.spec.name):
            pool.pages[eid].last_access = time

    def set_prefix_length(self, pool: "TypedPool", req: SequenceState,
                          rng: Optional[random.Random] = None) -> None:
        """Default: ordinal position — later tokens evicted first (§5.1)."""
        for i, eid in enumerate(req.page_tables.get(self.spec.name, [])):
            if eid != SequenceState.FREED:
                pool.pages[eid].prefix_length = i

    # ------------------------------------------------------------ cache hit
    def get_possible_prefix(self, is_hit: List[bool], req: SequenceState) -> Set[int]:
        """Full attention: prefix p valid iff tokens [0, p) all hit."""
        tpp = self.spec.tokens_per_page
        out: Set[int] = {0}
        for p in _aligned_prefixes(len(is_hit), tpp):
            if p == 0:
                continue
            if all(is_hit[:p]):
                out.add(p)
            else:
                break
        return out

    # ------------------------------------------- in-flight page retirement
    def retire_pages(self, req: SequenceState) -> List[int]:
        """Page-table indices whose pages are no longer needed by the running
        request (Jenga frees them early; vLLM keeps them — Fig. 16 waste)."""
        return []


class FullAttentionPolicy(LayerPolicy):
    pass


class SlidingWindowPolicy(LayerPolicy):
    """§5.3: only the last ``window`` tokens matter."""

    def __init__(self, spec: KVCacheSpec):
        super().__init__(spec)
        if spec.sliding_window is None:
            raise ValueError("SWA spec needs sliding_window")
        self.window = spec.sliding_window

    def update_last_access(self, pool, req, time) -> None:
        tpp = self.spec.tokens_per_page
        lo_tok = max(0, req.num_computed - self.window)
        lo_page = lo_tok // tpp
        table = req.page_tables.get(self.spec.name, [])
        for eid in table[lo_page:]:
            if eid != SequenceState.FREED:
                pool.pages[eid].last_access = time

    def get_possible_prefix(self, is_hit: List[bool], req: SequenceState) -> Set[int]:
        """p valid iff tokens [max(0, p-window), p) all hit (page aligned)."""
        tpp = self.spec.tokens_per_page
        n = len(is_hit)
        # prefix-sum of hits for O(1) range checks
        ps = [0]
        for h in is_hit:
            ps.append(ps[-1] + (1 if h else 0))
        out: Set[int] = {0}
        for p in _aligned_prefixes(n, tpp)[1:]:
            lo = max(0, p - self.window)
            # the page containing lo must be intact from its start
            lo = (lo // tpp) * tpp
            if ps[p] - ps[lo] == p - lo:
                out.add(p)
        return out

    def retire_pages(self, req: SequenceState) -> List[int]:
        """Pages entirely below the window can be dropped mid-request."""
        tpp = self.spec.tokens_per_page
        lo_tok = max(0, req.num_computed - self.window)
        lo_page = lo_tok // tpp  # pages [0, lo_page) are fully out of window
        table = req.page_tables.get(self.spec.name, [])
        return [i for i in range(min(lo_page, len(table)))
                if table[i] != SequenceState.FREED]


class StateSpacePolicy(LayerPolicy):
    """Mamba/RWKV (§5.3): fixed-size recurrent state; snapshots cached every
    ``state_checkpoint_interval`` tokens; only the snapshot at the hit
    position is needed."""

    def __init__(self, spec: KVCacheSpec):
        super().__init__(spec)
        self.interval = spec.state_checkpoint_interval

    def update_last_access(self, pool, req, time) -> None:
        # Only the live state page + the latest checkpoint are "accessed".
        name = self.spec.name
        if name in req.state_pages:
            pool.pages[req.state_pages[name]].last_access = time
        ckpts = req.ckpt_pages.get(name, {})
        if ckpts:
            pool.pages[ckpts[max(ckpts)]].last_access = time

    def set_prefix_length(self, pool, req, rng=None) -> None:
        name = self.spec.name
        for pos, eid in req.ckpt_pages.get(name, {}).items():
            pool.pages[eid].prefix_length = pos
        if name in req.state_pages:
            pool.pages[req.state_pages[name]].prefix_length = req.num_computed

    def get_possible_prefix(self, is_hit: List[bool], req: SequenceState) -> Set[int]:
        """is_hit[i] == snapshot for prefix length i+1 is cached."""
        out: Set[int] = {0}
        for p in range(self.interval, len(is_hit) + 1, self.interval):
            if is_hit[p - 1]:
                out.add(p)
        return out


class VisionEmbedPolicy(LayerPolicy):
    """§5.3: evict whole images — randomized per-image priority; an image is
    hit only if every one of its pages is cached; prefixes may not split a
    partially-cached image."""

    def update_last_access(self, pool, req, time) -> None:
        for eid in req.live_pages(self.spec.name):
            pool.pages[eid].last_access = time

    def set_prefix_length(self, pool, req, rng=None) -> None:
        rng = rng or random.Random(0)
        name = self.spec.name
        table = req.page_tables.get(name, [])
        tpp = self.spec.tokens_per_page
        # storage stream = concatenated mm items; map pages -> item index
        bounds = []  # (item_idx, first_storage_tok, last_storage_tok)
        off = 0
        items = req.encoder_items or req.mm_items
        for idx, it in enumerate(items):
            bounds.append((idx, off, off + it.length))
            off += it.length
        pri = {idx: rng.randrange(1 << 30) for idx, _, _ in bounds}
        for pi, eid in enumerate(table):
            if eid == SequenceState.FREED:
                continue
            tok = pi * tpp
            for idx, lo, hi in bounds:
                if lo <= tok < hi:
                    pool.pages[eid].prefix_length = pri[idx]
                    break

    def get_possible_prefix(self, is_hit: List[bool], req: SequenceState) -> Set[int]:
        """``is_hit`` is indexed over this type's *storage stream* (the
        concatenation of mm items)."""
        valid_upto = len(req.tokens)
        off = 0
        for it in req.mm_items:
            span_hit = all(is_hit[off : off + it.length])
            off += it.length
            if not span_hit:
                valid_upto = min(valid_upto, it.start)
        return set(range(0, valid_upto + 1))


class CrossAttentionPolicy(VisionEmbedPolicy):
    """Encoder-KV cache for cross-attention layers.

    Two flavours: (a) in-stream items (Llama-3.2-Vision pattern, §3.2) —
    identical to the vision-embedding semantics; (b) a separate encoder
    stream (Whisper-style enc-dec) — the decoder needs the *entire* encoder
    KV at every step, so hits are all-or-nothing."""

    def get_possible_prefix(self, is_hit: List[bool], req: SequenceState) -> Set[int]:
        if req.encoder_items:
            total = sum(it.length for it in req.encoder_items)
            if all(is_hit[:total]):
                return set(range(0, len(req.tokens) + 1))
            return {0}
        return super().get_possible_prefix(is_hit, req)


POLICY_BY_KIND = {
    "full_attn": FullAttentionPolicy,
    "swa": SlidingWindowPolicy,
    "mamba": StateSpacePolicy,
    "rwkv": StateSpacePolicy,
    "vision_embed": VisionEmbedPolicy,
    "cross_attn": CrossAttentionPolicy,
}


def make_policy(spec: KVCacheSpec) -> LayerPolicy:
    try:
        cls = POLICY_BY_KIND[spec.kind]
    except KeyError:
        raise ValueError(f"no policy for layer kind {spec.kind!r}") from None
    return cls(spec)
