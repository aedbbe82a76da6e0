"""Core sequence state shared by the allocator and the serving engine."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MMItem:
    """One multi-modal item (image / audio segment) embedded in the token
    stream: tokens [start, start+length) are its placeholder positions.
    ``mm_hash`` identifies the content (drives vision/cross-attn caching)."""

    start: int
    length: int
    mm_hash: int


@dataclasses.dataclass
class SequenceState:
    """Host-side state of one sequence for the Jenga manager.

    ``page_tables[type]`` is the ordered small-page exec-id list for
    token-storage types (full_attn / swa / vision_embed / cross_attn);
    entries may be ``FREED`` (-1) once e.g. a sliding window passed them.
    ``state_pages[type]`` is the live recurrent-state page of state types;
    ``ckpt_pages[type][pos]`` are state snapshots at token position ``pos``.

    Delta protocol for device-side mirrors (the serving ModelRunner keeps
    persistent per-request block-table arrays and updates them incrementally
    instead of rebuilding O(pages) state per step):
      * appends are discovered by comparing mirrored length to
        ``len(page_tables[type])`` (the manager only ever appends);
      * mid-table frees (sliding-window retirement, vision free-on-consume)
        are published to the append-only ``freed_events`` log;
      * trailing pops (speculative-decode rollback under async scheduling)
        are published to ``trim_events`` as (type, new_length) — a mirror
        replays them as in-order length clamps, so a table that shrinks and
        regrows to the same length still re-syncs its tail correctly;
      * ``epoch`` is bumped whenever the tables are invalidated wholesale
        (request free / preemption) — a mirror with a stale epoch rebuilds.
    """

    FREED = -1

    rid: str
    tokens: List[int]
    mm_items: Tuple[MMItem, ...] = ()
    # Encoder-decoder models (Whisper-style): encoder frames form a separate
    # storage stream for cross-attention KV; ``start`` is the offset in that
    # stream, not in ``tokens``.
    encoder_items: Tuple[MMItem, ...] = ()
    num_computed: int = 0
    page_tables: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    page_hashes: Dict[str, List[Optional[int]]] = dataclasses.field(default_factory=dict)
    state_pages: Dict[str, int] = dataclasses.field(default_factory=dict)
    ckpt_pages: Dict[str, Dict[int, int]] = dataclasses.field(default_factory=dict)
    # number of leading pages per type that came from the prefix cache
    num_cached_pages: Dict[str, int] = dataclasses.field(default_factory=dict)
    prefix_hit_tokens: int = 0
    last_access: int = 0
    # mirror-delta protocol (see class docstring)
    epoch: int = 0
    freed_events: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    trim_events: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)

    def mark_freed(self, type_name: str, idx: int) -> None:
        """Set a page-table entry to FREED and publish the delta."""
        self.page_tables[type_name][idx] = self.FREED
        self.freed_events.append((type_name, idx))

    def mark_trimmed(self, type_name: str) -> None:
        """Publish that trailing entries were popped from a table
        (speculative rollback): mirrors clamp their synced length to the
        table's current length before re-appending."""
        self.trim_events.append((type_name, len(self.page_tables[type_name])))

    def bump_epoch(self) -> None:
        self.epoch += 1
        self.freed_events.clear()
        self.trim_events.clear()

    def append_token(self, tok: int) -> None:
        self.tokens.append(tok)

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)

    def live_pages(self, type_name: str) -> List[int]:
        return [p for p in self.page_tables.get(type_name, []) if p != self.FREED]

    def is_image_pos(self, i: int) -> bool:
        return any(it.start <= i < it.start + it.length for it in self.mm_items)
