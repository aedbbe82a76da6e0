"""Stable hashing for prefix-cache chains (Jenga §5).

Pages are keyed by a chain hash over the request's *key stream*: token ids for
text positions, ``mix(mm_hash, offset)`` for positions inside a multi-modal
item (image patches are not tokens — their content hash identifies them).

State types (Mamba/RWKV) key snapshots by the chain hash at the checkpoint
position. All hashes are stable 64-bit values (splitmix64 mixing), so tests
and replays are deterministic across processes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .request import MMItem

_MASK = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer."""
    x &= _MASK
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def combine(h: int, v: int) -> int:
    return mix64(h ^ mix64(v))


def salt_of(name: str) -> int:
    h = 0xCBF29CE484222325
    for ch in name.encode():
        h = ((h ^ ch) * 0x100000001B3) & _MASK
    return h


def key_stream(tokens: Sequence[int], mm_items: Sequence[MMItem]) -> List[int]:
    """Per-position content keys (text token id, or mm-content key)."""
    keys = [int(t) for t in tokens]
    for it in mm_items:
        for off in range(it.length):
            pos = it.start + off
            if pos < len(keys):
                keys[pos] = combine(it.mm_hash, off)
    return keys


def page_chain_hashes(
    keys: Sequence[int], tokens_per_page: int, salt: int
) -> List[int]:
    """Chain hash per FULL page: h_i = H(salt, h_{i-1}, keys of page i)."""
    out: List[int] = []
    h = salt
    n_full = len(keys) // tokens_per_page
    for i in range(n_full):
        for k in keys[i * tokens_per_page : (i + 1) * tokens_per_page]:
            h = combine(h, k)
        out.append(h)
    return out


def prefix_hash(keys: Sequence[int], upto: int, salt: int) -> int:
    """Chain hash over keys[:upto] — snapshot key for state types."""
    h = salt
    for k in keys[:upto]:
        h = combine(h, k)
    return h


def mm_stream_page_hashes(
    mm_items: Sequence[MMItem], tokens_per_page: int, salt: int,
    upto_pos: Optional[int] = None,
) -> List[int]:
    """Chain hashes over the *storage stream* of vision/cross types: the
    concatenation of mm items (text positions store nothing there).

    If ``upto_pos`` is given, only storage tokens at main-sequence position
    < upto_pos are included (used when consuming partial prompts)."""
    keys: List[int] = []
    for it in mm_items:
        for off in range(it.length):
            if upto_pos is not None and it.start + off >= upto_pos:
                break
            keys.append(combine(it.mm_hash, off))
    return page_chain_hashes(keys, tokens_per_page, salt)
