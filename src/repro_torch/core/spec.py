"""KV-cache specifications for heterogeneous layer types (Jenga §3-§4).

Every *layer type* in a model (full attention, sliding-window attention,
Mamba state, vision-embedding cache, cross-attention KV, ...) declares a
``KVCacheSpec``: how many storage *units* one small page occupies, how many
tokens a small page holds, and which prefix-caching policy governs it.

Units are bf16 elements (2 bytes), the native storage dtype of the unified
KV buffer.  All LCM math operates on unit counts, which is equivalent to the
paper's byte-level math up to the constant factor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

BYTES_PER_UNIT = 2  # bf16


def lcm(values: Sequence[int]) -> int:
    out = 1
    for v in values:
        out = math.lcm(out, int(v))
    return out


def gcd(values: Sequence[int]) -> int:
    out = 0
    for v in values:
        out = math.gcd(out, int(v))
    return out


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Memory spec for one layer *type* (a group of layers sharing a page size).

    Attributes:
      name: unique layer-type name, e.g. ``"full_attn"``, ``"swa"``,
        ``"mamba"``, ``"vision_embed"``, ``"cross_attn"``.
      kind: one of {"full_attn", "swa", "mamba", "vision_embed",
        "cross_attn", "rwkv"} — selects the default prefix-cache policy.
      num_layers: how many model layers belong to this type.
      tokens_per_page: tokens stored per small page (1 for state types:
        one Mamba/RWKV state snapshot is "one token" of storage).
      units_per_token_per_layer: bf16 units one token needs in ONE layer of
        this type (e.g. 2*kv_heads*head_dim for attention K+V).
      sliding_window: window size for kind=="swa".
      state_checkpoint_interval: for state types, cache a state snapshot
        every N tokens (paper §5.3 uses 512 for Mamba).
    """

    name: str
    kind: str
    num_layers: int
    tokens_per_page: int
    units_per_token_per_layer: int
    sliding_window: Optional[int] = None
    state_checkpoint_interval: int = 512

    @property
    def units_per_token(self) -> int:
        return self.units_per_token_per_layer * self.num_layers

    @property
    def page_units(self) -> int:
        """Small-page size in units (the paper's per-type page size)."""
        return self.units_per_token * self.tokens_per_page

    @property
    def page_bytes(self) -> int:
        return self.page_units * BYTES_PER_UNIT

    def pages_for_tokens(self, num_tokens: int) -> int:
        return -(-num_tokens // self.tokens_per_page)  # ceil div


def attention_spec(
    name: str,
    *,
    num_layers: int,
    kv_heads: int,
    head_dim: int,
    tokens_per_page: int = 16,
    kind: str = "full_attn",
    sliding_window: Optional[int] = None,
) -> KVCacheSpec:
    """K + V for ``num_layers`` attention layers."""
    return KVCacheSpec(
        name=name,
        kind=kind,
        num_layers=num_layers,
        tokens_per_page=tokens_per_page,
        units_per_token_per_layer=2 * kv_heads * head_dim,
        sliding_window=sliding_window,
    )


def mamba_spec(
    name: str,
    *,
    num_layers: int,
    conv_units: int,
    ssm_units: int,
    checkpoint_interval: int = 512,
) -> KVCacheSpec:
    """One Mamba state snapshot (conv state + SSM state) per 'token' of storage."""
    return KVCacheSpec(
        name=name,
        kind="mamba",
        num_layers=num_layers,
        tokens_per_page=1,
        units_per_token_per_layer=conv_units + ssm_units,
        state_checkpoint_interval=checkpoint_interval,
    )


def rwkv_spec(
    name: str,
    *,
    num_layers: int,
    att_state_units: int,
    shift_state_units: int,
    checkpoint_interval: int = 512,
) -> KVCacheSpec:
    return KVCacheSpec(
        name=name,
        kind="rwkv",
        num_layers=num_layers,
        tokens_per_page=1,
        units_per_token_per_layer=att_state_units + shift_state_units,
        state_checkpoint_interval=checkpoint_interval,
    )


def vision_embed_spec(
    name: str, *, hidden_units: int, tokens_per_page: int = 16
) -> KVCacheSpec:
    """Vision embedding cache: one hidden vector per image token (Jenga §6.2)."""
    return KVCacheSpec(
        name=name,
        kind="vision_embed",
        num_layers=1,
        tokens_per_page=tokens_per_page,
        units_per_token_per_layer=hidden_units,
    )


def cross_attention_spec(
    name: str,
    *,
    num_layers: int,
    kv_heads: int,
    head_dim: int,
    tokens_per_page: int = 16,
) -> KVCacheSpec:
    """Encoder K/V consumed by cross-attention (image/audio tokens)."""
    return KVCacheSpec(
        name=name,
        kind="cross_attn",
        num_layers=num_layers,
        tokens_per_page=tokens_per_page,
        units_per_token_per_layer=2 * kv_heads * head_dim,
    )


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Derived two-level geometry for a set of specs (Jenga §4.1, §4.4)."""

    specs: tuple[KVCacheSpec, ...]
    large_page_units: int          # LCM of all small-page sizes
    num_large_pages: int           # pool capacity
    mode: str = "lcm"              # "lcm" | "max" | "gcd" (baselines §4.4)

    @property
    def total_units(self) -> int:
        return self.large_page_units * self.num_large_pages

    @property
    def total_bytes(self) -> int:
        return self.total_units * BYTES_PER_UNIT

    def small_pages_per_large(self, spec: KVCacheSpec) -> int:
        if self.mode == "max":
            # §4.4 MAX baseline: every small page is padded to the max
            # small-page size, i.e. one small page per large page.
            return 1
        if self.mode == "gcd":
            raise ValueError(
                "GCD pages split small pages across large pages; infeasible "
                "for real kernels (§4.4) — modeled analytically in benchmarks"
            )
        return self.large_page_units // spec.page_units

    def spec_by_name(self, name: str) -> KVCacheSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)


def make_geometry(
    specs: Sequence[KVCacheSpec],
    *,
    total_memory_bytes: int,
    mode: str = "lcm",
) -> PageGeometry:
    """Compute large-page size per §4.4 and fit the pool into the budget.

    mode="lcm" is Jenga; "max" pads every small page to the max small-page
    size (internal fragmentation baseline); "gcd" is analyzed analytically in
    the benchmarks (infeasible kernels, §4.4) but supported here for the
    allocator-level comparison.
    """
    if not specs:
        raise ValueError("at least one KVCacheSpec required")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate spec names: {names}")
    sizes = [s.page_units for s in specs]
    if mode == "lcm":
        large = lcm(sizes)
    elif mode == "max":
        large = max(sizes)
    elif mode == "gcd":
        large = gcd(sizes)
    else:
        raise ValueError(f"unknown geometry mode {mode!r}")
    total_units = total_memory_bytes // BYTES_PER_UNIT
    num_large = total_units // large
    if num_large <= 0:
        raise ValueError(
            f"memory budget {total_memory_bytes}B < one large page "
            f"({large * BYTES_PER_UNIT}B; mode={mode})"
        )
    return PageGeometry(
        specs=tuple(specs),
        large_page_units=large,
        num_large_pages=num_large,
        mode=mode,
    )
