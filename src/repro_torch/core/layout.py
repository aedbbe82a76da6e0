"""Unified KV-buffer layout — the paper's page-layer partition (Fig. 7b/7c);
torch twin of the reference's ``core/layout.py``.

One bf16 buffer of ``total_units`` per (model-parallel) device slice holds all
layer types. A type-t small page of ``S_t`` units at unit offset
``large_id*LCM + slot*S_t`` has exec id ``large_id*spp_t + slot`` inside the
reshape view ``buffer.reshape(total_units // S_t, *type_shape)`` — reshapes
are free views in torch, so unmodified paged kernels index ``view[exec_id, layer, ...]``
exactly like PagedAttention with a per-type ``start_ptr/page_size`` (Fig. 7c).

TP note: the buffer is allocated per model-parallel shard with the KV-head
dim already divided, so the geometry below is constructed from *local* head
counts; exec page ids are identical on every shard (the allocator is
host-side and global).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .spec import KVCacheSpec, PageGeometry


@dataclasses.dataclass(frozen=True)
class TypeView:
    """How to view the unified buffer for one layer type."""

    spec: KVCacheSpec
    view_shape: Tuple[int, ...]   # (virtual_pages, num_layers, *page_shape)
    page_shape: Tuple[int, ...]   # per-layer shape inside a small page

    @property
    def virtual_pages(self) -> int:
        return self.view_shape[0]


def attention_page_shape(spec: KVCacheSpec, kv_heads: int, head_dim: int
                         ) -> Tuple[int, ...]:
    """(2, tokens_per_page, kv_heads, head_dim) — K and V stacked, head_dim
    innermost (contiguous rows of one token's K or V)."""
    assert spec.units_per_token_per_layer == 2 * kv_heads * head_dim, (
        spec, kv_heads, head_dim)
    return (2, spec.tokens_per_page, kv_heads, head_dim)


def state_page_shape(spec: KVCacheSpec) -> Tuple[int, ...]:
    """Flat per-layer state vector (conv+ssm or att+shift concatenated)."""
    return (spec.units_per_token_per_layer,)


def vision_page_shape(spec: KVCacheSpec) -> Tuple[int, ...]:
    return (spec.tokens_per_page, spec.units_per_token_per_layer)


class UnifiedLayout:
    """Derives every type's reshape view over one unified buffer."""

    def __init__(self, geometry: PageGeometry,
                 page_shapes: Dict[str, Tuple[int, ...]]):
        self.geometry = geometry
        self.views: Dict[str, TypeView] = {}
        total = geometry.total_units
        for spec in geometry.specs:
            shape = page_shapes[spec.name]
            per_layer = 1
            for d in shape:
                per_layer *= d
            assert per_layer * spec.num_layers == spec.page_units, (
                spec.name, shape, spec.page_units)
            vpages = total // spec.page_units
            self.views[spec.name] = TypeView(
                spec=spec,
                view_shape=(vpages, spec.num_layers) + shape,
                page_shape=shape,
            )

    @property
    def total_units(self) -> int:
        return self.geometry.total_units

    def alloc_buffer(self, device, dtype=torch.bfloat16) -> torch.Tensor:
        """The flat zeroed unified buffer on ``device``."""
        return torch.zeros((self.total_units,), dtype=dtype, device=device)

    def view(self, buffer, type_name: str):
        """Free reshape view of the unified buffer for one layer type."""
        tv = self.views[type_name]
        return buffer.reshape(tv.view_shape)

    def flatten(self, view, type_name: str):
        """Inverse of :meth:`view`."""
        del type_name
        return view.reshape(self.total_units)

    def exec_capacity(self, type_name: str) -> int:
        """Max exec page id + 1 addressable for this type (virtual pages)."""
        return self.views[type_name].virtual_pages
