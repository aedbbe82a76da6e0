"""Unified KV-buffer layout — the paper's page-layer partition (Fig. 7b/7c);
torch twin of the reference's ``core/layout.py``.

One bf16 buffer of whole large pages per (model-parallel) device slice
holds all layer types. A type-t small page has exec id ``large_id*spp_t +
slot`` (``spp_t = geometry.small_pages_per_large``) and starts at unit
``exec_id * stride_t``, with ``stride_t = large_page_units // spp_t``:

* under the LCM geometry ``stride_t`` is the page's own ``S_t`` units, so
  the type's view is the free reshape
  ``buffer.reshape(total_units // S_t, *type_shape)`` (Fig. 7c);
* under the MAX geometry (§4.4's baseline) one small page fills a large
  page, so ``stride_t`` is the large page and a smaller type's pages are
  strided views, each padded to the large page (never copied).

Unmodified paged kernels index ``view[exec_id, layer, ...]`` exactly like
PagedAttention with a per-type ``start_ptr/page_size`` (Fig. 7c); every
device-side address of the port goes through ``PageView`` and
``page_view`` / ``page_rows`` below. The reference addresses page ``eid``
at ``eid * S_t`` under both geometries, so its MAX pages of different
types overlap; the port does not copy that.

TP note: the buffer is allocated per model-parallel shard with the KV-head
dim already divided, so the geometry below is constructed from *local* head
counts; exec page ids are identical on every shard (the allocator is
host-side and global). A mesh rank keeps the LCM stride.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .spec import KVCacheSpec, PageGeometry


class PageView(tuple):
    """A layer type's view shape ``(VP, L, *page_shape)`` over the flat
    unified buffer, with ``stride``: the units from the start of one of its
    pages to the next (at least the page's own units). It is a tuple of the
    shape, so a plain shape tuple reads as contiguous pages (the LCM
    geometry's stride), and it compares equal to another view shape only
    where both the shape and the stride are the same; ``page_view`` gives
    the tensor."""

    def __new__(cls, shape, stride: Optional[int] = None):
        self = super().__new__(cls, shape)
        self.stride = self.page_units if stride is None else int(stride)
        if self.stride < self.page_units:
            raise ValueError(f"pages of {self.page_units}u at a stride of "
                             f"{self.stride}u overlap")
        return self

    @property
    def page_units(self) -> int:
        return math.prod(self[1:])

    def __eq__(self, other):
        return tuple.__eq__(self, other) is True and \
            page_stride(self) == page_stride(other)

    def __ne__(self, other):
        return not self == other

    __hash__ = tuple.__hash__


def page_stride(view_shape) -> int:
    """The page stride of a ``PageView``, or of a plain shape tuple (its
    contiguous pages)."""
    stride = getattr(view_shape, "stride", None)
    return math.prod(view_shape[1:]) if stride is None else stride


def page_view(buf: torch.Tensor, view_shape) -> torch.Tensor:
    """The tensor view ``view_shape`` (a ``PageView`` or a plain shape)
    names over the flat contiguous ``buf``: one ``as_strided`` view, its
    pages ``page_stride`` units apart and each page's own units
    contiguous (the LCM geometry's reshape; under MAX each page padded to
    its stride), never a copy. Writes through it land in ``buf``."""
    shape = tuple(view_shape)
    stride = page_stride(view_shape)
    inner = [1]
    for n in reversed(shape[2:]):
        inner.insert(0, inner[0] * n)
    end = (shape[0] - 1) * stride + math.prod(shape[1:])
    if buf.dim() != 1 or buf.stride(0) != 1 or end > buf.shape[0]:
        raise ValueError(f"a view {shape} at a page stride of {stride}u "
                         f"needs a flat contiguous buffer of {end}u; got "
                         f"{tuple(buf.shape)} at {tuple(buf.stride())}")
    return buf.as_strided(shape, (stride, *inner))


def page_rows(buf: torch.Tensor, pages: int, stride: int,
              units: int) -> torch.Tensor:
    """``(pages, units)`` rows of the flat ``buf``, one a page, ``stride``
    units apart: a strided view, never a copy."""
    return page_view(buf, PageView((pages, units), stride))


def geometry_stride(geometry: PageGeometry, spec: KVCacheSpec) -> int:
    """The addressing rule: a type's pages sit ``large_page_units //
    small_pages_per_large`` units apart (its page units under "lcm", the
    large page under "max")."""
    return geometry.large_page_units // geometry.small_pages_per_large(spec)


def check_stride(spec: KVCacheSpec, stride: int, total: int) -> None:
    """Raise unless a buffer of ``total`` units holds whole pages of
    ``spec`` at ``stride`` (``geometry_stride``)."""
    if stride < spec.page_units or total % stride:
        raise ValueError(
            f"{spec.name}: pages of {spec.page_units}u at a stride of "
            f"{stride}u do not tile a buffer of {total}u: a geometry lays "
            "each type's pages large_page_units // small_pages_per_large "
            "units apart over whole large pages")


@dataclasses.dataclass(frozen=True)
class TypeView:
    """How to view the unified buffer for one layer type."""

    spec: KVCacheSpec
    view_shape: PageView          # (virtual_pages, num_layers, *page_shape)
    page_shape: Tuple[int, ...]   # per-layer shape inside a small page

    @property
    def virtual_pages(self) -> int:
        return self.view_shape[0]

    @property
    def stride(self) -> int:
        return self.view_shape.stride


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
    """Derives every type's view over one unified buffer at its
    ``geometry_stride``. ``page_shapes`` names each type's per-layer shape
    (a type it leaves out is viewed as flat rows); ``scratch`` large pages
    follow the pool (the runner keeps one, where dropped writes land), so
    a view's VP counts the pool's and the scratch's pages."""

    def __init__(self, geometry: PageGeometry,
                 page_shapes: Dict[str, Tuple[int, ...]], scratch: int = 0):
        self.geometry = geometry
        self.scratch = scratch
        self.views: Dict[str, TypeView] = {}
        large = geometry.num_large_pages + scratch
        for spec in geometry.specs:
            shape = tuple(page_shapes.get(
                spec.name, (spec.page_units // spec.num_layers,)))
            assert math.prod(shape) * spec.num_layers == spec.page_units, (
                spec.name, shape, spec.page_units)
            spp = geometry.small_pages_per_large(spec)
            self.views[spec.name] = TypeView(
                spec=spec,
                view_shape=PageView((large * spp, spec.num_layers) + shape,
                                    geometry_stride(geometry, spec)),
                page_shape=shape,
            )

    @property
    def total_units(self) -> int:
        """The pool's units (the geometry's large pages)."""
        return self.geometry.total_units

    @property
    def buffer_units(self) -> int:
        """The buffer's units: the pool and the scratch pages."""
        return self.geometry.large_page_units * (
            self.geometry.num_large_pages + self.scratch)

    def stride(self, type_name: str) -> int:
        return self.views[type_name].stride

    def alloc_buffer(self, device, dtype=torch.bfloat16) -> torch.Tensor:
        """The flat zeroed unified buffer on ``device``."""
        return torch.zeros((self.buffer_units,), dtype=dtype, device=device)

    def view(self, buffer, type_name: str):
        """One layer type's view of the unified buffer (free: a reshape
        under "lcm", a strided view under "max")."""
        return page_view(buffer, self.views[type_name].view_shape)

    def rows(self, buffer, type_name: str):
        """One layer type's pages as ``(VP, page_units)`` rows of the
        buffer at its stride (page copies and zeroing)."""
        tv = self.views[type_name]
        return page_rows(buffer, tv.virtual_pages, tv.stride,
                         tv.spec.page_units)

    def flatten(self, view, type_name: str):
        """Inverse of :meth:`view`: the flat buffer the view was taken of."""
        del type_name
        return view.as_strided((self.buffer_units,), (1,),
                               view.storage_offset())

    def exec_capacity(self, type_name: str) -> int:
        """Max exec page id + 1 addressable for this type (virtual pages)."""
        return self.views[type_name].virtual_pages
