"""Jenga core: two-level LCM memory allocation + customizable prefix caching.

Public API re-exports.
"""
from .lcm_allocator import LargePageAllocator
from .layout import (
    PageView,
    TypeView,
    UnifiedLayout,
    attention_page_shape,
    state_page_shape,
    vision_page_shape,
)
from .manager import (
    JengaKVCacheManager,
    MemoryStats,
    StateCopyOp,
)
from .policies import (
    CrossAttentionPolicy,
    FullAttentionPolicy,
    LayerPolicy,
    SlidingWindowPolicy,
    StateSpacePolicy,
    VisionEmbedPolicy,
    make_policy,
)
from .request import MMItem, SequenceState
from .spec import (
    BYTES_PER_UNIT,
    KVCacheSpec,
    PageGeometry,
    attention_spec,
    cross_attention_spec,
    make_geometry,
    mamba_spec,
    rwkv_spec,
    vision_embed_spec,
)
from .typed_pool import PageState, SmallPage, TypedPool

__all__ = [
    "BYTES_PER_UNIT",
    "CrossAttentionPolicy",
    "FullAttentionPolicy",
    "JengaKVCacheManager",
    "KVCacheSpec",
    "LargePageAllocator",
    "LayerPolicy",
    "MMItem",
    "MemoryStats",
    "PageGeometry",
    "PageState",
    "PageView",
    "SequenceState",
    "SlidingWindowPolicy",
    "SmallPage",
    "StateCopyOp",
    "StateSpacePolicy",
    "TypeView",
    "TypedPool",
    "UnifiedLayout",
    "VisionEmbedPolicy",
    "attention_page_shape",
    "attention_spec",
    "cross_attention_spec",
    "make_geometry",
    "make_policy",
    "mamba_spec",
    "rwkv_spec",
    "state_page_shape",
    "vision_embed_spec",
    "vision_page_shape",
]
