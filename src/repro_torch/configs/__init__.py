"""Architecture configs (copied from the reference) + shapes."""
from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                   SHAPES_BY_NAME, TRAIN_4K, ModelConfig, ShapeSpec, reduced,
                   shapes_for)
from .archs import ARCHS, get_config

__all__ = [
    "ALL_SHAPES", "ARCHS", "DECODE_32K", "LONG_500K", "PREFILL_32K",
    "SHAPES_BY_NAME", "TRAIN_4K", "ModelConfig", "ShapeSpec", "get_config",
    "reduced", "shapes_for",
]
