"""Config -> model (``repro/models/registry.py``) for the families the
port serves."""
from __future__ import annotations

from ..configs.base import ModelConfig
from .hybrid import HybridLM
from .lm import DecoderLM


def build_model(cfg: ModelConfig):
    """The port's model for ``cfg``: ``DecoderLM`` (dense, moe, vlm) or
    ``HybridLM`` (hybrid). Other families (ssm, encdec) are later slices
    and raise."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r}: the port serves dense, moe, vlm and hybrid")
