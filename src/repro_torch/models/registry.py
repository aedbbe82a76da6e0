"""Config -> model (``repro/models/registry.py``) for every family."""
from __future__ import annotations

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .lm import DecoderLM
from .rwkv_lm import RWKVLM


def build_model(cfg: ModelConfig):
    """The port's model for ``cfg``: ``DecoderLM`` (dense, moe, vlm),
    ``HybridLM`` (hybrid), ``RWKVLM`` (ssm) or ``EncDecLM`` (encdec)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "ssm":
        return RWKVLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r}")
