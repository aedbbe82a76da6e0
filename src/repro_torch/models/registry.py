"""Config -> model (``repro/models/registry.py``) for every family."""
from __future__ import annotations

from typing import Optional

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .hybrid import HybridLM
from .lm import DecoderLM
from .rwkv_lm import RWKVLM
from .tp import Dist


def build_model(cfg: ModelConfig, dist: Optional[Dist] = None):
    """The port's model for ``cfg``: ``DecoderLM`` (dense, moe, vlm),
    ``HybridLM`` (hybrid), ``RWKVLM`` (ssm) or ``EncDecLM`` (encdec), on
    one device or on the ``(data, model)`` (or ``(pod, data, model)``)
    mesh of ``dist``."""
    dist = dist or Dist()
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, dist)
    if cfg.family == "hybrid":
        return HybridLM(cfg, dist)
    if cfg.family == "ssm":
        return RWKVLM(cfg, dist)
    if cfg.family == "encdec":
        return EncDecLM(cfg, dist)
    raise NotImplementedError(f"family {cfg.family!r}")
