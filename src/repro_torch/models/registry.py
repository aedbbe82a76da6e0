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
    one device or, for the first two, on the ``(data, model)`` mesh of
    ``dist``. RWKV6 and enc-dec train on one device until their slice of
    the mesh is ported."""
    dist = dist or Dist()
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, dist)
    if cfg.family == "hybrid":
        return HybridLM(cfg, dist)
    if cfg.family in ("ssm", "encdec"):
        if dist.size > 1:
            raise NotImplementedError(
                f"family {cfg.family!r} runs on one device: its training "
                "across cards is a later slice of the port (ROADMAP queue 1)")
        return RWKVLM(cfg) if cfg.family == "ssm" else EncDecLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r}")
