from .hybrid import HybridLM
from .lm import DecodeBatch, DecoderLM
from .params import params_from_numpy
from .registry import build_model

__all__ = ["DecodeBatch", "DecoderLM", "HybridLM", "build_model",
           "params_from_numpy"]
