from .lm import DecodeBatch, DecoderLM
from .params import params_from_numpy

__all__ = ["DecodeBatch", "DecoderLM", "params_from_numpy"]
