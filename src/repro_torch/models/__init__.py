from .encdec import EncDecLM
from .hybrid import HybridLM
from .lm import DecodeBatch, DecoderLM
from .params import params_from_numpy
from .registry import build_model
from .rwkv_lm import RWKVLM

__all__ = ["DecodeBatch", "DecoderLM", "EncDecLM", "HybridLM", "RWKVLM",
           "build_model", "params_from_numpy"]
