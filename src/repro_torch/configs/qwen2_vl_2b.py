"""Alias module for the qwen2_vl_2b assigned architecture config."""
from .archs import QWEN2_VL_2B as CONFIG

CONFIG = CONFIG
