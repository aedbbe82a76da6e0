"""Alias module for the qwen3_moe_235b_a22b assigned architecture config."""
from .archs import QWEN3_MOE_235B as CONFIG

CONFIG = CONFIG
