"""Alias module for the zamba2_1p2b assigned architecture config."""
from .archs import ZAMBA2_1P2B as CONFIG

CONFIG = CONFIG
