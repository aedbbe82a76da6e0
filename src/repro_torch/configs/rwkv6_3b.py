"""Alias module for the rwkv6_3b assigned architecture config."""
from .archs import RWKV6_3B as CONFIG

CONFIG = CONFIG
