"""Alias module for the qwen2p5_32b assigned architecture config."""
from .archs import QWEN2P5_32B as CONFIG

CONFIG = CONFIG
