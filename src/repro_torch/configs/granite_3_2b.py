"""Alias module for the granite_3_2b assigned architecture config."""
from .archs import GRANITE3_2B as CONFIG

CONFIG = CONFIG
