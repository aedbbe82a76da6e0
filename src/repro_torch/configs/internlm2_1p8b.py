"""Alias module for the internlm2_1p8b assigned architecture config."""
from .archs import INTERNLM2_1P8B as CONFIG

CONFIG = CONFIG
