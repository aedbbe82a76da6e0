"""Alias module for the dbrx_132b assigned architecture config."""
from .archs import DBRX_132B as CONFIG

CONFIG = CONFIG
