"""Alias module for the h2o_danube_3_4b assigned architecture config."""
from .archs import H2O_DANUBE3_4B as CONFIG

CONFIG = CONFIG
