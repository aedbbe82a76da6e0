"""Alias module for the whisper_tiny assigned architecture config."""
from .archs import WHISPER_TINY as CONFIG

CONFIG = CONFIG
