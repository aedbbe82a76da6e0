"""Serving-invariant tooling: the PageSan page-lifecycle sanitizer."""
from .pagesan import PageSanError, PageSanitizer, sanitizer_enabled

__all__ = ["PageSanError", "PageSanitizer", "sanitizer_enabled"]
