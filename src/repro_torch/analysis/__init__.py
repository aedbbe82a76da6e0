"""Serving-invariant tooling: the ``jengalint`` static checks (host syncs
on the dispatch path, nondeterminism in replay-critical modules, allocator
transactionality, compile/capture hygiene; ``scripts/run_lint_torch.py``)
and the PageSan page-lifecycle sanitizer."""
from .jengalint import Violation, lint_file, lint_source, lint_tree
from .pagesan import PageSanError, PageSanitizer, sanitizer_enabled

__all__ = ["PageSanError", "PageSanitizer", "Violation", "lint_file",
           "lint_source", "lint_tree", "sanitizer_enabled"]
