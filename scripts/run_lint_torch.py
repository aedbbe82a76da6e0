#!/usr/bin/env python
"""Run the port's jengalint over the whole src/repro_torch tree.

Exit 0 when the tree is clean (every remaining host-sync / nondeterminism
/ allocation-lifecycle site carries a reviewed ``# jengalint: allow[...]``
waiver with a reason); exit 1 and print each violation otherwise. Imports
only ``repro_torch``, so it runs where JAX is not installed.

    python scripts/run_lint_torch.py                # lint the tree
    python scripts/run_lint_torch.py --list-waivers # audit the waivers
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.analysis import jengalint  # noqa: E402

if __name__ == "__main__":
    sys.exit(jengalint.main(sys.argv[1:]))
