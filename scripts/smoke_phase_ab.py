"""Time chip_smoke phases of two source trees in turns, on one card.

    python3 scripts/smoke_phase_ab.py OLD_TREE NEW_TREE \
        [--phases phase_engine phase_hybrid_engine] [--order ABBA]

Each tree is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory). For every letter
of ``--order`` (A: OLD_TREE, B: NEW_TREE) a fresh process runs that tree's
``chip_smoke.phase_env()`` (which builds its kernels) and then each named
phase, printing the phase's ``[... mode=...]`` leg lines and its wall
seconds. Compare the two trees only within one call: host-bound serving
phases move by tens of percent between calls.
"""
from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

RUN = """
import sys, time
sys.path.insert(0, ".")
import chip_smoke as cs
cs.phase_env()
for name in sys.argv[1:]:
    t0 = time.perf_counter()
    getattr(cs, name)()
    cs.log(f"[ab] {name}: {time.perf_counter() - t0:.1f} s")
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--phases", nargs="+",
                    default=["phase_engine", "phase_hybrid_engine"])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    trees = {"A": pathlib.Path(args.old), "B": pathlib.Path(args.new)}
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    keep = re.compile(r"\[ab\]|mode=.*wall_s")
    for i, side in enumerate(args.order, 1):
        log = out / f"ab_{i}_{side}.log"
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "-c", RUN, *args.phases],
                                cwd=trees[side], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        print(f"== run {i}: {side} ({trees[side]}), rc {rc}", flush=True)
        for line in log.read_text().splitlines():
            if keep.search(line):
                print(re.sub(r"(mean_step_ms=[0-9.]+).*", r"\1", line))
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
