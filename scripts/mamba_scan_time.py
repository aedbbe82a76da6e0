#!/usr/bin/env python3
"""Time the Mamba2 chunk-scan kernel of a checkout on one GPU: the host's
cost to issue one call and the kernel's device time on ``chip_smoke.py``'s
phase-2c cases.

    python3 scripts/mamba_scan_time.py [--tree PATH]

The cases, their inputs and the timers come from this checkout's
``chip_smoke.py``; ``repro_torch`` comes from the checkout at ``--tree``
(default: this one), so two commits compare in one call by running the
script once per checkout in turns. Prints the card's name and power limit
beside the numbers.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose kernel to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts this checkout's src first
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve() / "src"))

    import torch

    from repro_torch.kernels.mamba_scan import kernel as K

    if not torch.cuda.is_available():
        print("mamba_scan_time: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[scan] kernel {K.__file__}; card: {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for case in cs.mamba_cases():
        name = case[0]
        scan_args = cs.mamba_inputs(case, gen, dev)

        def call():
            return K.mamba_chunk_scan_varlen(*scan_args)

        host = cs.host_issue_ms(call)
        ms = cs.device_ms(call, "mamba_scan_kernel")
        print(f"[scan] {name}: host_issue_ms={host:.4f} device_ms={ms:.4f}",
              flush=True)
        del scan_args
    return 0


if __name__ == "__main__":
    sys.exit(main())
