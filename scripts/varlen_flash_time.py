#!/usr/bin/env python3
"""Time the varlen flash kernel of a checkout on one GPU: its device time
on ``chip_smoke.py``'s phase-2 packed streams.

    python3 scripts/varlen_flash_time.py [--tree PATH]

The cases, their inputs and the timer come from this checkout's
``chip_smoke.py``; ``repro_torch`` comes from the checkout at ``--tree``
(default: this one), so two commits compare in one call by running the
script once per checkout in turns. A case whose head dim the tree's
wrapper does not take is skipped. Prints the card's name and power limit
beside the numbers.
"""
from __future__ import annotations

import argparse
import pathlib
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

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    if not torch.cuda.is_available():
        print("varlen_flash_time: no CUDA device is available",
              file=sys.stderr)
        return 1
    print(f"[varlen] kernel {K.__file__}; card: {cs.card()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for case in cs.kernel_cases():
        q, k, v, meta, token = cs._varlen_inputs(case, rng, dev)
        if q.shape[-1] not in K._HEAD_DIMS:
            print(f"[varlen] {case['name']}: head dim {q.shape[-1]} not "
                  f"taken", flush=True)
            continue
        tiles = K.varlen_kv_tiles(meta[1], meta[3])
        args_ = token or (q, k, v)

        def call():
            return K.flash_attention_varlen(*args_, *meta,
                                            window=case["window"],
                                            kv_tiles=tiles)

        ms = cs.device_ms(call, "varlen_flash_kernel")
        print(f"[varlen] {case['name']}: device_ms={ms:.4f}", flush=True)
        del q, k, v, token
    return 0


if __name__ == "__main__":
    sys.exit(main())
