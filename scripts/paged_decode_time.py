#!/usr/bin/env python3
"""Time the paged decode kernel of a checkout on one GPU: the host's cost
to issue one call and the kernel's device time on ``chip_smoke.py``'s
paged cases.

    python3 scripts/paged_decode_time.py [--tree PATH]

The cases, their inputs and the timers come from this checkout's
``chip_smoke.py``; ``repro_torch`` comes from the checkout at ``--tree``
(default: this one), so two commits compare in one call by running the
script once per checkout in turns. A wrapper that takes the step's plan
(``paged_decode_plan``) gets it built once per case, as the serve path
builds it once per step; an older wrapper, which takes none, is called
without; a case whose head dim the tree's wrapper does not take is
skipped. Prints the card's name and power limit beside the numbers.
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

    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import kernel as K

    if not torch.cuda.is_available():
        print("paged_decode_time: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    planned = hasattr(K, "paged_decode_plan")
    print(f"[paged] kernel {K.__file__} (plan: {planned}); card: {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(3)
    for case in cs.paged_cases():
        if case["d"] not in K._HEAD_DIMS:
            print(f"[paged] {case['name']}: head dim {case['d']} not taken",
                  flush=True)
            continue
        w = case.get("window", 0)
        q, pool, meta, _ = cs.paged_inputs(case, gen, rng, dev)
        n_layers, tpp = pool.shape[1], pool.shape[3]
        kw = dict(window=w)
        if planned:
            kw["plan"] = K.paged_decode_plan(*meta, tpp, w)
        layer = [0]

        def call():
            layer[0] = (layer[0] + 1) % n_layers
            return K.paged_decode_attention(q, pool[:, layer[0]], *meta,
                                            **kw)

        host = cs.host_issue_ms(call)
        ms = cs.device_ms(call, "paged_decode_kernel")
        print(f"[paged] {case['name']}: host_issue_ms={host:.4f} "
              f"device_ms={ms:.4f}", flush=True)
        del pool, kw
    return 0


if __name__ == "__main__":
    sys.exit(main())
