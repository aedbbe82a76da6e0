#!/usr/bin/env python3
"""The paged decode kernel's split and ring constants, swept on one GPU.

    python3 scripts/sweep_paged_split.py

``paged_decode_plan`` splits a row's visible pages into blocks of at least
``PAGES_PER_SPLIT`` pages (over at most ``max_splits(B)`` blocks, aiming at
``SPLIT_BLOCKS`` for the batch); ``head_group`` gives a block the largest
group of kv heads whose ring stage fits ``STAGE_BYTES`` and that leaves
``MIN_UNITS`` (row, head group) pairs; the ring takes ``RING_BYTES``
(``launch_shape``, cleared for each alternative). This
times the kernel (device time under ``torch.profiler``,
``chip_smoke.device_ms``) on every paged case of ``chip_smoke.py`` with
the chosen constants and with each alternative below, and prints one line
each with the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ALTERNATIVES = (
    {},
    {"PAGES_PER_SPLIT": 4}, {"PAGES_PER_SPLIT": 6}, {"PAGES_PER_SPLIT": 12},
    {"PAGES_PER_SPLIT": 16},
    {"MIN_UNITS": 8}, {"MIN_UNITS": 32},
    {"RING_BYTES": 70 << 10}, {"RING_BYTES": 140 << 10},
    {"SPLIT_BLOCKS": 256}, {"SPLIT_BLOCKS": 1024, "MAX_SPLITS": 128},
    {},
)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import kernel as K

    if not torch.cuda.is_available():
        print("sweep_paged_split: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cases = cs.paged_cases()
    print(f"card: {smi}; paged decode device ms per call on: "
          + "; ".join(c["name"] for c in cases))
    for alt in ALTERNATIVES:
        saved = {k: getattr(K, k) for k in alt}
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rng = np.random.default_rng(3)
        row = []
        try:
            for k, v in alt.items():
                setattr(K, k, v)
            K.launch_shape.cache_clear()
            for case in cases:
                w = case.get("window", 0)
                q, pool, meta, _ = cs.paged_inputs(case, gen, rng, dev)
                n_layers, tpp = pool.shape[1], pool.shape[3]
                plan = K.paged_decode_plan(*meta, tpp, w)
                layer = [0]

                def call():
                    layer[0] = (layer[0] + 1) % n_layers
                    return K.paged_decode_attention(
                        q, pool[:, layer[0]], *meta, window=w, plan=plan)

                row.append(cs.device_ms(call, "paged_decode_kernel"))
                del pool, plan
        finally:
            for k, v in saved.items():
                setattr(K, k, v)
            K.launch_shape.cache_clear()
        label = ", ".join(f"{k}={v}" for k, v in alt.items()) or "chosen"
        print(f"[sweep] {label}: " + " ".join(f"{x:.4f}" for x in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
