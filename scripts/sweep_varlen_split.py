#!/usr/bin/env python3
"""The varlen flash kernel's split plan, swept on one GPU.

    python3 scripts/sweep_varlen_split.py

``varlen_plan`` cuts the kv stream into equal ranges of at least
``SPLIT_TILES`` kv tiles, one block of a q tile each, with at most enough
splits for about
``2 * SMS / 132`` blocks on each of the H100's 132 SMs. This times the
kernel (device time under ``torch.profiler``, ``chip_smoke.device_ms``) on
the packed streams of ``chip_smoke.py`` phase 2 for each pair of those two
constants, and with no split at all, and prints one line a case with the
card's name and power limit.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = ("mixed T=512 S=4608 token-major", "decode T=16 S=8192 token-major",
         "zamba2 G=1 mixed T=512 S=4608",
         "internlm2 heads D=128 G=2 mixed T=512",
         "qwen2.5-32b heads D=128 G=5 mixed T=512")
# (SPLIT_TILES, blocks per SM); 10**6 tiles: never split
PLANS = ((4, 2), (8, 2), (16, 2), (4, 4), (8, 4), (8, 1), (10 ** 6, 2))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_varlen
    from repro_torch.kernels.flash_attention import kernel as K

    if not torch.cuda.is_available():
        print("sweep_varlen_split: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; varlen device ms per call, "
          "SPLIT_TILES/blocks per SM (n_splits)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = {c["name"]: c for c in cs.kernel_cases()}
    chosen = (K.SPLIT_TILES, K.SMS)
    try:
        for name in CASES:
            case = cases[name]
            q, k, v, meta, token = cs._varlen_inputs(case, rng, dev)
            args = token or (q, k, v)
            tiles = K.varlen_kv_tiles(meta[1], meta[3])
            row = []
            for split_tiles, per_sm in PLANS:
                K.SPLIT_TILES, K.SMS = split_tiles, 66 * per_sm
                ms = cs.device_ms(lambda: flash_attention_varlen(
                    *args, *meta, window=case["window"], kv_tiles=tiles),
                    "varlen_flash_kernel")
                ns = K.varlen_plan(q.shape[1], k.shape[1],
                                   q.shape[0] // k.shape[0], k.shape[0])[2]
                label = "none" if split_tiles > 10 ** 5 else split_tiles
                row.append(f"{label}/{per_sm}:{ms:.4f}({ns})")
            print(f"[sweep] {name}: " + " ".join(row), flush=True)
    finally:
        K.SPLIT_TILES, K.SMS = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
