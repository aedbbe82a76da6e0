#!/usr/bin/env python3
"""Unprofiled packed serving step time and varlen host cost of a checkout,
on one GPU.

    python3 scripts/packed_step_time.py [--tree PATH] [--repeats N]

Imports ``repro_torch`` and ``chip_smoke.py`` from the checkout at
``--tree`` (default: this one), so two commits can be compared in one
call by running it once per checkout in turns. Prints the host time to
issue one varlen call (100 calls on phase 2's mixed stream, in the serve
path's token-major layout, before a synchronise) and, ``--repeats``
times, the mean step time of ``chip_smoke.py`` phase 3's packed depth-1
drain (full-width granite-3-2b, random weights from seed 0, 8 greedy
requests), with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]),
                    help="root of the checkout to import")
    ap.add_argument("--repeats", type=int, default=3,
                    help="drains of the packed depth-1 leg")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention_varlen
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models import build_model
    from repro_torch.models.blocks_attn import sparse_blocks

    if not torch.cuda.is_available():
        print("packed_step_time: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    case = next(c for c in cs.kernel_cases()
                if c["name"] == "mixed T=512 S=4608")
    rng = np.random.default_rng(0)
    t, s = len(case["q_seg"]), len(case["kv_seg"])
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device=dev).transpose(0, 1)
               for shape in ((t, 32, 64), (s, 8, 64), (s, 8, 64)))
    meta = [torch.tensor(case[n], device=dev)
            for n in ("q_seg", "kv_seg", "q_pos", "kv_pos")]
    kw = {}
    if hasattr(K, "varlen_kv_tiles"):       # the serve path's per-step skip data
        kw["kv_tiles"] = K.varlen_kv_tiles(meta[1], meta[3])
    blk_q, blk_k = sparse_blocks(t, s)

    def call():
        return flash_attention_varlen(q, k, v, *meta, blk_q=blk_q,
                                      blk_k=blk_k, **kw)

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    issue = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        issue.append((time.perf_counter() - t0) / 100 * 1e3)
        torch.cuda.synchronize()
    print(f"card: {smi}; tree {tree}")
    print(f"[host] varlen issue ms per call: "
          f"{' '.join(f'{x:.4f}' for x in issue)}", flush=True)

    cfg = ARCHS["granite-3-2b"]
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8, batching_mode="packed")
    prompts = cs._prompts(8, cfg.vocab_size)
    cs._drain(model, params, base, [prompts[0][:64], prompts[1][:64]], 2,
              "cuda")
    for _ in range(args.repeats):
        eng, wall, _ = cs._drain(model, params,
                                 dict(base, async_scheduling=False),
                                 prompts, 32, "cuda")
        print(f"[engine] packed depth 1: steps={eng.step_count} wall_s="
              f"{wall:.3f} mean_step_ms={wall / eng.step_count * 1e3:.2f}",
              flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
