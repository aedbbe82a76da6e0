#!/usr/bin/env python3
"""Where a serving step of the PyTorch port spends its time, on one GPU.

    python3 scripts/trace_torch_step.py [--arch granite-3-2b|zamba2-1.2b]
                                        [--mode packed|padded|serial]
                                        [--skip N] [--steps N]

Serves the workload of ``chip_smoke.py`` phase 3 (full-width granite-3-2b,
random weights from seed 0, 8 greedy requests) or, with ``--arch
zamba2-1.2b``, of its phase 3b (full-width zamba2-1.2b at
tokens_per_page 19, the same 8 requests) synchronously (pipeline depth 1)
in one batching mode and, after ``--skip`` untraced steps, traces a window
of engine steps with ``torch.profiler``:
host wall time per step, device kernel time per step (the sum over CUDA
kernels, so the device's busy share is device ms / wall ms), kernel
launches per step, each of the port's own kernels' device time per step
and share of the device time, and the kernels and host ops that take the
most time.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=("granite-3-2b", "zamba2-1.2b"),
                    help="the model: chip_smoke's dense or hybrid legs")
    ap.add_argument("--mode", default="packed",
                    choices=("packed", "padded", "serial"),
                    help="EngineConfig.batching_mode")
    ap.add_argument("--skip", type=int, default=3,
                    help="engine steps run before the traced window")
    ap.add_argument("--steps", type=int, default=6,
                    help="engine steps traced")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _prompts, hybrid_serving_setup
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import (Engine, EngineConfig, Request,
                                     SamplingParams)

    if not torch.cuda.is_available():
        print("trace_torch_step: no CUDA device is available",
              file=sys.stderr)
        return 1
    if args.arch == "zamba2-1.2b":
        cfg, model, base = hybrid_serving_setup()
    else:
        cfg = ARCHS[args.arch]
        model = build_model(cfg)
        base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                    chunk_size=256, max_running=8)
    params = model.init(seed=0, device="cuda")
    eng = Engine(model, EngineConfig(batching_mode=args.mode, **base),
                 params=params, device="cuda")
    for i, p in enumerate(_prompts(8, cfg.vocab_size)):
        eng.submit(Request(rid=f"r{i}", prompt=p,
                           sampling=SamplingParams(max_new_tokens=32)))
    for _ in range(args.skip):              # warm-up, and the steps to skip
        eng.step()
    torch.cuda.synchronize()

    rows = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            m = eng.step()
            torch.cuda.synchronize()
            rows.append((m.batched_tokens, m.decode_batch,
                         (time.perf_counter() - t0) * 1e3))
    wall_ms = sum(r[2] for r in rows)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0.0)

    kernels = [e for e in events if dev_us(e) > 0 and e.key and
               getattr(e, "device_type", None) is not None and
               str(e.device_type).endswith("CUDA")]
    if not kernels:                         # older field names
        kernels = [e for e in events if dev_us(e) > 0 and
                   e.cpu_time_total == 0]
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; {args.arch}; mode {args.mode}; {args.steps} steps "
          f"traced after "
          f"{args.skip} (profiler on: host times include its overhead)")
    for tok, dec, ms in rows:
        print(f"[step] tokens={tok} decodes={dec} wall_ms={ms:.2f}")
    print(f"[trace] {args.steps} steps: wall {wall_ms:.1f} ms, device "
          f"kernels {dev_ms:.1f} ms (busy share "
          f"{dev_ms / wall_ms:.3f}), {launches} kernel launches "
          f"({launches / args.steps:.0f} per step)")
    for name in ("varlen_flash", "paged_decode", "mamba_scan"):
        mine = [e for e in kernels if f"{name}_kernel" in e.key]
        if mine:
            ms = sum(dev_us(e) for e in mine) / 1e3
            print(f"[trace] {name}_kernel: {ms / args.steps:.3f} ms per "
                  f"step over {sum(e.count for e in mine) / args.steps:.0f} "
                  f"launches ({ms / dev_ms:.3f} of device time)")
    print("[trace] kernels by device time:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:6d}  {e.key[:90]}")
    print("[trace] host ops by self CPU time:")
    ops = [e for e in events if e.self_cpu_time_total > 0]
    for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
