#!/usr/bin/env python3
"""Where a training step on a mesh of cards spends its time.

    python3 scripts/trace_mesh_train.py [--arch A] [--mesh 2x2 | 2x2x1]
        [--no-fsdp] [--layers N]

Runs a ``chip_smoke.py`` phase 5c leg (ii) configuration: ``--arch``
(granite-3-2b, qwen3-moe-235b-a22b, qwen2-vl-2b with its image batch,
zamba2-1.2b, rwkv6-3b or whisper-tiny with its frames) at full width, cut
to ``--layers`` (default: granite 16, qwen3-moe 1, rwkv6-3b 8, the others
whole), weights from seed 0, ZeRO-1, FSDP unless ``--no-fsdp`` (never for
the hybrid, RWKV6 or enc-dec, which have none), phase 5's batch of
2048-token rows in 2 micro-batches (4 rows, one a rank on a mesh of 4
data ranks; whisper-tiny phase 5b's 16 rows of 448 tokens), on a
``(data, model)`` mesh of the visible cards or a ``(pod, data, model)``
one (``--mesh PxDxM``), one process a card over NCCL. First each rank times the collectives at the sizes one step issues
(CUDA events, the median of 10 after 3 warm-ups): an all-reduce over
"model" of one layer's bf16 activations, an all-gather over "data" of one
layer's FSDP shard and a reduce-scatter over "data" of its gradient, a MoE
layer's (E, cap, d) bf16 all-to-all over "data", and a 256 MB all-reduce
over every rank; then it traces its third Trainer step with
``torch.profiler``: wall ms, device kernel ms and busy share, device ms by
kernel group (NCCL's send/recv, which carries the all-to-all, the other
NCCL collectives, GEMMs, the dense flash and scan kernels, elementwise and
copies), the device launches a layer and micro-batch, and the bytes each
kind of collective sent in that step (``Dist.comm_bytes``). Each card's
name and power limit are printed beside them.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# --arch -> its default depth (None: whole)
LAYERS = {"granite-3-2b": 16, "qwen3-moe-235b-a22b": 1, "qwen2-vl-2b": None,
          "zamba2-1.2b": None, "rwkv6-3b": 8, "whisper-tiny": None}
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GROUPS = (("NCCL send/recv (all-to-all)", ("sendrecv",)),
          ("NCCL collectives", ("nccl",)),
          ("dense_flash", ("dense_fwd", "dense_dkv", "dense_dq",
                           "dense_delta")),
          ("mamba scan", ("mamba",)),
          ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
          ("elementwise and copies", ("elementwise", "copy")),
          ("reductions", ("reduce",)))


def _time_ms(fn, iters=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _collectives(dist, dev, cfg):
    """(label, input MB, ms) of the step's collectives at their sizes."""
    import torch
    from repro_torch.models.tp import replica_info
    d, hd = cfg.d_model, cfg.head_dim
    ri = replica_info(cfg.num_heads, cfg.num_kv_heads, dist.tp)
    # one layer's FSDP-split leaves: attention, and the dense MLP
    layer = 2 * d * ri["q_local"] * hd + 2 * d * ri["kv_local"] * hd
    if cfg.family in ("dense", "vlm"):
        layer += 3 * d * cfg.d_ff // dist.tp
    act = torch.randn(2048, d, device=dev).to(torch.bfloat16)
    shard = torch.randn(layer // dist.dp, device=dev).to(torch.bfloat16)
    grad = torch.randn(dist.dp, layer // dist.dp,
                       device=dev).to(torch.bfloat16)
    big = torch.randn(1 << 27, device=dev).to(torch.bfloat16)
    cases = [("all-reduce over model, one layer's activations", act,
              dist.tp, lambda: dist.all_reduce(act, "model")),
             ("all-gather over data, one layer's FSDP shard", shard,
              dist.dp, lambda: dist.all_gather(shard, "data")),
             ("reduce-scatter over data, one layer's gradient", grad,
              dist.dp, lambda: dist.reduce_scatter(grad, "data")),
             ("all-reduce over every rank, 256 MB", big, dist.size,
              lambda: dist.all_reduce(big, "all"))]
    if cfg.num_experts:
        e, k = cfg.num_experts, cfg.experts_per_token
        cap = int(max(1, round(2048 * k / e * cfg.capacity_factor)))
        disp = torch.randn(dist.dp, e // dist.dp, cap, d,
                           device=dev).to(torch.bfloat16)
        cases.append((f"all-to-all over data, one layer's ({e}, {cap}, {d}) "
                      f"dispatch", disp, dist.dp,
                      lambda: dist.all_to_all(disp, "data")))
    # an axis of one rank issues no collective: nothing to time
    return [(label, x.numel() * x.element_size() / 1e6, _time_ms(fn))
            for label, x, n, fn in cases if n > 1]


def _rank(dist, dev, cfg):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticLM
    colls = _collectives(dist, dev, cfg)
    micro, rows, seq = chip_smoke.WHISPER_BATCH \
        if cfg.family == "encdec" else (2, max(4, 2 * dist.rows), 2048)
    data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=rows,
                       mode="markov")
    with tempfile.TemporaryDirectory() as ckpt:
        tr = chip_smoke._mesh_trainer(build_model(cfg, dist), micro, ckpt,
                                      chip_smoke._family_extra(cfg))
        params, state = tr.init_state(0, device=dev)
        times = []
        params, state, _ = tr.run(params, state, data, num_steps=2,
                                  log_every=1, on_metrics=lambda s, m:
                                  times.append(1e3 * m["sec_per_step"]))
        torch.cuda.synchronize(dev)
        before = dict(dist.comm_bytes)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, hist = tr.run(params, state, data, num_steps=3,
                                         start_step=2)
            torch.cuda.synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    sent = {k: dist.comm_bytes[k] - v for k, v in before.items()}
    kernels = [e for e in prof.key_averages()
               if chip_smoke._dev_us(e) > 0 and
               str(getattr(e, "device_type", "")).endswith("CUDA")]
    groups = {}
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, words in GROUPS
                     if any(w in key for w in words)), "other")
        ms, n = groups.get(name, (0.0, 0))
        groups[name] = (ms + chip_smoke._dev_us(e) / 1e3, n + e.count)
    return dict(colls=colls, wall=wall, steps=times, groups=groups,
                launches=sum(e.count for e in kernels) / (
                    cfg.num_layers * micro),
                sent=sent, loss=hist[-1],
                finite=bool(np.isfinite(hist).all()),
                card=torch.cuda.get_device_name(dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=sorted(LAYERS))
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import run_mesh
    if not torch.cuda.is_available():
        print("trace_mesh_train: no CUDA device is available",
              file=sys.stderr)
        return 1
    shape = tuple(int(x) for x in args.mesh.split("x"))
    full = ARCHS[args.arch]
    layers = args.layers or LAYERS[args.arch] or full.num_layers
    cfg = dataclasses.replace(full, num_layers=layers)
    fsdp = not args.no_fsdp and cfg.family in ("dense", "moe", "vlm")
    print(f"cards: {chip_smoke.card()}")
    ranks = run_mesh(_rank, shape, args=(cfg,), fsdp=fsdp,
                     backend="nccl", device="cuda", timeout=300,
                     deadline=900)
    for rank, r in enumerate(ranks):
        for label, mb, ms in r["colls"]:
            print(f"[collective] rank {rank} {label}: {mb:.1f} MB in "
                  f"{ms:.3f} ms ({mb / ms:.1f} GB/s of input)")
        dev = sum(ms for ms, _ in r["groups"].values())
        sent = ", ".join(f"{k} {v / 1e6:.1f} MB"
                         for k, v in r["sent"].items())
        print(f"[trace] rank {rank} [{r['card']}] {args.arch} "
              f"{' x '.join(map(str, shape))}{' FSDP' if fsdp else ''} at "
              f"{layers} layers: untraced steps "
              f"{[round(t, 1) for t in r['steps']]} ms; traced step wall "
              f"{r['wall']:.1f} ms, device kernels {dev:.1f} ms (busy share "
              f"{dev / r['wall']:.3f}), {r['launches']:.0f} device launches "
              f"a layer and micro-batch, loss {r['loss']:.4f}; sent in the "
              f"traced step: {sent}")
        for name, (ms, n) in sorted(r["groups"].items(),
                                    key=lambda x: -x[1][0]):
            print(f"[trace]   {name}: {ms:.1f} ms over {n} launches "
                  f"({ms / dev:.3f} of device time)")
    return 0 if all(r["finite"] for r in ranks) else 1


if __name__ == "__main__":
    sys.exit(main())
