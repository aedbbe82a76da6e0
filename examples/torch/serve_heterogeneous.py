"""Serve three heterogeneous families through the SAME engine on the port —
one memory manager for SWA mixes, hybrid SSM state, and cross-attention
caches; Jenga vs PagedAttention-baseline peak pool usage.

Run: PYTHONPATH=src python examples/torch/serve_heterogeneous.py [--device cpu]
"""
import argparse

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.serving import (Engine, EngineConfig, MMItem, Request,
                                 SamplingParams)

ARCHES = ("h2o-danube-3-4b", "zamba2-1.2b", "whisper-tiny")


def serve(arch: str, mode: str, device: str, new_tokens: int):
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg)
    eng = Engine(model, EngineConfig(kv_pool_bytes=4 << 20, chunk_size=16,
                                     memory_mode=mode), device=device)
    kw = {}
    if cfg.family == "encdec":
        kw["encoder_items"] = (MMItem(0, cfg.encoder_seq, mm_hash=5),)
    for i in range(3):
        eng.submit(Request(rid=f"r{i}", prompt=list(range(40)),
                           sampling=SamplingParams(max_new_tokens=new_tokens),
                           **kw))
    eng.run_until_done(max_steps=600)
    return max(m.used_units for m in eng.metrics)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--new-tokens", type=int, default=4)
    args = ap.parse_args(argv)
    peaks = {}
    for arch in ARCHES:
        j = serve(arch, "jenga", args.device, args.new_tokens)
        p = serve(arch, "paged-baseline", args.device, args.new_tokens)
        peaks[arch] = (j, p)
        print(f"{arch:20s} peak used units: jenga={j:>9} paged={p:>9} "
              f"({p / max(1, j):.2f}x waste)")
    return peaks


if __name__ == "__main__":
    main()
