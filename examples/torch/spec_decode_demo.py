"""Speculative decoding (§6.1) on the port: draft + target share ONE Jenga
pool with two page sizes.

Run: PYTHONPATH=src python examples/torch/spec_decode_demo.py [--device cpu]
"""
import argparse

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.serving.spec_decode import SpecDecodeConfig, SpecDecodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--new-tokens", type=int, default=12)
    args = ap.parse_args(argv)
    tcfg = reduced(ARCHS["granite-3-2b"])
    dcfg = reduced(ARCHS["internlm2-1.8b"], num_layers=2,
                   vocab_size=tcfg.vocab_size)
    sd = SpecDecodeEngine(build_model(tcfg), build_model(dcfg),
                          SpecDecodeConfig(k=3, kv_pool_bytes=16 << 20),
                          device=args.device)
    sizes = {s.name: s.page_units for s in sd.mgr.specs}
    print("pool page sizes:", sizes,
          "LCM large page:", sd.mgr.geometry.large_page_units)
    out = sd.generate(list(range(16)), max_new_tokens=args.new_tokens)
    print("output:", out)
    print("accepted per round:", sd.accept_lengths)
    return sizes, out


if __name__ == "__main__":
    main()
