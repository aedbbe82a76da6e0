"""Train the reduced Zamba2-style hybrid (Mamba2 + shared attention) on the
port with fault-tolerant checkpointing; restoring the last checkpoint is
exact.

Run: PYTHONPATH=src python examples/torch/train_hybrid.py [--device cpu]
"""
import argparse
import pathlib

import numpy as np

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,
                                  TrainerConfig)

BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / "examples"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=str(BUILD / "hybrid_ckpt"))
    args = ap.parse_args(argv)
    cfg = reduced(ARCHS["zamba2-1.2b"])
    model = build_model(cfg)
    trainer = Trainer(model, AdamWConfig(lr=5e-3, warmup_steps=10,
                                         total_steps=300),
                      TrainerConfig(ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every,
                                    micro_batches=2))
    params, state = trainer.init_state(0, device=args.device)
    data = SyntheticLM(cfg.vocab_size, seq_len=64, global_batch=8)
    params, state, hist = trainer.run(
        params, state, data, num_steps=args.steps, log_every=20,
        on_metrics=lambda s, m: print(
            f"step {s}: loss={m['loss']:.3f} gnorm={m['grad_norm']:.2f} "
            f"{m['sec_per_step'] * 1e3:.0f}ms"))
    print(f"loss: {hist[0]:.3f} -> {np.mean(hist[-10:]):.3f}")
    last = trainer.ckpt.latest_step()
    p2, s2, meta = trainer.restore(last, device=args.device)
    print(f"restored step {last} (model={meta['extra']['model']}) — resume OK")
    return hist, last, p2


if __name__ == "__main__":
    main()
