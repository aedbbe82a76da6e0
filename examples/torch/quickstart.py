"""Quickstart on the port: train a reduced model for a few steps, then serve
it with the Jenga-managed engine.

Run: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import pathlib

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.serving import Engine, EngineConfig, Request, SamplingParams
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,
                                  TrainerConfig)

BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / "examples"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(BUILD / "quickstart_ckpt"))
    args = ap.parse_args(argv)
    cfg = reduced(ARCHS["granite-3-2b"])
    model = build_model(cfg)

    print("== train a few steps (AdamW, NaN watchdog, async checkpoints) ==")
    trainer = Trainer(model, AdamWConfig(lr=1e-2, warmup_steps=5),
                      TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=10,
                                    micro_batches=2))
    params, state = trainer.init_state(0, device=args.device)
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8)
    params, state, hist = trainer.run(
        params, state, data, num_steps=args.steps,
        on_metrics=lambda s, m: print(f"  step {s}: loss={m['loss']:.3f}"))
    print(f"  loss {hist[0]:.3f} -> {hist[-1]:.3f}")

    print("== serve with the Jenga KV manager (prefix caching on) ==")
    eng = Engine(model, EngineConfig(kv_pool_bytes=8 << 20, chunk_size=16),
                 params=params, device=args.device)
    for i in range(3):
        eng.submit(Request(rid=f"req{i}", prompt=list(range(10 + 2 * i)),
                           sampling=SamplingParams(max_new_tokens=8)))
    done = eng.run_until_done()
    for r in done:
        print(f"  {r.rid}: out={r.output}")
    stats = eng.mgr.memory_stats()
    print(f"  pool: used={stats.used_units}u cached={stats.evictable_units}u "
          f"free={stats.free_units}u")
    return hist, done


if __name__ == "__main__":
    main()
