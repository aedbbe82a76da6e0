#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 scripts/trace_torch_train.py [--arch ARCH] [--layers N]

Builds the ``Trainer`` of ``chip_smoke.py`` phase 5b for ``--arch`` (one
of its ``FAMILY_TRAIN`` entries: the same fp32 masters from seed 0,
AdamW, micro-batches, rows and tokens a row, and extra batch), cut to
``--layers`` decoder layers when given (the width stays), runs one
untraced step and traces the next with ``torch.profiler``
(``chip_smoke._trace_train_step``): host wall ms, device kernel ms and
busy share, launches, device time by kernel group and the kernels that
take the most time. The card's name and power limit go beside them.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke
    archs = [r[0] for r in chip_smoke.FAMILY_TRAIN]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-3b", choices=archs)
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers kept (default: phase 5b's depth)")
    args = ap.parse_args()

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,
                                      TrainerConfig)

    if not torch.cuda.is_available():
        print("trace_torch_train: no CUDA device is available",
              file=sys.stderr)
        return 1
    _, cut, micro, batch, seq = next(r for r in chip_smoke.FAMILY_TRAIN
                                     if r[0] == args.arch)
    if args.layers is not None:
        cut = dict(cut, num_layers=args.layers)
    cfg = dataclasses.replace(ARCHS[args.arch], **cut)
    extra = {"vlm": lambda: chip_smoke._image_batch(cfg, 5),
             "encdec": lambda: chip_smoke._frame_batch(cfg, 5)}.get(
        cfg.family, lambda: None)()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        tr = Trainer(build_model(cfg), AdamWConfig(),
                     TrainerConfig(micro_batches=micro, ckpt_every=1 << 30,
                                   ckpt_dir=ckpt), extra_batch=extra)
        params, state = tr.init_state(0)
        data = SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch,
                           mode="markov")
        params, state, warm = tr.run(params, state, data, num_steps=1)
        chip_smoke.log(f"[train trace] {args.arch}: {cfg.num_layers} of "
                       f"{ARCHS[args.arch].num_layers} layers, {micro} x "
                       f"{batch // micro} rows of {seq} tokens a step; "
                       f"untraced step loss {warm} [{chip_smoke.card()}]")
        chip_smoke._trace_train_step(tr, params, state, data, 1)
    return 0


if __name__ == "__main__":
    (ROOT / "build").mkdir(exist_ok=True)
    sys.exit(main())
