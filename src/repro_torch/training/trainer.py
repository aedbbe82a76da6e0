"""Fault-tolerant trainer on one device (``repro/training/trainer.py``).

  * train step: ``train_loss`` -> backward per micro-batch, the fp32
    gradients summed across micro-batches in the params' ``.grad`` buffers,
    then AdamW in place;
  * deterministic data keyed by step -> exact resume;
  * NaN/Inf watchdog: restore the last checkpoint and skip the bad step.
    The update is in place, so the loss is tested BEFORE it runs (the same
    host sync as the reference's ``float(metrics["loss"])``);
  * async checkpointing every N steps;
  * straggler monitor: per-step wall-time EMA and a slow-step counter.

``zero1`` is accepted for the reference's config: on one card the data
axis has size 1 and the optimizer state stays whole.

``extra_batch`` (the reference's hook): ``tokens -> {name: array}`` of
extra ``train_loss`` arguments for a step's batch (a VLM's
``mm_embeds`` / ``mm_mask`` / ``mrope_pos``, an enc-dec model's
``enc_embeds``), split per micro-batch along
the batch axis: axis 1 of ``mrope_pos`` (3, B, T), axis 0 of the others.
(The reference reshapes axis 0 of every extra, which cannot split a
(3, B, T) ``mrope_pos``.)
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from . import optimizer as opt
from .checkpoint import Checkpointer
from .data import SyntheticLM


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    micro_batches: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep_ckpts: int = 3
    zero1: bool = True
    straggler_factor: float = 3.0
    max_restores: int = 3


def _batch_axis(name: str) -> int:
    return 1 if name == "mrope_pos" else 0


class Trainer:
    def __init__(self, model, adamw: opt.AdamWConfig, tcfg: TrainerConfig,
                 extra_batch: Optional[Callable] = None):
        self.model = model
        self.adamw = adamw
        self.tcfg = tcfg
        self.extra_batch = extra_batch or (lambda tokens: {})
        self.ckpt = Checkpointer(tcfg.ckpt_dir, model.cfg.family,
                                 keep=tcfg.keep_ckpts)
        # straggler stats
        self.step_ema: Optional[float] = None
        self.slow_steps = 0
        self.restores = 0

    # ------------------------------------------------------------------- init
    def init_state(self, seed: int = 0, device="cuda"):
        """fp32 master params from ``seed`` (the model's ``init(...,
        master=True)``) and a fresh optimizer state, on ``device``."""
        params = self.model.init(seed, device=resolve_device(device),
                                 master=True)
        return params, opt.init(params)

    # ------------------------------------------------------------------- step
    def _step(self, params, tokens, targets, extras=None):
        """Gradients of the mean micro-batch loss, summed in fp32 in the
        params' ``.grad`` buffers. ``extras``: ``train_loss``'s extra
        arguments for the whole batch. Returns (mean loss tensor, grads
        tree)."""
        extras = extras or {}
        n_micro = self.tcfg.micro_batches
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             "micro-batches")
        mb = b // n_micro
        for p in opt.leaves(params):
            p.requires_grad_(True)
            p.grad = None
        lsum = None
        for i in range(n_micro):
            sl = slice(i * mb, (i + 1) * mb)
            ex = {k: v.narrow(_batch_axis(k), i * mb, mb)
                  for k, v in extras.items()}
            loss = self.model.train_loss(params, tokens[sl], targets[sl],
                                         **ex)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
        grads = opt.tree_map(lambda p: p.grad, params)
        for g in opt.leaves(grads):
            g.div_(n_micro)
        return lsum / n_micro, grads

    @staticmethod
    def _release(params):
        for p in opt.leaves(params):
            p.grad = None
            p.requires_grad_(False)

    # -------------------------------------------------------------------- run
    def run(self, params, state, dataset: SyntheticLM, num_steps: int,
            start_step: int = 0, log_every: int = 10,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        step = start_step
        history = []
        dev = next(opt.leaves(params)).device
        while step < num_steps:
            tokens_np, targets_np = dataset.batch_at(step)
            extras = {k: torch.as_tensor(np.asarray(v)).to(dev)
                      for k, v in self.extra_batch(tokens_np).items()}
            t0 = time.perf_counter()
            loss_t, grads = self._step(
                params, torch.from_numpy(tokens_np).to(dev),
                torch.from_numpy(targets_np).to(dev), extras)
            loss = float(loss_t)
            # ---- NaN watchdog: restore + skip the poisoned step (before
            # the in-place update touches params or moments)
            if not np.isfinite(loss):
                self._release(params)
                self.restores += 1
                if self.restores > self.tcfg.max_restores:
                    raise RuntimeError("too many NaN restores")
                last = self.ckpt.latest_step()
                if last is None:
                    raise RuntimeError(f"NaN at step {step}, no checkpoint")
                params, state, _ = self.restore(last, device=dev)
                step = last + 1  # skip the bad batch deterministically
                continue
            params, state, metrics = opt.update(self.adamw, params, grads,
                                                state)
            self._release(params)
            del grads
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            metrics["loss"] = loss
            # ---- straggler monitor
            if self.step_ema is None:
                self.step_ema = dt
            else:
                if dt > self.tcfg.straggler_factor * self.step_ema:
                    self.slow_steps += 1
                self.step_ema = 0.9 * self.step_ema + 0.1 * dt
            history.append(loss)
            if on_metrics and step % log_every == 0:
                on_metrics(step, {**{k: float(v) for k, v in metrics.items()},
                                  "sec_per_step": dt,
                                  "slow_steps": self.slow_steps})
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self.save(step, params, state)
        self.ckpt.wait()
        return params, state, history

    # ----------------------------------------------------------- checkpoints
    def save(self, step: int, params, state, blocking: bool = False):
        self.ckpt.save(step, {"params": params, "opt": state},
                       extra={"model": self.model.cfg.name}, blocking=blocking)

    def restore(self, step: int, device="cuda"):
        """(params, state, meta) of checkpoint ``step`` on ``device``:
        fp32 params and moments, an int32 step."""
        dev = resolve_device(device)

        def struct():
            return opt.tree_map(
                lambda shape: torch.empty(shape, dtype=torch.float32,
                                          device="meta"),
                self.model.param_shapes())

        target = {"params": struct(),
                  "opt": opt.OptState(
                      step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=struct(), nu=struct())}
        tree, meta = self.ckpt.restore(step, target, device=dev)
        return tree["params"], tree["opt"], meta
