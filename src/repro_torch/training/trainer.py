"""Fault-tolerant trainer (``repro/training/trainer.py``), on one device or
on every rank of a ``(data, model)`` or ``(pod, data, model)`` mesh (the
model's ``dist``).

  * train step: ``train_loss`` -> backward per micro-batch, the fp32
    gradients summed across micro-batches in the params' ``.grad`` buffers,
    summed over the mesh axes each leaf is replicated on, then AdamW in
    place (ZeRO-1 over the data axis when ``zero1``);
  * data: every rank draws the same global batch from ``batch_at(step)``,
    splits it into micro-batches first and takes its data rank's
    ``1 / dp`` of each micro-batch's rows (on a pod mesh, its
    ``1 / (pod x dp)``, pod-major) (the reference's order: the
    step reshapes the global batch, then ``shard_map`` splits each
    micro-batch over "data");
  * deterministic data keyed by step -> exact resume;
  * NaN/Inf watchdog: restore the last checkpoint and skip the bad step.
    The update is in place, so the loss is tested BEFORE it runs (the same
    host sync as the reference's ``float(metrics["loss"])``); the loss is
    summed over the data axis, so every rank decides alike;
  * async checkpointing every N steps, of global arrays written by one
    rank; a checkpoint restores onto a mesh of another data size;
  * straggler monitor: per-step wall-time EMA and a slow-step counter.

``zero1`` has no effect on one device, where the data axis has size 1.

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
from ..models.tp import Shard
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
        # every family's model carries its mesh (one device by default)
        self.dist = model.dist
        ps = model.shards()
        self.layout = opt.Layout(
            self.dist, ps, opt.zero1_shards(
                ps, model.global_shapes(), self.dist.dp, self.dist.pod)
            if tcfg.zero1 else ps)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, model.cfg.family,
                                 keep=tcfg.keep_ckpts, dist=self.dist)
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
        return params, opt.init(params, self.layout)

    # ------------------------------------------------------------------- step
    def loss_and_grads(self, params, tokens, targets, extras=None):
        """The step's gradients: ``tokens`` / ``targets`` (and ``extras``,
        ``train_loss``'s extra arguments) are the GLOBAL batch; each
        micro-batch's data-rank rows go through ``train_loss`` and
        backward, the fp32 gradients summed in the params' ``.grad``
        buffers, then summed over the mesh axes each leaf is replicated on
        (FSDP leaves were reduce-scattered by the backward; an expert leaf,
        split over both axes, is complete on its rank: the all-to-all's
        backward brought every data rank's cotangents to it; both are
        summed over "pod", whose ranks each hold a copy) and divided
        by the number of micro-batches. Returns (mean loss tensor, grads
        tree)."""
        extras = extras or {}
        n_micro, dist = self.tcfg.micro_batches, self.dist
        b = tokens.shape[0]
        if b % (n_micro * dist.rows):
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             f"micro-batches of {dist.rows} data ranks")
        mb = b // n_micro
        rows = mb // dist.rows
        for p in opt.leaves(params):
            p.requires_grad_(True)
            p.grad = None
        lsum = None
        for i in range(n_micro):
            lo = i * mb + dist.row_rank * rows
            ex = {k: v.narrow(_batch_axis(k), lo, rows)
                  for k, v in extras.items()}
            loss = self.model.train_loss(params, tokens[lo:lo + rows],
                                         targets[lo:lo + rows], **ex)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
        for p, sh, _ in opt.with_shards(params, self.layout):
            if sh is None:
                continue
            if sh.data_dim is None:
                p.grad = dist.all_reduce(
                    p.grad, "rows" if sh.split_model else "all")
            else:
                p.grad = dist.all_reduce(p.grad, "pod")
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
            loss_t, grads = self.loss_and_grads(
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
                                                state, self.layout)
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
    def _shards(self):
        """The ``Shard`` tree of ``{"params", "opt"}``."""
        return {"params": self.layout.params,
                "opt": opt.OptState(step=Shard(), mu=self.layout.state,
                                    nu=self.layout.state)}

    def save(self, step: int, params, state, blocking: bool = False):
        """A checkpoint of the global arrays (a collective on a mesh)."""
        self.ckpt.save(step, {"params": params, "opt": state},
                       extra={"model": self.model.cfg.name}, blocking=blocking,
                       shards=self._shards())

    def restore(self, step: int, device="cuda"):
        """(params, state, meta) of checkpoint ``step`` on ``device``:
        fp32 params and moments (this rank's parts of them), an int32
        step."""
        dev = resolve_device(device)
        params = opt.tree_map(
            lambda shape: torch.empty(shape, dtype=torch.float32,
                                      device="meta"),
            self.model.param_shapes())
        target = {"params": params, "opt": opt.init(params, self.layout)}
        tree, meta = self.ckpt.restore(step, target, device=dev,
                                       shards=self._shards())
        return tree["params"], tree["opt"], meta
