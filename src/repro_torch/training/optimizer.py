"""AdamW on one device (``repro/training/optimizer.py``): the same schedule,
global-norm clipping, bias correction at ``step + 1`` and weight decay on
every leaf (norms included, as the reference does), all in fp32.

The update runs in place under ``torch.no_grad()``: the reference returns
new params and moments, which at full width (granite-3-2b, 2.5 B fp32
parameters) would need another 30 GB for the second copies of params, mu
and nu. The reference's ZeRO-1 state sharding has a data axis of size 1 on
one card, so the state stays whole here; its bf16 ``compressed_psum`` needs
a collective across cards and is not ported (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: Any      # 0-d int32 tensor on the params' device
    mu: Any        # fp32 tree like the params
    nu: Any


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict in the reference's flatten order
    (sorted keys)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaves(val)
        else:
            yield val


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params) -> OptState:
    """Zero fp32 moments and step 0 on the params' device."""
    dev = next(leaves(params)).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE: ``params`` and the moments of ``state``
    are overwritten, and ``grads`` (consumed) are scaled by the clip
    factor. Returns (params, the new state, metrics) like the reference;
    the metrics are 0-d device tensors (no host sync)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_((p.float() - lr * delta).to(p.dtype))
        del delta
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
