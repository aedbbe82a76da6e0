"""AdamW (``repro/training/optimizer.py``): the same schedule, global-norm
clipping, bias correction at ``step + 1`` and weight decay on every leaf
(norms included, as the reference does), all in fp32, with ZeRO-1 over a
mesh's data axis and the reference's bf16 ``compressed_psum``.

The update runs in place under ``torch.no_grad()``: the reference returns
new params and moments, which at full width (granite-3-2b, 2.5 B fp32
parameters) would need another 30 GB for the second copies of params, mu
and nu.

ZeRO-1 (``zero1_shards``, the reference's ``zero1_shardings``): each
moment is split over the data axis on the first dim of its global leaf
that is not the tp axis and that the data axis divides; a leaf that
already uses the data axis (FSDP) keeps its own split. On a pod mesh it
is split over the pod axis too, on the next free dim the pod size divides,
and the updated slices are gathered over "pod", then over "data". Each rank keeps its slices of
``mu`` and ``nu`` only, updates the same slice of its fp32 params (the
masters, whole over the data axis as in the reference) and all-gathers
the updated slices over the data axis. The clip norm is taken over the
whole gradient of the mesh. The arithmetic is elementwise, so the result
is the unsharded update's, bit for bit. An expert leaf already splits its
experts over the data axis (expert parallelism), so ZeRO-1 leaves it
whole on its rank, as the reference's ``zero1_spec`` falls back to the
param's own spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ..models.tp import Dist, Shard


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


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a mesh's ranks share a model's params (``params``: a tree of
    ``Shard``, the model's ``shards()``) and the optimizer's moments
    (``state``: ``zero1_shards`` of them, or ``params`` without ZeRO-1)."""

    dist: Dist
    params: Dict
    state: Dict


def _global_dim(sh: Shard, local: Optional[int]) -> Optional[int]:
    """A dim of the rank's tensor as a dim of its global leaf (which has
    the tp axis)."""
    if local is None or sh.tp_axis is None:
        return local
    return local + (local >= sh.tp_axis)


def zero1_shards(param_shards, global_shapes, dp: int, pod: int = 1):
    """The reference's ``zero1_shardings`` for every leaf: split the moment
    over the data axis on the first dim of its global shape that is not
    the tp axis, is not empty and that ``dp`` divides (as a dim of the
    rank's tensor); leaves already split over "data" (FSDP) keep their
    split, and a leaf with no such dim stays whole. Expert leaves, whose
    experts the data axis already splits, keep their split too. On a pod
    mesh (``pod`` > 1) each moment is split over "pod" as well, on the
    first dim that no axis splits yet and that ``pod`` divides
    (``pod_dim``)."""
    def one(sh: Shard, shape) -> Shard:
        # at one data rank the reference still takes a dim for "data" (of
        # size 1) first, which moves the pod's dim to the next free one
        if (dp > 1 or pod > 1) and sh.data_dim is None:
            for i, n in enumerate(shape):
                if i != sh.tp_axis and n > 0 and n % dp == 0:
                    local = i - (sh.tp_axis is not None and i > sh.tp_axis)
                    sh = Shard(sh.tp_axis, local)
                    break
        if pod == 1:
            return sh
        taken = {sh.tp_axis, _global_dim(sh, sh.data_dim),
                 _global_dim(sh, sh.model_dim)}
        for i, n in enumerate(shape):
            if i not in taken and n > 0 and n % pod == 0:
                local = i - (sh.tp_axis is not None and i > sh.tp_axis)
                return dataclasses.replace(sh, pod_dim=local)
        return sh

    def go(shards, shapes):
        return {k: go(v, shapes[k]) if isinstance(v, dict) else
                one(v, shapes[k]) for k, v in shards.items()}
    return go(param_shards, global_shapes)


def _zero1_dims(layout: Optional[Layout], ps: Shard, ss: Shard):
    """The (dim, axis) pairs a ZeRO-1 rank updates a slice of: the data
    axis's dim, then the pod axis's (empty: the whole leaf)."""
    if layout is None:
        return ()
    out = ()
    if layout.dist.dp > 1 and ss.data_dim != ps.data_dim:
        out += ((ss.data_dim, "data"),)
    if layout.dist.pod > 1 and ss.pod_dim is not None:
        out += ((ss.pod_dim, "pod"),)
    return out


def _slice(t: torch.Tensor, dims, dist: Optional[Dist]) -> torch.Tensor:
    """This rank's part of ``t`` over each of ``dims`` (``_zero1_dims``;
    ``t`` itself where there is none)."""
    for dim, axis in dims:
        n, r = (dist.dp, dist.data_rank) if axis == "data" else \
            (dist.pod, dist.pod_rank)
        k = t.shape[dim] // n
        t = t.narrow(dim, r * k, k)
    return t


def with_shards(tree, layout: Optional[Layout]):
    """(tensor, param shard, state shard) of every leaf of ``tree``, in
    ``leaves`` order (the shards None without a layout)."""
    if layout is None:
        return ((t, None, None) for t in leaves(tree))
    return zip(leaves(tree), leaves(layout.params), leaves(layout.state))


def init(params, layout: Optional[Layout] = None) -> OptState:
    """Zero fp32 moments (this rank's ZeRO-1 slices under ``layout``) and
    step 0 on the params' device."""
    dev = next(leaves(params)).device

    def zeros(p, dims):
        return torch.zeros(_slice(p, dims, layout and layout.dist).shape,
                           dtype=torch.float32, device=p.device)

    def moments():
        if layout is None:
            return tree_map(lambda p: zeros(p, ()), params)
        out = [zeros(p, _zero1_dims(layout, ps, ss))
               for p, ps, ss in with_shards(params, layout)]
        return _rebuild(params, iter(out))

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=moments(), nu=moments())


def _rebuild(tree, it):
    return {k: _rebuild(tree[k], it) if isinstance(tree[k], dict)
            else next(it) for k in sorted(tree)}


def _counted(sh: Optional[Shard], dist: Dist) -> bool:
    """Whether this rank adds a leaf of the (reduced) gradient to the
    norm: each element once over the mesh."""
    return sh is None or (
        (sh.split_model or dist.model_rank == 0)
        and (sh.data_dim is not None or dist.data_rank == 0)
        and dist.pod_rank == 0)


def global_norm(tree, layout: Optional[Layout] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tree``; under a
    ``layout``, of the global tree the mesh's ranks hold parts of."""
    dist = layout.dist if layout is not None else Dist()
    total = None
    for x, sh, _ in with_shards(tree, layout):
        if not _counted(sh, dist):
            continue
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if dist.size > 1:
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=next(leaves(tree)).device)
        total = dist.all_reduce(total, "all")
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState,
           layout: Optional[Layout] = None
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE: ``params`` and the moments of ``state``
    are overwritten, and ``grads`` (consumed) are scaled by the clip
    factor. Returns (params, the new state, metrics) like the reference;
    the metrics are 0-d device tensors (no host sync). Under a ZeRO-1
    ``layout`` each rank updates its slice and the slices are gathered
    over the data axis."""
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for (whole, ps, ss), g, m, v in zip(with_shards(params, layout),
                                        leaves(grads), leaves(state.mu),
                                        leaves(state.nu)):
        dims = _zero1_dims(layout, ps, ss)
        p = _slice(whole, dims, layout and layout.dist)
        g = _slice(g, dims, layout and layout.dist)
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
        for i in reversed(range(len(dims))):
            # the slice of the axes before dims[i], gathered over dims[i]
            dim, axis = dims[i]
            parts = layout.dist.all_gather(p, axis)
            shape = list(p.shape)
            shape[dim] *= parts.shape[0]
            full = parts.movedim(0, dim).reshape(shape)
            if i:
                p = _slice(whole, dims[:i], layout.dist)
                p.copy_(full)
            else:
                whole.copy_(full)
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------- compressed DP gradient all-reduce
def compressed_psum(x: torch.Tensor, dist: Dist, axis: str = "data",
                    error: Optional[torch.Tensor] = None):
    """The reference's bf16 all-reduce with error feedback: quantize
    (x + error) to bf16, sum it over ``axis`` in bf16, and return (the sum
    in fp32, the new fp32 error). Half the bytes of an fp32 gradient
    sync; the error carry keeps the long-run bias at zero. (The reference's
    ``Trainer`` does not call it, nor does the port's.)"""
    xf = x.float()
    if error is not None:
        xf = xf + error
    q = xf.to(torch.bfloat16)
    new_error = xf - q.float()
    total = dist.all_reduce(q, axis).float()
    return total, new_error
