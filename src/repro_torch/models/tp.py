"""The reference's tensor-parallel primitives (``repro/models/tp.py``) on
``torch.distributed``.

The reference runs a training step as one ``shard_map`` over a
``("data", "model")`` mesh. The port runs one process per rank of the same
mesh, and ``Dist`` holds what the reference's ``Dist`` and
``jax.lax.axis_index`` give a shard: the rank's coordinates, the sizes of
both axes, ``fsdp`` and one process group per axis. Global rank
``r = data_rank * tp + model_rank``, the device order of the reference's
``make_mesh_auto((dp, tp), ("data", "model"))``.

The reference's multi-pod mesh ``("pod", "data", "model")`` (its
``Dist(mesh, dp_axes=("pod", "data"))``) adds a third axis: ``pod``
ranks, global rank ``((pod_rank * dp) + data_rank) * tp + model_rank``.
The batch rows and the loss's mean run over pod x data (``rows``,
``row_rank``; ``psum_dp``), while FSDP's shards and a MoE's experts stay
over "data" alone and are replicated over "pod". At one pod every
collective is the two-axis mesh's.

Parameters live in the reference's *expanded layout*: every tensor-parallel
leaf has a ``tp`` axis, and rank ``m`` of the model axis holds slice ``m``
of it (``models.params``), including the padded GQA heads and the K/V
replicas of ``gqa_tp_layout``.

Gradients. ``jax.value_and_grad`` of the reference's ``shard_map`` body
transposes each ``psum`` into a ``psum`` of the cotangents, and seeds each
of the mesh's N devices with 1/N of the replicated loss's cotangent; every
input cotangent is then summed over the axes its spec leaves out. The port
follows the same rules, so that each partial sum is rounded where the
reference rounds it: ``psum_tp`` and ``psum_dp`` all-reduce forward and
backward, ``replicated_loss`` scales the cotangent by 1/N, and the trainer
sums each leaf's gradient over the axes it is replicated on. The result is
the gradient of the global loss, on any mesh (held against JAX on 2- and
4-process CPU meshes in ``tests/test_torch_mesh_train.py``).

Serving. ``sp`` (the reference's sequence-parallel decode) splits every
sequence's pages over the data axis, and a GQA layout with ``repl`` K/V
replicas splits a kv head group's pages over its replica set of the model
axis (``attention.replica_groups``; one process group, ``kv_group``, per
set).
Partial attention results over those pages combine by ``combine_partials``
(the reference's ``attention.combine_partials``): a max of ``m`` over the
group, then one sum of ``o * corr`` and ``l * corr`` in fp32.

A ``Dist`` of size 1 issues no collective, so at a 1 x 1 mesh every
function here computes what the single-card code computes, bit for bit.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch

from .attention import rescale_partials
from .common import gqa_tp_layout


def _comm_counts() -> Dict[str, int]:
    return {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
            "all_to_all": 0, "combine": 0}


@dataclasses.dataclass(frozen=True)
class Dist:
    """One rank of a ``(data, model)`` mesh, or of a ``(pod, data,
    model)`` one. ``dp_group`` holds the ranks that share this rank's
    ``pod_rank`` and ``model_rank``, ``tp_group`` those that share its
    ``pod_rank`` and ``data_rank``, ``pod_group`` those that share its
    ``data_rank`` and ``model_rank``, ``rows_group`` those that share its
    ``model_rank`` (pod x data: the reference's ``dp_axes``), ``group``
    every rank, and ``kv_group`` the ``repl`` ranks of this rank's K/V
    replica set (``attention.replica_groups``; serving).
    ``sp``: serving splits each sequence's pages over the data axis.
    ``comm_bytes`` counts the bytes each kind of collective of this rank
    sent into the group (its input's size; ``combine``: the partial
    attention combines), for the step's communication volume."""

    dp: int = 1
    tp: int = 1
    data_rank: int = 0
    model_rank: int = 0
    fsdp: bool = False
    dp_group: Any = None
    tp_group: Any = None
    group: Any = None
    sp: bool = False
    repl: int = 1
    kv_group: Any = None
    pod: int = 1
    pod_rank: int = 0
    pod_group: Any = None
    rows_group: Any = None
    comm_bytes: Dict[str, int] = dataclasses.field(
        default_factory=_comm_counts, compare=False)

    @property
    def rows(self) -> int:
        """Ranks the batch rows split over: pod x data."""
        return self.pod * self.dp

    @property
    def row_rank(self) -> int:
        return self.pod_rank * self.dp + self.data_rank

    @property
    def size(self) -> int:
        return self.rows * self.tp

    @property
    def rank(self) -> int:
        return self.row_rank * self.tp + self.model_rank

    @property
    def combine_axes(self):
        """The axes whose ranks hold parts of a sequence's pages, in the
        order their partials combine (the reference's: the K/V replica
        group, then "data" under ``sp``)."""
        return (("replica",) if self.repl > 1 else ()) + \
            (("data",) if self.sp and self.dp > 1 else ())

    def _group(self, axis: str):
        return {"data": (self.dp_group, self.dp), "model":
                (self.tp_group, self.tp), "all": (self.group, self.size),
                "replica": (self.kv_group, self.repl),
                "pod": (self.pod_group, self.pod),
                "rows": (self.rows_group if self.pod > 1 else self.dp_group,
                         self.rows)}[axis]

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum",
                   kind: str = "all_reduce") -> torch.Tensor:
        """The sum (``op`` "sum") or max ("max") of ``x`` over ``axis``
        ("data", "model", "replica", "pod", "rows" (pod x data) or "all")
        in ``x``'s dtype, as a new
        tensor (``x`` itself when the axis has one rank); its bytes count
        under ``kind``."""
        group, n = self._group(axis)
        if n == 1:
            return x
        y = x.contiguous().clone()
        red = torch.distributed.ReduceOp.MAX if op == "max" else \
            torch.distributed.ReduceOp.SUM
        torch.distributed.all_reduce(y, op=red, group=group)
        self.comm_bytes[kind] += y.numel() * y.element_size()
        return y

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` of ``axis``, in rank order."""
        group, n = self._group(axis)
        if n == 1:
            return x[None]
        x = x.contiguous()
        flat = x.reshape(-1)
        out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.distributed.all_gather_into_tensor(out, flat, group=group)
        self.comm_bytes["all_gather"] += x.numel() * x.element_size()
        return out.view(n, *x.shape)

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x: (n, *shape); this rank's slice of the sum over ``axis``."""
        group, n = self._group(axis)
        if n == 1:
            return x[0]
        x = x.contiguous()
        out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.distributed.reduce_scatter_tensor(out, x.reshape(-1),
                                                    group=group)
        self.comm_bytes["reduce_scatter"] += x.numel() * x.element_size()
        return out.view(x.shape[1:])

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x: (n, ...): chunk ``i`` of dim 0 goes to rank ``i`` of
        ``axis``, and chunk ``j`` of the result came from rank ``j`` (the
        reference's ``all_to_all(split_axis=0, concat_axis=0,
        tiled=False)``); ``x`` itself when the axis has one rank."""
        group, n = self._group(axis)
        if n == 1:
            return x
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {n} ranks of a dim of "
                             f"{x.shape[0]}")
        x = x.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=group)
        self.comm_bytes["all_to_all"] += x.numel() * x.element_size()
        return out

    def barrier(self) -> None:
        if self.size > 1:
            torch.distributed.barrier(group=self.group)


def single_device_dist() -> Dist:
    return Dist()


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a rank's tensor sits in its global leaf (the reference's
    expanded layout): ``tp_axis`` is the global leaf's tensor-parallel
    axis, which the rank's tensor drops; ``model_dim`` a dim the rank
    keeps, split evenly over the model axis (an expert's ``ffe``: the
    reference's ``"model"`` on a real dim); with neither, the leaf is the
    same on every rank of the model axis. ``data_dim`` is the rank's dim
    split evenly over the data axis (FSDP's, or the experts of expert
    parallelism; None: the rank holds it whole). ``pod_dim``, a dim of
    the rank's tensor split evenly over the pod axis, is the ZeRO-1
    moments' on a pod mesh (``training.optimizer.zero1_shards``); every
    parameter is whole over "pod"."""

    tp_axis: Optional[int] = None
    data_dim: Optional[int] = None
    model_dim: Optional[int] = None
    pod_dim: Optional[int] = None

    @property
    def split_model(self) -> bool:
        """Whether the model axis's ranks hold different parts."""
        return self.tp_axis is not None or self.model_dim is not None

    @property
    def fsdp_dim(self) -> Optional[int]:
        """The data dim FSDP gathers whole before use (None for an expert
        leaf, whose data dim is expert parallelism's and stays split)."""
        return self.data_dim if self.tp_axis is not None else None


def combine_partials(o, m, l, dist: Optional[Dist], axis: str):
    """Flash-decoding combine of partial softmax results (o (..., D) fp32
    unnormalised, m and l (...) fp32) over ``axis`` of ``dist`` ("replica"
    or "data"), the reference's ``combine_partials``: the group's max of
    ``m``, then the sum of ``o * corr`` and ``l * corr`` (one all-reduce of
    both, fp32). Returns (o, m, l) rescaled to the group max. A member
    that saw nothing (m -inf) weighs 0; a row no member saw keeps m -inf
    and o = l = 0. The identity at a group of one."""
    if dist is None or dist._group(axis)[1] == 1:
        return o, m, l
    gmax = dist.all_reduce(m, axis, op="max", kind="combine")
    o, l = rescale_partials(o, m, l, gmax)
    both = dist.all_reduce(torch.cat([o.reshape(-1), l.reshape(-1)]), axis,
                           kind="combine")
    return both[:o.numel()].view(o.shape), gmax, \
        both[o.numel():].view(l.shape)


def combine_all(o, m, l, dist: Optional[Dist]):
    """``combine_partials`` over every axis of ``dist.combine_axes``."""
    for axis in (() if dist is None else dist.combine_axes):
        o, m, l = combine_partials(o, m, l, dist, axis)
    return o, m, l


def replica_info(num_heads: int, num_kv_heads: int, tp: int):
    q_pad, q_local, kv_tp, kv_local = gqa_tp_layout(num_heads, num_kv_heads,
                                                    tp)
    repl = tp // kv_tp
    return dict(q_pad=q_pad, q_local=q_local, kv_tp=kv_tp,
                kv_local=kv_local, repl=repl)


# ----------------------------------------------- collectives with gradients
class _Psum(torch.autograd.Function):
    """Sum over a mesh axis; its transpose is the same sum of the
    cotangents (the reference's ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, dist: Dist, axis: str):
        ctx.dist, ctx.axis = dist, axis
        return dist.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_reduce(g, ctx.axis), None, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Gather(torch.autograd.Function):
    """The reference's tiled ``all_gather`` over a mesh axis: every rank's
    ``w`` concatenated along ``dim`` in rank order; its transpose sums the
    cotangents over the axis and keeps this rank's part (a reduce-scatter
    in the cotangent's dtype). FSDP gathers a weight's shards over "data"
    with it, RWKV6's channel mix its output columns over "model"."""

    @staticmethod
    def forward(ctx, w, dist: Dist, dim: int, axis: str):
        ctx.dist, ctx.dim, ctx.axis = dist, dim, axis
        parts = dist.all_gather(w, axis)            # (n, *w.shape)
        shape = list(w.shape)
        shape[dim] *= parts.shape[0]
        return parts.movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        dist, dim = ctx.dist, ctx.dim
        n = dist._group(ctx.axis)[1]
        shape = list(g.shape)
        shape[dim:dim + 1] = [n, shape[dim] // n]
        parts = g.reshape(shape).movedim(dim, 0)
        return dist.reduce_scatter(parts, ctx.axis), None, None, None


class _AllToAll(torch.autograd.Function):
    """``Dist.all_to_all`` over the data axis; its transpose is the same
    exchange of the cotangents (chunk ``j`` goes back to rank ``j``), as
    JAX transposes ``all_to_all(..., tiled=False)``."""

    @staticmethod
    def forward(ctx, x, dist: Dist):
        ctx.dist = dist
        return dist.all_to_all(x, "data")

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_to_all(g, "data"), None


def all_to_all_dp(x: torch.Tensor, dist: Optional[Dist]) -> torch.Tensor:
    """x: (dp, ...): the expert-parallel exchange over the data axis, with
    a gradient; ``x`` itself at one data rank."""
    if dist is None or dist.dp == 1:
        return x
    return _AllToAll.apply(x, dist)


def psum_tp(x: torch.Tensor, dist: Optional[Dist]) -> torch.Tensor:
    if dist is None or dist.tp == 1:
        return x
    return _Psum.apply(x, dist, "model")


def psum_dp(x: torch.Tensor, dist: Optional[Dist]) -> torch.Tensor:
    """The sum over the reference's ``dp_axes``: "data", and "pod" on a
    pod mesh."""
    if dist is None or dist.rows == 1:
        return x
    return _Psum.apply(x, dist, "rows")


def replicated_loss(loss: torch.Tensor, dist: Optional[Dist]) -> torch.Tensor:
    """The loss every rank holds, as the reference's ``out_specs=P()``:
    each rank's backward starts from 1/N of the cotangent, which the
    transposed sums above add up again."""
    if dist is None or dist.size == 1:
        return loss
    return _ScaleGrad.apply(loss, 1.0 / dist.size)


def gather_data(w: torch.Tensor, dim: int, dist: Dist) -> torch.Tensor:
    """An FSDP weight shard gathered whole along ``dim`` over "data"."""
    return _Gather.apply(w, dist, dim, "data")


def gather_tp(x: torch.Tensor, dim: int, dist: Optional[Dist]
              ) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``, with a
    gradient (the reference's ``all_gather(..., tiled=True)`` over
    "model"); ``x`` itself at one model rank."""
    if dist is None or dist.tp == 1:
        return x
    return _Gather.apply(x, dist, dim % x.dim(), "model")


def gather_logits(logits: torch.Tensor, dist: Optional[Dist],
                  rows_over_data: bool = False) -> torch.Tensor:
    """A rank's (rows, V_local) serving logits in the reference's global
    layout (a collective): the vocabulary gathered over the model axis,
    and with ``rows_over_data`` (padded rows split over "data") the rows
    over the data axis, in rank order."""
    if dist is None or dist.size == 1:
        return logits
    out = dist.all_gather(logits, "model")            # (tp, rows, V_local)
    out = out.permute(1, 0, 2).reshape(logits.shape[0], -1)
    if rows_over_data and dist.dp > 1:
        out = dist.all_gather(out, "data").reshape(-1, out.shape[1])
    return out


# ------------------------------------------------ vocab-parallel heads
def _vocab_offset(v_local: int, dist: Optional[Dist]) -> int:
    return 0 if dist is None else dist.model_rank * v_local


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor,
                 dist: Optional[Dist] = None) -> torch.Tensor:
    """tokens: (...,) int; table: this rank's (V_local, d) rows of the
    vocab. Returns (..., d) bf16, summed over the model axis; ids outside
    the table embed as zeros."""
    v = table.shape[0]
    lo = _vocab_offset(v, dist)
    idx = tokens - lo if lo else tokens
    ok = (idx >= 0) & (idx < v)
    idx = idx.clamp(0, v - 1).long()
    out = table[idx].to(torch.bfloat16)
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return psum_tp(out, dist)


def logits_local(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> fp32 logits (..., V_local). The operands are bf16
    values (the table is rounded as the reference rounds it) and the
    product is taken in fp32, never rounded to bf16: a bf16 output would
    be coarser than the greedy tie band."""
    w = table.to(x.dtype).float()
    return torch.matmul(x.float(), w.t())


def mask_pad_vocab(logits: torch.Tensor, vocab_size: int,
                   dist: Optional[Dist] = None) -> torch.Tensor:
    """Pad-vocab columns (global id >= vocab_size) to -1e30; keep in sync
    with ``serving.sampler.NEG``."""
    v = logits.shape[-1]
    gid = torch.arange(v, device=logits.device) + _vocab_offset(v, dist)
    return torch.where(gid < vocab_size, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def sharded_softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor = None,
                         dist: Optional[Dist] = None) -> torch.Tensor:
    """Cross-entropy over this rank's vocab-sharded fp32 logits
    (..., V_local). The max shift is detached (it cancels in d/dx
    logsumexp) and, across the model axis, the largest of every rank's
    max; the sum of exponentials and the gold logit are summed over the
    model axis. nll = logz - gold, with targets outside the vocab scoring
    a gold logit of 0; the mean runs over ``mask`` when given (at least 1
    in the denominator). Pad-vocab rows of the table are not masked: they
    enter logz, as in the reference."""
    v = logits.shape[-1]
    lo = _vocab_offset(v, dist)
    lmax = logits.detach().amax(-1)
    if dist is not None and dist.tp > 1:
        lmax = dist.all_gather(lmax, "model").amax(0)
    z = psum_tp(torch.exp(logits - lmax[..., None]).sum(-1), dist)
    logz = torch.log(z) + lmax
    idx = targets - lo if lo else targets
    ok = (idx >= 0) & (idx < v)
    idx = idx.clamp(0, v - 1).long()
    gold = logits.gather(-1, idx[..., None])[..., 0]
    gold = torch.where(ok, gold, torch.zeros((), dtype=gold.dtype,
                                             device=gold.device))
    gold = psum_tp(gold, dist)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
