"""The weight bridge: the reference's parameter pytree (numpy leaves) to the
port's parameter dict, and back.

The reference stores each tensor-parallel leaf in its *expanded layout*,
with a ``tp`` axis (``repro/models/tp.py``). The port's parameters mirror
the reference tree, each rank holding its slice of every leaf: index
``model_rank`` of the tp axis (which its tensor drops), and, for a layer
leaf that FSDP shards, its part of the first dim after the tp axis that
the data axis divides (the reference's rule in ``DecoderLM.template``).
The (L, ...) layer stacking is kept. On one device the tp axis has size 1
and nothing is split. For serving, matrices are stored bf16 (``dense``
rounds them to bf16 before the product anyway, so this loses nothing)
while norm weights and biases stay fp32, since they enter fp32
arithmetic. Training keeps the reference's fp32 masters instead
(``master=True``, the counterpart of the reference's
``model.param_dtype`` override).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .tp import Dist, Shard

# leaf name -> its size-1 tp axis in the reference's expanded layout (the
# MoE leaves, router and moe_*, have none: the reference shards experts
# over "data" and the expert FFN over "model" without a size-1 dim)
_TP_AXIS = {"embed": 0, "unembed": 0, "q": 1, "k": 1, "v": 1, "o": 1,
            "gate": 1, "up": 1, "down": 1, "q_bias": 1, "k_bias": 1,
            "v_bias": 1}
MATRICES = frozenset({"embed", "unembed", "q", "k", "v", "o", "gate", "up",
                      "down", "w_z", "w_x", "w_B", "w_C", "w_dt", "w_out",
                      "moe_gate", "moe_up", "moe_down", "w_r", "w_k", "w_v",
                      "w_g", "w_o", "w_lora_a", "cm_wk", "cm_wv", "cm_wr",
                      "w1", "w2", "dec_pos"})
# hybrid subtrees: stacked Mamba2 leaves carry tp at axis 1 (their "norm"
# has none); the shared attention block's matrices at axis 0
_HYBRID_TP_AXIS = {
    "mamba": {n: 1 for n in ("w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias",
                             "A_log", "D", "conv_w", "out_norm", "w_out")},
    "shared_attn": {n: 0 for n in ("q", "k", "v", "o", "gate", "up",
                                   "down")},
}
# ssm (RWKV6) layer stacks and enc-dec attention / MLP stacks: tp at axis 1
_SSM_TP_AXIS = {n: 1 for n in ("ln_x", "w_r", "w_k", "w_v", "w_g", "w_o",
                               "w_lora_a", "w_lora_b", "w_base", "u",
                               "cm_wk", "cm_wv", "cm_wr")}
_ENCDEC_TP_AXIS = {n: 1 for n in ("q", "k", "v", "o", "q_bias", "v_bias",
                                  "w1", "b1", "w2")}
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")
# the MoE expert stacks (L, E, ...): experts (dim 1) over "data" (expert
# parallelism) and each expert's ffe dim, named here, over "model"
# (expert-TP), the reference's P(None, "data", None, "model") and
# P(None, "data", "model") (``DecoderLM.template``)
EP_MODEL_DIM = {"moe_gate": 3, "moe_up": 3, "moe_down": 2}


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Bit-exact numpy -> torch (CPU). ml_dtypes bfloat16 arrays, which
    ``torch.from_numpy`` rejects, go through their uint16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch tensors must own writable data
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def subtree_tp_axes(family: str, parent: str):
    """The leaf-name -> tp-axis map of the leaves under the dict key
    ``parent`` of a ``family`` tree: a hybrid's ``mamba_main`` /
    ``mamba_tail`` and ``shared_attn``, RWKV6's ``layers``, and every
    enc-dec attention and MLP stack (``enc.attn`` / ``enc.mlp``,
    ``dec_self``, ``dec_cross``, ``dec_mlp``) have their own; every other
    leaf takes the dense map."""
    if family == "hybrid":
        if parent in ("mamba_main", "mamba_tail"):
            return _HYBRID_TP_AXIS["mamba"]
        if parent == "shared_attn":
            return _HYBRID_TP_AXIS["shared_attn"]
    if family == "ssm" and parent == "layers":
        return _SSM_TP_AXIS
    if family == "encdec" and parent in ("attn", "mlp", "dec_self",
                                         "dec_cross", "dec_mlp"):
        return _ENCDEC_TP_AXIS
    return _TP_AXIS


def fsdp_dim(global_shape, data: int) -> Optional[int]:
    """The reference's FSDP rule for a stacked layer leaf (L, tp, ...):
    the first dim after the tp dim that the data axis divides, as a dim of
    the rank's (L, ...) tensor (the tp dim dropped); None when there is
    none."""
    if len(global_shape) < 3:
        return None
    for i in range(2, len(global_shape)):
        if global_shape[i] % data == 0 and global_shape[i] >= data:
            return i - 1
    return None


def leaf_shard(family: str, parent: str, name: str, global_shape=None,
               dist: Optional[Dist] = None) -> Shard:
    """The ``Shard`` of leaf ``name`` under the dict key ``parent`` of a
    ``family`` tree whose global (expanded) shape is ``global_shape``: its
    tp axis from ``subtree_tp_axes``, and under FSDP (``dist.fsdp`` with
    more than one data rank) the data dim of a decoder's stacked layer
    leaf whose tp axis is its second (``fsdp_dim``). An expert stack has
    no tp axis: its experts are split over "data" and its ffe over
    "model" on every mesh (``EP_MODEL_DIM``), and FSDP leaves it alone,
    as the reference's rule does (its spec's second entry is "data")."""
    if family == "moe" and parent == "layers" and name in EP_MODEL_DIM:
        return Shard(None, 1, EP_MODEL_DIM[name])
    tp_axis = subtree_tp_axes(family, parent).get(name)
    data_dim = None
    if (dist is not None and dist.fsdp and dist.dp > 1
            and family in ("dense", "moe", "vlm") and parent == "layers"
            and tp_axis == 1):
        data_dim = fsdp_dim(global_shape, dist.dp)
    return Shard(tp_axis, data_dim)


def _split(a, dim: int, rank: int, n: int):
    """Part ``rank`` of ``n`` even parts of ``a``'s ``dim``."""
    if a.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(a.shape)} does not split "
                         f"over {n} ranks")
    k = a.shape[dim] // n
    if isinstance(a, torch.Tensor):
        return a.narrow(dim, rank * k, k)
    return np.take(a, range(rank * k, (rank + 1) * k), axis=dim)


def local_part(a, shard: Shard, dist: Optional[Dist] = None):
    """This rank's part of the global leaf ``a`` (numpy or torch): index
    ``model_rank`` of ``shard.tp_axis``, then ``data_rank``'s slice of
    ``shard.data_dim``, ``model_rank``'s of ``shard.model_dim`` and
    ``pod_rank``'s of ``shard.pod_dim``."""
    dist = dist or Dist()
    if shard.tp_axis is not None:
        n = a.shape[shard.tp_axis]
        if n != dist.tp:
            raise ValueError(f"tp dim {n} != the mesh's tp {dist.tp}")
        a = (a.select(shard.tp_axis, dist.model_rank)
             if isinstance(a, torch.Tensor)
             else np.take(a, dist.model_rank, axis=shard.tp_axis))
    if shard.data_dim is not None:
        a = _split(a, shard.data_dim, dist.data_rank, dist.dp)
    if shard.model_dim is not None:
        a = _split(a, shard.model_dim, dist.model_rank, dist.tp)
    if shard.pod_dim is not None:
        a = _split(a, shard.pod_dim, dist.pod_rank, dist.pod)
    return a


def gather_global(t: torch.Tensor, shard: Shard,
                  dist: Optional[Dist] = None) -> torch.Tensor:
    """The inverse of ``local_part``: the global leaf from every rank's
    part (a collective: every rank of the mesh calls it, leaf by leaf in
    the same order, and every rank gets the whole leaf)."""
    dist = dist or Dist()
    if shard.pod_dim is not None:
        parts = dist.all_gather(t, "pod")
        t = torch.cat(list(parts), dim=shard.pod_dim)
    if shard.data_dim is not None:
        parts = dist.all_gather(t, "data")
        t = torch.cat(list(parts), dim=shard.data_dim)
    if shard.model_dim is not None:
        parts = dist.all_gather(t, "model")
        t = torch.cat(list(parts), dim=shard.model_dim)
    if shard.tp_axis is not None:
        t = dist.all_gather(t, "model").movedim(0, shard.tp_axis)
    return t


def _leaf(name: str, a, device, master: bool, shard: Shard,
          dist) -> torch.Tensor:
    t = tensor_from_numpy(local_part(np.asarray(a), shard, dist)).to(device)
    if master:
        return t.float()
    return t.to(torch.bfloat16 if name in MATRICES else torch.float32)


def params_from_numpy(tree: Dict, cfg, device, master: bool = False,
                      dist: Optional[Dist] = None) -> Dict:
    """Convert the reference's param tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``, drawn at the mesh's tp) of any
    family's ``cfg`` into this rank's part of it (``dist``; one device by
    default). With ``master`` every leaf stays fp32 (training's masters);
    otherwise matrices (and the enc-dec ``dec_pos`` table, which the
    reference rounds to bf16 before use) become bf16 (serving). The
    hybrid's ``conv_w``, the MoE ``router`` and RWKV6's ``w_lora_b`` stay
    fp32: the reference multiplies by them in fp32 (a bf16 router of a
    bf16-param model is widened exactly)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}")

    def conv(name, a, parent):
        if isinstance(a, dict):
            return {n: conv(n, x, name) for n, x in a.items()}
        a = np.asarray(a)
        return _leaf(name, a, device, master,
                     leaf_shard(cfg.family, parent, name, a.shape, dist),
                     dist)
    return {name: conv(name, a, "") for name, a in tree.items()}


def gather_tree(tree: Dict, shards: Dict, dist: Optional[Dist] = None
                ) -> Dict:
    """The global tree (numpy leaves, the reference's layout) of every
    rank's ``tree`` (this rank's tensors) under ``shards`` (a tree of
    ``Shard`` like it, ``DecoderLM.shards()``): a collective, leaf by
    leaf in sorted key order."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out[key] = gather_tree(val, shards[key], dist)
        else:
            g = gather_global(val.detach(), shards[key], dist)
            # a copy: on the CPU the array would share a whole leaf's
            # storage, which a later in-place update changes
            out[key] = g.cpu().numpy().copy()
    return out
