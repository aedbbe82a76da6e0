"""The weight bridge: the reference's parameter pytree (numpy leaves) to the
port's parameter dict.

The port's parameters mirror the reference tree with its size-1 tp dim
dropped (``DecoderLM._squeeze_params``) and the (L, ...) layer stacking
kept. For serving, matrices are stored bf16 — ``dense`` rounds them to
bf16 before the product anyway, so this loses nothing — while norm weights
and biases stay fp32, since they enter fp32 arithmetic. Training keeps the
reference's fp32 masters instead (``master=True``, the counterpart of the
reference's ``model.param_dtype`` override).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Bit-exact numpy -> torch (CPU). ml_dtypes bfloat16 arrays, which
    ``torch.from_numpy`` rejects, go through their uint16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch tensors must own writable data
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def squeeze_tp(name: str, a, axes=None) -> np.ndarray:
    """A reference leaf (numpy) with its size-1 tp axis dropped (``axes``:
    the leaf-name -> tp-axis map of its subtree, the dense one by
    default)."""
    a = np.asarray(a)
    ax = (_TP_AXIS if axes is None else axes).get(name)
    if ax is not None:
        if a.shape[ax] != 1:
            raise ValueError(f"{name}: tp dim {a.shape[ax]} != 1 "
                             "(the port runs on one device)")
        a = np.squeeze(a, axis=ax)
    return a


def expand_tp(name: str, a: np.ndarray, axes=None) -> np.ndarray:
    """The inverse of ``squeeze_tp``: the reference's expanded layout."""
    ax = (_TP_AXIS if axes is None else axes).get(name)
    return a if ax is None else np.expand_dims(a, ax)


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


def _leaf(name: str, a, device, master: bool, axes) -> torch.Tensor:
    t = tensor_from_numpy(squeeze_tp(name, a, axes)).to(device)
    if master:
        return t.float()
    return t.to(torch.bfloat16 if name in MATRICES else torch.float32)


def params_from_numpy(tree: Dict, cfg, device, master: bool = False) -> Dict:
    """Convert the reference's param tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) of any family's ``cfg``. With
    ``master`` every leaf stays fp32 (training's masters); otherwise
    matrices (and the enc-dec ``dec_pos`` table, which the reference
    rounds to bf16 before use) become bf16 (serving). The hybrid's
    ``conv_w``, the MoE ``router`` and RWKV6's ``w_lora_b`` stay fp32:
    the reference multiplies by them in fp32 (a bf16 router of a
    bf16-param model is widened exactly)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}")

    def conv(name, a, parent):
        if isinstance(a, dict):
            return {n: conv(n, x, name) for n, x in a.items()}
        return _leaf(name, a, device, master,
                     subtree_tp_axes(cfg.family, parent))
    return {name: conv(name, a, "") for name, a in tree.items()}
