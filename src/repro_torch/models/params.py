"""The weight bridge: the reference's parameter pytree (numpy leaves) to the
port's parameter dict.

The port's parameters mirror the reference tree with its size-1 tp dim
dropped (``DecoderLM._squeeze_params``) and the (L, ...) layer stacking
kept. Matrices are stored bf16 — ``dense`` rounds them to bf16 before the
product anyway, so this loses nothing — while norm weights and biases stay
fp32, since they enter fp32 arithmetic.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# leaf name -> its size-1 tp axis in the reference's expanded layout
_TP_AXIS = {"embed": 0, "unembed": 0, "q": 1, "k": 1, "v": 1, "o": 1,
            "gate": 1, "up": 1, "down": 1, "q_bias": 1, "k_bias": 1,
            "v_bias": 1}
MATRICES = frozenset({"embed", "unembed", "q", "k", "v", "o", "gate", "up",
                      "down"})


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Bit-exact numpy -> torch (CPU). ml_dtypes bfloat16 arrays, which
    ``torch.from_numpy`` rejects, go through their uint16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch tensors must own writable data
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    ax = _TP_AXIS.get(name)
    if ax is not None:
        if a.shape[ax] != 1:
            raise ValueError(f"{name}: tp dim {a.shape[ax]} != 1 "
                             "(the port serves on one device)")
        a = np.squeeze(a, axis=ax)
    t = tensor_from_numpy(a).to(device)
    return t.to(torch.bfloat16 if name in MATRICES else torch.float32)


def params_from_numpy(tree: Dict, cfg, device) -> Dict:
    """Convert the reference's dense-family param tree (leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) for ``cfg``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: dense only")
    out = {name: _leaf(name, a, device)
           for name, a in tree.items() if name != "layers"}
    out["layers"] = {name: _leaf(name, a, device)
                     for name, a in tree["layers"].items()}
    return out
