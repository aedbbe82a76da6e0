"""Plain fp32 reference of the dense decoder (h2o-danube-3-4b): pre-norm
attention (GQA, RoPE, full or sliding-window layers in the configuration's
pattern) and SwiGLU MLP, then the final norm and the untied head."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import common as C


@torch.no_grad()
def logits(params: Dict, model: Dict, tokens: Sequence[int],
           rows: Sequence[int], quant=None) -> torch.Tensor:
    """fp32 logits (len(rows), V) at positions ``rows`` of the sequence
    ``tokens``, computed over all of it."""
    dev = params["embed"].device
    ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(ids.shape[0], device=dev)
    x = params["embed"][ids].float()
    pat = model.get("attn_pattern", ["full"])
    eps = model["norm_eps"]
    for i in range(model["num_layers"]):
        p = C.layer(params["layers"], i)
        window = model["sliding_window"] if pat[i % len(pat)] == "swa" else 0
        x = x + C.attention_block(
            p, x, pos, heads=model["num_heads"],
            kv_heads=model["num_kv_heads"], head_dim=model["head_dim"],
            theta=model["rope_theta"], window=window, eps=eps, quant=quant)
        x = x + C.mlp_block(p, x, eps, quant)
    table = params["embed"] if model.get("tie_embeddings") else \
        params["unembed"]
    sel = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    return C.head(x[sel], params["final_norm"], table, eps, quant)
