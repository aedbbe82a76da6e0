"""Roofline constants of the card the port serves on, and the analytic
parameter count (``repro/launch/roofline.py``, cut to what
``serving.autotune`` needs).

One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity, at
its full 700 W power limit: 989 TFLOP/s on bf16 tensor-core products and
3.35 TB/s of HBM3 bandwidth. These are the constants every bound in the
port's measurements uses. ``count_params`` is copied from the reference
unchanged.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # H100 SXM, HBM3 bytes/s


def count_params(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    V = cfg.vocab_size
    H, KV = cfg.num_heads, cfg.num_kv_heads
    attn = d * hd * (2 * H + 2 * KV)
    out = {"embed": V * d * (1 if cfg.tie_embeddings else 2)}
    if cfg.family == "ssm":
        att_dim = d
        per_layer = 5 * d * att_dim + att_dim * d + 2 * d * cfg.d_ff \
            + d * d + 64 * (d + att_dim)
        out["layers"] = cfg.num_layers * per_layer
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.family == "hybrid":
        di = cfg.mamba_expand * d
        N = cfg.mamba_d_state
        mamba = 2 * d * di + 2 * d * N + d * (di // cfg.mamba_headdim) \
            + di * d
        shared = attn + 3 * d * cfg.d_ff
        out["layers"] = cfg.num_layers * mamba + shared
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.family == "encdec":
        per = attn + 2 * d * cfg.d_ff
        dec = 2 * attn + 2 * d * cfg.d_ff
        out["layers"] = cfg.encoder_layers * per + cfg.num_layers * dec
        out["active"] = out["layers"] + out["embed"]
        out["total"] = out["active"]
        return out
    if cfg.num_experts:
        expert = 3 * d * cfg.moe_d_ff
        per_layer_dense = attn + d * cfg.num_experts
        out["layers"] = cfg.num_layers * (
            per_layer_dense + cfg.num_experts * expert)
        active = cfg.num_layers * (
            per_layer_dense + cfg.experts_per_token * expert)
        out["active"] = active + out["embed"]
        out["total"] = out["layers"] + out["embed"]
        return out
    per_layer = attn + 3 * d * cfg.d_ff
    out["layers"] = cfg.num_layers * per_layer
    out["active"] = out["layers"] + out["embed"]
    out["total"] = out["active"]
    return out
