"""The work a step's plan asks for: FLOPs and bytes, from the requests'
own lengths and positions (never from a kernel's launch arguments, so a
kernel that changes its tiling, or is replaced, leaves the count as it
is).

A plan item is ``(prompt_len, num_tokens, start)``: the step computes the
request's positions ``start .. start + num_tokens - 1``. Widths come from
a configuration file's ``model`` section. Bytes count each input byte read
once and each output byte written once (bf16 activations and K/V, fp32
scan inputs and states as the port's kernels take them); FLOPs count a
multiply-add as two."""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Item = Tuple[int, int, int]


def visible_pairs(start: int, nt: int, window: int = 0) -> int:
    """(query, key) pairs a chunk at positions start .. start+nt-1 attends:
    each query at p sees keys (p - window, p], or [0, p] without a window."""
    if not window:
        return nt * start + nt * (nt + 1) // 2      # sum of p + 1
    # queries below p = window - 1 see p + 1 keys, the rest see window
    c = max(0, min(start + nt - 1, window - 2) - start + 1)
    return c * (start + 1) + c * (c - 1) // 2 + (nt - c) * window


def distinct_keys(start: int, nt: int, window: int = 0) -> int:
    """Keys any query of the chunk sees (each read once)."""
    end = start + nt
    if not window:
        return end
    return end - max(0, start - window + 1)


def attention_windows(model: Dict) -> List[int]:
    """The window of each attention layer a step runs (0: full)."""
    if model["family"] == "hybrid":
        return [0] * (model["num_layers"] // model["attn_every"])
    pat = model.get("attn_pattern", ["full"])
    win = model.get("sliding_window", 0)
    return [win if pat[i % len(pat)] == "swa" else 0
            for i in range(model["num_layers"])]


def varlen(items: Iterable[Item], model: Dict) -> Tuple[float, float]:
    """FLOPs and bytes of the step's attention layers: Q, O, and the
    visible K/V of each segment."""
    h, kv, d = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    flops = nbytes = 0.0
    for w in attention_windows(model):
        for _, nt, start in items:
            flops += 4.0 * h * d * visible_pairs(start, nt, w)
            nbytes += 2 * nt * h * d * 2 + \
                2 * distinct_keys(start, nt, w) * kv * d * 2
    return flops, nbytes


def _mamba(model: Dict):
    d_in = model["mamba_expand"] * model["d_model"]
    heads = d_in // model["mamba_headdim"]
    return d_in, heads, model["mamba_headdim"], model["mamba_d_state"]


def scan(items: Sequence[Item], model: Dict) -> Tuple[float, float]:
    """FLOPs and bytes of the step's Mamba2 scans: per token and head the
    recurrence h = a h + dt x B^T and y = C h (5 P N FLOPs); x, B, C in
    bf16, dt and y in fp32, each segment's fp32 state read and written."""
    if model["family"] != "hybrid":
        return 0.0, 0.0
    _, h, p, n = _mamba(model)
    tokens = sum(nt for _, nt, _ in items)
    layers = model["num_layers"]
    flops = layers * 5.0 * h * p * n * tokens
    per_tok = h * p * 2 + 2 * n * 2 + h * 4 + h * p * 4
    per_seg = 2 * h * p * n * 4
    nbytes = layers * (tokens * per_tok + len(items) * per_seg + h * 4)
    return flops, nbytes


def _dense_layer_params(model: Dict) -> int:
    d, h, kv, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], model["head_dim"])
    return d * h * hd * 2 + d * kv * hd * 2 + 3 * d * model["d_ff"]


def matmul_params(model: Dict) -> int:
    """Weights every token multiplies (the head and embedding apart)."""
    if model["family"] == "hybrid":
        d = model["d_model"]
        d_in, h, _, n = _mamba(model)
        mamba = d * (2 * d_in + 2 * n + h) + d_in * d
        shared = model["num_layers"] // model["attn_every"]
        return model["num_layers"] * mamba + shared * _dense_layer_params(
            model)
    return model["num_layers"] * _dense_layer_params(model)


def model_flops(items: Sequence[Item], model: Dict) -> float:
    """A step's model FLOPs: every token through the matmuls, the head at
    the positions that sample a token, attention over the visible keys,
    and the scan."""
    tokens = sum(nt for _, nt, _ in items)
    sampled = sum(1 for plen, nt, start in items if start + nt >= plen)
    return (2.0 * matmul_params(model) * tokens +
            2.0 * model["d_model"] * model["vocab_size"] * sampled +
            varlen(items, model)[0] + scan(items, model)[0])
