"""Pieces the family references share: fp32 RMSNorm, RoPE, causal and
windowed attention in query blocks, the SwiGLU MLP, and the matmul with
its fp8 control."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3fn
Q_BLOCK = 512       # query rows per attention block (bounds the scores)


def exact_fp32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (absmax to 448), returned in float32."""
    scale = x.abs().amax(dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (T, in) @ w (in, out) in float32; under ``quant="fp8"`` both
    operands rounded to float8 first (x per row, w per column)."""
    w = w.float()
    if quant == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, -2)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) rotated by position: the halves (x1, x2) go to
    (x1 cos - x2 sin, x2 cos + x1 sin) at frequencies theta^(-i / half)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int = 0) -> torch.Tensor:
    """Causal softmax attention of q (T, H, D) over k, v (T, KV, D): query
    head h reads K/V head h // (H / KV); the query at p sees keys at
    (p - window, p], or [0, p] without a window. Scale 1 / sqrt(D).
    Returns (T, H * D)."""
    t, h, d = q.shape
    kv = k.shape[1]
    g = h // kv
    out = torch.empty((t, h * d), dtype=torch.float32, device=q.device)
    pos = torch.arange(t, device=q.device)
    for i0 in range(0, t, Q_BLOCK):
        i1 = min(t, i0 + Q_BLOCK)
        j0 = max(0, i0 - window + 1) if window else 0
        qb = q[i0:i1].reshape(i1 - i0, kv, g, d)
        s = torch.einsum("qkgd,tkd->kgqt", qb, k[j0:i1]) / math.sqrt(d)
        qp, kp = pos[i0:i1, None], pos[None, j0:i1]
        seen = kp <= qp
        if window:
            seen &= kp > qp - window
        s = s.masked_fill(~seen, float("-inf"))
        o = torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, -1), v[j0:i1])
        out[i0:i1] = o.reshape(i1 - i0, h * d)
    return out


def attention_block(p, x, pos, *, heads, kv_heads, head_dim, theta,
                    window, eps, quant=None) -> torch.Tensor:
    """The pre-norm attention block's residual update: RMSNorm, q/k/v,
    RoPE, attention, o."""
    t = x.shape[0]
    xn = rms(x, p["attn_norm"], eps)
    q = rope(mm(xn, p["q"], quant).view(t, heads, head_dim), pos, theta)
    k = rope(mm(xn, p["k"], quant).view(t, kv_heads, head_dim), pos, theta)
    v = mm(xn, p["v"], quant).view(t, kv_heads, head_dim)
    return mm(attention(q, k, v, window), p["o"], quant)


def mlp_block(p, x, eps, quant=None) -> torch.Tensor:
    """The pre-norm SwiGLU MLP's residual update."""
    xn = rms(x, p["mlp_norm"], eps)
    h = F.silu(mm(xn, p["gate"], quant)) * mm(xn, p["up"], quant)
    return mm(h, p["down"], quant)


def head(x, final_norm, unembed, eps, quant=None) -> torch.Tensor:
    """Final RMSNorm and the fp32 logits against the (V, d) table."""
    return mm(rms(x, final_norm, eps), unembed.t(), quant)


def layer(stack, i: int):
    """Layer ``i`` of a dict of stacked (L, ...) leaves."""
    return {n: w[i] for n, w in stack.items()}
