"""Rotary position embeddings (standard RoPE and Qwen2-VL's M-RoPE),
computed in fp32 as the reference does (``repro/models/rotary.py``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 1e6):
    """fp32 tables (cos|cos, -sin|sin) of shape (..., seq, 1, head_dim) —
    the same for every layer of a step."""
    inv = rope_freqs(head_dim, theta, device=positions.device)  # (half,)
    ang = positions[..., None].float() * inv                   # (..., seq, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def default_mrope_sections(head_dim: int):
    """Qwen2-VL proportions (16, 24, 24 at head dim 128): a quarter of the
    frequency slots temporal, the rest split between height and width."""
    half = head_dim // 2
    t = max(1, half // 4)
    h1 = (half - t) // 2
    return (t, h1, half - t - h1)


def mrope_tables(positions3: torch.Tensor, head_dim: int,
                 theta: float = 1e6, sections=None):
    """``rope_tables`` for M-RoPE (the reference's ``apply_mrope``): the
    head_dim / 2 frequency slots are split into ``sections`` groups, slot
    i rotated by position stream ``sel[i]`` of ``positions3`` (3, ...,
    seq). Returns the same (cos|cos, -sin|sin) pair of shape (..., seq,
    1, head_dim), for ``rotate``."""
    half = head_dim // 2
    if sections is None:
        sections = default_mrope_sections(head_dim)
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    inv = rope_freqs(head_dim, theta, device=dev)               # (half,)
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                     for i, s in enumerate(sections)])         # (half,)
    ang = positions3.float().movedim(0, -1)[..., sel] * inv    # (..., seq, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def rotate(x: torch.Tensor, cos2: torch.Tensor,
           sin2: torch.Tensor) -> torch.Tensor:
    """Apply precomputed rope tables to x: (..., seq, heads, head_dim).
    In fp32, [x1*cos - x2*sin, x2*cos + x1*sin] as x*(cos|cos) +
    (x2|x1)*(-sin|sin): the same roundings, fewer ops."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos2 + torch.cat([x2, x1], -1) * sin2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal encoder positions, fp32 (seq_len,
    d_model): [sin | cos] of pos / 10000^(2i / d_model)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
