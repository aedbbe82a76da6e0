"""Rotary position embeddings (standard RoPE), computed in fp32 as the
reference does (``repro/models/rotary.py``)."""
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
