"""Zeroed int32 scratch for kernels that count or signal across their
blocks (the varlen flash kernel's split counters, the Mamba2 scan's ticket
and state flags)."""
from __future__ import annotations

import torch

_MIN = 1 << 16
_BUFS = {}


def stream_scratch(device, stream, n):
    """At least ``n`` int32 on ``device`` for launches on ``stream``: zeroed
    once, and every kernel that takes it must leave what it touched zero
    again, so no launch needs a memset. Launches on one stream run one
    after another and can share it, whichever kernel they are; another
    stream gets its own."""
    key = (device, stream)
    buf = _BUFS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, _MIN), dtype=torch.int32, device=device)
        _BUFS[key] = buf
    return buf
