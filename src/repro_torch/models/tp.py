"""Single-device twins of the reference's vocab-parallel heads
(``repro/models/tp.py``): the port serves on one card, so the tp axis has
size 1 and every vocab shard is the whole table."""
from __future__ import annotations

import torch


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """tokens: (...,) int; table: (V, d). Returns (..., d) bf16; ids outside
    the table embed as zeros."""
    v = table.shape[0]
    ok = (tokens >= 0) & (tokens < v)
    idx = tokens.clamp(0, v - 1).long()
    out = table[idx].to(torch.bfloat16)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))


def logits_local(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> fp32 logits (..., V). The operands are bf16 values
    (the table is rounded as the reference rounds it) and the product is
    taken in fp32, never rounded to bf16: a bf16 output would be coarser
    than the greedy tie band."""
    w = table.to(x.dtype).float()
    return torch.matmul(x.float(), w.t())


def mask_pad_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Pad-vocab columns (id >= vocab_size) to -1e30; keep in sync with
    ``serving.sampler.NEG``."""
    gid = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(gid < vocab_size, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))
