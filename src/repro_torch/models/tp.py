"""Single-device twins of the reference's vocab-parallel heads
(``repro/models/tp.py``): the port runs on one card, so the tp axis has
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


def sharded_softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor = None) -> torch.Tensor:
    """Cross-entropy over fp32 logits (..., V): the reference's
    vocab-sharded head with one shard. The max shift is detached (it
    cancels in d/dx logsumexp); nll = logz - gold, with targets outside the
    vocab scoring a gold logit of 0; the mean runs over ``mask`` when given
    (at least 1 in the denominator)."""
    v = logits.shape[-1]
    lmax = logits.detach().amax(-1)
    z = torch.exp(logits - lmax[..., None]).sum(-1)
    logz = torch.log(z) + lmax
    ok = (targets >= 0) & (targets < v)
    idx = targets.clamp(0, v - 1).long()
    gold = logits.gather(-1, idx[..., None])[..., 0]
    gold = torch.where(ok, gold, torch.zeros((), dtype=gold.dtype,
                                             device=gold.device))
    nll = logz - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
