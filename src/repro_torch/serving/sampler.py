"""Token selection, on the host and on the device (``repro/serving/sampler.py``).

Greedy resolves within a tie band: any token whose fp32 logit is within
``TIE_EPS`` of the row max is tie-eligible and the lowest id wins. On the
device that is ``argmax(x >= max - eps)`` — argmax returns the first
maximal index, the lowest id in the band — bit-identical to the host
``np.flatnonzero`` form, since max and compare are exact fp32 operations
on the same values.

The token board: the fused dispatch tail scatters each segment's token into
a persistent device int32 board at a per-request slot; a later dispatch
whose input token is still in flight reads it back on the device
(``inject_tokens``). Host arrays use -1 for "no write"/"no read". The
board's last element is a trash slot that -1 writes are redirected to: a
negative index would wrap in torch and an out-of-range one faults on CUDA.

Seeded temperature/top-k sampling (the reference's threefry-keyed draws)
is not in this slice of the port.
"""
import zlib

import numpy as np
import torch

# Greedy tie band over fp32 logits; see module docstring.
TIE_EPS = 5e-3
# Matches the pad-vocab mask value in models.tp.mask_pad_vocab.
NEG = -1e30

SEEDED_SAMPLING_LATER = (
    "temperature > 0 (seeded temperature/top-k sampling with threefry "
    "keys) is not ported yet: it comes in the seeded-sampling slice")


def greedy_token(logits) -> int:
    """Host greedy pick: lowest token id within TIE_EPS of the row max."""
    logits = np.asarray(logits, np.float32)
    return int(np.flatnonzero(logits >= logits.max() - TIE_EPS)[0])


def rid_hash(rid: str) -> int:
    """Stable 32-bit request-id hash (Python ``hash`` is process-salted)."""
    return zlib.crc32(rid.encode()) & 0xFFFFFFFF


def host_sample(row, temperature, top_k, rh, pos, seed) -> int:
    """Seeded temperature/top-k draw: not in this slice."""
    raise NotImplementedError(SEEDED_SAMPLING_LATER)


def band_pick(x: torch.Tensor) -> torch.Tensor:
    """Lowest index within TIE_EPS of the row max (trailing axis), int32."""
    m = x.amax(dim=-1, keepdim=True)
    return torch.argmax((x >= m - TIE_EPS).to(torch.uint8),
                        dim=-1).to(torch.int32)


def sample_greedy(logits: torch.Tensor, board: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """Fused greedy tail: pick each row's token and scatter it into
    ``board`` (in place) at ``dst``; dst -1 writes nowhere (to the trash
    slot). Returns the (rows,) int32 tokens."""
    toks = band_pick(logits.float())
    trash = board.shape[0] - 1
    idx = torch.where(dst < 0, trash, dst).long()
    board.index_copy_(0, idx, toks)
    return toks


def inject_tokens(tokens: torch.Tensor, src: torch.Tensor,
                  board: torch.Tensor) -> torch.Tensor:
    """Replace tokens at positions where ``src >= 0`` with board[src]."""
    fed = board[src.clamp(0, board.shape[0] - 2).long()]
    return torch.where(src >= 0, fed.to(tokens.dtype), tokens)
